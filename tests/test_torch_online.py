"""The port's serving entry points vs the JAX ``OnlineDenoiser``.

The JAX engine runs its fused Pallas serving path in interpret mode
(``F2F_FUSED=force`` with ``conv_impl="fused"``, as tests/test_fused_stack.py
does); the port runs on the CPU, where its kernel wrappers compute their
plain versions. Both chains store bf16, hence rtol 0.03 / atol 0.02.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.train.online import OnlineDenoiser as JaxDenoiser  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import from_jax_variables  # noqa: E402
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402
from frame2frame_tpu_torch.train import online as tonline  # noqa: E402
from frame2frame_tpu_torch.train.online import OnlineDenoiser  # noqa: E402

from test_torch_fused_apply import frames, perturbed_model  # noqa: E402

BF16_TOL = dict(rtol=0.03, atol=0.02)
ROUTE_TOL = dict(rtol=0.0, atol=4e-3)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("impl", ["affine", "act-bf16"])
def test_serving_matches_jax_engine(monkeypatch, impl, residual):
    """denoise_only and denoise_batch on both routes, both eval impls, both
    output conventions; the CPU leaves the launch counters at 0."""
    monkeypatch.setenv("F2F_FUSED", "force")
    for var in ("F2F_EVAL", "F2F_EVAL_DTYPE", "F2F_BATCH", "F2F_CONV"):
        monkeypatch.delenv(var, raising=False)
    H, W = 16, 32
    model, variables = perturbed_model(H, W, seed=8, residual=residual,
                                       conv_impl="fused")
    x = frames(3, H, W, seed=9)
    jeng = JaxDenoiser(model, variables, iters=1, residual_model=residual,
                       eval_impl=impl)
    want_only = np.asarray(jeng.denoise_only(jnp.asarray(x[0])))
    want = {r: np.asarray(jeng.denoise_batch(jnp.asarray(x), route=r))
            for r in ("stacked", "perframe")}

    eng = OnlineDenoiser(from_jax_variables(variables, residual=residual),
                         variables, residual_model=residual, eval_impl=impl,
                         device="cpu")
    tfs.reset_launch_counts()
    got_only = eng.denoise_only(x[0])
    assert got_only.shape == (H, W, 1) and got_only.device.type == "cpu"
    np.testing.assert_allclose(got_only.numpy(), want_only, **BF16_TOL)
    for route in ("stacked", "perframe"):
        got = eng.denoise_batch(x, route=route).numpy()
        np.testing.assert_allclose(got, want[route], err_msg=route,
                                   **BF16_TOL)
    assert not any(tfs.launch_counts().values())


def test_routes_agree_and_stacked_falls_back(monkeypatch):
    """Both routes give the same frames, up to two bf16 ulps of the noise
    (the bf16 end convs round a batch and a lone frame apart); a batch over
    the memory budget takes the per-frame route instead of failing."""
    H, W = 13, 20
    _, variables = perturbed_model(H, W, seed=10)
    eng = OnlineDenoiser(from_jax_variables(variables), variables,
                         batch_route="perframe", device="cpu")
    x = frames(3, H, W, seed=11)
    one = torch.stack([eng.denoise_only(f) for f in x])
    stacked = eng.denoise_batch(x, route="stacked")
    np.testing.assert_allclose(stacked.numpy(), one.numpy(), **ROUTE_TOL)
    np.testing.assert_allclose(eng.denoise_batch(x).numpy(), one.numpy(),
                               rtol=1e-5, atol=1e-6)
    seen = []
    monkeypatch.setattr(tonline, "fused_eval_apply_batch",
                        lambda *a, **k: seen.append(1))
    monkeypatch.setattr(tonline, "_memory_budget", lambda device: 1024)
    fallback = eng.denoise_batch(x, route="stacked")
    assert not seen
    np.testing.assert_allclose(fallback.numpy(), one.numpy(), **ROUTE_TOL)


def test_engine_serves_its_variables_and_validates_options():
    _, variables = perturbed_model(8, 8, seed=12)
    model = from_jax_variables(variables)
    eng = OnlineDenoiser(model, variables, device="cpu")
    out = eng.variables
    np.testing.assert_array_equal(out["params"]["conv_1"]["kernel"],
                                  variables["params"]["conv_1"]["kernel"])
    np.testing.assert_array_equal(out["batch_stats"]["bn_2"]["var"],
                                  variables["batch_stats"]["bn_2"]["var"])
    with pytest.raises(ValueError):
        OnlineDenoiser(model, variables, batch_route="chunked", device="cpu")
    with pytest.raises(ValueError):
        OnlineDenoiser(model, variables, eval_impl="act", device="cpu")
    with pytest.raises(ValueError):
        eng.denoise_batch(np.zeros((1, 8, 8, 1), np.float32), route="chunked")


def test_engine_without_device_raises_without_cuda(monkeypatch):
    """Entry points run on the card unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, variables = perturbed_model(8, 8, seed=13)
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineDenoiser(from_jax_variables(variables), variables)
