"""The port's DnCNN and fused eval forward vs the JAX package.

- ``from_jax_variables`` + the plain module forward against
  ``DnCNN(conv_impl="xla").apply(train=False)``, f32, both output
  conventions;
- ``fused_eval_apply`` / ``fused_eval_apply_batch`` (plain kernel versions on
  the CPU) against the JAX functions of the same names, whose Pallas kernels
  run in interpret mode, for every eval implementation and both JAX conv
  forms.

Tolerances: rtol = atol = 2e-4 with f32 storage (tests/test_fused_stack.py),
rtol 0.03 / atol 0.02 where a bf16 chain is involved.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.models import fused_apply as jfa  # noqa: E402
from frame2frame_tpu.models.dncnn import init_dncnn  # noqa: E402
from frame2frame_tpu_torch.models import fused_apply as tfa  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    from_jax_variables,
    to_jax_variables,
)
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=0.03, atol=0.02)


def perturbed_model(H, W, seed, residual=False, conv_impl="packed",
                    num_layers=5, channels=1):
    """A JAX DnCNN with numpy-seeded, non-trivial BN parameters and running
    statistics; returns (model, variables with numpy leaves)."""
    model, variables = init_dncnn(jax.random.PRNGKey(seed), channels=channels,
                                  num_layers=num_layers, residual=residual,
                                  conv_impl=conv_impl, spatial=(H, W))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    for i in range(num_layers - 2):
        bn = variables["params"][f"bn_{i}"]
        bn["scale"] = (1.0 + 0.2 * rng.standard_normal(64)).astype(np.float32)
        bn["bias"] = (0.1 * rng.standard_normal(64)).astype(np.float32)
        st = variables["batch_stats"][f"bn_{i}"]
        st["mean"] = (0.1 * rng.standard_normal(64)).astype(np.float32)
        st["var"] = (0.5 + rng.random(64)).astype(np.float32)
    return model, variables


def frames(B, H, W, seed, C=1):
    return np.random.default_rng(seed).random((B, H, W, C)).astype(np.float32)


@pytest.mark.parametrize("residual,channels", [(False, 1), (True, 1),
                                               (False, 3)])
def test_from_jax_variables_matches_xla_model(residual, channels):
    H, W = 16, 20
    model, variables = perturbed_model(H, W, seed=1, residual=residual,
                                       conv_impl="xla", channels=channels)
    x = frames(2, H, W, seed=2, C=channels)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    tm = from_jax_variables(variables, residual=residual,
                            conv_impl="xla").eval()
    assert (tm.channels, tm.num_layers, tm.features) == (channels, 5, 64)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_jax_variables_round_trip():
    _, variables = perturbed_model(8, 8, seed=3)
    back = to_jax_variables(from_jax_variables(variables))
    flat = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(flat)
    for path, v in flat:
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))


CASES = [("affine", "f32", None), ("affine", "bf16", None),
         ("act-f32", "f32", "odd"), ("act-f32", "f32", "even"),
         ("act-bf16", "f32", "odd"), ("act-bf16", "bf16", "even")]


@pytest.mark.parametrize("impl,store,conv", CASES)
@pytest.mark.parametrize("H,W", [(16, 32), (13, 20)])
def test_fused_eval_apply_matches_jax(H, W, impl, store, conv):
    """Single frame and stacked batch, against the JAX fused functions."""
    model, variables = perturbed_model(H, W, seed=4, residual=True)
    x = frames(2, H, W, seed=5)
    jdt = jnp.float32 if store == "f32" else jnp.bfloat16
    tdt = torch.float32 if store == "f32" else torch.bfloat16
    tol = F32_TOL if (store, impl) in (("f32", "affine"),
                                       ("f32", "act-f32")) else BF16_TOL
    args = (model, variables["params"], variables["batch_stats"])
    want1 = np.asarray(jfa.fused_eval_apply(*args, jnp.asarray(x[:1]),
                                            store_dtype=jdt, conv=conv,
                                            eval_impl=impl))
    wantb = np.asarray(jfa.fused_eval_apply_batch(*args, jnp.asarray(x),
                                                  store_dtype=jdt, conv=conv,
                                                  eval_impl=impl))
    tm = from_jax_variables(variables, residual=True).eval()
    tfs.reset_launch_counts()
    got1 = tfa.fused_eval_apply(tm, torch.from_numpy(x[:1]), store_dtype=tdt,
                                eval_impl=impl).numpy()
    gotb = tfa.fused_eval_apply_batch(tm, torch.from_numpy(x),
                                      store_dtype=tdt, eval_impl=impl).numpy()
    np.testing.assert_allclose(got1, want1, err_msg="single", **tol)
    np.testing.assert_allclose(gotb, wantb, err_msg="batch", **tol)
    assert not any(tfs.launch_counts().values())


def test_fused_eval_apply_rejects_batches_and_bad_impl():
    model = from_jax_variables(perturbed_model(8, 8, seed=6)[1])
    x = torch.zeros(2, 8, 8, 1)
    with pytest.raises(ValueError):
        tfa.fused_eval_apply(model, x)
    with pytest.raises(ValueError):
        tfa.fused_eval_apply_batch(model, x, eval_impl="act")


def test_can_fuse_batch_budget_matches_nhwc_footprint():
    """Four NHWC activations of the chain's element size must fit."""
    model = from_jax_variables(perturbed_model(8, 8, seed=7)[1])
    shape = (8, 1080, 1920, 1)
    bf16_bytes = 4 * 8 * 1080 * 1920 * 64 * 2
    assert tfa.can_fuse_batch(model, shape, bf16_bytes + 1)
    assert not tfa.can_fuse_batch(model, shape, bf16_bytes)
    assert tfa.can_fuse_batch(model, shape, bf16_bytes + 1, "act-bf16")
    assert not tfa.can_fuse_batch(model, shape, bf16_bytes + 1, "act-f32")
    assert tfa.can_fuse_batch(model, shape, 2 * bf16_bytes + 1, "act-f32")


def test_torch_state_dict_converters_match_jax(tmp_path):
    """The port's copies of the reference state-dict converters give what
    the JAX package's give, and a saved .pth loads back."""
    from frame2frame_tpu.models import dncnn as jd
    from frame2frame_tpu_torch.models import dncnn as td

    _, variables = perturbed_model(8, 8, seed=14)
    sd = td.export_torch_state_dict(variables, num_layers=5)
    want = jd.export_torch_state_dict(variables, num_layers=5)
    assert sd.keys() == want.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    path = tmp_path / "net.pth"
    torch.save({"module." + k: torch.from_numpy(np.array(v))
                for k, v in sd.items()}, path)
    back = td.load_torch_checkpoint(path, num_layers=5)
    ref = jd.import_torch_state_dict(sd, num_layers=5)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    for p, v in jax.tree_util.tree_leaves_with_path(ref):
        np.testing.assert_array_equal(got[p], v, err_msg=str(p))
