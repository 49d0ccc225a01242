"""The port's whole-iteration flat step
(frame2frame_tpu_torch/train/flat_step.py: ``prep_frame``, ``flat_net_loss``,
``eligible``, ``run_flat_scan``; ``OnlineDenoiser(flat_step=...)``) vs the JAX
package's (frame2frame_tpu/train/flat_step.py, Pallas kernels in interpret
mode under ``F2F_FUSED=force``) and vs the port's own per-iteration route
(``fused_train_apply`` + image-space L1).

Bounds, those of tests/test_flat_step.py: loss rtol 2e-4, batch means rtol
1e-3 / atol 1e-5 (the forwards round at the same points on either chain and
differ by the order of f32 additions), parameter gradients per leaf
max |d| / max |ref| 1e-4 on the f32 chain (summation order only) and 1e-2 on
the bf16 chain (the backwards round at different points); through the engine (3 Adam updates a frame)
losses rtol 1e-2, denoised frame atol 5e-3, parameters atol 1e-3, running
statistics rtol 1e-2 / atol 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.ops import fused_stack as jfs  # noqa: E402
from frame2frame_tpu.train import flat_step as jflat  # noqa: E402
from frame2frame_tpu.train import online as jonline  # noqa: E402
from frame2frame_tpu_torch.models import fused_apply as tfa  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    DnCNN,
    from_jax_variables,
)
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402
from frame2frame_tpu_torch.train import flat_step as tflat  # noqa: E402
from frame2frame_tpu_torch.train import online as tonline  # noqa: E402

from test_torch_fused_apply import perturbed_model  # noqa: E402
from test_torch_fused_apply_train import (  # noqa: E402
    assert_grads_close,
    grads_tree,
)
from test_torch_online_train import sequence  # noqa: E402

H, W = 16, 32
GRAD_TOL = {"f32": 1e-4, "bf16": 1e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def frame(h, w, seed):
    rng = np.random.default_rng(seed)
    cur = rng.random((h, w, 1)).astype(np.float32)
    mask = (rng.random((h, w, 1)) > 0.2).astype(np.float32)
    target = mask * rng.random((h, w, 1)).astype(np.float32)
    return cur, mask, target


def jax_flat(model, variables, cur, mask, target, dt):
    """loss, means, vars and the gradients of the JAX ``flat_net_loss``."""
    nmid = model.num_layers - 2
    W2 = cur.shape[1] // 2
    th = jfs.default_tile_h(W2)
    data = jflat.prep_frame(jnp.asarray(cur), jnp.asarray(mask),
                            jnp.asarray(target), jfs.Geom(cur.shape[0], W2, th),
                            store_dtype=JDT[dt])

    def loss_fn(p):
        diff = {
            "w_in": p["conv_in"]["kernel"],
            "ws": jnp.stack([p[f"conv_{i}"]["kernel"] for i in range(nmid)]),
            "gammas": jnp.stack([p[f"bn_{i}"]["scale"] for i in range(nmid)]),
            "betas": jnp.stack([p[f"bn_{i}"]["bias"] for i in range(nmid)]),
            "w_out": p["conv_out"]["kernel"],
        }
        loss, means, vars_ = jflat.flat_net_loss(diff, data, cur.shape[0],
                                                 W2, th, None)
        return loss, (means, vars_)

    (loss, (means, vars_)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    return float(loss), np.asarray(means), np.asarray(vars_), grads


def torch_flat(tm, cur, mask, target, dt, fn=tflat.flat_net_loss):
    data = tflat.prep_frame(*(torch.from_numpy(v) for v in (cur, mask, target)),
                            store_dtype=TDT[dt])
    loss, means, vars_ = fn(tflat.diff_of(tm), data)
    loss.backward()
    return loss, means, vars_


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h,w,residual,seed", [(16, 32, False, 70),
                                               (13, 20, True, 71)])
def test_flat_net_loss_matches_jax(monkeypatch, h, w, residual, seed, dt):
    monkeypatch.setenv("F2F_FUSED", "force")
    model, variables = perturbed_model(h, w, seed=seed, residual=residual,
                                       conv_impl="fused")
    cur, mask, target = frame(h, w, seed + 1)
    loss_j, means_j, vars_j, grads_j = jax_flat(model, variables, cur, mask,
                                                target, dt)
    tm = from_jax_variables(variables, residual=residual)
    tfs.reset_launch_counts()
    loss, means, vars_ = torch_flat(tm, cur, mask, target, dt)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert means.shape == vars_.shape == (3, 64)
    assert not means.requires_grad and not vars_.requires_grad
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=2e-4)
    np.testing.assert_allclose(means.numpy(), means_j, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(vars_.numpy(), vars_j, rtol=1e-3, atol=1e-5)
    assert_grads_close(grads_tree(tm), grads_j, GRAD_TOL[dt])
    assert all(p.grad.dtype == torch.float32 and p.grad.shape == p.shape
               for p in tm.parameters())
    assert not any(tfs.launch_counts().values())


def per_iteration_route(tm, cur, mask, target, dt):
    """The port's other route: ``fused_train_apply`` + the image-space L1."""
    x = torch.from_numpy(cur)[None]
    y = tfa.fused_train_apply(tm, x, store_dtype=TDT[dt])
    deno = y if tm.residual else x - y
    loss = (torch.from_numpy(mask) * deno[0]
            - torch.from_numpy(target)).abs().sum()
    loss.backward()
    return loss


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("h,w,residual", [(16, 32, False), (9, 13, True)])
def test_flat_route_matches_per_iteration_route(h, w, residual, dt):
    """Loss, batch means (through the running statistics) and gradients of
    the two routes of the port, also at an odd size."""
    _, variables = perturbed_model(16, 32, seed=72, residual=residual)
    cur, mask, target = frame(h, w, 73)
    old, new = (from_jax_variables(variables, residual=residual)
                for _ in range(2))
    loss_old = per_iteration_route(old, cur, mask, target, dt)
    loss_new, means, vars_ = torch_flat(new, cur, mask, target, dt)
    np.testing.assert_allclose(float(loss_new.detach()),
                               float(loss_old.detach()), rtol=2e-4)
    for i in range(old.nmid):
        _, bn = old.mid(i)
        _, bn0 = new.mid(i)  # untouched by flat_net_loss itself
        m_old = (bn.running_mean - 0.9 * bn0.running_mean) / 0.1
        np.testing.assert_allclose(means[i].numpy(), m_old.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=f"bn_{i}")
    assert_grads_close(grads_tree(new), grads_tree(old), GRAD_TOL[dt])


def test_loss_cotangent_scales_every_gradient():
    _, variables = perturbed_model(H, W, seed=74)
    cur, mask, target = frame(9, 14, 75)
    one, three = (from_jax_variables(variables) for _ in range(2))
    torch_flat(one, cur, mask, target, "f32")
    data = tflat.prep_frame(*(torch.from_numpy(v) for v in (cur, mask, target)),
                            store_dtype=torch.float32)
    (3.0 * tflat.flat_net_loss(tflat.diff_of(three), data)[0]).backward()
    for p, q in zip(one.parameters(), three.parameters()):
        np.testing.assert_allclose(q.grad.numpy(), 3.0 * p.grad.numpy(),
                                   rtol=1e-6, atol=1e-30)


def test_plain_twin_is_the_function_over_plain_versions():
    """``flat_net_loss_plain`` equals ``flat_net_loss`` on the CPU, where the
    wrappers compute their plain versions, with or without ``kernel_forward``;
    ``mma_bf16`` moves it by bf16 steps of the dot operands only."""
    _, variables = perturbed_model(H, W, seed=76)
    cur, mask, target = frame(11, 18, 77)
    outs = {}
    for key, fn in (
            ("kernels", tflat.flat_net_loss),
            ("plain", tflat.flat_net_loss_plain),
            ("plain_bwd", lambda d, x: tflat.flat_net_loss_plain(
                d, x, kernel_forward=True)),
            ("mma", lambda d, x: tflat.flat_net_loss_plain(
                d, x, mma_bf16=True))):
        tm = from_jax_variables(variables)
        loss, means, _ = torch_flat(tm, cur, mask, target, "bf16", fn)
        outs[key] = (loss.detach(), means, tm.conv_1.weight.grad)
    for key in ("plain", "plain_bwd"):
        for got, want in zip(outs[key], outs["kernels"]):
            assert torch.equal(got, want), key
    assert not torch.equal(outs["mma"][0], outs["kernels"][0])
    np.testing.assert_allclose(float(outs["mma"][0]),
                               float(outs["kernels"][0]), rtol=1e-2)


def test_eligible():
    def model(**kw):
        return DnCNN(**{"channels": 1, "num_layers": 5, **kw})

    assert tflat.eligible(model(), (16, 32, 1), False)
    assert tflat.eligible(model(residual=True), (13, 21, 1), True)
    assert not tflat.eligible(model(residual=True), (16, 32, 1), False)
    assert not tflat.eligible(model(), (16, 32, 1), True)
    assert not tflat.eligible(model(channels=3), (16, 32, 3), False)
    assert not tflat.eligible(model(features=32), (16, 32, 1), False)
    assert not tflat.eligible(model(num_layers=2), (16, 32, 1), False)


@pytest.mark.parametrize("h,w,residual", [(16, 32, False), (13, 20, True)])
def test_process_frame_flat_matches_jax_engine(monkeypatch, h, w, residual):
    """Two frames, three Adam updates each, both engines on their flat
    routes: losses, denoised frames, parameters, running statistics and the
    optimizer state."""
    monkeypatch.setenv("F2F_FUSED", "force")
    monkeypatch.setenv("F2F_FLATSTEP", "1")
    for var in ("F2F_EVAL", "F2F_EVAL_DTYPE", "F2F_BATCH", "F2F_CONV",
                "F2F_DOT_BF16", "F2F_STORE_O"):
        monkeypatch.delenv(var, raising=False)
    model, variables = perturbed_model(h, w, seed=78, residual=residual,
                                       conv_impl="fused")
    variables["params"]["conv_out"]["kernel"] = (
        0.25 * variables["params"]["conv_out"]["kernel"])
    assert jflat.eligible(model, (h, w, 1), None, residual)
    noisy, flows = sequence(3, h, w, seed=79)
    jeng = jonline.OnlineDenoiser(
        model, jax.tree_util.tree_map(jnp.asarray, variables), iters=3,
        residual_model=residual)
    teng = tonline.OnlineDenoiser(
        from_jax_variables(variables, residual=residual), variables, iters=3,
        residual_model=residual, device="cpu", flat_step=True)
    tfs.reset_launch_counts()
    for k in (1, 2):
        want_d, want_l = jeng.process_frame(
            jnp.asarray(noisy[k]), jnp.asarray(noisy[k - 1]),
            jnp.asarray(flows[k]))
        got_d, got_l = teng.process_frame(noisy[k], noisy[k - 1], flows[k])
        assert got_d.shape == (h, w, 1) and got_l.shape == (3,)
        assert not got_d.requires_grad and not got_l.requires_grad
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                                   rtol=1e-2, err_msg=f"losses {k}")
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                   atol=5e-3, err_msg=f"denoised {k}")
    got = teng.variables
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got["params"]))
    for path, r in jax.tree_util.tree_leaves_with_path(jeng.params):
        np.testing.assert_allclose(flat_got[path], np.asarray(r), atol=1e-3,
                                   err_msg=str(path))
    stats_got = dict(jax.tree_util.tree_leaves_with_path(got["batch_stats"]))
    for path, r in jax.tree_util.tree_leaves_with_path(jeng.batch_stats):
        np.testing.assert_allclose(stats_got[path], np.asarray(r), rtol=1e-2,
                                   atol=1e-3, err_msg=str(path))
    assert teng.opt_state["count"] == int(jeng.opt_state["count"]) == 6
    for key in ("m", "v"):
        want = np.asarray(jeng.opt_state[key])
        scale = np.abs(want).max()
        np.testing.assert_allclose(teng.opt_state[key].numpy() / scale,
                                   want / scale, atol=2e-2, err_msg=key)
    moved = np.abs(got["params"]["conv_in"]["kernel"]
                   - variables["params"]["conv_in"]["kernel"]).max()
    assert 1e-5 < moved < 1e-3
    assert not any(tfs.launch_counts().values())
    assert not any(p.grad is not None for p in teng.model.parameters())


def test_engine_takes_the_flat_route_where_eligible(monkeypatch):
    """``flat_step=None`` runs ``run_flat_scan`` for an eligible model and the
    per-iteration body otherwise; ``False`` never runs it; the two routes
    give the same fine-tune up to their rounding."""
    _, variables = perturbed_model(H, W, seed=80)
    noisy, flows = sequence(2, 13, 21, seed=81)
    calls = []
    real = tonline.run_flat_scan
    monkeypatch.setattr(tonline, "run_flat_scan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for flat in (None, False, True):
        eng = tonline.OnlineDenoiser(from_jax_variables(variables), variables,
                                     iters=3, device="cpu", flat_step=flat)
        out[flat] = eng.process_frame(noisy[1], noisy[0], flows[1])
        assert len(calls) == (0 if flat is False else 1), flat
        calls.clear()
        assert eng.opt_state["count"] == 3
    np.testing.assert_allclose(out[False][1].numpy(), out[None][1].numpy(),
                               rtol=1e-2)
    np.testing.assert_allclose(out[False][0].numpy(), out[None][0].numpy(),
                               atol=5e-3)
    assert torch.equal(out[True][0], out[None][0])
    # residual_model against a non-residual model: not the standard
    # convention, so the default falls back to the per-iteration body
    eng = tonline.OnlineDenoiser(from_jax_variables(variables), variables,
                                 iters=1, residual_model=True, device="cpu")
    eng.process_frame(noisy[1], noisy[0], flows[1])
    assert not calls
