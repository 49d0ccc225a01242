"""The port's online fine-tune (frame2frame_tpu_torch/train/online.py:
``torch_adam``, ``make_online_step``, ``OnlineDenoiser.process_frame``) vs the
JAX package.

- ``torch_adam`` against the JAX ``torch_adam`` over 5 updates on the same
  gradients, with the optimizer state crossing over in both directions
  (``opt_state_to_jax`` / ``opt_state_from_jax``) in mid-run, and against
  ``torch.optim.Adam(weight_decay=...)``: moments to rtol 1e-5, parameters
  to 1e-3 of one update (the bias correction amplifies an ulp of ``pow``).
- ``process_frame`` over 3 frames with ``iters=3`` against the JAX
  ``OnlineDenoiser`` on its fused route (``F2F_FUSED=force``,
  ``F2F_FLATSTEP=0``, Pallas kernels in interpret mode), both on the bf16
  production chain: losses rtol 1e-2, denoised frames atol 5e-3, parameters
  atol 1e-3 (the bounds of tests/test_flat_step.py:157-162), running
  statistics rtol 1e-2 / atol 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from frame2frame_tpu.train import online as jonline  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    JaxRavel,
    from_jax_variables,
    opt_state_from_jax,
    opt_state_to_jax,
    param_leaves,
    to_jax_variables,
)
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402
from frame2frame_tpu_torch.train import online as tonline  # noqa: E402

from test_torch_fused_apply import frames, perturbed_model  # noqa: E402

ADAM_TOL = dict(rtol=1e-5, atol=1e-8)


def random_tree_like(params, rng, scale):
    return jax.tree_util.tree_map(
        lambda v: (scale * rng.standard_normal(np.shape(v))).astype(np.float32),
        params)


def set_grads(model, grads):
    """Write a JAX-layout gradient tree into the parameters' ``.grad``."""
    for name, p in param_leaves(model):
        layer, leaf = name.split(".")
        g = torch.from_numpy(np.array(grads[layer][leaf]))
        p.grad = g.permute(3, 2, 0, 1).contiguous() if g.dim() == 4 else g


def test_ravel_order_is_ravel_pytree_order():
    """bn_0, bn_1, bn_10, ..., conv_0, ..., conv_in, conv_out; bias before
    scale; kernels HWIO: for 12 mid layers, so that bn_10 sorts before bn_2."""
    _, variables = perturbed_model(8, 8, seed=50, num_layers=14)
    params = variables["params"]
    model = from_jax_variables(variables)
    want, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_array_equal(JaxRavel(model).ravel().numpy(),
                                  np.asarray(want))
    names = [n for n, _ in param_leaves(model)]
    assert names[:6] == ["bn_0.bias", "bn_0.scale", "bn_1.bias", "bn_1.scale",
                         "bn_10.bias", "bn_10.scale"]
    assert names[-2:] == ["conv_in.kernel", "conv_out.kernel"]
    grads = random_tree_like(params, np.random.default_rng(51), 1.0)
    set_grads(model, grads)
    want_g, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, grads))
    np.testing.assert_array_equal(JaxRavel(model).ravel(grads=True).numpy(),
                                  np.asarray(want_g))
    # add is the inverse layout: adding the raveled gradient doubles
    # nothing but adds grads leaf by leaf
    flat = JaxRavel(model)
    before = flat.ravel().clone()
    flat.add(flat.ravel(grads=True))
    np.testing.assert_allclose(flat.ravel().numpy(),
                               (before + torch.from_numpy(np.array(want_g)))
                               .numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weight_decay", [1e-5, 0.0, 0.1])
def test_torch_adam_matches_jax_with_state_crossing_over(weight_decay):
    _, variables = perturbed_model(8, 8, seed=52)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    model = from_jax_variables(variables)
    lr = 1e-2
    jtx = jonline.torch_adam(lr, weight_decay)
    ttx = tonline.torch_adam(lr, weight_decay)
    jstate = jtx.init(params)
    flat = JaxRavel(model)
    tstate = ttx.init(flat.ravel())
    rng = np.random.default_rng(53)
    for step in range(5):
        grads = random_tree_like(variables["params"], rng, 10.0 ** (step - 2))
        updates, jstate = jtx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, params)
        params = optax.apply_updates(params, updates)
        set_grads(model, grads)
        upd, tstate = ttx.update(flat.ravel(grads=True), tstate, flat.ravel())
        flat.add(upd)
        assert tstate["count"] == int(jstate["count"]) == step + 1
        for k in ("m", "v"):
            np.testing.assert_allclose(tstate[k].numpy(),
                                       np.asarray(jstate[k]), err_msg=k,
                                       **ADAM_TOL)
        if step == 1:  # each side goes on from the other's state
            crossed = opt_state_to_jax(tstate)
            assert crossed["count"].dtype == np.int32
            assert crossed["m"].dtype == np.float32
            tstate = opt_state_from_jax(jstate)
            jstate = jax.tree_util.tree_map(jnp.asarray, crossed)
            assert isinstance(tstate["count"], int)
    # the update divides by 1 - 0.999^t, which cancels to 1e-3 of its
    # operands and so amplifies an ulp of either side's pow a thousandfold:
    # the parameters are held to 1e-3 of one update of lr, the moments above,
    # which hold no such term, to rounding
    want, _ = ravel_pytree(params)
    np.testing.assert_allclose(flat.ravel().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-3 * lr)
    back = to_jax_variables(model)["params"]
    np.testing.assert_allclose(back["conv_1"]["kernel"],
                               np.asarray(params["conv_1"]["kernel"]),
                               rtol=1e-5, atol=1e-3 * lr)


def test_opt_state_round_trip():
    rng = np.random.default_rng(54)
    state = {"count": np.asarray(7, np.int32),
             "m": rng.standard_normal(100).astype(np.float32),
             "v": rng.random(100).astype(np.float32)}
    back = opt_state_to_jax(opt_state_from_jax(state))
    assert back.keys() == state.keys()
    for k in state:
        assert back[k].dtype == state[k].dtype
        np.testing.assert_array_equal(back[k], state[k])


@pytest.mark.parametrize("weight_decay", [1e-5, 0.0])
def test_torch_adam_matches_torch_optim_adam(weight_decay):
    _, variables = perturbed_model(8, 8, seed=55)
    ours, theirs = from_jax_variables(variables), from_jax_variables(variables)
    lr = 1e-3
    tx = tonline.torch_adam(lr, weight_decay)
    flat = JaxRavel(ours)
    state = tx.init(flat.ravel())
    opt = torch.optim.Adam(theirs.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=weight_decay)
    rng = np.random.default_rng(56)
    for _ in range(5):
        grads = random_tree_like(variables["params"], rng, 1.0)
        set_grads(ours, grads)
        set_grads(theirs, grads)
        upd, state = tx.update(flat.ravel(grads=True), state, flat.ravel())
        flat.add(upd)
        opt.step()
    # torch.optim.Adam divides sqrt(v) by sqrt(1 - b2^t) where torch_adam
    # divides v first: 4e-8 apart on updates of 1e-3
    np.testing.assert_allclose(flat.ravel().numpy(),
                               JaxRavel(theirs).ravel().numpy(), rtol=1e-5,
                               atol=1e-7)
    start = JaxRavel(from_jax_variables(variables)).ravel()
    assert (flat.ravel() - start).abs().max() > 1e-3


def sequence(n, H, W, seed):
    rng = np.random.default_rng(seed)
    noisy = rng.random((n, H, W, 1)).astype(np.float32)
    flows = (0.5 * rng.standard_normal((n, H, W, 2))).astype(np.float32)
    return noisy, flows


@pytest.mark.parametrize("H,W,residual", [(16, 32, False), (13, 20, True)])
def test_process_frame_matches_jax_engine(monkeypatch, H, W, residual):
    """Three frames, three Adam updates each, state carried across frames:
    losses, denoised frames, parameters, running statistics and the
    optimizer state; the CPU leaves every launch counter at 0."""
    monkeypatch.setenv("F2F_FUSED", "force")
    monkeypatch.setenv("F2F_FLATSTEP", "0")
    for var in ("F2F_EVAL", "F2F_EVAL_DTYPE", "F2F_BATCH", "F2F_CONV"):
        monkeypatch.delenv(var, raising=False)
    model, variables = perturbed_model(H, W, seed=57, residual=residual,
                                       conv_impl="fused")
    # a readout of |noise| < 0.25: the bf16 end conv rounds the noise to
    # 2^-9 of its size, and one such step must stay well under the 5e-3 bound
    variables["params"]["conv_out"]["kernel"] = (
        0.25 * variables["params"]["conv_out"]["kernel"])
    noisy, flows = sequence(4, H, W, seed=58)
    jeng = jonline.OnlineDenoiser(
        model, jax.tree_util.tree_map(jnp.asarray, variables), iters=3,
        residual_model=residual)
    teng = tonline.OnlineDenoiser(
        from_jax_variables(variables, residual=residual), variables, iters=3,
        residual_model=residual, device="cpu")
    tfs.reset_launch_counts()
    for k in range(1, 4):
        want_d, want_l = jeng.process_frame(
            jnp.asarray(noisy[k]), jnp.asarray(noisy[k - 1]),
            jnp.asarray(flows[k]))
        got_d, got_l = teng.process_frame(noisy[k], noisy[k - 1], flows[k])
        assert got_d.shape == (H, W, 1) and got_l.shape == (3,)
        assert got_d.device.type == "cpu" and not got_d.requires_grad
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
    assert teng.opt_state["count"] == int(jeng.opt_state["count"]) == 9
    # the fine-tune moved the weights, and not the caller's
    moved = np.abs(got["params"]["conv_1"]["kernel"]
                   - variables["params"]["conv_1"]["kernel"]).max()
    assert 1e-5 < moved < 1e-3
    assert not any(tfs.launch_counts().values())
    assert not any(p.grad is not None for p in teng.model.parameters())
    assert not teng.model.training


def test_unfused_route_follows_the_fused_one(monkeypatch):
    """A model the kernels do not cover fine-tunes through the plain module
    in training mode: the same losses as the fused route up to its bf16
    chain (rtol 1e-2), and the module is left in eval mode."""
    H, W = 13, 20
    _, variables = perturbed_model(H, W, seed=59)
    noisy, flows = sequence(2, H, W, seed=60)
    fused = tonline.OnlineDenoiser(from_jax_variables(variables), variables,
                                   iters=3, device="cpu")
    monkeypatch.setattr(tonline, "can_fuse", lambda model: False)
    plain = tonline.OnlineDenoiser(from_jax_variables(variables), variables,
                                   iters=3, device="cpu")
    d0, l0 = fused.process_frame(noisy[1], noisy[0], flows[1])
    d1, l1 = plain.process_frame(noisy[1], noisy[0], flows[1])
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-2)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), atol=2e-2)
    assert not plain.model.training
    np.testing.assert_allclose(plain.model.bn_0.running_var.numpy(),
                               fused.model.bn_0.running_var.numpy(),
                               rtol=1e-2, atol=1e-3)


def test_engine_options_follow_the_jax_engine():
    _, variables = perturbed_model(8, 8, seed=61)
    eng = tonline.OnlineDenoiser(from_jax_variables(variables), variables,
                                 device="cpu")
    assert eng.iters == 20
    assert (eng.tx.lr, eng.tx.weight_decay) == (5e-5, 1e-5)
    assert (eng.tx.b1, eng.tx.b2, eng.tx.eps) == (0.9, 0.999, 1e-8)
    assert eng.opt_state["count"] == 0
    n = sum(p.numel() for p in eng.model.parameters())
    assert eng.opt_state["m"].shape == eng.opt_state["v"].shape == (n,)
