"""The port's DnCNN under every ``conv_impl`` against the JAX model with the
same ``conv_impl`` (its Pallas kernels in interpret mode on the CPU, the
port's kernels as their plain versions): eval forward, training forward with
the new running statistics, and every parameter's gradient; activation
checkpointing (``remat_every``); ``OnlineDenoiser.process_frame`` on the
``"pallas"`` and ``"hybrid"`` routes; and the ``conv_impl`` gate that keeps
every other model off the flat step and the fused kernels.

Bounds: outputs 1e-5 where the graph is f32 (f32 sums in another order),
rtol 0.03 / atol 0.02 on the bf16 graph ("packed_bf16", and "fused" on the
module route, at an even width); gradients per leaf as max |d| / max |ref|,
1e-4 in f32, 2e-3 for "bf16res", whose dW rounds the cotangent to bf16: a
cotangent entry that the two packages compute one f32 step apart rounds to
bf16 values one bf16 step apart (4e-3 of it). On the bf16 graph the gradients of both packages lie 10-27 %
(per leaf, of its largest entry) from the f32 graph's at these sizes: the
cotangents are bf16 and their sums over a few hundred pixels carry the
roundings. XLA's CPU autodiff and PyTorch's take those sums in different
orders and precisions, so the two bf16 gradients differ by up to 12 % at
the first layers (0.04 % at the last); the test holds each leaf within 0.15
of the JAX package's, and the port's worst deviation from the f32 gradient
within 1.25 times the JAX package's own.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.models.dncnn import DnCNN as JaxDnCNN  # noqa: E402
from frame2frame_tpu.train import online as jonline  # noqa: E402
from frame2frame_tpu_torch.models import fused_apply as tfa  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import (  # noqa: E402
    CONV_IMPLS,
    DnCNN,
    JaxRavel,
    from_jax_variables,
    init_dncnn,
    opt_state_to_jax,
    param_leaves,
)
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402
from frame2frame_tpu_torch.train import flat_step as tflat  # noqa: E402
from frame2frame_tpu_torch.train import online as tonline  # noqa: E402

from test_torch_fused_apply import frames, perturbed_model  # noqa: E402
from test_torch_fused_apply_train import (  # noqa: E402
    assert_grads_close,
    grads_tree,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.03, atol=0.02)
CASES = [(16, 32, False, 60), (13, 21, True, 61)]


def bf16_graph(impl, W):
    return impl in ("packed_bf16", "fused") and W % 2 == 0


@pytest.fixture(scope="module")
def models():
    """Weights shared by every case of one geometry: JAX variables with
    perturbed BatchNorm parameters and running statistics."""
    return {(H, W): perturbed_model(H, W, seed=seed)[1]
            for H, W, _, seed in CASES}


def jax_train(model, variables, x, gref):
    def loss_fn(p):
        y, upd = model.apply({"params": p,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        return jnp.sum(y * gref), (y, upd["batch_stats"])

    (_, (y, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    return np.asarray(y), stats, grads


def torch_train(tm, x, gref):
    tm.train()
    y = tm(torch.from_numpy(x))
    (y * torch.from_numpy(gref)).sum().backward()
    tm.eval()
    return y.detach().numpy()


def assert_stats_close(tm, stats, tol):
    for i in range(tm.nmid):
        _, bn = tm.mid(i)
        for buf, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            np.testing.assert_allclose(buf.numpy(),
                                       np.asarray(stats[f"bn_{i}"][key]),
                                       err_msg=f"bn_{i} {key}", **tol)


@pytest.mark.parametrize("H,W,residual,seed", CASES)
@pytest.mark.parametrize("impl", CONV_IMPLS)
def test_dncnn_matches_jax_model(models, impl, H, W, residual, seed):
    variables = models[(H, W)]
    model = JaxDnCNN(channels=1, num_layers=5, residual=residual,
                     conv_impl=impl)
    x = frames(2, H, W, seed=seed + 100)
    gref = np.random.default_rng(seed).standard_normal(x.shape).astype(
        np.float32)
    bf16 = bf16_graph(impl, W)
    out_tol = BF16_TOL if bf16 else F32_TOL
    tm = from_jax_variables(variables, residual=residual, conv_impl=impl)
    assert tm.conv_impl == impl
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(model.apply(variables, jnp.asarray(x), train=False)),
        **out_tol)

    y_j, stats_j, grads_j = jax_train(model, variables, x, gref)
    y = torch_train(tm, x, gref)
    np.testing.assert_allclose(y, y_j, **out_tol)
    assert_stats_close(tm, stats_j, dict(rtol=1e-2, atol=1e-3) if bf16
                       else dict(rtol=1e-4, atol=1e-5))
    if not bf16:
        assert_grads_close(grads_tree(tm), grads_j,
                           2e-3 if impl == "bf16res" else 1e-4)
        return
    _, _, grads_f32 = jax_train(
        JaxDnCNN(channels=1, num_layers=5, residual=residual,
                 conv_impl="xla"), variables, x, gref)
    assert_bf16_grads_close(grads_tree(tm), grads_j, grads_f32)


def assert_bf16_grads_close(got_tree, want_tree, f32_tree):
    assert_grads_close(got_tree, want_tree, 0.15)
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    ref = dict(jax.tree_util.tree_leaves_with_path(f32_tree))
    ours = theirs = 0.0
    for path, w in jax.tree_util.tree_leaves_with_path(want_tree):
        r = np.asarray(ref[path])
        scale = np.abs(r).max()
        ours = max(ours, np.abs(got[path] - r).max() / scale)
        theirs = max(theirs, np.abs(np.asarray(w) - r).max() / scale)
    assert ours <= 1.25 * theirs, (ours, theirs)


@pytest.mark.parametrize("impl", ["hybrid", "packed_bf16"])
def test_remat_matches_no_remat_and_jax_remat(models, impl):
    """``remat_every=2`` runs each group of two mid layers' forward again in
    the backward: the running statistics are updated once, and statistics
    and gradients equal those without it; both match the JAX model with
    ``remat_every=2``."""
    H, W = 16, 32
    variables = models[(H, W)]
    x = frames(1, H, W, seed=70)
    gref = np.random.default_rng(71).standard_normal(x.shape).astype(
        np.float32)
    plain = from_jax_variables(variables, conv_impl=impl)
    remat = from_jax_variables(variables, conv_impl=impl, remat_every=2)
    y0 = torch_train(plain, x, gref)
    y2 = torch_train(remat, x, gref)
    np.testing.assert_array_equal(y0, y2)
    for (n, a), (_, b) in zip(plain.named_buffers(), remat.named_buffers()):
        assert torch.equal(a, b), n
    for (n, a), (_, b) in zip(plain.named_parameters(),
                              remat.named_parameters()):
        assert torch.equal(a.grad, b.grad), n
    model = JaxDnCNN(channels=1, num_layers=5, conv_impl=impl,
                     remat_every=2)
    y_j, stats_j, grads_j = jax_train(model, variables, x, gref)
    bf16 = bf16_graph(impl, W)
    np.testing.assert_allclose(y2, y_j, **(BF16_TOL if bf16 else F32_TOL))
    assert_stats_close(remat, stats_j, dict(rtol=1e-2, atol=1e-3) if bf16
                       else dict(rtol=1e-4, atol=1e-5))
    if bf16:
        _, _, grads_f32 = jax_train(JaxDnCNN(channels=1, num_layers=5,
                                             conv_impl="xla"), variables, x,
                                    gref)
        assert_bf16_grads_close(grads_tree(remat), grads_j, grads_f32)
    else:
        assert_grads_close(grads_tree(remat), grads_j, 1e-4)


def moving_pair(H, W, seed):
    rng = np.random.default_rng(seed)
    prev = rng.random((H, W, 1)).astype(np.float32)
    cur = np.roll(prev, 1, axis=1) + 0.05 * rng.standard_normal(
        (H, W, 1)).astype(np.float32)
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = -1.0 + 0.1 * rng.standard_normal((H, W)).astype(np.float32)
    return cur, prev, flow


@pytest.mark.parametrize("impl", ["pallas", "hybrid"])
def test_process_frame_matches_jax_engine(impl):
    """Two updates and the eval denoise of one frame on the model's own
    forward: losses, the denoised frame, the parameters, running statistics
    and Adam state against the JAX engine with the same model, at 1e-4
    (parameters at 1e-4 absolute: Adam moves a parameter by up to lr = 5e-5
    an update, whatever the size of its gradient, so a gradient near 0 whose
    sign the two packages see differently moves it by up to 1e-4). The Adam
    moments are held per parameter, max |d| / max |ref|, at 1e-2 (they agree
    to 1e-5 after one update; from parameters equal to 4e-9, the second
    gradient of "pallas" differs by 6e-3 at ``conv_1`` because
    one pre-activation lies within f32 rounding of 0 and its ReLU decides
    the other way; the port's plain convolution, oneDNN's (which both
    packages' library convolutions use on the CPU) and float64 are each a
    different rounding, and the port's lies closest to float64 there.)"""
    H = W = 32
    _, variables = perturbed_model(H, W, seed=80, num_layers=4)
    cur, prev, flow = moving_pair(H, W, seed=81)
    jeng = jonline.OnlineDenoiser(
        JaxDnCNN(channels=1, num_layers=4, conv_impl=impl), variables,
        iters=2)
    deno_j, losses_j = jeng.process_frame(cur, prev, flow)
    tm = from_jax_variables(variables, conv_impl=impl)
    eng = tonline.OnlineDenoiser(tm, variables, iters=2, device="cpu")
    tfs.reset_launch_counts()
    deno, losses = eng.process_frame(cur, prev, flow)
    assert not any(tfs.launch_counts().values())
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j),
                               rtol=1e-4)
    np.testing.assert_allclose(deno.numpy(), np.asarray(deno_j), rtol=1e-4,
                               atol=1e-4)
    got = eng.variables
    for kind in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(
            {"params": jeng.params, "batch_stats": jeng.batch_stats}[kind])
        have = dict(jax.tree_util.tree_leaves_with_path(got[kind]))
        assert len(have) == len(want)
        for path, w in want:
            w = np.asarray(w)
            atol = 1e-4 if kind == "params" else 1e-4 * np.abs(w).max()
            np.testing.assert_allclose(have[path], w, rtol=1e-4, atol=atol,
                                       err_msg=f"{kind} {path}")
    state = opt_state_to_jax(eng.opt_state)
    assert int(state["count"]) == int(jeng.opt_state["count"]) == 2
    sizes = JaxRavel(eng.model).sizes
    names = [n for n, _ in param_leaves(eng.model)]
    for k in ("m", "v"):
        got, want = (np.split(np.asarray(a), np.cumsum(sizes)[:-1])
                     for a in (state[k], jeng.opt_state[k]))
        for name, a, b in zip(names, got, want):
            scale = np.abs(b).max()
            assert np.abs(a - b).max() <= 1e-2 * scale, (k, name)


def test_conv_impl_gate_keeps_other_models_off_the_kernels(monkeypatch):
    """A 64-feature grayscale DnCNN with ``conv_impl="xla"`` is what the
    flat step and the fused kernels cover but for its ``conv_impl``: it
    takes neither, as in the JAX package, and ``flat_step=True`` raises
    naming it."""
    model, variables = init_dncnn(3, num_layers=4, residual=True,
                                  conv_impl="xla")
    fused, _ = init_dncnn(3, num_layers=4, residual=True)
    assert fused.conv_impl == "fused" and tfa.can_fuse(fused)
    assert tflat.eligible(fused, (8, 8, 1), True)
    assert not tfa.can_fuse(model)
    assert not tflat.eligible(model, (8, 8, 1), True)

    def refuse(*a, **k):
        raise AssertionError("the kernels' route on a conv_impl='xla' model")

    for name in ("run_flat_scan", "fused_train_apply", "fused_eval_apply"):
        monkeypatch.setattr(tonline, name, refuse)
    cur, prev, flow = moving_pair(8, 8, seed=90)
    eng = tonline.OnlineDenoiser(model, variables, iters=2,
                                 residual_model=True, device="cpu")
    deno, losses = eng.process_frame(cur, prev, flow)
    assert deno.shape == cur.shape and losses.shape == (2,)
    with pytest.raises(ValueError, match="conv_impl='xla'"):
        tonline.make_online_step(copy.deepcopy(model), tonline.torch_adam(1e-3),
                                 flat_step=True)
    with pytest.raises(ValueError, match="conv_impl"):
        DnCNN(conv_impl="tpu")


def test_init_dncnn_is_seeded_lecun_normal():
    """Truncated normal at two standard deviations of variance 1 / fan_in,
    from the seed alone; BatchNorm at its identity."""
    a, va = init_dncnn(7, num_layers=5)
    b, vb = init_dncnn(7, num_layers=5)
    c, _ = init_dncnn(8, num_layers=5)
    assert torch.equal(a.conv_1.weight, b.conv_1.weight)
    assert not torch.equal(a.conv_1.weight, c.conv_1.weight)
    assert a.conv_impl == "fused"
    w = va["params"]["conv_0"]["kernel"]
    assert w.shape == (3, 3, 64, 64)
    std = np.sqrt(1.0 / (9 * 64))
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(w.std() / std - 1) < 0.05
    assert (va["params"]["bn_0"]["scale"] == 1).all()
    assert (va["batch_stats"]["bn_0"]["var"] == 1).all()
