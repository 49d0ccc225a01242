"""The port's training kernels' plain versions and the differentiable mid
stack (frame2frame_tpu_torch/ops/fused_stack.py) vs the JAX package.

- ``fwd_layer_train`` and ``bwd_layer`` (CPU tensors: their plain versions)
  against the Pallas kernels ``fwd_layer(emit_stats=True)`` and ``bwd_layer``
  in interpret mode, fed through ``to_flat`` / ``pack_kernel_*`` and read back
  through ``from_flat`` / ``fold_vec`` / ``fold_dw6`` / ``fold_dw2``, in both
  JAX conv forms, f32 strict and bf16 chains.
- ``fused_mid_stack`` against the JAX ``fused_mid_stack(..., jnp.float32)``
  and against torch autograd of conv + train-mode BN + ReLU.

Tolerances. f32 chain: rtol = atol = 2e-4 for activations (as
tests/test_fused_stack.py), and for sums over the pixels max |d| <= 2e-5 of
the largest entry (its gradient bound). bf16 chain: both sides round the
stored tensors and the weights to bf16 at the same points, so they differ
by the order of f32 additions and at most one bf16 step of an output:
rtol 0.03 / atol 0.02 for activations, 2e-3 of the largest entry for sums.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.ops import fused_stack as jfs  # noqa: E402
from frame2frame_tpu.ops.packed import pack_image, unpack_image  # noqa: E402
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402

ACT_TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.03, atol=0.02)}
SUM_TOL = {"f32": 2e-5, "bf16": 2e-3}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
SHAPES = [(16, 32), (13, 20)]


def assert_sums_close(got, want, dt, name):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=SUM_TOL[dt], err_msg=name)


def geom(H, W):
    W2 = W // 2
    return jfs.Geom(H, W2, jfs.default_tile_h(W2))


def flat(x, g, dt):
    """NHWC (1, H, W, 64) numpy -> the JAX flat layout in ``dt``."""
    return jfs.to_flat(pack_image(jnp.asarray(x, JDT[dt])), g)


def unflat(f, g):
    return np.asarray(unpack_image(jfs.from_flat(f, g)).astype(jnp.float32))


def rounded(x, dt):
    """numpy f32 as the chain stores it."""
    return np.array(jnp.asarray(x, JDT[dt]).astype(jnp.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("odd", [True, False])
@pytest.mark.parametrize("H,W", SHAPES)
def test_fwd_layer_train_matches_pallas(H, W, odd, dt):
    """z and the batch sums (sum z, sum z^2), taken from the f32 accumulator
    over the H*W image pixels only."""
    rng = np.random.default_rng(H + W)
    x = rng.standard_normal((1, H, W, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 64)) * 0.06).astype(np.float32)
    s = (1.0 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    b = (0.3 * rng.standard_normal(64)).astype(np.float32)
    g = geom(H, W)
    w2 = (jfs.pack_kernel_odd if odd else jfs.pack_kernel_flat)(jnp.asarray(w))
    z_j, stats_j = jfs.fwd_layer(flat(x, g, dt), w2, jfs.tile_vec(jnp.asarray(s)),
                                 jfs.tile_vec(jnp.asarray(b)), g, odd=odd)
    tfs.reset_launch_counts()
    z, stats = tfs.fwd_layer_train(torch.from_numpy(x).to(TDT[dt]),
                                   torch.from_numpy(w), torch.from_numpy(s),
                                   torch.from_numpy(b))
    assert z.dtype == TDT[dt] and z.shape == x.shape
    assert stats.dtype == torch.float32 and stats.shape == (2, 64)
    np.testing.assert_allclose(z.float().numpy(), unflat(z_j, g), **ACT_TOL[dt])
    for k, name in enumerate(("sum z", "sum z^2")):
        assert_sums_close(stats[k].numpy(), jfs.fold_vec(stats_j[k]), dt, name)
    assert not any(tfs.launch_counts().values())


def bwd_inputs(H, W, seed, dt):
    rng = np.random.default_rng(seed)
    shape = (1, H, W, 64)
    g = rounded(0.1 * rng.standard_normal(shape), dt)
    z_i = rounded(rng.standard_normal(shape), dt)
    z_prev = rounded(rng.standard_normal(shape), dt)
    w = (rng.standard_normal((3, 3, 64, 64)) * 0.06).astype(np.float32)

    def vec(mean, std):
        return (mean + std * rng.standard_normal(64)).astype(np.float32)

    vecs = np.stack([vec(1.0, 0.2), vec(0.0, 0.3), vec(0.0, 1e-2),
                     vec(0.0, 1e-2), vec(1.0, 0.2), vec(0.0, 0.3),
                     (0.5 + rng.random(64)).astype(np.float32), vec(0.0, 0.1)])
    return g, z_i, z_prev, w, vecs


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("odd", [True, False])
@pytest.mark.parametrize("first_layer", [False, True])
@pytest.mark.parametrize("H,W", SHAPES)
def test_bwd_layer_matches_pallas(H, W, first_layer, odd, dt):
    """da_prev, dW and the previous layer's BN-backward sums, rebuilt
    operand path of the JAX kernel (o_flat=None)."""
    g, z_i, z_prev, w, vecs = bwd_inputs(H, W, seed=3 * H + W, dt=dt)
    if first_layer:  # the stack input is post-ReLU, its affine the identity
        z_prev = np.abs(z_prev)
        vecs[4:] = np.stack([np.ones(64), np.zeros(64), np.ones(64),
                             np.zeros(64)])
    gm = geom(H, W)
    wj = jnp.asarray(w)
    w2t = (jfs.pack_kernel_odd_bwd(wj) if odd
           else jfs._io_t(jfs.pack_kernel_flat(wj)))
    vecs_j = jnp.stack([jfs.tile_vec(jnp.asarray(v)) for v in vecs])
    da_j, dw_j, stats_j = jfs.bwd_layer(
        flat(g, gm, dt), flat(z_i, gm, dt), flat(z_prev, gm, dt), w2t, vecs_j,
        gm, first_layer=first_layer, odd=odd)
    dw_j = jfs.fold_dw6(dw_j) if odd else jfs.fold_dw2(dw_j)

    tfs.reset_launch_counts()
    da, dw, stats = tfs.bwd_layer(
        *(torch.from_numpy(v).to(TDT[dt]) for v in (g, z_i, z_prev)),
        torch.from_numpy(w), torch.from_numpy(vecs), first_layer)
    assert da.dtype == TDT[dt] and da.shape == g.shape
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, 64, 64)
    assert stats.dtype == torch.float32 and stats.shape == (2, 64)
    np.testing.assert_allclose(da.float().numpy(), unflat(da_j, gm),
                               **ACT_TOL[dt])
    assert_sums_close(dw.numpy(), dw_j, dt, "dW")
    if first_layer:
        assert not stats.any()
    else:
        for k, name in enumerate(("sum gp", "sum gp zhat")):
            assert_sums_close(stats[k].numpy(), jfs.fold_vec(stats_j[k]), dt,
                              name)
    assert not any(tfs.launch_counts().values())


def stack_inputs(L, H, W, seed):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((L, 3, 3, 64, 64)) * 0.08).astype(np.float32)
    gammas = (1.0 + 0.2 * rng.standard_normal((L, 64))).astype(np.float32)
    betas = (0.1 * rng.standard_normal((L, 64))).astype(np.float32)
    a1 = np.abs(rng.standard_normal((1, H, W, 64))).astype(np.float32)
    gref = rng.standard_normal((1, H, W, 64)).astype(np.float32)
    return ws, gammas, betas, a1, gref


def torch_stack_grads(fn, inputs, gref):
    t = [torch.from_numpy(v).requires_grad_() for v in inputs]
    out = fn(*t)
    grads = torch.autograd.grad((out[0] * torch.from_numpy(gref)).sum(), t)
    return [o.detach().numpy() for o in out], [g.numpy() for g in grads]


@pytest.mark.parametrize("H,W,L", [(16, 32, 3), (13, 20, 2)])
def test_fused_mid_stack_matches_jax(H, W, L):
    """Output, batch means and variances, and all four gradients, f32."""
    *inputs, gref = stack_inputs(L, H, W, seed=L + H)
    th = jfs.default_tile_h(W // 2)

    def loss(ws, gammas, betas, a1):
        out, m, v = jfs.fused_mid_stack(ws, gammas, betas, pack_image(a1), H,
                                        th, jnp.float32)
        return jnp.sum(unpack_image(out) * gref), (unpack_image(out), m, v)

    grads_j, outs_j = jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(v) for v in inputs))
    tfs.reset_launch_counts()
    outs, grads = torch_stack_grads(
        lambda *t: tfs.fused_mid_stack(*t, torch.float32), inputs, gref)
    np.testing.assert_allclose(outs[0], np.asarray(outs_j[0]), rtol=1e-4,
                               atol=1e-4)
    for got, want, name in zip(outs[1:], outs_j[1:], ("means", "vars")):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    for got, want, name in zip(grads, grads_j, ("dW", "dgamma", "dbeta", "da1")):
        assert_sums_close(got, want, "f32", name)
    assert not any(tfs.launch_counts().values())


def autograd_stack(ws, gammas, betas, a1):
    """conv + train-mode BatchNorm + ReLU by torch autograd."""
    cur = a1.permute(0, 3, 1, 2)
    means, vars_ = [], []
    for i in range(ws.shape[0]):
        z = torch.nn.functional.conv2d(cur, ws[i].permute(3, 2, 0, 1),
                                       padding=1)
        v, m = torch.var_mean(z.detach(), dim=(0, 2, 3), unbiased=False)
        cur = torch.relu(torch.nn.functional.batch_norm(
            z, None, None, gammas[i], betas[i], training=True, eps=1e-5))
        means.append(m)
        vars_.append(v)
    return cur.permute(0, 2, 3, 1), torch.stack(means), torch.stack(vars_)


@pytest.mark.parametrize("B,H,W,L", [(1, 16, 32, 3), (2, 13, 20, 2),
                                     (1, 5, 7, 4)])
def test_fused_mid_stack_matches_torch_autograd(B, H, W, L):
    """Also a batch of two (statistics over B*H*W) and an odd frame size,
    which the NHWC port takes and the packed JAX layout does not."""
    ws, gammas, betas, a1, gref = stack_inputs(L, H, W, seed=7 * L + W)
    if B > 1:
        rng = np.random.default_rng(B)
        a1 = np.abs(rng.standard_normal((B, H, W, 64))).astype(np.float32)
        gref = rng.standard_normal((B, H, W, 64)).astype(np.float32)
    inputs = (ws, gammas, betas, a1)
    outs_r, grads_r = torch_stack_grads(autograd_stack, inputs, gref)
    outs, grads = torch_stack_grads(
        lambda *t: tfs.fused_mid_stack(*t, torch.float32), inputs, gref)
    np.testing.assert_allclose(outs[0], outs_r[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[1], outs_r[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs[2], outs_r[2], rtol=1e-4, atol=1e-5)
    for got, want, name in zip(grads, grads_r, ("dW", "dgamma", "dbeta", "da1")):
        assert_sums_close(got, want, "f32", name)


def test_fused_mid_stack_bf16_stores_bf16_and_keeps_f32_sums():
    """The bf16 chain: f32 output, statistics and gradients; close to the
    f32 chain's output; the statistics carry no gradient."""
    ws, gammas, betas, a1, gref = stack_inputs(2, 13, 20, seed=11)
    t = [torch.from_numpy(v).requires_grad_() for v in (ws, gammas, betas, a1)]
    out, means, vars_ = tfs.fused_mid_stack(*t)
    ref, means_r, _ = tfs.fused_mid_stack(*t, torch.float32)
    assert out.dtype == means.dtype == vars_.dtype == torch.float32
    assert not means.requires_grad and not vars_.requires_grad
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=0.05, atol=0.05)
    np.testing.assert_allclose(means.numpy(), means_r.numpy(), atol=2e-2)
    grads = torch.autograd.grad((out * torch.from_numpy(gref)).sum(), t)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


def test_plain_stack_is_the_function_over_plain_layers():
    """``fused_mid_stack_plain`` equals ``fused_mid_stack`` on the CPU, where
    the wrappers compute their plain versions; its ``mma_bf16`` operand
    rounding moves the output by a few bf16 steps at most."""
    ws, gammas, betas, a1, _ = stack_inputs(2, 13, 20, seed=12)
    t = [torch.from_numpy(v) for v in (ws, gammas, betas, a1)]
    for dt in (torch.float32, torch.bfloat16):
        got = tfs.fused_mid_stack_plain(*t, dt)
        want = tfs.fused_mid_stack(*t, dt)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        rounded_ops = tfs.fused_mid_stack_plain(*t, dt, mma_bf16=True)
        assert not torch.equal(rounded_ops[0], want[0])
        np.testing.assert_allclose(rounded_ops[0].numpy(), want[0].numpy(),
                                   rtol=0.05, atol=0.05)


@pytest.mark.parametrize("bad", ["shape", "dtype", "vecs", "vecs_dtype"])
def test_bwd_layer_rejects_bad_inputs(bad):
    g = torch.zeros(1, 4, 6, 64)
    z_i, z_prev = torch.zeros_like(g), torch.zeros_like(g)
    w, vecs = torch.zeros(3, 3, 64, 64), torch.zeros(8, 64)
    if bad == "shape":
        z_i = torch.zeros(1, 4, 5, 64)
    elif bad == "dtype":
        z_prev = z_prev.bfloat16()
    elif bad == "vecs":
        vecs = torch.zeros(2, 64)
    else:
        vecs = vecs.double()
    with pytest.raises((ValueError, TypeError)):
        tfs.bwd_layer(g, z_i, z_prev, w, vecs)


def test_kernels_table_and_counters():
    names = [k.__name__ for k in tfs.KERNELS]
    assert names == ["fwd_layer", "fwd_layer_train", "fwd_layer_eval",
                     "bwd_layer", "first_conv", "last_loss_fwd",
                     "last_loss_bwd", "first_dw", "tvl1_inner_loop",
                     "conv3x3_fwd", "dw_conv3x3"]
    tfs.bwd_layer.launches = 3
    assert tfs.launch_counts()["bwd_layer"] == 3
    tfs.reset_launch_counts()
    assert tfs.launch_counts() == dict.fromkeys(names, 0)
