"""The plain versions of the port's end kernels
(frame2frame_tpu_torch/ops/fused_ends.py: ``first_conv``, ``last_loss_fwd``,
``last_loss_bwd``, ``first_dw`` on CPU tensors) vs the JAX package's Pallas
kernels (frame2frame_tpu/ops/fused_ends.py) in interpret mode.

The JAX kernels are called as ``train/flat_step.py`` calls them: the frame
constants from ``prep_frame`` (lane embedding, odd slab, flat layout), the
weights through ``embed_w_in`` / ``embed_w_out`` and ``pack_kernel_odd`` /
``pack_kernel_odd_bwd`` with the negated taps, and the results brought back
to image space with ``from_flat`` / ``unpack_image`` / ``fold_dw6`` /
``fold_vec`` and the caller's sign fix of ``dW_out``.

Tolerances. f32 chain: both sides multiply and add in f32 and differ by the
order of the additions: rtol = atol = 2e-4 for per-pixel outputs (as
tests/test_fused_stack.py), 2e-5 of the largest entry for sums over the
pixels, rtol 1e-5 for the loss. bf16 chain: both sides round the stored
tensors and the forward weights to bf16 at the same points, so a per-pixel
output differs by at most one bf16 step (rtol 0.03 / atol 0.02) and a sum by
2e-3 of its largest entry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.ops import fused_ends as jfe  # noqa: E402
from frame2frame_tpu.ops import fused_stack as jfs  # noqa: E402
from frame2frame_tpu.ops.packed import pack_image, unpack_image  # noqa: E402
from frame2frame_tpu.train import flat_step as jflat  # noqa: E402
from frame2frame_tpu_torch.ops import fused_ends as tfe  # noqa: E402
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402

ACT_TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.03, atol=0.02)}
SUM_TOL = {"f32": 2e-5, "bf16": 2e-3}
LOSS_RTOL = {"f32": 1e-5, "bf16": 2e-3}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
SHAPES = [(16, 32), (13, 20)]
CASES = [(H, W, dt) for H, W in SHAPES for dt in ("f32", "bf16")]


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
    """The JAX flat layout -> NHWC (1, H, W, 64) numpy f32."""
    return np.asarray(unpack_image(jfs.from_flat(f, g)).astype(jnp.float32))


def rounded(x, dt):
    """numpy f32 as the chain stores it."""
    return np.array(jnp.asarray(x, JDT[dt]).astype(jnp.float32))


def frame(H, W, seed):
    """cur, mask, target (H, W, 1) as the online step builds them."""
    rng = np.random.default_rng(seed)
    cur = rng.random((H, W, 1)).astype(np.float32)
    mask = (rng.random((H, W, 1)) > 0.2).astype(np.float32)
    target = mask * rng.random((H, W, 1)).astype(np.float32)
    return cur, mask, target


def both_prep(H, W, seed, dt):
    cur, mask, target = frame(H, W, seed)
    g = geom(H, W)
    data_j = jflat.prep_frame(jnp.asarray(cur), jnp.asarray(mask),
                              jnp.asarray(target), g, store_dtype=JDT[dt])
    from frame2frame_tpu_torch.train.flat_step import prep_frame

    data_t = prep_frame(torch.from_numpy(cur), torch.from_numpy(mask),
                        torch.from_numpy(target), store_dtype=TDT[dt])
    return g, data_j, data_t


def t64(x, dt):
    return torch.from_numpy(x).to(TDT[dt])


@pytest.mark.parametrize("H,W,dt", CASES)
def test_prep_frame_matches_jax(H, W, dt):
    """x, aux_c and aux_m against the JAX constants at lanes {0, 64}."""
    g, data_j, data_t = both_prep(H, W, seed=H, dt=dt)
    assert data_t["x"].dtype == TDT[dt] and data_t["x"].shape == (H, W)
    for key in ("aux_c", "aux_m"):
        assert data_t[key].dtype == torch.float32
        got = data_t[key].numpy()
        np.testing.assert_array_equal(got, unflat(data_j[key], g)[0, :, :, 0])
    # the JAX side holds x only as its odd slab: compare through first_conv
    # with a kernel that passes the centre tap to channel 0
    w = np.zeros((3, 3, 1, 64), np.float32)
    w[1, 1, 0, 0] = 1.0
    z = jfe.first_conv(data_j["ox"], jfs.pack_kernel_odd(
        jfe.embed_w_in(jnp.asarray(w))), g)
    np.testing.assert_array_equal(data_t["x"].float().numpy(),
                                  unflat(z, g)[0, :, :, 0])


@pytest.mark.parametrize("H,W,dt", CASES)
def test_first_conv_matches_pallas(H, W, dt):
    g, data_j, data_t = both_prep(H, W, seed=H + 1, dt=dt)
    rng = np.random.default_rng(W)
    w = (0.3 * rng.standard_normal((3, 3, 1, 64))).astype(np.float32)
    z_j = jfe.first_conv(data_j["ox"], jfs.pack_kernel_odd(
        jfe.embed_w_in(jnp.asarray(w))), g)
    tfs.reset_launch_counts()
    z = tfe.first_conv(data_t["x"], torch.from_numpy(w))
    assert z.dtype == TDT[dt] and z.shape == (1, H, W, 64)
    np.testing.assert_allclose(z.float().numpy(), unflat(z_j, g),
                               **ACT_TOL[dt])
    assert not any(tfs.launch_counts().values())


def last_inputs(H, W, seed, dt):
    rng = np.random.default_rng(seed)
    z = rounded(rng.standard_normal((1, H, W, 64)), dt)
    w = (0.06 * rng.standard_normal((3, 3, 64, 1))).astype(np.float32)
    s = (1.0 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    b = (0.3 * rng.standard_normal(64)).astype(np.float32)
    rstd = (0.5 + rng.random(64)).astype(np.float32)
    nmr = (0.1 * rng.standard_normal(64)).astype(np.float32)
    return z, w, s, b, rstd, nmr


def jax_last_fwd(z, w, s, b, data_j, g, dt):
    w6 = jfs.pack_kernel_odd(jfe.embed_w_out(jnp.asarray(w)))
    return jfe.last_loss_fwd(
        flat(z, g, dt), data_j["aux_c"], data_j["aux_m"], w6,
        jfs.tile_vec(jnp.asarray(s)), jfs.tile_vec(jnp.asarray(b)), g)


@pytest.mark.parametrize("H,W,dt", CASES)
def test_last_loss_fwd_matches_pallas(H, W, dt):
    """noise in f32 on either chain, and the loss; the zero border applies
    to the activation after its affine and ReLU (b has both signs)."""
    g, data_j, data_t = both_prep(H, W, seed=H + 2, dt=dt)
    z, w, s, b, _, _ = last_inputs(H, W, seed=3 * W, dt=dt)
    noise_j, _, lossp = jax_last_fwd(z, w, s, b, data_j, g, dt)
    tfs.reset_launch_counts()
    noise, loss = tfe.last_loss_fwd(
        t64(z, dt), torch.from_numpy(s), torch.from_numpy(b),
        torch.from_numpy(w), data_t["aux_c"], data_t["aux_m"])
    assert noise.dtype == torch.float32 and noise.shape == (H, W)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(noise.numpy(), unflat(noise_j, g)[0, :, :, 0],
                               **ACT_TOL[dt])
    np.testing.assert_allclose(float(loss), float(jnp.sum(lossp)),
                               rtol=LOSS_RTOL[dt])
    assert not any(tfs.launch_counts().values())


@pytest.mark.parametrize("H,W,dt", CASES)
def test_last_loss_bwd_matches_pallas(H, W, dt):
    """g_L, dW_out and the last BatchNorm's backward sums, with their final
    signs, from the JAX forward's own noise, so both decide the same L1
    signs."""
    g, data_j, data_t = both_prep(H, W, seed=H + 3, dt=dt)
    z, w, s, b, rstd, nmr = last_inputs(H, W, seed=5 * W, dt=dt)
    noise_j, o_j, _ = jax_last_fwd(z, w, s, b, data_j, g, dt)
    vecs = np.stack([s, b, rstd, nmr])
    v6 = jfs.pack_kernel_odd_bwd(-jfe.embed_w_out(jnp.asarray(w)))
    g_j, dw6, stats_j = jfe.last_loss_bwd(
        noise_j, data_j["aux_c"], data_j["aux_m"], flat(z, g, dt), o_j, v6,
        jnp.stack([jfs.tile_vec(jnp.asarray(v)) for v in vecs]), g)
    dw_j = -jfs.fold_dw6(dw6)[:, :, :, :1]

    noise = torch.from_numpy(
        np.ascontiguousarray(unflat(noise_j, g)[0, :, :, 0]))
    tfs.reset_launch_counts()
    g_t, dw, stats = tfe.last_loss_bwd(
        noise, data_t["aux_c"], data_t["aux_m"], t64(z, dt),
        torch.from_numpy(w), torch.from_numpy(vecs))
    assert g_t.dtype == TDT[dt] and g_t.shape == (1, H, W, 64)
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, 64, 1)
    assert stats.dtype == torch.float32 and stats.shape == (2, 64)
    np.testing.assert_allclose(g_t.float().numpy(), unflat(g_j, g),
                               **ACT_TOL[dt])
    assert np.abs(dw.numpy()).max() > 1.0  # a sum over pixels, not noise
    assert_sums_close(dw.numpy(), dw_j, dt, "dW_out")
    for k, name in enumerate(("sum gp", "sum gp zhat")):
        assert_sums_close(stats[k].numpy(), jfs.fold_vec(stats_j[k]), dt, name)
    assert not any(tfs.launch_counts().values())


@pytest.mark.parametrize("H,W,dt", CASES)
def test_first_dw_matches_pallas(H, W, dt):
    g, data_j, data_t = both_prep(H, W, seed=H + 4, dt=dt)
    rng = np.random.default_rng(7 * W)
    da = rounded(0.1 * rng.standard_normal((1, H, W, 64)), dt)
    z1 = rounded(rng.standard_normal((1, H, W, 64)), dt)
    dw_j = jfs.fold_dw6(jfe.first_dw(flat(da, g, dt), flat(z1, g, dt),
                                     data_j["ox"], g))[:, :, :1]
    tfs.reset_launch_counts()
    dw = tfe.first_dw(t64(da, dt), t64(z1, dt), data_t["x"])
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, 1, 64)
    assert_sums_close(dw.numpy(), dw_j, dt, "dW_in")
    assert not any(tfs.launch_counts().values())


def test_sign_of_zero_is_zero():
    """Where aux_c == aux_m * noise the loss has no slope: sign(0) = 0 gives
    no cotangent and no weight gradient."""
    H, W = 5, 7
    rng = np.random.default_rng(3)
    z, w, s, b, rstd, nmr = last_inputs(H, W, seed=9, dt="f32")
    aux_m = torch.ones(H, W)
    noise = torch.from_numpy(rng.standard_normal((H, W)).astype(np.float32))
    g, dw, stats = tfe.last_loss_bwd(
        noise, noise.clone(), aux_m, torch.from_numpy(z), torch.from_numpy(w),
        torch.from_numpy(np.stack([s, b, rstd, nmr])))
    assert not g.any() and not dw.any() and not stats.any()


@pytest.mark.parametrize("H,W", [(5, 7), (1, 1), (9, 33)])
def test_plain_ends_match_torch_autograd(H, W):
    """The four plain versions chained (f32) against autograd of conv ->
    affine + ReLU -> conv -> masked L1 in plain torch, at odd sizes the
    packed JAX layout does not take."""
    rng = np.random.default_rng(H * W)
    cur, mask, target = (torch.from_numpy(v) for v in frame(H, W, seed=H))
    w_in = torch.from_numpy(
        (0.3 * rng.standard_normal((3, 3, 1, 64))).astype(np.float32))
    w_out = torch.from_numpy(
        (0.06 * rng.standard_normal((3, 3, 64, 1))).astype(np.float32))
    s = torch.from_numpy((1 + 0.2 * rng.standard_normal(64)).astype(np.float32))
    b = torch.from_numpy((0.3 * rng.standard_normal(64)).astype(np.float32))
    w_in.requires_grad_()
    w_out.requires_grad_()
    x = cur[..., 0]
    z1 = torch.nn.functional.conv2d(x[None, None], w_in.permute(3, 2, 0, 1),
                                    padding=1)
    a = torch.relu(z1 * s[:, None, None] + b[:, None, None])
    a.retain_grad()
    noise_r = torch.nn.functional.conv2d(a, w_out.permute(3, 2, 0, 1),
                                         padding=1)[0, 0]
    loss_r = (mask[..., 0] * (x - noise_r) - target[..., 0]).abs().sum()
    loss_r.backward()

    aux_c = (mask * cur - target)[..., 0].contiguous()
    aux_m = mask[..., 0].contiguous()
    z = tfe.first_conv(x.contiguous(), w_in.detach())
    np.testing.assert_allclose(z.numpy(), z1.detach().permute(0, 2, 3, 1),
                               rtol=1e-5, atol=1e-5)
    noise, loss = tfe.last_loss_fwd(z, s, b, w_out.detach(), aux_c, aux_m)
    np.testing.assert_allclose(noise.numpy(), noise_r.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(loss_r.detach()), rtol=1e-5)
    vecs = torch.stack([s, b, torch.ones(64), torch.zeros(64)])
    g, dw_out, stats = tfe.last_loss_bwd(noise, aux_c, aux_m, z,
                                         w_out.detach(), vecs)
    np.testing.assert_allclose(g.numpy(), a.grad.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-4, atol=1e-5)
    assert_sums_close(dw_out.numpy(), w_out.grad.numpy(), "f32", "dW_out")
    gt = a.grad * (a > 0)
    assert_sums_close(stats[0].numpy(), gt.sum((0, 2, 3)).numpy(), "f32",
                      "sum gp")
    assert_sums_close(stats[1].numpy(), (gt * z1.detach()).sum((0, 2, 3))
                      .numpy(), "f32", "sum gp zhat")
    # first_dw's mask is [z > 0]: hand it the cotangent of relu(z) for an
    # identity affine, i.e. the conv_in gradient of sum(relu(z) * da)
    da = torch.from_numpy(rng.standard_normal((1, H, W, 64)).astype(np.float32))
    w2 = w_in.detach().clone().requires_grad_()
    zz = torch.nn.functional.conv2d(x[None, None], w2.permute(3, 2, 0, 1),
                                    padding=1).permute(0, 2, 3, 1)
    (torch.relu(zz) * da).sum().backward()
    dw_in = tfe.first_dw(da, zz.detach().contiguous(), x.contiguous())
    assert_sums_close(dw_in.numpy(), w2.grad.numpy(), "f32", "dW_in")


def test_mma_bf16_rounds_the_dot_operands():
    """``mma_bf16`` moves the plain versions by bf16 steps of the operands,
    and changes nothing where the operands are bf16 values already."""
    H, W = 6, 9
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((H, W)).astype(np.float32))
    w = torch.from_numpy(
        (0.3 * rng.standard_normal((3, 3, 1, 64))).astype(np.float32))
    exact = tfe.first_conv_plain(x, w)
    rounded_ops = tfe.first_conv_plain(x, w, mma_bf16=True)
    assert not torch.equal(exact, rounded_ops)
    np.testing.assert_allclose(rounded_ops.numpy(), exact.numpy(), atol=0.02)
    xb, wb = x.bfloat16(), w.bfloat16().float()
    assert torch.equal(tfe.first_conv_plain(xb, wb),
                       tfe.first_conv_plain(xb, wb, mma_bf16=True))


@pytest.mark.parametrize("bad", ["batch", "dtype", "aux_shape", "aux_dtype",
                                 "w_shape", "vecs", "strided"])
def test_wrappers_reject_bad_inputs(bad):
    H, W = 4, 6
    z = torch.zeros(1, H, W, 64)
    s = b = torch.zeros(64)
    w = torch.zeros(3, 3, 64, 1)
    aux = torch.zeros(H, W)
    vecs = torch.zeros(4, 64)
    if bad == "batch":
        z = torch.zeros(2, H, W, 64)
    elif bad == "dtype":
        z = z.double()
    elif bad == "aux_shape":
        aux = torch.zeros(H, W, 1)
    elif bad == "aux_dtype":
        aux = aux.to(torch.float16)
    elif bad == "w_shape":
        w = torch.zeros(3, 3, 1, 64)
    elif bad == "vecs":
        vecs = torch.zeros(8, 64)
    else:
        aux = torch.zeros(W, H).t()
    calls = {
        "last_loss_fwd": lambda: tfe.last_loss_fwd(z, s, b, w, aux, aux),
        "last_loss_bwd": lambda: tfe.last_loss_bwd(aux, aux, aux, z, w, vecs),
        "first_dw": lambda: tfe.first_dw(z, z, aux),
        "first_conv": lambda: tfe.first_conv(aux, w.reshape(3, 3, 1, 64)),
    }
    hit = {"batch": ("last_loss_fwd", "last_loss_bwd", "first_dw"),
           "dtype": ("last_loss_fwd", "last_loss_bwd", "first_dw"),
           "aux_shape": tuple(calls), "aux_dtype": tuple(calls),
           "w_shape": ("last_loss_fwd", "last_loss_bwd"),
           "vecs": ("last_loss_bwd",), "strided": tuple(calls)}[bad]
    for name in hit:
        with pytest.raises((ValueError, TypeError)):
            calls[name]()
