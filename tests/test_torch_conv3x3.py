"""The port's 3x3 convolution and its weight gradient (``ops/conv3x3.py``,
``ops/conv_dw.py``) against the JAX package's Pallas kernels, which run in
interpret mode on the CPU (``pallas_conv._interpret``, ``conv_dw._interpret``),
and the port's differentiable convolutions against the JAX custom VJPs.

On the CPU the wrappers compute their plain versions: what is held here is
the plain versions' function, which ``chip_smoke.py`` holds the kernels to on
the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.ops import conv_dw as jdw  # noqa: E402
from frame2frame_tpu.ops import packed as jpacked  # noqa: E402
from frame2frame_tpu.ops import pallas_conv as jpc  # noqa: E402
from frame2frame_tpu_torch.ops import conv3x3 as tc  # noqa: E402
from frame2frame_tpu_torch.ops import conv_dw as tdw  # noqa: E402
from frame2frame_tpu_torch.ops import fused_stack as fs  # noqa: E402

# forward: f32 sums of the same products in another order; dX and dW: the
# bounds of tests/test_pallas_conv.py
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# (B, H, W, Cin, Cout): test_pallas_conv.py's shapes, DnCNN's three layer
# kinds at 8x16, an odd frame
SHAPES = [(2, 16, 24, 8, 8), (1, 8, 12, 1, 16), (1, 8, 16, 64, 64),
          (1, 8, 16, 64, 1), (1, 8, 16, 1, 64), (2, 13, 21, 3, 8)]


def operands(B, H, W, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout))
         / np.sqrt(9 * cin)).astype(np.float32)
    g = rng.standard_normal((B, H, W, cout)).astype(np.float32)
    return x, w, g


def pad(a):
    return jnp.pad(jnp.asarray(a), ((0, 0), (1, 1), (1, 1), (0, 0)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_conv3x3_fwd_plain_matches_pallas_kernels(shape):
    """Kernel A's plain version against ``conv3x3_nopad`` and
    ``conv3x3_nopad_p2`` (rows 9 and 11), image by image."""
    x, w, _ = operands(*shape, seed=1)
    got = tc.conv3x3_fwd(t(x), t(w)).numpy()
    assert got.dtype == np.float32 and got.shape == shape[:3] + shape[4:]
    xp = pad(x)
    for core in (jpc.conv3x3_nopad, jpc.conv3x3_nopad_p2):
        want = np.stack([np.asarray(core(xp[b], jnp.asarray(w)))
                         for b in range(shape[0])])
        np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dw_plain_matches_pallas_kernels(shape):
    """Kernel B's plain version on a batch against ``_dw_nopad`` and
    ``_dw_nopad_p2`` (rows 10 and 12) summed over the batch."""
    x, _, g = operands(*shape, seed=2)
    got = tdw.dw_conv3x3(t(x), t(g)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 3) + shape[3:]
    xp = pad(x)
    for core in (jpc._dw_nopad, jpc._dw_nopad_p2):
        want = sum(np.asarray(core(xp[b], jnp.asarray(g[b])))
                   for b in range(shape[0]))
        np.testing.assert_allclose(got, want, **GRAD_TOL)


@pytest.mark.parametrize("shape", [(2, 8, 16, 64, 64), (1, 8, 12, 1, 64),
                                   (1, 6, 10, 64, 1)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dw_plain_matches_pair_packed_kernel(shape, dtype):
    """Kernel B's plain version against row 8, ``dw_conv3x3`` (one image)
    and ``dw_conv3x3_batched``, on f32 and on bf16 operands (the JAX kernel
    runs both in interpret mode). Its widths are even: pair packing needs
    them so."""
    x, _, g = operands(*shape, seed=3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    xt, gt = t(x).to(tdt), t(g).to(tdt)
    np.testing.assert_allclose(tdw.dw_conv3x3(xt[0], gt[0]).numpy(),
                               np.asarray(jdw.dw_conv3x3(xj[0], gj[0])),
                               **GRAD_TOL)
    got = tdw.dw_conv3x3_batched(xt, gt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jdw.dw_conv3x3_batched(xj, gj)),
                               **GRAD_TOL)


def _sin_loss_grads_torch(fn, x, w):
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    y = fn(xt, wt)
    torch.sin(y).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


def _sin_loss_grads_jax(fn, x, w):
    y = np.asarray(fn(jnp.asarray(x), jnp.asarray(w)))
    gx, gw = jax.grad(lambda a, b: jnp.sum(jnp.sin(fn(a, b))),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return y, np.asarray(gx), np.asarray(gw)


@pytest.mark.parametrize("name", ["conv3x3", "conv3x3_hybrid", "conv3x3_p2",
                                  "conv3x3_dwflat"])
@pytest.mark.parametrize("shape", [(2, 16, 24, 8, 8), (1, 8, 16, 64, 64),
                                   (1, 8, 12, 1, 16)], ids=str)
def test_autograd_functions_match_jax_custom_vjps(name, shape):
    """Forward, dX and dW of the port's differentiable convolutions against
    the JAX custom VJPs of the same name on sum(sin(conv))."""
    x, w, _ = operands(*shape, seed=4)
    port = getattr(tdw if name == "conv3x3_dwflat" else tc, name)
    ref = getattr(jdw if name == "conv3x3_dwflat" else jpc, name)
    y, gx, gw = _sin_loss_grads_torch(port, x, w)
    y_j, gx_j, gw_j = _sin_loss_grads_jax(ref, x, w)
    np.testing.assert_allclose(y, y_j, **FWD_TOL)
    np.testing.assert_allclose(gx, gx_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gw, gw_j, **GRAD_TOL)


@pytest.mark.parametrize("shape", [(2, 16, 24, 8, 8), (1, 8, 16, 64, 64)],
                         ids=str)
def test_bf16res_matches_jax_bf16res(shape):
    """dW from x and the cotangent rounded to bf16, f32 sums: within 1e-5
    of the JAX function's own (the same products, summed in another order),
    and within its 0.02 * max bound of the f32 gradient; forward and dX are
    f32."""
    x, w, _ = operands(*shape, seed=5)
    y, gx, gw = _sin_loss_grads_torch(tc.conv3x3_bf16res, x, w)
    y_j, gx_j, gw_j = _sin_loss_grads_jax(jpc.conv3x3_bf16res, x, w)
    _, _, gw_f32 = _sin_loss_grads_jax(jpc._xla_conv, x, w)
    np.testing.assert_allclose(y, y_j, **FWD_TOL)
    np.testing.assert_allclose(gx, gx_j, rtol=1e-5, atol=1e-6)
    assert np.abs(gw - gw_j).max() <= 1e-5 * np.abs(gw_j).max()
    assert np.abs(gw - gw_f32).max() < 0.02 * np.abs(gw_f32).max()


def test_bf16_conv_matches_packed_bf16_conv():
    """``conv3x3_bf16`` (the "packed_bf16" data path in image space) against
    ``conv3x3_packed_bf16`` on the pair-packed layout: bf16 forward and dX,
    dW f32 from the bf16 operands."""
    x, w, g = operands(2, 8, 16, 64, 64, seed=6)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    g16 = jnp.asarray(g).astype(jnp.bfloat16)
    y_j, vjp = jax.vjp(jpacked.conv3x3_packed_bf16, jpacked.pack_image(x16),
                       jnp.asarray(w))
    dx_j, dw_j = vjp(jpacked.pack_image(g16))
    xt = t(x).to(torch.bfloat16).requires_grad_()
    wt = t(w).requires_grad_()
    y = tc.conv3x3_bf16(xt, wt)
    y.backward(t(g).to(torch.bfloat16))
    assert y.dtype == xt.grad.dtype == torch.bfloat16
    assert wt.grad.dtype == torch.float32

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    # one bf16 rounding of an f32 sum taken in another order: at most one
    # step of 2^-8 relative apart
    np.testing.assert_allclose(y.detach().float().numpy(),
                               f32(jpacked.unpack_image(y_j)),
                               rtol=8e-3, atol=1e-2)
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               f32(jpacked.unpack_image(dx_j)),
                               rtol=8e-3, atol=1e-2)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), **GRAD_TOL)


def test_dx_is_skipped_where_the_input_needs_no_gradient(monkeypatch):
    """The backward's dX runs only where x needs a gradient (the first
    layer's frame does not)."""
    calls = []
    fwd = tc.conv3x3_fwd

    def counted(x, w):
        calls.append(tuple(w.shape))
        return fwd(x, w)

    monkeypatch.setattr(tc, "conv3x3_fwd", counted)
    x, w, _ = operands(1, 6, 8, 1, 8, seed=7)
    for needs_dx in (False, True):
        calls.clear()
        xt = t(x).requires_grad_(needs_dx)
        wt = t(w).requires_grad_()
        tc.conv3x3(xt, wt).sum().backward()
        assert calls == [(3, 3, 1, 8)] + [(3, 3, 8, 1)] * needs_dx
        assert wt.grad is not None


def test_wrappers_validate_and_count_nothing_on_the_cpu():
    fs.reset_launch_counts()
    x, w, g = operands(1, 5, 7, 3, 4, seed=8)
    tc.conv3x3_fwd(t(x), t(w))
    tdw.dw_conv3x3(t(x), t(g))
    assert not any(fs.launch_counts().values())
    with pytest.raises(TypeError):
        tc.conv3x3_fwd(t(x).double(), t(w))
    with pytest.raises(ValueError):
        tc.conv3x3_fwd(t(x), t(w)[:, :, :2])
    with pytest.raises(TypeError):
        tdw.dw_conv3x3(t(x), t(g).to(torch.bfloat16))
    with pytest.raises(ValueError):
        tdw.dw_conv3x3(t(x), t(g)[:, :4])


# (dtype, Cin, Cout, which of x and g the kernels read in 16-byte chunks):
# the tensor-core bodies on f32, each vector operand on bf16, the wide
# operand of the thin f32 layers (g at n -> 64, x at 64 -> n)
CP_ASYNC_CASES = [("float32", 64, 64, (True, True)),
                  ("float32", 80, 72, (True, True)),
                  ("float32", 1, 64, (False, True)),
                  ("float32", 64, 1, (True, False)),
                  ("float32", 3, 64, (False, True)),
                  ("float32", 64, 3, (True, False)),
                  ("bfloat16", 64, 64, (True, True)),
                  ("bfloat16", 1, 64, (False, True)),
                  ("bfloat16", 64, 1, (True, False))]


@pytest.mark.parametrize("dtype,cin,cout,reads", CP_ASYNC_CASES, ids=str)
def test_unaligned_operands_are_refused_where_read_in_16_byte_chunks(
        dtype, cin, cout, reads):
    """A contiguous view one element into its storage is refused before a
    launch wherever a kernel reads that operand with 16-byte cp.async, and
    an aligned tensor passes."""
    assert tdw.cp_async_reads(dtype == "float32", cin, cout) == reads
    dt = getattr(torch, dtype)
    for c in (cin, cout):
        whole = torch.zeros(1 + 2 * 4 * 5 * c, dtype=dt)
        view = whole[1:].view(2, 4, 5, c)
        assert view.is_contiguous() and view.contiguous() is view
        tdw.refuse_unaligned("op", whole[:-1].view(2, 4, 5, c))
        with pytest.raises(ValueError, match="op: an operand read in "
                           "16-byte chunks"):
            tdw.refuse_unaligned("op", view)
