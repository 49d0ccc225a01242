"""The tensor-core formulation of the port's ``last_loss_bwd`` kernel
(frame2frame_tpu_torch/csrc/fused_ends.cu ``last_bwd_k``), as a plain,
test-only PyTorch function, against the port's plain version
(``last_loss_bwd_plain``) and the JAX package's Pallas kernel in interpret
mode (frame2frame_tpu.ops.fused_ends.last_loss_bwd, called as
tests/test_torch_fused_ends.py calls it).

The kernel takes a row in units of 16 pixels, the last one running past the
image's right edge. For the pixels p of a unit it builds E[p][t] = -e at
p - off_t (taps 9-15 zero, -e zero outside the image) and computes
``g = E . W16`` (W16: taps by 64 channels, rows 9-15 zero) and
``dW^T = a^T . E``, each unit's chain started from zero and added to f32
sums; ``a = relu(s * z + b)`` (a rounded product and a rounded sum) is 0 at
the pixels past the edge by their position, and the BatchNorm sums take
``gp = g * [s * z + b > 0]`` from the f32 ``g`` at the image's pixels
only. ``b`` is drawn with ``relu(b) > 0`` in every channel, so a
formulation that zero-fills z past the edge and computes a from it there
(``relu(b)``) adds those pixels to dW and the sums; the last test shows
that this one would be caught.

Tolerances. Against ``last_loss_bwd_plain`` with the same operand rounding
(``mma_bf16``): f32 sums of the same products in another order, 1e-5 of the
largest value. ``g`` is compared before its rounding to the chain's dtype,
against the plain version on the f32 chain with the same z: on the bf16
chain two orders of the same nine products can round to neighbouring bf16
values. Against the JAX kernel: the bounds of
tests/test_torch_fused_ends.py (per pixel f32 rtol = atol = 2e-4, bf16 rtol
0.03 / atol 0.02; sums 2e-5 and 2e-3 of the largest entry) with the JAX
kernel's own operand rounding (the chain's dtype), at even widths: the
JAX package packs column pairs.
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
from frame2frame_tpu_torch.ops._common import _round_operand  # noqa: E402
from frame2frame_tpu_torch.train.flat_step import prep_frame  # noqa: E402

C = 64
UNIT = 16
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
ACT_TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=0.03, atol=0.02)}
SUM_TOL = {"f32": 2e-5, "bf16": 2e-3}
SAME_ROUNDING_RTOL = 1e-5
SHAPES = [(1, 1), (2, 3), (13, 21), (16, 32)]
CASES = [(H, W, dt) for H, W in SHAPES for dt in ("f32", "bf16")]
JAX_CASES = [(H, W, dt) for H, W in ((13, 20), (16, 32))
             for dt in ("f32", "bf16")]


def bwd_units(noise, aux_c, aux_m, z, w, vecs, mma_bf16, pad_z=False):
    """``last_loss_bwd`` as the kernel forms it: (g (1, H, W, 64) f32 before
    its rounding, dW_out (3, 3, 64, 1), stats (2, 64)).

    ``mma_bf16`` rounds -e, a and the weights to bf16 as the kernel does;
    else -e and the weights stay f32 and a is rounded to the chain's dtype,
    as in ``last_loss_bwd_plain``. ``pad_z``: the pixels past the image's
    edge take a = relu(b) from a zero-filled z and count in dW and the sums,
    the wrong border, for the last test."""
    _, H, W, _ = z.shape
    nu = -(-W // UNIT)
    Wp = nu * UNIT
    v = vecs.float()
    ne = _round_operand(-aux_m * torch.sign(aux_c - aux_m * noise), mma_bf16)
    nep = torch.zeros(H + 2, Wp + 2)
    nep[1:H + 1, 1:W + 1] = ne
    # E[y, x, t] = -e at (y, x) - off_t, off_t = (t // 3 - 1, t % 3 - 1)
    E = torch.zeros(H, Wp, UNIT)
    for t in range(9):
        dy, dx = 2 - t // 3, 2 - t % 3
        E[:, :, t] = nep[dy:dy + H, dx:dx + Wp]
    w16 = torch.zeros(UNIT, C)
    w16[:9] = _round_operand(w.reshape(9, C), mma_bf16)
    zp = torch.zeros(H, Wp, C)
    zp[:, :W] = z[0].float()
    y = zp * v[tfe.E_S] + v[tfe.E_B]
    inside = torch.arange(Wp) < W
    if not pad_z:  # past the edge: a = 0 by position, no gp
        y[:, ~inside] = -1.0
    a = _round_operand(torch.relu(y).to(z.dtype), mma_bf16)
    # one unit: 16 pixels of a row
    Eu = E.reshape(H * nu, UNIT, UNIT)
    g = (Eu @ w16).reshape(H, Wp, C)
    chains = a.reshape(H * nu, UNIT, C).transpose(1, 2) @ Eu  # (units, 64, 16)
    dw = torch.zeros(C, UNIT)
    for chain in chains:  # each from zero, added to the f32 sums in order
        dw = dw + chain
    gp = torch.where(y > 0, g, torch.zeros(()))
    zhat = zp * v[tfe.E_RSTD] + v[tfe.E_NMR]
    stats = torch.stack([gp.sum((0, 1)), (gp * zhat).sum((0, 1))])
    return (g[None, :, :W].contiguous(),
            dw[:, :9].T.reshape(3, 3, C, 1).contiguous(), stats)


def inputs(H, W, dt, seed):
    """The frame constants as the flat step builds them, a forward's noise,
    and z, w, vecs with relu(b) > 0, as numpy."""
    rng = np.random.default_rng(seed)
    cur = rng.random((H, W, 1)).astype(np.float32)
    mask = (rng.random((H, W, 1)) > 0.2).astype(np.float32)
    target = mask * rng.random((H, W, 1)).astype(np.float32)
    z = np.array(jnp.asarray(rng.standard_normal((1, H, W, C)), JDT[dt])
                 .astype(jnp.float32))
    w = (0.06 * rng.standard_normal((3, 3, C, 1))).astype(np.float32)
    s = (1.0 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    b = (0.05 + np.abs(0.3 * rng.standard_normal(C))).astype(np.float32)
    rstd = (0.5 + rng.random(C)).astype(np.float32)
    nmr = (0.1 * rng.standard_normal(C)).astype(np.float32)
    noise = (0.5 * rng.standard_normal((H, W))).astype(np.float32)
    return cur, mask, target, noise, z, w, np.stack([s, b, rstd, nmr])


def torch_args(cur, mask, target, noise, z, w, vecs, dt):
    data = prep_frame(torch.from_numpy(cur), torch.from_numpy(mask),
                      torch.from_numpy(target), store_dtype=TDT[dt])
    return (torch.from_numpy(noise), data["aux_c"], data["aux_m"],
            torch.from_numpy(z).to(TDT[dt]), torch.from_numpy(w),
            torch.from_numpy(vecs))


def assert_sums_close(got, want, rtol, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, name
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rtol,
                               err_msg=name)


@pytest.mark.parametrize("mma_bf16", [True, False])
@pytest.mark.parametrize("H,W,dt", CASES)
def test_units_match_plain(H, W, dt, mma_bf16):
    args = torch_args(*inputs(H, W, dt, seed=H * W + 1), dt)
    g, dw, stats = bwd_units(*args, mma_bf16=mma_bf16)
    _, want_dw, want_stats = tfe.last_loss_bwd_plain(*args, mma_bf16=mma_bf16)
    # g before its rounding: the plain version on the f32 chain, same z
    want_g = tfe.last_loss_bwd_plain(*args[:3], args[3].float(), *args[4:],
                                     mma_bf16=mma_bf16)[0]
    assert_sums_close(g.numpy(), want_g.numpy(), SAME_ROUNDING_RTOL, "g_L")
    assert_sums_close(dw.numpy(), want_dw.numpy(), SAME_ROUNDING_RTOL,
                      "dW_out")
    for k, name in enumerate(("sum gp", "sum gp zhat")):
        assert_sums_close(stats[k].numpy(), want_stats[k].numpy(),
                          SAME_ROUNDING_RTOL, name)


def geom(H, W):
    return jfs.Geom(H, W // 2, jfs.default_tile_h(W // 2))


def flat(x, g, dt):
    return jfs.to_flat(pack_image(jnp.asarray(x, JDT[dt])), g)


def unflat(f, g):
    return np.asarray(unpack_image(jfs.from_flat(f, g)).astype(jnp.float32))


@pytest.fixture(scope="module")
def jax_bwd():
    """(noise, g_L, dW_out, stats) of the JAX kernels in interpret mode by
    case, each computed once: the JAX forward's own noise feeds both
    sides."""
    cache = {}

    def get(H, W, dt):
        if (H, W, dt) not in cache:
            cur, mask, target, _, z, w, vecs = inputs(H, W, dt, seed=H + W)
            g = geom(H, W)
            data_j = jflat.prep_frame(jnp.asarray(cur), jnp.asarray(mask),
                                      jnp.asarray(target), g,
                                      store_dtype=JDT[dt])
            s, b = (jfs.tile_vec(jnp.asarray(v)) for v in vecs[:2])
            w6 = jfs.pack_kernel_odd(jfe.embed_w_out(jnp.asarray(w)))
            noise_j, o_j, _ = jfe.last_loss_fwd(
                flat(z, g, dt), data_j["aux_c"], data_j["aux_m"], w6, s, b, g)
            v6 = jfs.pack_kernel_odd_bwd(-jfe.embed_w_out(jnp.asarray(w)))
            g_j, dw6, stats_j = jfe.last_loss_bwd(
                noise_j, data_j["aux_c"], data_j["aux_m"], flat(z, g, dt),
                o_j, v6, jnp.stack([jfs.tile_vec(jnp.asarray(v))
                                    for v in vecs]), g)
            cache[H, W, dt] = (
                np.ascontiguousarray(unflat(noise_j, g)[0, :, :, 0]),
                unflat(g_j, g), -jfs.fold_dw6(dw6)[:, :, :, :1],
                np.stack([jfs.fold_vec(stats_j[k]) for k in range(2)]))
        return cache[H, W, dt]
    return get


@pytest.mark.parametrize("H,W,dt", JAX_CASES)
def test_units_match_pallas(H, W, dt, jax_bwd):
    cur, mask, target, _, z, w, vecs = inputs(H, W, dt, seed=H + W)
    noise_j, g_j, dw_j, stats_j = jax_bwd(H, W, dt)
    args = torch_args(cur, mask, target, noise_j, z, w, vecs, dt)
    g, dw, stats = bwd_units(*args, mma_bf16=False)
    np.testing.assert_allclose(g.to(TDT[dt]).float().numpy(), g_j,
                               **ACT_TOL[dt])
    assert np.abs(np.asarray(dw_j)).max() > 0.1  # a sum over pixels
    assert_sums_close(dw.numpy(), dw_j, SUM_TOL[dt], "dW_out")
    for k, name in enumerate(("sum gp", "sum gp zhat")):
        assert_sums_close(stats[k].numpy(), stats_j[k], SUM_TOL[dt], name)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_padding_z_instead_of_a_is_caught(dt):
    """With relu(b) > 0, pixels past the right edge that take a = relu(b)
    from a zero-filled z move dW_out and the BatchNorm sums by more than ten
    times the bf16 bound above (13 x 21: 11 such pixels a row, the first of
    them next to the image), and leave g as it is; at a width of whole
    units (16 x 32) there are none."""
    args = torch_args(*inputs(13, 21, dt, seed=5), dt)
    good = bwd_units(*args, mma_bf16=True)
    bad = bwd_units(*args, mma_bf16=True, pad_z=True)
    torch.testing.assert_close(bad[0], good[0], rtol=0, atol=0)
    for k in (1, 2):
        d = (bad[k] - good[k]).abs().max() / good[k].abs().max()
        assert float(d) > 10 * SUM_TOL["bf16"]
    args = torch_args(*inputs(16, 32, dt, seed=5), dt)
    for got, want in zip(bwd_units(*args, mma_bf16=True, pad_z=True),
                         bwd_units(*args, mma_bf16=True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
