"""The row window (``valid_bounds``) of the port's mid-layer functions
(frame2frame_tpu_torch/ops/fused_stack.py; CPU tensors: their plain
versions) against the Pallas kernels' ``valid_bounds`` in interpret mode.

A slab of a frame split by rows is its body rows and one halo row above and
below; the JAX kernels take the same slab in their flat layout, the halo
rows at the end of the head tile and the start of the tail tile, where the
JAX package's ``_exchange`` puts them. Windows: slab 0, an interior slab
and the last slab of a 2-way and a 3-way split of a frame whose padded rows
fill the last slab's tail (``frame2frame_tpu.ops.fused_spatial`` pads to
whole tiles of 8 rows), on the f32 chain; the bf16 chain on the windows of
the slabs after the first.

- ``fwd_layer_train`` and ``fwd_layer``: z at the body rows and the BN sums
  over the body rows in the window, against ``fwd_layer(emit_stats=True)``;
- ``fwd_layer_eval``: relu(s * conv + b) at the body rows in the window,
  from an input that is zero outside it (the act chain's halos are masked
  rows); the port also zeroes the operand outside the window, so garbage
  there changes nothing;
- ``bwd_layer``: da_prev at the body rows, dW and the previous layer's
  BN-backward sums, against ``bwd_layer(valid_bounds=...)``;
- the window of a whole image computes what the layer without a window
  computes, bit for bit.

Tolerances as ``test_torch_fused_stack_train.py``: f32 activations 1e-5
(rtol and atol), sums 2e-5 of the largest entry; bf16 rtol 0.03 / atol
0.02 and 2e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.ops import fused_stack as jfs  # noqa: E402
from frame2frame_tpu.ops.packed import pack_image, unpack_image  # noqa: E402
from frame2frame_tpu_torch.ops import fused_spatial as tsp  # noqa: E402
from frame2frame_tpu_torch.ops import fused_stack as tfs  # noqa: E402

ACT_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
           "bf16": dict(rtol=0.03, atol=0.02)}
SUM_TOL = {"f32": 2e-5, "bf16": 2e-3}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
W, TH, R = 32, 8, 8  # frame width, JAX tile rows, body rows of a slab
# (D, slab k, true H): H = 13 pads to 16 over two slabs, H = 20 to 24 over
# three; the last slab holds 3 and 4 pad rows
WINDOWS = [(2, 0, 13), (2, 1, 13), (3, 0, 20), (3, 1, 20), (3, 2, 20)]


def window(k, H):
    """The port's window of slab k (local row r is frame row k R + r - 1):
    its rows of the frame, and the body rows among them."""
    return tsp._valid_bounds(k, R, H)


def jax_window(g, k, H):
    """The JAX package's ``_valid_bounds`` of slab k, in flat positions."""
    base = k * g.T * g.n
    return jnp.asarray([g.n - base, g.n + H * g.wpad - base], jnp.int32)


def local_flat(slab, g, dt):
    """Port slab (1, R + 2, W, 64) -> the JAX slab's flat layout: zero rows,
    the top halo row, the body, the bottom halo row, zero rows."""
    z = np.zeros((1, TH - 1, W, 64), np.float32)
    ext = np.concatenate([z, slab, z], axis=1)
    packed = pack_image(jnp.asarray(ext, JDT[dt]))[0]
    return jnp.pad(packed, ((0, 0), (1, 1), (0, 0))).reshape(g.tot, 128)


def body(flat, g):
    return np.asarray(unpack_image(jfs.from_flat(flat, g)).astype(jnp.float32))


def rounded(x, dt):
    return np.array(jnp.asarray(x, JDT[dt]).astype(jnp.float32))


def slab_inputs(seed, dt):
    rng = np.random.default_rng(seed)
    shape = (1, R + 2, W, 64)
    z_prev = rounded(rng.standard_normal(shape), dt)
    z_i = rounded(rng.standard_normal(shape), dt)
    g = rounded(0.1 * rng.standard_normal(shape), dt)
    w = (rng.standard_normal((3, 3, 64, 64)) * 0.06).astype(np.float32)

    def vec(mean, std):
        return (mean + std * rng.standard_normal(64)).astype(np.float32)

    vecs = np.stack([vec(1.0, 0.2), vec(0.3, 0.3), vec(0.0, 1e-2),
                     vec(0.0, 1e-2), vec(1.0, 0.2), vec(0.3, 0.3),
                     (0.5 + rng.random(64)).astype(np.float32), vec(0.0, 0.1)])
    return z_prev, z_i, g, w, vecs


def zero_outside(x, lo, hi):
    x = x.copy()
    x[:, :max(lo, 0)] = 0
    x[:, max(hi, 0):] = 0
    return x


def assert_sums_close(got, want, dt, name):
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-8
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=SUM_TOL[dt], err_msg=name)


# the bf16 chain on the windows that hold halo rows of a neighbour
CASES = ([(w, "f32") for w in WINDOWS]
         + [(w, "bf16") for w in WINDOWS if w[1] > 0])


@pytest.fixture(scope="module", params=CASES,
                ids=lambda p: f"D{p[0][0]}-k{p[0][1]}-{p[1]}")
def case(request):
    """One window and chain: the inputs and the JAX kernels' outputs."""
    (D, k, H), dt = request.param
    z_prev, z_i, g, w, vecs = slab_inputs(10 * D + k, dt)
    lo, hi, _, _ = window(k, H)
    a_eval = zero_outside(np.maximum(z_prev, 0), lo, hi)
    gm = jfs.Geom(R, W // 2, TH)
    vb = jax_window(gm, k, H)
    wj = jnp.asarray(w)
    w2 = jfs.pack_kernel_flat(wj)
    s, b = (jfs.tile_vec(jnp.asarray(v)) for v in vecs[4:6])
    z_j, stats_j = jfs.fwd_layer(local_flat(z_prev, gm, dt), w2, s, b, gm,
                                 valid_bounds=vb)
    se, be = vecs[0], vecs[1]
    a_j, = jfs.fwd_layer_eval(
        local_flat(a_eval, gm, dt),
        jfs.pack_kernel_flat(wj * jnp.asarray(se)[None, None, None, :]),
        jfs.tile_vec(jnp.asarray(be)), gm, odd=False, valid_bounds=vb)
    vecs_j = jnp.stack([jfs.tile_vec(jnp.asarray(v)) for v in vecs])
    da_j, dw_j, sp_j = jfs.bwd_layer(
        local_flat(g, gm, dt), local_flat(z_i, gm, dt),
        local_flat(z_prev, gm, dt), jfs._io_t(w2), vecs_j, gm,
        valid_bounds=vb)
    want = {"z": body(z_j, gm), "stats": [jfs.fold_vec(v) for v in stats_j],
            "a": body(a_j, gm), "da": body(da_j, gm),
            "dw": np.asarray(jfs.fold_dw2(dw_j)),
            "sp": [jfs.fold_vec(v) for v in sp_j]}
    t = {n: torch.from_numpy(v) for n, v in (
        ("z_prev", z_prev), ("z_i", z_i), ("g", g), ("a", a_eval),
        ("w", w), ("vecs", vecs))}
    return dict(dt=dt, vb=window(k, H), lo=lo, hi=hi, H=H, k=k, t=t,
                want=want)


def as_chain(t, dt):
    return t.to(TDT[dt]).contiguous()


def in_window_body(x, lo, hi):
    """Body rows of a port slab, and a mask of those in the window."""
    rows = np.arange(1, R + 1)
    return x[:, 1:R + 1], (rows >= lo) & (rows < hi)


def test_fwd_layer_train_window(case):
    dt, t, want = case["dt"], case["t"], case["want"]
    vb = case["vb"]
    s, b = t["vecs"][4], t["vecs"][5]
    tfs.reset_launch_counts()
    z, stats = tfs.fwd_layer_train(as_chain(t["z_prev"], dt), t["w"], s, b,
                                   valid_bounds=vb)
    z2 = tfs.fwd_layer(as_chain(t["z_prev"], dt), t["w"], s, b,
                       valid_bounds=vb)
    assert z.shape == z2.shape == (1, R + 2, W, 64)
    assert z.dtype == z2.dtype == TDT[dt]
    for got in (z, z2):
        np.testing.assert_allclose(got.float().numpy()[:, 1:R + 1], want["z"],
                                   **ACT_TOL[dt])
    for k, name in enumerate(("sum z", "sum z^2")):
        assert_sums_close(stats[k].numpy(), want["stats"][k], dt, name)
    assert not any(tfs.launch_counts().values())


def test_fwd_layer_eval_window(case):
    dt, t, want = case["dt"], case["t"], case["want"]
    lo, hi = case["lo"], case["hi"]
    se, be = t["vecs"][0], t["vecs"][1]
    a = tfs.fwd_layer_eval(as_chain(t["a"], dt), t["w"], se, be,
                           valid_bounds=case["vb"])
    got, ok = in_window_body(a.float().numpy(), lo, hi)
    np.testing.assert_allclose(got[:, ok], want["a"][:, ok], **ACT_TOL[dt])
    # rows outside the window are zero in the operand, whatever they hold
    noisy = t["a"].clone()
    noisy[:, :max(lo, 0)] = 5.0
    noisy[:, max(hi, 0):] = 5.0
    a2 = tfs.fwd_layer_eval(as_chain(noisy, dt), t["w"], se, be,
                            valid_bounds=case["vb"])
    assert torch.equal(a, a2)


def test_bwd_layer_window(case):
    dt, t, want = case["dt"], case["t"], case["want"]
    da, dw, sp = tfs.bwd_layer(
        *(as_chain(t[n], dt) for n in ("g", "z_i", "z_prev")), t["w"],
        t["vecs"], False, valid_bounds=case["vb"])
    np.testing.assert_allclose(da.float().numpy()[:, 1:R + 1], want["da"],
                               **ACT_TOL[dt])
    assert_sums_close(dw.numpy(), want["dw"], dt, "dW")
    for k, name in enumerate(("sum gp", "sum gp zhat")):
        assert_sums_close(sp[k].numpy(), want["sp"][k], dt, name)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_whole_image_window_is_no_window(dt):
    """The window of a whole image, (0, H) or (0, H, 0, H), computes what
    the layer without a window computes, bit for bit."""
    z_prev, z_i, g, w, vecs = (torch.from_numpy(v) for v in
                               slab_inputs(7, dt))
    z_prev, z_i, g = (as_chain(x, dt) for x in (z_prev, z_i, g))
    full = (0, R + 2)
    s, b = vecs[4], vecs[5]
    for fn in (tfs.fwd_layer, tfs.fwd_layer_eval):
        assert torch.equal(fn(z_prev, w, s, b, valid_bounds=full),
                           fn(z_prev, w, s, b))
    for got, ref in zip(
            tfs.fwd_layer_train(z_prev, w, s, b, valid_bounds=full),
            tfs.fwd_layer_train(z_prev, w, s, b)):
        assert torch.equal(got, ref)
    for first in (False, True):
        for got, ref in zip(
                tfs.bwd_layer(g, z_i, z_prev, w, vecs, first,
                              valid_bounds=full),
                tfs.bwd_layer(g, z_i, z_prev, w, vecs, first)):
            assert torch.equal(got, ref)


def test_window_validation():
    x = torch.zeros(1, R + 2, W, 64)
    w, s = torch.zeros(3, 3, 64, 64), torch.zeros(64)
    with pytest.raises(ValueError, match="no row"):
        tfs.fwd_layer(x, w, s, s, valid_bounds=(5, 5))
    with pytest.raises(ValueError, match="no row"):
        tfs.fwd_layer(x, w, s, s, valid_bounds=(R + 2, R + 9))
    assert tfs.rows_of(x, (-7, 40)) == (0, R + 2, 0, R + 2)
    assert tfs.rows_of(x, (3, 6)) == (3, 6, 3, 6)
    assert tfs.rows_of(x, (0, 5, -1, 99)) == (0, 5, 0, R + 2)
    assert tfs.rows_of(x, window(1, 13)) == (0, 6, 1, 6)
    assert tfs.rows_of(x, None) is None
