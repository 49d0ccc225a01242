"""The port's non-local search and SSIM (``frame2frame_tpu_torch/ops/nls.py``,
``ops/ssim.py``) against the JAX package's, on the CPU.

Inputs: smooth random videos (gaussian-filtered noise in [0, 1]) at 16x24,
C = 1 and 3, with smooth non-zero flows of a few pixels, all from numpy
seeds. Holds:
- values (warps, composed flows, distances, stacks, patches, SSIM) within
  1e-5 of the largest JAX value;
- search ``inds`` equal exactly on these (tie-free) inputs, and on a
  constant video, where every offset ties and the order of
  ``_search_offsets`` decides (JAX's stable ``lax.top_k``, the port's stable
  sort);
- gradients of ``refine_search``, ``paired_refine`` and ``scale_grad``
  against ``jax.grad`` within 1e-4 of the largest;
- reflection by index where the pad is wider than the frame, equal to
  ``jnp.pad(mode="reflect")``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.ndimage import gaussian_filter  # noqa: E402

from frame2frame_tpu.ops import nls as jnls  # noqa: E402
from frame2frame_tpu.ops.ssim import ssim as jssim  # noqa: E402
from frame2frame_tpu_torch.ops import nls as tnls  # noqa: E402
from frame2frame_tpu_torch.ops.ssim import ssim as tssim  # noqa: E402

B, T, H, W = 1, 4, 16, 24
VAL_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth(rng, shape, sigma):
    x = rng.standard_normal(shape)
    sig = [0] * (len(shape) - 3) + [sigma, sigma, 0]
    return gaussian_filter(x, sig).astype(np.float32)


def video(seed, C, t=T):
    v = smooth(np.random.default_rng(seed), (B, t, H, W, C), 2.0)
    return (v - v.min()) / (v.max() - v.min())


def flows(seed, t=T, scale=12.0):
    rng = np.random.default_rng(seed)
    return (smooth(rng, (B, t, H, W, 2), 4.0) * scale,
            smooth(rng, (B, t, H, W, 2), 4.0) * scale)


def hold(got, want, rtol=VAL_RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    inf = np.isinf(want)  # the distances of a short sequence's empty slots
    np.testing.assert_array_equal(got[inf], want[inf])
    got, want = got[~inf], want[~inf]
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def t_(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def data():
    return {C: video(1 + C, C) for C in (1, 3)}, flows(7)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("pad", [1, 4, 11])
def test_reflect_idx_is_jnp_pad_reflect(n, pad):
    x = np.arange(n, dtype=np.float32)
    want = np.asarray(jnp.pad(jnp.asarray(x), (pad, pad + 2), mode="reflect"))
    idx = tnls._reflect_idx(torch.arange(-pad, n + pad + 2), n)
    np.testing.assert_array_equal(x[idx.numpy()], want)


@pytest.mark.parametrize("C", [1, 3])
def test_bilinear_and_warp(data, C):
    vids, (ff, _) = data
    img = vids[C][0, 1]
    rng = np.random.default_rng(3)
    sx = rng.uniform(-30, 60, (5, 7, 2)).astype(np.float32)
    sy = rng.uniform(-30, 40, (5, 7, 2)).astype(np.float32)
    hold(tnls.bilinear_sample_reflect(t_(img), t_(sx), t_(sy)),
         jnls.bilinear_sample_reflect(img, sx, sy), what="sample")
    hold(tnls.flow_warp_reflect(t_(img), t_(ff[0, 0])),
         jnls.flow_warp_reflect(img, ff[0, 0]), what="warp")
    # leading batch dims: one warp a frame
    got = tnls.flow_warp_reflect(t_(vids[C][0]), t_(ff[0]))
    for t in range(T):
        hold(got[t], jnls.flow_warp_reflect(vids[C][0, t], ff[0, t]),
             what=f"warp frame {t}")


@pytest.mark.parametrize("shape,ps", [((16, 24), 3), ((16, 24), 4),
                                      ((16, 24), 5), ((3, 5), 9),
                                      ((1, 4), 3)])
def test_box_filter_sum(shape, ps):
    """ps = 9 on 3x5 and ps = 3 on one row: pads wider than the frame."""
    x = np.random.default_rng(ps).standard_normal(shape).astype(np.float32)
    hold(tnls.box_filter_sum(t_(x), ps), jnls.box_filter_sum(x, ps))


@pytest.mark.parametrize("wt", [1, 2])
@pytest.mark.parametrize("t", [2, 3, 5, 6])
def test_window_tables(wt, t):
    tj, valid = tnls._window_tables(t, wt)
    jtj, jvalid = jnls._window_tables(t, wt)
    np.testing.assert_array_equal(tj, np.asarray(jtj))
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    for ti in range(t):
        assert tnls.time_window_frames(ti, wt, t) == \
            jnls.time_window_frames(ti, wt, t)


@pytest.mark.parametrize("wt", [1, 2])
def test_search_flow_compose(data, wt):
    """wt = 2: the clamped two-hop windows reach targets 2*wt away."""
    _, (ff, bf) = data
    got_f, got_b = tnls.compose_flow_pyramids(t_(ff), t_(bf), 2 * wt)
    want_f, want_b = jnls.compose_flow_pyramids(ff, bf, 2 * wt)
    hold(got_f, want_f, what="comp_f")
    hold(got_b, want_b, what="comp_b")
    hold(tnls.search_flow_compose(t_(ff), t_(bf), wt),
         jnls.search_flow_compose(ff, bf, wt), what="compose")


@pytest.fixture(scope="module")
def searches(data):
    """JAX's searches, once: {(C, stride0, wt, ps): (dists, inds)}."""
    vids, (ff, bf) = data
    out = {}
    for C, s0, wt, ps in ((1, 1, 1, 3), (3, 2, 1, 5), (1, 2, 2, 3)):
        d, i = jnls.non_local_search(
            jnp.asarray(vids[C]), {"fflow": ff, "bflow": bf}, ws=5, wt=wt,
            ps=ps, k=2, stride0=s0)
        out[C, s0, wt, ps] = np.asarray(d), np.asarray(i)
    return out


@pytest.mark.parametrize("key", [(1, 1, 1, 3), (3, 2, 1, 5), (1, 2, 2, 3)])
def test_non_local_search(data, searches, key):
    C, s0, wt, ps = key
    vids, (ff, bf) = data
    d, i = tnls.non_local_search(
        t_(vids[C]), {"fflow": t_(ff), "bflow": t_(bf)}, ws=5, wt=wt, ps=ps,
        k=2, stride0=s0)
    want_d, want_i = searches[key]
    hold(d, want_d, what="dists")
    np.testing.assert_array_equal(i.numpy(), want_i)


def test_non_local_search_precomposed_and_tables(data):
    """A precomposed flow stack, a srch_vid and an explicit table (the
    last frame's slots marked invalid: +inf distances)."""
    vids, (ff, bf) = data
    tj, valid = jnls._window_tables(T, 1)
    valid = np.asarray(valid).copy()
    valid[-1] = False
    tables = (np.asarray(tj), valid)
    comp = np.asarray(jnls.search_flow_compose(ff, bf, 1))
    srch = vids[1][:, ::-1].copy()
    want_d, want_i = jnls.non_local_search(
        jnp.asarray(vids[1]), comp, ws=3, wt=1, ps=3, k=2, stride0=2,
        srch_vid=jnp.asarray(srch), tables=(jnp.asarray(tables[0]),
                                            jnp.asarray(tables[1])))
    d, i = tnls.non_local_search(t_(vids[1]), t_(comp), ws=3, wt=1, ps=3,
                                 k=2, stride0=2, srch_vid=t_(srch),
                                 tables=tables)
    want_d = np.asarray(want_d)
    assert np.isinf(want_d[:, -1]).all() and np.isinf(d[:, -1].numpy()).all()
    hold(d[:, :-1], want_d[:, :-1], what="dists")
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("ws,k", [(3, 4), (5, 2), (3, 12)])
def test_search_ties_take_the_earlier_offset(ws, k):
    """A constant video: every offset gives distance 0, so the result is the
    first k offsets in ``_search_offsets`` order (and with k > ws*ws the
    carried +inf entries at offset 0 after them)."""
    vid = np.full((B, 3, 8, 10, 1), 0.5, np.float32)
    z = np.zeros((B, 3, 8, 10, 2), np.float32)
    want_d, want_i = jnls.non_local_search(
        jnp.asarray(vid), {"fflow": z, "bflow": z}, ws=ws, wt=1, ps=3, k=k)
    d, i = tnls.non_local_search(t_(vid), {"fflow": t_(z), "bflow": t_(z)},
                                 ws=ws, wt=1, ps=3, k=k)
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("key", [(1, 1, 1, 3), (3, 2, 1, 5), (1, 2, 2, 3)])
def test_refine_search_and_grad(data, searches, key):
    C, s0, wt, ps = key
    vids, _ = data
    inds = searches[key][1]
    v0, v1 = vids[C], vids[C][:, ::-1].copy()
    wts = np.random.default_rng(5).random(
        jnls.refine_search(v0, v1, inds, wt, ps, s0).shape).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(jnls.refine_search(a, b, inds, wt, ps, s0) * wts)

    want = jnls.refine_search(v0, v1, inds, wt, ps, s0)
    ga, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(v0), jnp.asarray(v1))
    a, b = t_(v0).requires_grad_(True), t_(v1).requires_grad_(True)
    got = tnls.refine_search(a, b, t_(inds), wt, ps, s0)
    hold(got, want, what="refine")
    (got * t_(wts)).sum().backward()
    hold(a.grad, ga, GRAD_RTOL, "d/dvid0")
    hold(b.grad, gb, GRAD_RTOL, "d/dvid1")


@pytest.mark.parametrize("s0", [1, 2])
def test_paired_refine_and_grad(data, s0):
    vids, (ff, _) = data
    src, tgt = vids[3][0, 0], vids[3][0, 1]
    flow = ff[0, 0] if s0 == 1 else ff[0, 0, ::s0, ::s0]

    def jloss(a, b):
        return jnp.sum(jnls.paired_refine(a, b, flow, 5, s0) ** 2)

    ga, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(src),
                                             jnp.asarray(tgt))
    a, b = t_(src).requires_grad_(True), t_(tgt).requires_grad_(True)
    got = tnls.paired_refine(a, b, t_(flow), 5, s0)
    hold(got, jnls.paired_refine(src, tgt, flow, 5, s0), what="paired")
    (got**2).sum().backward()
    hold(a.grad, ga, GRAD_RTOL, "d/dsrc")
    hold(b.grad, gb, GRAD_RTOL, "d/dtgt")


def test_scale_grad():
    x = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)

    def f(v):
        return jnp.sum(jnp.sin(jnls.scale_grad(v, 0.25)) * 3.0)

    want = jax.grad(f)(jnp.asarray(x))
    v = t_(x).requires_grad_(True)
    out = tnls.scale_grad(v, 0.25)
    hold(out, x, what="forward")
    (torch.sin(out) * 3.0).sum().backward()
    hold(v.grad, want, GRAD_RTOL, "grad")


@pytest.mark.parametrize("key", [(1, 1, 1, 3), (3, 2, 1, 5), (1, 2, 2, 3)])
def test_non_local_stack_and_unfold(data, searches, key):
    C, s0, wt, ps = key
    vids, _ = data
    inds = searches[key][1]
    hold(tnls.non_local_stack(t_(vids[C]), t_(inds), wt, s0),
         jnls.non_local_stack(vids[C], inds, wt, s0), what="stack")
    hold(tnls.unfold_k(t_(vids[C]), t_(inds), 3, wt, s0),
         jnls.unfold_k(vids[C], inds, 3, wt, s0), what="unfold")


@pytest.mark.parametrize("s0,ps", [(1, 3), (2, 3), (3, 5)])
def test_fold_patches(s0, ps):
    nH, nW = -(-H // s0), -(-W // s0)
    p = np.random.default_rng(s0).standard_normal(
        (B, 2, nH, nW, ps, ps, 2)).astype(np.float32)
    shape = (B, 2, H, W, 2)
    got = tnls.fold_patches(t_(p), shape, s0)
    want = jnls.fold_patches(p, shape, s0)
    hold(got[0], want[0], what="vid")
    hold(got[1], want[1], what="weights")


def test_refine_flow_search(data):
    vids, (ff, _) = data
    src, tgt = vids[3][0, 0], vids[3][0, 2]
    want_d, want_f = jnls.refine_flow_search(src, tgt, ff[0, 0], ws=5, ps=3)
    d, f = tnls.refine_flow_search(t_(src), t_(tgt), t_(ff[0, 0]), ws=5,
                                   ps=3)
    hold(d, want_d, what="dists")
    np.testing.assert_array_equal(f.numpy(), np.asarray(want_f))


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("reduce", ["mean", "image"])
def test_ssim(data, C, reduce):
    vids, _ = data
    a, b = vids[C][0], vids[C][0, ::-1].copy()
    hold(tssim(t_(a), t_(b), reduce=reduce),
         jssim(jnp.asarray(a), jnp.asarray(b), reduce=reduce))
