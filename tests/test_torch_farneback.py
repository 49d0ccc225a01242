"""The port's Farneback flow (``frame2frame_tpu_torch/flow/farneback.py``)
on the CPU: the JAX package's oracles of ``tests/test_farneback.py`` run on
the port (known translations recovered, the ``run_flows`` dispatch), and the
port's solver held against the JAX solver on one numpy-seeded pair."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from frame2frame_tpu.flow import farneback as jfb  # noqa: E402
from frame2frame_tpu_torch.flow import api as tapi  # noqa: E402
from frame2frame_tpu_torch.flow import farneback as tfb  # noqa: E402

# the port against the JAX solver, px: the same f32 operations in the same
# order on both sides, apart from XLA's fusion of multiply-adds, measured
# 6e-7 on a flow of 1.5 px
JAX_ATOL = 1e-5


def _textured(h, w, pad, seed=0):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    base = np.zeros((h + 2 * pad, w + 2 * pad))
    for s, amp in ((1.0, 0.5), (2.0, 1.0), (4.0, 2.0), (8.0, 4.0)):
        base += amp * gaussian_filter(rng.standard_normal(base.shape), s)
    base = 255 * (base - base.min()) / np.ptp(base)
    return base.astype(np.float32)


def _interior(err, margin=18):
    return err[margin:-margin, margin:-margin]


@pytest.fixture(scope="module")
def pair():
    """A 64 x 80 pair moved by (1, -1) px, and the JAX solver's flow of it
    with 3 levels (the coarsest 16 x 20)."""
    h, w, pad = 64, 80, 4
    base = _textured(h, w, pad, seed=7)
    I0 = base[pad:pad + h, pad:pad + w]
    I1 = base[pad + 1:pad + 1 + h, pad - 1:pad - 1 + w]
    want = np.asarray(jfb.make_farneback_solver(w, h, levels=3)(I0, I1))
    return I0, I1, want


def test_solver_matches_the_jax_solver(pair):
    I0, I1, want = pair
    h, w = I0.shape
    got = tfb.make_farneback_solver(w, h, levels=3, device="cpu")(I0, I1)
    assert got.shape == (h, w, 2) and got.dtype == torch.float32
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_ATOL)
    # a batch of pairs is the same solve, pair by pair
    both = tfb.make_batched_farneback(w, h, device="cpu", levels=3)(
        np.stack([I0, I1]), np.stack([I1, I0]))
    assert both.shape == (2, h, w, 2)
    assert torch.equal(both[0], got)
    single = tfb.make_farneback_solver(w, h, levels=3, device="cpu")(I1, I0)
    assert torch.equal(both[1], single)


def test_host_helpers_match_the_jax_package():
    for n, sigma in ((5, 1.2), (7, 1.5), (3, 0.9)):
        np.testing.assert_array_equal(tfb._poly_inv(n, sigma),
                                      jfb._poly_inv(n, sigma))
    assert tfb.DEFAULT_PARAMS == jfb.DEFAULT_PARAMS
    mixed = dict(levels=3, tau=0.25, winsize=9, lambda_=0.2, poly_n=7)
    assert tfb.fb_params(mixed) == jfb.fb_params(mixed)


def test_integer_translation_recovered():
    h, w, pad = 96, 128, 8
    base = _textured(h, w, pad)
    sx, sy = 2, -1
    I0 = base[pad:pad + h, pad:pad + w]
    # I1(p) = I0(p - s), so I0(p) = I1(p + s): the flow is (sx, sy)
    I1 = base[pad - sy:pad - sy + h, pad - sx:pad - sx + w]
    flow = tfb.make_farneback_solver(w, h, levels=3, device="cpu")(I0, I1)
    flow = flow.numpy()
    ex = _interior(flow[..., 0] - sx)
    ey = _interior(flow[..., 1] - sy)
    assert abs(np.median(ex)) < 0.1 and abs(np.median(ey)) < 0.1
    assert np.mean(np.hypot(ex, ey)) < 0.35


def test_subpixel_translation_recovered():
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def img(ox, oy):
        v = (np.sin(0.23 * (xx + ox)) + np.cos(0.31 * (yy + oy))
             + 0.5 * np.sin(0.11 * (xx + ox) + 0.17 * (yy + oy)))
        return (127.5 + 50 * v).astype(np.float32)

    sx, sy = 0.6, -0.4
    I0, I1 = img(0, 0), img(-sx, -sy)
    flow = tfb.make_farneback_solver(w, h, levels=2, device="cpu")(I0, I1)
    flow = flow.numpy()
    ex = _interior(flow[..., 0] - sx)
    ey = _interior(flow[..., 1] - sy)
    assert abs(np.median(ex)) < 0.15 and abs(np.median(ey)) < 0.15


def test_run_flows_cv2_dispatch_and_conventions():
    h, w, pad, T = 64, 80, 6, 3
    base = _textured(h, w, pad, seed=3)
    vid = np.stack([base[pad + t:pad + t + h, pad + t:pad + t + w]
                    for t in range(T)])[..., None]
    out = tapi.run_flows(vid, ftype="cv2", device="cpu", levels=3)
    assert out.fflow.shape == (1, T, h, w, 2)
    assert out.bflow.shape == (1, T, h, w, 2)
    # frame_{t+1}(p) = frame_t(p + 1): fflow ~ (-1, -1), bflow ~ (+1, +1);
    # the boundary frames are zero (lightning.py:299-301)
    assert not out.fflow[0, -1].any() and not out.bflow[0, 0].any()
    ff = out.fflow[0, 0, 16:-16, 16:-16].numpy()
    bf = out.bflow[0, 1, 16:-16, 16:-16].numpy()
    assert abs(np.median(ff[..., 0]) + 1) < 0.25
    assert abs(np.median(ff[..., 1]) + 1) < 0.25
    assert abs(np.median(bf[..., 0]) - 1) < 0.25
    assert abs(np.median(bf[..., 1]) - 1) < 0.25
    # the flows are the batched solver's, with TV-L1's keys left out
    solver = tfb.make_batched_farneback(w, h, device="cpu",
                                        **dict(tfb.DEFAULT_PARAMS, levels=3))
    g = torch.from_numpy(vid[..., 0])
    assert torch.equal(out.fflow[0, :-1], solver(g[:-1], g[1:]))
    mixed = tapi.run_flows(vid, ftype="cv2", device="cpu", levels=3,
                           tau=0.1, fscale=0)
    assert torch.equal(mixed.bflow, out.bflow)


def test_svnlb_is_tvl1_alias_and_cv2_differs():
    h, w, pad, T = 48, 64, 6, 2
    base = _textured(h, w, pad, seed=5)
    vid = np.stack([base[pad + t:pad + t + h, pad + t:pad + t + w]
                    for t in range(T)])[..., None]
    tv = tapi.run_flows(vid, ftype="tvl1", device="cpu")
    sv = tapi.run_flows(vid, ftype="svnlb", device="cpu")
    assert torch.equal(tv.bflow, sv.bflow)
    cv = tapi.run_flows(vid, ftype="cv2", device="cpu", levels=2)
    assert not torch.equal(cv.bflow, tv.bflow)


def test_unknown_ftype_raises():
    with pytest.raises(ValueError, match="unknown flow type"):
        tapi.run_flows(np.zeros((2, 8, 8), np.float32), ftype="nope",
                       device="cpu")
