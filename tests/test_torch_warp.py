"""The port's warp, masks and warped losses (frame2frame_tpu_torch/ops/warp.py)
vs ``frame2frame_tpu/ops/warp.py``.

Both are plain f32 array code on the same numpy-seeded frames and flows, so
they agree to rounding: atol 1e-6 on images in [0, 1] and on 0/1 masks,
rtol 1e-5 on the summed losses (sums of ~10^3 terms in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.ops import warp as jw  # noqa: E402
from frame2frame_tpu_torch.ops import warp as tw  # noqa: E402

ATOL = 1e-6
SHAPES = [(16, 32, 1), (13, 20, 3)]


def make_flow(kind, H, W, rng):
    if kind == "subpixel":
        return (1.5 * rng.standard_normal((H, W, 2))).astype(np.float32)
    if kind == "integer":
        return rng.integers(-3, 4, (H, W, 2)).astype(np.float32)
    if kind == "leaves":  # most samples land outside the frame
        return (20.0 * rng.standard_normal((H, W, 2))).astype(np.float32)
    if kind == "zero":
        return np.zeros((H, W, 2), np.float32)
    # smooth motion with one step edge: an occlusion boundary inside a
    # frame that is otherwise kept
    flow = np.full((H, W, 2), 0.3, np.float32)
    flow[H // 2:, :, 0] += 2.0
    flow[:, W // 2:, 1] -= 1.5
    return flow


FLOWS = ["subpixel", "integer", "leaves", "zero", "edge"]


def inputs(shape, kind, seed):
    H, W, C = shape
    rng = np.random.default_rng(seed)
    img = rng.random(shape).astype(np.float32)
    other = rng.random(shape).astype(np.float32)
    return img, other, make_flow(kind, H, W, rng)


@pytest.mark.parametrize("kind", FLOWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_warp_and_masks_match_jax(shape, kind):
    img, _, flow = inputs(shape, kind, seed=1)
    want_w, want_m = jw.bilinear_warp_with_mask(jnp.asarray(img),
                                                jnp.asarray(flow))
    want_o = jw.occlusion_mask(jnp.asarray(flow), want_m)
    got_w, got_m = tw.bilinear_warp_with_mask(torch.from_numpy(img),
                                              torch.from_numpy(flow))
    got_o = tw.occlusion_mask(torch.from_numpy(flow), got_m)
    assert got_w.shape == shape and got_m.shape == shape
    assert got_o.shape == shape and got_o.dtype == torch.float32
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=ATOL)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    if kind == "zero":
        np.testing.assert_allclose(got_w.numpy(), img, atol=ATOL)
        assert got_m.min() == 1 and got_o[1:-1, 1:-1].min() == 1
        assert got_o[0].max() == 0 and got_o[:, -1].max() == 0
    if kind == "edge":
        assert 0 < got_o.mean() < 1
    if kind == "leaves":
        assert got_m.mean() < 0.5


@pytest.mark.parametrize("kind", FLOWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_warped_losses_match_jax(shape, kind):
    deno, prev, flow = inputs(shape, kind, seed=2)
    in_mask = (np.random.default_rng(3).random(shape) > 0.3).astype(np.float32)
    j = [jnp.asarray(v) for v in (deno, prev, flow)]
    t = [torch.from_numpy(v) for v in (deno, prev, flow)]
    np.testing.assert_allclose(float(tw.warped_l1_loss(*t)),
                               float(jw.warped_l1_loss(*j)), rtol=1e-5,
                               atol=ATOL)
    for crit in ("l1", "l2"):
        for tm, jm in ((None, None),
                       (torch.from_numpy(in_mask), jnp.asarray(in_mask))):
            got = float(tw.warped_dist_loss(*t, dist_crit=crit, in_mask=tm))
            want = float(jw.warped_dist_loss(*j, dist_crit=crit, in_mask=jm))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


def test_dilate_cross_matches_jax():
    m = np.random.default_rng(4).random((9, 11)) > 0.8
    want = np.asarray(jw._dilate_cross(jnp.asarray(m)))
    got = tw._dilate_cross(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() > m.sum()


def test_warped_dist_loss_rejects_unknown_criterion():
    z = torch.zeros(4, 4, 1)
    with pytest.raises(ValueError):
        tw.warped_dist_loss(z, z, torch.zeros(4, 4, 2), dist_crit="huber")


def test_warp_gradient_flows_to_the_denoised_frame():
    """The loss is differentiable in ``deno`` with the mask as its weight."""
    deno, prev, flow = (torch.from_numpy(v)
                        for v in inputs((13, 20, 1), "edge", seed=5))
    deno.requires_grad_()
    tw.warped_l1_loss(deno, prev, flow).backward()
    warped, mask = tw.bilinear_warp_with_mask(prev, flow)
    mask = tw.occlusion_mask(flow, mask)
    want = mask * torch.sign(mask * deno.detach() - mask * warped)
    np.testing.assert_allclose(deno.grad.numpy(), want.numpy(), atol=ATOL)
