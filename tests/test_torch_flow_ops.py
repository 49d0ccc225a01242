"""The flow solver's operators of the port (frame2frame_tpu_torch/ops/grad.py,
gaussian.py, interp.py, pyramid.py) vs the JAX package's, on the same
numpy-seeded inputs.

Tolerances. Images are on [0, 255]; both sides run the same f32 operations in
the same order, and XLA may contract a product and a sum into one rounding
where PyTorch rounds twice: rtol 1e-6, atol 1e-4. The integer functions
(pyramid shapes, number of scales) are held exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.ops import gaussian as jgauss  # noqa: E402
from frame2frame_tpu.ops import grad as jgrad  # noqa: E402
from frame2frame_tpu.ops import interp as jinterp  # noqa: E402
from frame2frame_tpu.ops import pyramid as jpyr  # noqa: E402
from frame2frame_tpu_torch.ops import gaussian as tgauss  # noqa: E402
from frame2frame_tpu_torch.ops import grad as tgrad  # noqa: E402
from frame2frame_tpu_torch.ops import interp as tinterp  # noqa: E402
from frame2frame_tpu_torch.ops import pyramid as tpyr  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-4)
SHAPES = [(16, 32), (13, 21), (9, 15)]
ZOOM_SIGMA = tpyr.ZOOM_SIGMA_ZERO * np.sqrt(1.0 / 0.25 - 1.0)  # 1.039...


def image(shape, seed=0):
    """A smooth texture plus noise on [0, 255], f32."""
    rng = np.random.default_rng(seed)
    ny, nx = shape[-2:]
    yy, xx = np.mgrid[0:ny, 0:nx]
    img = 128 + 60 * np.sin(0.4 * xx + 0.3 * yy) + 40 * rng.standard_normal(shape)
    return np.clip(img, 0, 255).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES + [(1, 1), (2, 3), (1, 5), (4, 1)])
def test_divergence_and_forward_gradient(shape):
    a, b = image(shape, 1), image(shape, 2)
    close(tgrad.divergence(torch.from_numpy(a), torch.from_numpy(b)),
          jgrad.divergence(jnp.asarray(a), jnp.asarray(b)))
    for got, want in zip(tgrad.forward_gradient(torch.from_numpy(a)),
                         jgrad.forward_gradient(jnp.asarray(a))):
        assert got.shape == want.shape
        close(got, want)


@pytest.mark.parametrize("shape", SHAPES + [(1, 1), (2, 3)])
def test_centered_gradient(shape):
    a = image(shape, 3)
    for got, want in zip(tgrad.centered_gradient(torch.from_numpy(a)),
                         jgrad.centered_gradient(jnp.asarray(a))):
        close(got, want)


def test_grad_ops_take_a_batch():
    """Leading axes are a batch: each slice equals the 2-D call, bit for
    bit."""
    a, b = (torch.from_numpy(image((3, 13, 21), s)) for s in (4, 5))
    div = tgrad.divergence(a, b)
    fx, fy = tgrad.forward_gradient(a)
    cx, cy = tgrad.centered_gradient(a)
    for k in range(3):
        assert torch.equal(div[k], tgrad.divergence(a[k], b[k]))
        assert torch.equal(fx[k], tgrad.forward_gradient(a[k])[0])
        assert torch.equal(fy[k], tgrad.forward_gradient(a[k])[1])
        assert torch.equal(cx[k], tgrad.centered_gradient(a[k])[0])
        assert torch.equal(cy[k], tgrad.centered_gradient(a[k])[1])


@pytest.mark.parametrize("sigma", [0.8, ZOOM_SIGMA])
@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_smooth(shape, sigma):
    a = image(shape, 6)
    assert np.array_equal(tgauss.gaussian_kernel(float(sigma)),
                          jgauss.gaussian_kernel(float(sigma)))
    close(tgauss.gaussian_smooth(torch.from_numpy(a), sigma),
          jgauss.gaussian_smooth(jnp.asarray(a), sigma))


def test_gaussian_smooth_batch_and_zero_sigma():
    a = torch.from_numpy(image((2, 13, 21), 7))
    out = tgauss.gaussian_smooth(a, 0.8)
    for k in range(2):
        assert torch.equal(out[k], tgauss.gaussian_smooth(a[k], 0.8))
    assert tgauss.gaussian_smooth(a, 0.0) is a


@pytest.mark.parametrize("border_out", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bicubic_at_scattered_positions(shape, border_out):
    """Positions inside, in the border band, outside and negative."""
    ny, nx = shape
    rng = np.random.default_rng(8)
    a = image(shape, 9)
    uu = rng.uniform(-3.5, nx + 2.5, (11, 17)).astype(np.float32)
    vv = rng.uniform(-3.5, ny + 2.5, (11, 17)).astype(np.float32)
    # exact integers and the band of one or two pixels inside the image
    uu[0, :6] = [-1.0, 0.0, 0.5, 1.0, nx - 2.0, nx - 1.0]
    vv[0, :6] = [-0.5, 0.0, 1.5, 1.0, ny - 1.5, ny - 1.0]
    got = tinterp.bicubic_at(torch.from_numpy(a), torch.from_numpy(uu),
                             torch.from_numpy(vv), border_out)
    want = jinterp.bicubic_at(jnp.asarray(a), jnp.asarray(uu),
                              jnp.asarray(vv), border_out)
    close(got, want)
    if border_out:
        assert (got == 0).any()


@pytest.mark.parametrize("border_out", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bicubic_warp(shape, border_out):
    rng = np.random.default_rng(10)
    a = image(shape, 11)
    u = rng.uniform(-2.5, 2.5, shape).astype(np.float32)
    v = rng.uniform(-2.5, 2.5, shape).astype(np.float32)
    got = tinterp.bicubic_warp(torch.from_numpy(a), torch.from_numpy(u),
                               torch.from_numpy(v), border_out)
    close(got, jinterp.bicubic_warp(jnp.asarray(a), jnp.asarray(u),
                                    jnp.asarray(v), border_out))


def test_bicubic_warp_of_a_stack_by_one_flow():
    """Several images warped by one flow in one call, and a batch of pairs:
    each image's result is what it gets alone, bit for bit."""
    rng = np.random.default_rng(12)
    imgs = torch.from_numpy(image((2, 3, 13, 21), 13))
    u = torch.from_numpy(rng.uniform(-2, 2, (2, 13, 21)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-2, 2, (2, 13, 21)).astype(np.float32))
    out = tinterp.bicubic_warp(imgs, u[:, None], v[:, None])
    assert out.shape == imgs.shape
    for p in range(2):
        for k in range(3):
            assert torch.equal(out[p, k],
                               tinterp.bicubic_warp(imgs[p, k], u[p], v[p]))


@pytest.mark.parametrize("size", [(960, 540), (128, 96), (33, 17)])
def test_pyramid_shapes_and_num_scales(size):
    nx, ny = size
    for nscales in (100, 3, 1):
        for zfactor in (0.5, 0.7):
            ns = tpyr.num_scales(nx, ny, nscales, zfactor)
            assert ns == jpyr.num_scales(nx, ny, nscales, zfactor)
            assert (tpyr.pyramid_shapes(nx, ny, ns, zfactor)
                    == jpyr.pyramid_shapes(nx, ny, ns, zfactor))
    assert tpyr.zoom_size(nx, ny, 0.5) == jpyr.zoom_size(nx, ny, 0.5)


def test_pyramid_of_a_540p_frame():
    """Seven levels, of which the denoising parameters solve five."""
    assert tpyr.num_scales(960, 540, 100, 0.5) == 7
    assert tpyr.pyramid_shapes(960, 540, 7, 0.5) == [
        (960, 540), (480, 270), (240, 135), (120, 68), (60, 34), (30, 17),
        (15, 9)]


@pytest.mark.parametrize("shape", [(32, 48), (17, 33), (13, 21)])
def test_zoom_out(shape):
    a = image(shape, 14)
    nxx, nyy = tpyr.zoom_size(shape[1], shape[0], 0.5)
    close(tpyr.zoom_out(torch.from_numpy(a), 0.5, (nyy, nxx)),
          jpyr.zoom_out(jnp.asarray(a), 0.5, (nyy, nxx)))


@pytest.mark.parametrize("shapes", [((16, 24), (32, 48)), ((9, 15), (17, 30)),
                                    ((34, 60), (68, 120)), ((7, 11), (13, 21))])
def test_zoom_in(shapes):
    """Up to an even and to an odd size: the sample positions divide by a
    factor that is not a power of two."""
    small, big = shapes
    a = image(small, 15)
    close(tpyr.zoom_in(torch.from_numpy(a), big),
          jpyr.zoom_in(jnp.asarray(a), big))


def test_zoom_positions_divide_by_the_rounded_factor():
    """arange / factor with the factor rounded to f32 first, a true division:
    the positions equal numpy's f32 division bit for bit."""
    like = torch.zeros(1)
    for n, factor in ((135, 135 / 68), (17, 17 / 9), (30, 30 / 17), (9, 0.5)):
        want = np.arange(n, dtype=np.float32) / np.float32(factor)
        assert np.array_equal(tpyr._positions(n, factor, like).numpy(), want)


def test_zoom_takes_a_batch():
    a = torch.from_numpy(image((2, 17, 33), 16))
    out = tpyr.zoom_out(a, 0.5, (9, 17))
    up = tpyr.zoom_in(a, (34, 66))
    for k in range(2):
        assert torch.equal(out[k], tpyr.zoom_out(a[k], 0.5, (9, 17)))
        assert torch.equal(up[k], tpyr.zoom_in(a[k], (34, 66)))
