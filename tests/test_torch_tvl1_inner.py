"""The TV-L1 inner loop of the port (frame2frame_tpu_torch/flow/tvl1_inner.py)
vs the JAX package's Pallas kernel itself, in interpret mode
(frame2frame_tpu.flow.tvl1_pallas.tvl1_inner_loop).

On a CPU tensor ``tvl1_inner_loop`` computes ``tvl1_inner_loop_plain``. Both
sides get the same numpy arrays, built the way ``_tvl1_scale`` builds them:
a smooth texture pair, the second image and its gradients warped by a
starting flow.

Tolerance. Both run the same f32 operations in the same order; they differ
where XLA contracts a product and a sum into one rounding, and in the error
sum, which the port takes in double: outputs within 1e-5 absolute on flows of
a pixel or so, as long as both stop at the same iteration. The batched loop
equals the single one bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.flow import tvl1_pallas as jinner  # noqa: E402
from frame2frame_tpu_torch.flow import tvl1_inner as tinner  # noqa: E402
from frame2frame_tpu_torch.ops.grad import centered_gradient  # noqa: E402
from frame2frame_tpu_torch.ops.interp import bicubic_warp  # noqa: E402

PARAMS = dict(tau=0.25, lambda_=0.2, theta=0.3, epsilon=0.01)
ATOL = 1e-5


def inner_inputs(shape, seed=0, shift=(1.3, -0.7), p_scale=0.2):
    """The ten arrays of one launch as numpy f32, in the wrapper's order."""
    rng = np.random.default_rng(seed)
    ny, nx = shape
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)

    def scene(y, x):
        return (128 + 50 * np.sin(0.31 * x + 0.17 * y) + 40 * np.cos(0.23 * y)
                + 30 * np.sin(0.11 * x * y / max(ny, 1)))

    I0 = torch.from_numpy(scene(yy, xx).astype(np.float32))
    I1 = torch.from_numpy(scene(yy + shift[1], xx + shift[0]).astype(np.float32))
    u1 = torch.from_numpy((0.5 * shift[0] + 0.2 * rng.standard_normal(shape))
                          .astype(np.float32))
    u2 = torch.from_numpy((0.5 * shift[1] + 0.2 * rng.standard_normal(shape))
                          .astype(np.float32))
    I1x, I1y = centered_gradient(I1)
    I1w, I1wx, I1wy = (bicubic_warp(x, u1, u2, border_out=True)
                       for x in (I1, I1x, I1y))
    grad = I1wx * I1wx + I1wy * I1wy
    rho_c = I1w - I1wx * u1 - I1wy * u2 - I0
    ps = [torch.from_numpy((p_scale * rng.standard_normal(shape))
                           .astype(np.float32)) for _ in range(4)]
    return [x.numpy() for x in (I1wx, I1wy, rho_c, grad, u1, u2, *ps)]


def run_torch(arrays, max_iters, **kw):
    return tinner.tvl1_inner_loop(*(torch.from_numpy(a) for a in arrays),
                                  max_iters=max_iters, **PARAMS, **kw)


@pytest.mark.parametrize("max_iters", [1, 5, 30])
@pytest.mark.parametrize("shape", [(48, 64), (13, 21), (9, 15)])
def test_plain_matches_the_pallas_kernel(shape, max_iters):
    arrays = inner_inputs(shape, seed=shape[0] + max_iters)
    want = jinner.tvl1_inner_loop(*(jnp.asarray(a) for a in arrays),
                                  PARAMS["tau"], PARAMS["lambda_"],
                                  PARAMS["theta"], PARAMS["epsilon"], max_iters)
    got, stats = run_torch(arrays, max_iters, return_iterations=True)
    assert stats.shape == (1, 2) and 1 <= int(stats[0, 0]) <= max_iters
    for name, g, w in zip(("u1", "u2", "p11", "p12", "p21", "p22"), got, want):
        assert g.shape == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL,
                                   err_msg=name)
    # the state moved: the comparison is not of two copies of the input
    assert np.abs(got[0].numpy() - arrays[4]).max() > 1e-3


@pytest.mark.parametrize("shape", [(1, 1), (2, 3)])
def test_plain_matches_the_pallas_kernel_with_borders_only(shape):
    """Frames with nothing between the borders: every pixel takes a border
    rule of the divergence and of the forward gradient."""
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(10)]
    arrays[3] = arrays[0] ** 2 + arrays[1] ** 2
    want = jinner.tvl1_inner_loop(*(jnp.asarray(a) for a in arrays),
                                  0.25, 0.2, 0.3, 0.01, 4)
    got = run_torch(arrays, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_loop_stops_on_the_error():
    """With the reference's 300 iterations allowed the loop ends early on the
    error, and one more allowed iteration changes nothing."""
    arrays = inner_inputs((24, 40), seed=5, p_scale=0.0)
    got, stats = run_torch(arrays, 300, return_iterations=True)
    n, err = int(stats[0, 0]), float(stats[0, 1])
    assert 1 < n < 300 and err <= np.float32(1e-4)
    again, stats2 = run_torch(arrays, n + 1, return_iterations=True)
    assert int(stats2[0, 0]) == n
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    shorter, stats3 = run_torch(arrays, n - 1, return_iterations=True)
    assert int(stats3[0, 0]) == n - 1 and float(stats3[0, 1]) > 1e-4


def test_batched_equals_single_bit_for_bit():
    """Pairs that stop at different iterations: each pair's result in the
    batch is its result alone, and a stopped pair no longer changes."""
    shape = (20, 36)
    pairs = [inner_inputs(shape, seed=7, shift=(0.2, 0.1), p_scale=0.0),
             inner_inputs(shape, seed=8, shift=(2.5, -1.5), p_scale=0.3),
             inner_inputs(shape, seed=9, shift=(1.0, 0.8), p_scale=0.05),
             inner_inputs(shape, seed=10, shift=(0.0, 0.0), p_scale=0.0)]
    batch = [np.stack([p[k] for p in pairs]) for k in range(10)]
    got, stats = run_torch(batch, 300, return_iterations=True)
    counts = [int(n) for n in stats[:, 0]]
    assert len(set(counts)) > 2, counts
    for q, arrays in enumerate(pairs):
        alone, s = run_torch(arrays, 300, return_iterations=True)
        assert int(s[0, 0]) == counts[q]
        assert float(s[0, 1]) == float(stats[q, 1])
        for a, b in zip(alone, got):
            assert torch.equal(a, b[q])


def test_zero_iterations_return_the_state():
    arrays = inner_inputs((9, 15), seed=11)
    got, stats = run_torch(arrays, 0, return_iterations=True)
    assert int(stats[0, 0]) == 0 and np.isinf(float(stats[0, 1]))
    for g, a in zip(got, arrays[4:]):
        assert np.array_equal(g.numpy(), a)


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    arrays = [torch.from_numpy(a) for a in inner_inputs((9, 15), seed=12)]
    if bad == "dtype":
        arrays[2] = arrays[2].double()
        exc = TypeError
    elif bad == "shape":
        arrays[7] = arrays[7][:, :-1]
        exc = ValueError
    else:
        arrays = [a[None, None] for a in arrays]
        exc = ValueError
    with pytest.raises(exc, match="tvl1_inner_loop"):
        tinner.tvl1_inner_loop(*arrays, max_iters=3, **PARAMS)
    if bad == "dtype":
        with pytest.raises(TypeError, match="f32 only"):
            tinner.tvl1_inner_loop(*(a.to(torch.bfloat16) for a in arrays),
                                   max_iters=3, **PARAMS)


def test_wrapper_refuses_a_device_without_a_kernel():
    arrays = [torch.zeros(4, 6, device="meta") for _ in range(10)]
    with pytest.raises(ValueError, match="no kernel for meta"):
        tinner.tvl1_inner_loop(*arrays, max_iters=3, **PARAMS)
    assert tinner.tvl1_inner_loop.launches == 0
