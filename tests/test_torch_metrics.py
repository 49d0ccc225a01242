"""The port's quality metrics (``frame2frame_tpu_torch/utils/metrics.py``:
``psnr``, ``compute_psnrs``, ``compute_ssims``, ``compute_strred`` with
``method="spyr"`` and ``"analytic"``) against the JAX package's on 3 frames
at 48x64, within 1e-10 (the same numpy and scipy host code), on numpy
arrays and on torch tensors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frame2frame_tpu.utils import metrics as jm  # noqa: E402
from frame2frame_tpu_torch.utils import metrics as tm  # noqa: E402

TOL = dict(rtol=1e-10, atol=1e-10)
METRICS = {
    "psnrs": lambda m, a, b: m.compute_psnrs(a, b),
    "ssims": lambda m, a, b: m.compute_ssims(a, b),
    "strred_spyr": lambda m, a, b: m.compute_strred(a, b, method="spyr"),
    "strred_analytic": lambda m, a, b: m.compute_strred(a, b,
                                                        method="analytic"),
    "psnr": lambda m, a, b: m.psnr(a / 255.0, b / 255.0),
}


def video(C, seed):
    """A clean 3-frame 48x64 video in [0, 255] and a noisy copy (sigma
    25)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:48, 0:64]
    clean = np.stack([
        128 + 80 * np.sin(0.2 * xx + 0.1 * yy + t)[..., None]
        * np.ones(C) for t in range(3)]).astype(np.float32)
    noisy = clean + 25 * rng.standard_normal(clean.shape).astype(np.float32)
    return clean, noisy


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name, C):
    clean, noisy = video(C, seed=C)
    want = np.asarray(METRICS[name](jm, noisy, clean))
    got = np.asarray(METRICS[name](tm, noisy, clean))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    # torch tensors are taken to the host as they are
    got_t = np.asarray(METRICS[name](tm, torch.from_numpy(noisy),
                                     torch.from_numpy(clean)))
    np.testing.assert_allclose(got_t, want, **TOL)


def test_strred_is_zero_on_identical_videos_and_shapes():
    clean, noisy = video(3, seed=0)
    assert np.all(tm.compute_strred(clean, clean) == 0)
    assert tm.compute_strred(noisy, clean).shape == (2,)
    # one frame: spatial only, one value
    assert tm.compute_strred(noisy[:1], clean[:1]).shape == (1,)
    # (B, T, H, W, C) and (T, H, W) layouts
    np.testing.assert_allclose(tm.compute_psnrs(noisy[None], clean[None]),
                               tm.compute_psnrs(noisy, clean), **TOL)
    np.testing.assert_allclose(
        tm.compute_ssims(noisy[..., 0], clean[..., 0]),
        jm.compute_ssims(noisy[..., 0], clean[..., 0]), **TOL)


def test_ssim_single_matches_jax_on_a_grad_tensor():
    """A tensor that requires grad is detached, not refused."""
    rng = np.random.default_rng(2)
    a, b = rng.random((2, 40, 50))
    got = tm.ssim_single(torch.tensor(a, requires_grad=True), b)
    np.testing.assert_allclose(got, jm.ssim_single(a, b), **TOL)
