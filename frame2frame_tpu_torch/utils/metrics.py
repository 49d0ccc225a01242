"""Quality metrics: PSNR / SSIM / ST-RRED, host code in numpy and scipy.

The port's own copy of ``frame2frame_tpu/utils/metrics.py``, the replacement
for the reference's external ``dev_basics.utils.metrics``
(``compute_psnrs/compute_ssims/compute_strred``, test.py:25,245-252) and the
CLI's ``psnr`` helper (blind_denoising.py:36-41).

All metrics accept video arrays shaped (..., T, H, W, C) or (T, H, W) as numpy
arrays or torch tensors (on any device: they are copied to the host) and
return per-frame numpy arrays, matching the reference convention of per-frame
lists.
"""

from __future__ import annotations

import numpy as np


def _host(x):
    """A torch tensor as a numpy array on the host; anything else as is."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x


def _to_thwc(vid):
    vid = np.asarray(_host(vid), dtype=np.float64)
    if vid.ndim == 2:  # (H,W)
        vid = vid[None, ..., None]
    elif vid.ndim == 3:  # (T,H,W)
        vid = vid[..., None]
    elif vid.ndim == 5:  # (B,T,H,W,C) -> flatten batch into time
        vid = vid.reshape((-1,) + vid.shape[2:])
    return vid


def psnr(img1, img2, peak=1.0):
    """Scalar PSNR over the full (squeezed) arrays, as blind_denoising.py:36-41."""
    x = (np.asarray(_host(img1), dtype=np.float64).squeeze()
         - np.asarray(_host(img2), dtype=np.float64).squeeze()).ravel()
    return 10.0 * np.log10(peak**2 / np.mean(x**2))


def compute_psnrs(deno, clean, div=255.0):
    """Per-frame PSNR. ``div`` rescales inputs to [0,1] first (dev_basics style)."""
    deno = _to_thwc(deno) / div
    clean = _to_thwc(clean) / div
    mse = np.mean((deno - clean) ** 2, axis=(1, 2, 3))
    with np.errstate(divide="ignore"):
        return 10.0 * np.log10(1.0 / mse)


def _gaussian_kernel1d(sigma, radius):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return k / k.sum()


def _filter2d_valid(img, k1d):
    """Separable 2D 'valid' convolution with a 1D kernel (gaussian window)."""
    from scipy.ndimage import convolve1d

    out = convolve1d(img, k1d, axis=0, mode="constant")
    out = convolve1d(out, k1d, axis=1, mode="constant")
    r = len(k1d) // 2
    return out[r:-r, r:-r] if r > 0 else out


def ssim_single(img1, img2, data_range=1.0, sigma=1.5, win_size=11):
    """SSIM of a single grayscale image pair (gaussian-weighted, standard constants)."""
    img1 = np.asarray(_host(img1), dtype=np.float64)
    img2 = np.asarray(_host(img2), dtype=np.float64)
    k1, k2 = 0.01, 0.03
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    r = win_size // 2
    kern = _gaussian_kernel1d(sigma, r)

    mu1 = _filter2d_valid(img1, kern)
    mu2 = _filter2d_valid(img2, kern)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2d_valid(img1 * img1, kern) - mu1_sq
    s2 = _filter2d_valid(img2 * img2, kern) - mu2_sq
    s12 = _filter2d_valid(img1 * img2, kern) - mu12
    num = (2 * mu12 + c1) * (2 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    return float(np.mean(num / den))


def compute_ssims(deno, clean, div=255.0):
    """Per-frame SSIM (mean over channels)."""
    deno = _to_thwc(deno) / div
    clean = _to_thwc(clean) / div
    T, _, _, C = deno.shape
    out = np.zeros(T)
    for t in range(T):
        vals = [ssim_single(deno[t, ..., c], clean[t, ..., c]) for c in range(C)]
        out[t] = np.mean(vals)
    return out


# ---------------------------------------------------------------------------
# ST-RRED (reduced-reference spatio-temporal entropic differences)
#
# Faithful implementation of Soundararajan & Bovik, "Video Quality Assessment
# by Reduced Reference Spatio-Temporal Entropic Differencing" (TCSVT 2013),
# mirroring the reference-ecosystem tooling (skvideo.measure.strred, the
# metric behind dev_basics.utils.metrics.compute_strred, test.py:25,245-252):
#
# 1. one steerable-pyramid subband per frame (orientation 0 of a 6-orientation
#    pyramid at decomposition level 4) and per frame-difference;
# 2. GSM modelling of 3x3 subband blocks: eigen-decomposition of the block
#    covariance, per-block multiplier MLE, per-block Gaussian channel
#    entropies with neutral noise sigma^2 = 0.1;
# 3. entropies scaled by log2(1 + s) premultipliers; spatial RRED = mean
#    |scaled entropies (ref) - scaled entropies (dis)| per frame, temporal
#    RRED likewise on frame differences (additionally weighted by the spatial
#    premultiplier); ST-RRED = mean(srred) * mean(trred).
#
# The steerable pyramid is the analytic frequency-domain construction
# (Simoncelli & Freeman; raised-cosine radial bands x cos^(K-1) angular
# windows), not the sampled sp5 filter bank, so absolute values differ
# slightly from skvideo's; the structure and scaling of the measure are the
# published ones. The JAX package pins regression values in
# tests/test_harness.py.
# ---------------------------------------------------------------------------


def _steerable_band0(img, level=4, norient=6):
    """Orientation-0 band of an analytic frequency-domain steerable pyramid.

    Radial window: raised cosine in log2 r, one octave wide, centered so the
    band at ``level`` spans [pi/2^level, pi/2^(level-1)]. Angular window:
    alpha_K cos^(K-1)(theta), support |theta| < pi/2 (real, two-lobed).
    Returns the real subband (same shape as img).
    """
    img = np.asarray(img, dtype=np.float64)
    H, W = img.shape
    fy = np.fft.fftfreq(H)[:, None] * 2 * np.pi
    fx = np.fft.fftfreq(W)[None, :] * 2 * np.pi
    r = np.hypot(fy, fx)
    theta = np.arctan2(fy, fx)
    # radial band: the standard H/L raised-cosine transition pair,
    # band(r) = cos(pi/2 * |log2(r/(2 rc))|) on (rc, 4 rc), peak at 2 rc
    rc = np.pi / 2 ** level  # lower band edge
    band = np.zeros_like(r)
    m = (r > rc) & (r < 4 * rc)
    band[m] = np.cos(np.pi / 2 * np.abs(np.log2(r[m] / (2 * rc))))
    # angular cos^(K-1) window at orientation 0
    K = norient
    import math

    alpha = 2 ** (K - 1) * math.factorial(K - 1) / np.sqrt(
        K * math.factorial(2 * (K - 1)))
    ang = np.where(np.cos(theta) > 0, alpha * np.cos(theta) ** (K - 1), 0.0)
    ang_pi = np.where(np.cos(theta) < 0,
                      alpha * np.abs(np.cos(theta)) ** (K - 1), 0.0)
    mask = band * (ang + ang_pi)  # real (two-lobed) oriented band
    return np.real(np.fft.ifft2(np.fft.fft2(img) * mask))


_SPYR_CACHE = {}


def _make_spyr_filters(norient=6, ngrid=64):
    """Sampled spatial-domain steerable-pyramid filters (lo0 9x9, lofilt
    17x17, orientation-0 band 9x9), constructed by sampling the published
    frequency design (raised-cosine log-radial transitions, cos^(K-1)
    angular windows) and inverse-transforming — the same filter ROLES as
    matlabPyrTools' sp5Filters bank (whose numeric tables are not
    redistributable in this repository; see compute_strred notes)."""
    import math

    if norient in _SPYR_CACHE:
        return _SPYR_CACHE[norient]
    f = np.fft.fftfreq(ngrid) * 2 * np.pi
    fy, fx = f[:, None], f[None, :]
    r = np.hypot(fy, fx)
    th = np.arctan2(fy, fx)

    def lowpass(rr):
        out = np.ones_like(rr)
        m = (rr > np.pi / 4) & (rr < np.pi / 2)
        out[m] = np.cos(np.pi / 2 * np.log2(4 * rr[m] / np.pi))
        out[rr >= np.pi / 2] = 0.0
        return out

    def highband(rr):
        out = np.zeros_like(rr)
        m = (rr > np.pi / 4) & (rr < np.pi / 2)
        out[m] = np.cos(np.pi / 2 * np.log2(2 * rr[m] / np.pi))
        out[rr >= np.pi / 2] = 1.0
        return out

    K = norient
    alpha = 2 ** (K - 1) * math.factorial(K - 1) / np.sqrt(
        K * math.factorial(2 * (K - 1)))
    ang = alpha * np.cos(th) ** (K - 1)  # odd for even K -> imaginary band

    def crop(spatial, size):
        c = ngrid // 2
        h = size // 2
        return spatial[c - h:c + h + 1, c - h:c + h + 1].copy()

    def to_spatial(mask, size, imag=False):
        resp = 1j * mask if imag else mask
        sp = np.fft.fftshift(np.real(np.fft.ifft2(resp)))
        return crop(sp, size)

    lo0 = to_spatial(lowpass(r / 2), 9)
    lo0 /= lo0.sum()                      # DC gain 1
    lof = to_spatial(lowpass(r), 17)
    lof /= lof.sum()
    band = to_spatial(highband(r) * ang, 9, imag=True)
    band -= band.mean()                   # zero DC
    out = (lo0, lof, band)
    _SPYR_CACHE[norient] = out
    return out


def _spyr_band0(img, level=4, norient=6):
    """Orientation-0 subband at pyramid ``level`` via the sampled spatial
    filter bank with reflect boundaries and 2x downsampling per level —
    the structure of skvideo's SpatialSteerablePyramid.extractSingleBand
    (band=0, level=4), which backs the reference's compute_strred."""
    from scipy.ndimage import correlate

    lo0, lof, band = _make_spyr_filters(norient)
    x = correlate(np.asarray(img, np.float64), lo0, mode="reflect")
    for _ in range(level - 1):
        x = correlate(x, lof, mode="reflect")[::2, ::2]
    return correlate(x, band, mode="reflect")


def _est_params_gsm(band, blk=3, sigma_nsq=0.1):
    """GSM block model: returns (s, h) per block — multiplier MLE and local
    entropy Sum_j log2(s * lambda_j + sigma^2) over the block's Gaussian
    channels (paper eq. 7-9 structure)."""
    Hc = (band.shape[0] // blk) * blk
    Wc = (band.shape[1] // blk) * blk
    y = band[:Hc, :Wc]
    # (blk*blk, nblocks) block matrix
    b = y.reshape(Hc // blk, blk, Wc // blk, blk).transpose(0, 2, 1, 3)
    b = b.reshape(-1, blk * blk).T
    n = b.shape[1]
    cu = (b @ b.T) / max(n, 1)
    lam, V = np.linalg.eigh(cu)
    lam = np.maximum(lam, 0.0)
    # per-block multiplier MLE: s = y^T Cu^{-1} y / m (pseudo-inverse on the
    # positive eigenspace)
    proj = V.T @ b  # (m, n)
    inv_lam = np.where(lam > 1e-12, 1.0 / np.maximum(lam, 1e-12), 0.0)
    s = np.einsum("mn,m->n", proj ** 2, inv_lam) / (blk * blk)
    h = np.sum(np.log2(s[None, :] * lam[:, None] + sigma_nsq), axis=0)
    return s, h


def _extract_info(frame1, frame2, blk=3, sigma_nsq=0.1, band_fn=None):
    """Scaled spatial/temporal entropies of one frame (+ its successor)."""
    band_fn = band_fn or _steerable_band0
    y1 = band_fn(frame1)
    ydiff = band_fn(frame1 - frame2) if frame2 is not None else None
    s, h = _est_params_gsm(y1, blk, sigma_nsq)
    spatial = h * np.log2(1.0 + s)
    if ydiff is None:
        return spatial, None
    sd, hd = _est_params_gsm(ydiff, blk, sigma_nsq)
    temporal = hd * np.log2(1.0 + s) * np.log2(1.0 + sd)
    return spatial, temporal


def compute_strred(clean, deno, div=255.0, method="spyr"):
    """Per-frame-pair ST-RRED values (lower is better; 0 for identical
    videos). Returns an array of length T-1 (or length 1 for single-frame
    videos, spatial-only). The scalar reported by the reference harness
    (test.py:245-252) is the mean.

    ``method``:
    - "spyr" (default): sampled spatial steerable-pyramid band at level 4
      with per-level 2x downsampling — the structure of
      skvideo.measure.strred's extractSingleBand path;
    - "analytic": full-resolution frequency-domain band (round-2
      implementation, kept for comparison).

    External-oracle note: skvideo's absolute numbers depend on the
    matlabPyrTools sp5Filters coefficient tables, which the repository does
    not carry; both methods use filters sampled from the published frequency
    design instead. The JAX package cross-validates the two (rank
    correlation across distortion levels) and pins them in
    tests/test_harness.py; tests/test_torch_metrics.py holds these to the
    JAX package's values.
    """
    ref = _to_thwc(clean) / div * 255.0  # published metric operates on [0,255]
    dis = _to_thwc(deno) / div * 255.0
    ref = ref.mean(-1)
    dis = dis.mean(-1)
    band_fn = _spyr_band0 if method == "spyr" else _steerable_band0
    T = ref.shape[0]
    vals = []
    for t in range(max(T - 1, 1)):
        nxt_r = ref[t + 1] if T > 1 else None
        nxt_d = dis[t + 1] if T > 1 else None
        sref, tref = _extract_info(ref[t], nxt_r, band_fn=band_fn)
        sdis, tdis = _extract_info(dis[t], nxt_d, band_fn=band_fn)
        srred = float(np.mean(np.abs(sref - sdis)))
        if T > 1:
            trred = float(np.mean(np.abs(tref - tdis)))
            vals.append(srred * trred)
        else:
            vals.append(srred)
    return np.asarray(vals)
