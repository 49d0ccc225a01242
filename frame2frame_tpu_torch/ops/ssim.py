"""Differentiable SSIM: gaussian window 11, sigma 1.5, K1 = 0.01, K2 = 0.03.

Counterpart of ``frame2frame_tpu/ops/ssim.py`` (the reference's missing
``frame2frame.ssim`` module, imported at stnls_loss.py:384). The separable
filter pads with zeros, as the JAX package's explicit convolution pads do,
and is written as weighted sums of shifted slices: plain tensor ops on the
images' device, no library convolution (and so no TF32 question).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=8)
def _gaussian_window_np(window_size: int, sigma: float):
    x = np.arange(window_size, dtype=np.float64) - window_size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter(img, win):
    """Separable gaussian filter of img (B, H, W, C) with zero padding (the
    output has the input's size); ``win`` a sequence of k floats."""
    k = len(win)
    r = k // 2
    H, W = img.shape[1], img.shape[2]
    xp = F.pad(img, (0, 0, 0, 0, r, r))  # rows
    x = sum(float(win[i]) * xp[:, i:i + H] for i in range(k))
    xp = F.pad(x, (0, 0, r, r))  # columns
    return sum(float(win[i]) * xp[:, :, i:i + W] for i in range(k))


def ssim(img1, img2, window_size=11, sigma=1.5, data_range=1.0,
         reduce="mean"):
    """Mean SSIM over a batch; img1/img2: (B, H, W, C). Differentiable.
    ``reduce="image"`` returns per-image means (B,) instead of the scalar."""
    win = _gaussian_window_np(window_size, sigma)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu1 = _filter(img1, win)
    mu2 = _filter(img2, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter(img1 * img1, win) - mu1_sq
    s2 = _filter(img2 * img2, win) - mu2_sq
    s12 = _filter(img1 * img2, win) - mu12
    smap = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    if reduce == "image":
        return smap.mean(dim=(1, 2, 3))
    return smap.mean()
