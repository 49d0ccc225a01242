"""Separable Gaussian smoothing with the reference solver's semantics
(tvl1flow/mask.c:223-339).

Counterpart of ``frame2frame_tpu/ops/gaussian.py``:

- half-width ``size = int(5 * sigma) + 1`` (mask.c:234), taps ``B[i] =
  exp(-i^2 / (2 sigma^2)) / (sigma sqrt(2 pi))`` normalised by ``2 * sum(B) -
  B[0]`` (mask.c:245-255), built on the host in float64;
- only offsets ``|j| <= size - 1`` are summed (mask.c:288-293);
- asymmetric reflecting boundary (mask.c:273-277): the left edge mirrors about
  index 0 without the edge pixel (``I[-p] = I[p]``), the right edge with it
  (``I[n-1+p] = I[n-p]``);
- rows first, then the columns of the row-smoothed image.

The sum is taken tap by tap in the order of the reference, ``B[0] * x`` and
then ``+ B[j] * (x[i-j] + x[i+j])`` for rising j. A library convolution sums
in an order of its own and is not used.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def gaussian_kernel(sigma: float):
    """Half-kernel B[0..size-1] (mask.c:243-255) as numpy float64."""
    size = int(5 * sigma) + 1
    i = np.arange(size, dtype=np.float64)
    B = np.exp(-(i * i) / (2.0 * sigma * sigma)) / (sigma * np.sqrt(2.0 * np.pi))
    norm = 2.0 * B.sum() - B[0]
    return B / norm


def _reflect_pad_1d(x, m, axis):
    """Pad ``axis`` by ``m`` on both sides with the solver's asymmetric
    reflecting boundary."""
    if m == 0:
        return x
    n = x.shape[axis]
    # left: positions -1..-m hold I[1]..I[m] (mirror about 0, edge excluded)
    left = x.narrow(axis, 1, m).flip(axis)
    # right: positions n..n+m-1 hold I[n-1]..I[n-m] (mirror with the edge)
    right = x.narrow(axis, n - m, m).flip(axis)
    return torch.cat([left, x, right], dim=axis)


def _conv_sym_1d(x, B, axis):
    """out[i] = B[0] * x[i] + sum_j B[j] * (x[i-j] + x[i+j]), j = 1..size-1,
    added in that order; ``B`` a sequence of Python floats."""
    size = len(B)
    m = size - 1
    xp = _reflect_pad_1d(x, m, axis)
    n = x.shape[axis]
    out = B[0] * xp.narrow(axis, m, n)
    for j in range(1, size):
        out = out + B[j] * (xp.narrow(axis, m - j, n) + xp.narrow(axis, m + j, n))
    return out


def gaussian_smooth(img, sigma):
    """Separable Gaussian blur of ``(..., H, W)`` tensors; rows then columns.
    The taps are rounded to the image's dtype before they multiply."""
    if sigma <= 0:
        return img
    B = torch.from_numpy(gaussian_kernel(float(sigma))).to(img.dtype).tolist()
    out = _conv_sym_1d(img, B, axis=-1)   # rows pass (along x)
    return _conv_sym_1d(out, B, axis=-2)  # columns pass (along y)
