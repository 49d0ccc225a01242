"""Image pyramid zoom of the reference solver (tvl1flow/zoom.c).

Counterpart of ``frame2frame_tpu/ops/pyramid.py``. The shapes of the levels
are host integers from Python float arithmetic; the zooms take
``(..., H, W)`` tensors.
"""

from __future__ import annotations

import math

import torch

from .gaussian import gaussian_smooth
from .interp import bicubic_at

ZOOM_SIGMA_ZERO = 0.6


def zoom_size(nx, ny, factor):
    """New size after zooming (zoom.c:24-36): round half up by +0.5 and
    truncation."""
    return int(nx * factor + 0.5), int(ny * factor + 0.5)


def pyramid_shapes(nx, ny, nscales, zfactor):
    """(nx, ny) of every scale, finest first (tvl1flow_lib.c:400-414)."""
    shapes = [(nx, ny)]
    for _ in range(1, nscales):
        nxs, nys = zoom_size(shapes[-1][0], shapes[-1][1], zfactor)
        shapes.append((nxs, nys))
    return shapes


def num_scales(nx, ny, nscales, zfactor):
    """``nscales`` clamped so that the coarsest level keeps 16 px
    (main.c:159-163)."""
    N = 1 + math.log(math.hypot(nx, ny) / 16.0) / math.log(1.0 / zfactor)
    if N < nscales:
        nscales = int(N)
    return max(nscales, 1)


def _positions(n, factor, like):
    """``arange(n) / factor`` in ``like``'s dtype. The factor is rounded to
    that dtype first and the division is a true one, tensor by tensor: a
    Python-scalar divisor may be turned into a multiplication by its
    reciprocal, which moves a position by one bit and can flip a truncation."""
    f = torch.full((), factor, dtype=like.dtype, device=like.device)
    return torch.arange(n, dtype=like.dtype, device=like.device) / f


def zoom_out(img, factor, out_shape):
    """Anti-aliased downsample (zoom.c:43-81): Gaussian, then bicubic
    resampling. ``out_shape`` is (ny_out, nx_out) from :func:`zoom_size`."""
    nyy, nxx = out_shape
    sigma = ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (factor * factor) - 1.0)
    Is = gaussian_smooth(img, sigma)
    j2 = _positions(nxx, factor, img)
    i2 = _positions(nyy, factor, img)
    return bicubic_at(Is, j2[None, :], i2[:, None], border_out=False)


def zoom_in(img, out_shape):
    """Bicubic upsample to an explicit target size (zoom.c:89-115)."""
    ny, nx = img.shape[-2:]
    nyy, nxx = out_shape
    j2 = _positions(nxx, nxx / nx, img)
    i2 = _positions(nyy, nyy / ny, img)
    return bicubic_at(img, j2[None, :], i2[:, None], border_out=False)
