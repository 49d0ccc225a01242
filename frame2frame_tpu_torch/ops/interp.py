"""Keys bicubic interpolation and dense warping, sample for sample as the
reference solver (tvl1flow/bicubic_interpolation.c).

Counterpart of ``frame2frame_tpu/ops/interp.py``:

- the cell index is truncated toward zero (the C ``(int)`` casts, :147-163);
- Neumann boundary (clamp) with an "out" flag that is set if ANY of the eight
  taps of the two axes clamps, so a band of one or two pixels inside the image
  is flagged too (:156-163);
- the first y tap uses ``sx``, not ``sy`` (a quirk of the C code, :159, that
  the golden flows depend on);
- ``border_out=True`` returns 0 at flagged samples (:197-198), as the solver's
  warps ask; the pyramid zoom passes ``border_out=False`` (zoom.c:76).

Images are ``(..., H, W)``: leading axes are a batch, and coordinates
broadcast against them, so one call warps several images by one flow.
"""

from __future__ import annotations

import torch


def _cubic(v0, v1, v2, v3, t):
    """Keys cubic kernel, as bicubic_interpolation.c:102-110."""
    return v1 + 0.5 * t * (
        v2 - v0 + t * (2.0 * v0 - 5.0 * v1 + 4.0 * v2 - v3
                       + t * (3.0 * (v1 - v2) + v3 - v0))
    )


def bicubic_at(img, uu, vv, border_out):
    """Bicubic samples of ``img`` (..., H, W) at the positions (uu, vv): uu is
    the x (column) coordinate, vv the y (row) coordinate. Their broadcast
    shape ends in the two sample axes; any leading axes broadcast against
    ``img``'s. Returns (..., oy, ox).

    The four taps of an axis ride on a leading axis of 4 and the sixteen
    samples come from one gather: each sample and each cubic is computed as
    it would be tap by tap, in a quarter of the launches."""
    ny, nx = img.shape[-2:]
    dtype = img.dtype
    dev = img.device
    shape = torch.broadcast_shapes(uu.shape, vv.shape, (1, 1))
    uu = uu.to(dtype).expand(shape)
    vv = vv.to(dtype).expand(shape)

    sx = torch.where(uu < 0, -1, 1)
    sy = torch.where(vv < 0, -1, 1)
    x = torch.trunc(uu).long()
    y = torch.trunc(vv).long()

    # made on the device: a host-to-device copy cannot be recorded in a graph
    taps = torch.arange(-1, 3, device=dev).view(4, *([1] * len(shape)))
    xs = x + sx * taps  # x - sx, x, x + sx, x + 2 sx
    # the first y tap uses sx (reference quirk, line 159)
    ys = torch.stack([y - sx, y, y + sy, y + 2 * sy])

    out = (((xs < 0) | (xs >= nx)).any(0) | ((ys < 0) | (ys >= ny)).any(0))
    xc = xs.clamp(0, nx - 1)
    yc = ys.clamp(0, ny - 1)

    lead = torch.broadcast_shapes(img.shape[:-2], shape[:-2])
    full = lead + shape[-2:]
    flat = img.reshape(*img.shape[:-2], ny * nx).expand(*lead, ny * nx)
    # idx[a, b]: x tap a, y tap b
    idx = yc[None, :] * nx + xc[:, None]
    idx = idx.reshape(4, 4, *([1] * (len(full) - len(shape))), *shape)
    idx = idx.expand(4, 4, *full)
    idx = idx.movedim((0, 1), (-2, -1)).reshape(*lead, -1)
    vals = torch.gather(flat, -1, idx).reshape(*full, 4, 4)
    vals = vals.movedim((-2, -1), (0, 1))

    # interpolate along y within each x column, then along x
    fy = vv - y.to(dtype)
    fx = uu - x.to(dtype)
    cols = _cubic(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3], fy)
    val = _cubic(cols[0], cols[1], cols[2], cols[3], fx)
    if border_out:
        val = torch.where(out, torch.zeros_like(val), val)
    return val


def bicubic_warp(img, u, v, border_out=True):
    """Dense bicubic warp: ``output[i, j] = img(j + u[i, j], i + v[i, j])``
    (bicubic_interpolation.c:242-266). ``u`` and ``v`` end in (H, W) and
    broadcast against ``img``'s leading axes."""
    ny, nx = img.shape[-2:]
    jj = torch.arange(nx, dtype=img.dtype, device=img.device)[None, :]
    ii = torch.arange(ny, dtype=img.dtype, device=img.device)[:, None]
    return bicubic_at(img, jj + u, ii + v, border_out)
