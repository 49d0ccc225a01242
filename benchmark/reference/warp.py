"""The flow warp and the occlusion mask of the online fine-tune, a frozen
copy in plain PyTorch ops of the reference's ``WarpedLoss``
(``blind_denoising.py``): the previous frame sampled bilinearly at (x + u,
y + v), zero outside the image; the validity mask is the bilinear sample of
an all-ones image thresholded at 0.9999; the occlusion mask thresholds the
flow's |du/dy + dv/dx| at 0.75, dilates it with a 3x3 cross, marks the
one-pixel border occluded, and is ANDed with the validity mask.

Images are (H, W, C), flows (H, W, 2) with ``flow[..., 0]`` the x
displacement.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_warp_with_mask(img, flow):
    """Warp ``img`` by ``flow`` and return (warped, validity_mask).

    The validity mask is the bilinear sample of an all-ones image thresholded
    at 0.9999 (blind_denoising.py:73-76): 1 where the sample was fully
    interpolated from in-bounds pixels, 0 otherwise.
    """
    H, W, C = img.shape
    dtype = img.dtype
    xx = torch.arange(W, dtype=dtype, device=img.device)[None, :]
    yy = torch.arange(H, dtype=dtype, device=img.device)[:, None]
    sx = xx + flow[..., 0]
    sy = yy + flow[..., 1]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    flat = img.reshape(H * W, C)

    def corner(ix, iy, w):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
        vals = flat[idx.reshape(-1)].reshape(H, W, C)
        w_in = torch.where(inb, w, torch.zeros_like(w))
        return vals * w_in[..., None], w_in

    v00, w00 = corner(x0i, y0i, (1 - wx) * (1 - wy))
    v01, w01 = corner(x0i + 1, y0i, wx * (1 - wy))
    v10, w10 = corner(x0i, y0i + 1, (1 - wx) * wy)
    v11, w11 = corner(x0i + 1, y0i + 1, wx * wy)

    warped = v00 + v01 + v10 + v11
    ones_sampled = w00 + w01 + w10 + w11
    mask = (ones_sampled >= 0.9999).to(dtype)
    return warped, mask[..., None].expand(H, W, C).contiguous()


def _dilate_cross(m):
    """Binary dilation with the 3x3 cross structuring element
    (blind_denoising.py:97-103), zero padding: an OR of the 4 axis shifts."""
    up = F.pad(m[1:, :], (0, 0, 0, 1))
    down = F.pad(m[:-1, :], (0, 0, 1, 0))
    left = F.pad(m[:, 1:], (0, 1))
    right = F.pad(m[:, :-1], (1, 0))
    return m | up | down | left | right


def occlusion_mask(flow, old_mask, thresh=0.75):
    """Occlusion mask from the flow 'divergence' (blind_denoising.py:81-113).

    The reference computes ``a = d(u)/dy`` (u differenced along rows) and
    ``b = d(v)/dx`` (v differenced along cols), thresholds |a+b| > 0.75,
    dilates with a 3x3 cross, forces the 1px border occluded, then inverts
    and ANDs with the sampling validity mask. The (H, W, 1) result
    broadcasts against ``old_mask`` (H, W, C).
    """
    u = flow[..., 0]
    v = flow[..., 1]
    a = torch.zeros_like(u)
    a[:-1, :] = u[1:, :] - u[:-1, :]
    b = torch.zeros_like(v)
    b[:, :-1] = v[:, 1:] - v[:, :-1]
    occ = _dilate_cross((a + b).abs() > thresh)
    occ[0, :] = True
    occ[-1, :] = True
    occ[:, 0] = True
    occ[:, -1] = True
    good = (~occ).to(flow.dtype)[..., None]
    return old_mask * good
