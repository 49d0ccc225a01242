"""Gradient and divergence operators with the border rules of the reference
TV-L1 solver (tvl1flow/mask.c:43-215).

Counterpart of ``frame2frame_tpu/ops/grad.py``. Every function takes and
returns ``(..., H, W)`` tensors: leading axes are a batch, so the batched
solver needs no ``vmap``.
"""

from __future__ import annotations

import torch


def divergence(v1, v2):
    """Backward-difference divergence (mask.c:43-94): column 0 keeps v1,
    column nx-1 contributes -v1[..., nx-2]; the same for the rows of v2."""
    dx = torch.cat([v1[..., :, :1], v1[..., :, 1:-1] - v1[..., :, :-2],
                    -v1[..., :, -2:-1]], dim=-1)
    dy = torch.cat([v2[..., :1, :], v2[..., 1:-1, :] - v2[..., :-2, :],
                    -v2[..., -2:-1, :]], dim=-2)
    return dx + dy


def forward_gradient(f):
    """Forward differences with a zero last column (fx) and last row (fy)
    (mask.c:103-148)."""
    fx = torch.cat([f[..., :, 1:] - f[..., :, :-1],
                    torch.zeros_like(f[..., :, :1])], dim=-1)
    fy = torch.cat([f[..., 1:, :] - f[..., :-1, :],
                    torch.zeros_like(f[..., :1, :])], dim=-2)
    return fx, fy


def centered_gradient(f):
    """Centered differences with one-sided halves at the borders
    (mask.c:156-215): half the central difference of the edge-replicated
    image."""
    fpx = torch.cat([f[..., :, :1], f, f[..., :, -1:]], dim=-1)
    fpy = torch.cat([f[..., :1, :], f, f[..., -1:, :]], dim=-2)
    dx = 0.5 * (fpx[..., :, 2:] - fpx[..., :, :-2])
    dy = 0.5 * (fpy[..., 2:, :] - fpy[..., :-2, :])
    return dx, dy
