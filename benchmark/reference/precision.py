"""The arithmetic the plain references run in: float32 with TF32 off (the
reference), the controls one step below a configuration's precision
(float8 operands for a bf16 chain, TF32 for float32 with TF32 off), and a
bf16 chain, the witness of what a configuration's own bf16 precision moves.

``conv2d(x, w, mode, ...)`` is ``F.conv2d`` on NCHW tensors in one of
these modes, run inside ``arithmetic(mode)``, which sets the TF32 switches
for the forward and for the backward that autograd runs later:

- ``"f32"``: cuDNN with TF32 off, so every product is a float32 one;
- ``"tf32"``: cuDNN with TF32 on (the control of a float32 configuration);
- ``"fp8"``: the operands rounded to float8 e4m3 with one scale a tensor
  (the largest magnitude to 448), the gradient that flows back into them
  rounded to float8 e5m2 the same way, the products then taken in float32
  (the control of a bf16 configuration);
- ``"bf16"``: the operands rounded to bfloat16 (round to nearest, no
  scale), the gradient that flows back into them too, the products then
  taken in float32: a bf16 chain as a configuration states it, which no
  cell is judged against.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8", "bf16")


@contextlib.contextmanager
def tf32(allow):
    """cuDNN's and cuBLAS's TF32 switches set to ``allow``, and given
    back."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=allow):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _round(x, dtype, largest):
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / largest
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(x):
    """``x`` rounded to float8 e4m3 (its gradient to e5m2)."""
    return _Fp8.apply(x)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(x):
    """``x`` rounded to bfloat16 (its gradient too)."""
    return _Bf16.apply(x)


def arithmetic(mode):
    """The context a computation in ``mode`` runs in: TF32 on for "tf32",
    off otherwise."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return tf32(mode == "tf32")


def conv2d(x, w, mode="f32", stride=1, padding=1, groups=1):
    """``F.conv2d`` in ``mode``, to be called inside ``arithmetic(mode)``."""
    if mode == "fp8":
        x, w = fp8(x), fp8(w)
    elif mode == "bf16":
        x, w = bf16(x), bf16(w)
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)
