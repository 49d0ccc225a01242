"""The 3x3 SAME convolution of DnCNN's ``conv_impl`` routes: one CUDA kernel
for Hopper (``csrc/conv3x3.cu`` ``f2f_conv3x3``), its plain PyTorch version,
and the differentiable convolutions built on it and on ``ops/conv_dw.py``.

Counterpart of ``frame2frame_tpu/ops/pallas_conv.py``. Its TPU kernels come
to two functions: ``conv3x3_nopad`` and ``conv3x3_nopad_p2`` compute the
convolution (and its dX, with flipped, io-transposed weights), ``_dw_nopad``
and ``_dw_nopad_p2`` the weight gradient; ``_p2`` only stages the taps
differently for the TPU's matrix unit. Here the first is ``conv3x3_fwd``
(kernel A; it pads inside the kernel, so it takes the unpadded image) and
the second ``conv_dw.dw_conv3x3`` (kernel B).

The differentiable convolutions, each on NHWC f32 x and HWIO f32 weights,
as the JAX functions take them:

- ``conv3x3``: forward and dX on kernel A, dW on kernel B.
- ``conv3x3_p2``: the same function as ``conv3x3`` (the JAX package's v2
  kernels compute what its v1 kernels compute), so the same object.
- ``conv3x3_hybrid``: the library's f32 forward and dX, dW on kernel B:
  ``conv_dw.conv3x3_dwflat``, since the JAX package's hybrid and dwflat
  differ only in which TPU kernel computes dW.
- ``conv3x3_bf16res``: the library's f32 forward and dX; x saved in bf16
  and dW from it and the cotangent rounded to bf16, f32 sums, on kernel B
  with bf16 operands (the JAX function's bf16 einsum).
- ``conv3x3_bf16``: the 3x3 conv of ``conv3x3_packed_bf16``
  (``frame2frame_tpu/ops/packed.py``) in image space: bf16 operands and
  result for the forward and dX, the cotangent cast to bf16, dW in f32 on
  kernel B with bf16 operands. The JAX package takes its Pallas dW there
  only under ``F2F_PALLAS_DW=1``; the port reads no environment and always
  takes kernel B.
- ``_xla_conv``: the library's convolution (``conv_dw._xla_conv``).

``conv_function(conv_impl, plain_backward)`` gives a ``conv_impl``'s
convolution; ``plain_backward`` keeps the forward and takes the plain
versions in the backward, what ``chip_smoke.py`` holds the kernels against.

A wrapper given a CPU tensor computes the plain version; given a CUDA tensor
it launches the kernel or raises. ``conv3x3_fwd.launches`` counts launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import _on_current_cuda, _raise_on
from .conv_dw import (
    Conv3x3VJP,
    _lib,
    _xla_conv,
    conv3x3_dwflat,
    cp_async_reads,
    dw_conv3x3,
    dw_conv3x3_plain,
    flip_io,
    refuse_unaligned,
    xla_dx,
)


def conv3x3_fwd_plain(x, w):
    """Plain version of ``conv3x3_fwd``: the sum of nine shifted einsums in
    f32."""
    H, W = x.shape[1:3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            t = torch.einsum("bhwc,co->bhwo", xp[:, dy:dy + H, dx:dx + W],
                             w[dy, dx].float())
            out = t if out is None else out + t
    return out


def conv3x3_fwd(x, w):
    """3x3 SAME convolution, zero outside the image.

    x: (B, H, W, Cin) f32; w: (3, 3, Cin, Cout) f32 HWIO. Returns (B, H, W,
    Cout) f32. On the card, where Cin and Cout are multiples of 8, every
    product is split f32 on the TF32 tensor cores (hi*lo + lo*hi + hi*hi,
    within 1.4e-6 of float64), else an f32 FMA (``conv_dw.conv_body``).
    Where ``cp_async_reads`` says so, x is read in 16-byte chunks and must
    start 16-byte aligned; a view that does not raises."""
    if x.dim() != 4 or not x.numel() or w.shape != (3, 3, x.shape[-1],
                                                    w.shape[-1]):
        raise ValueError(f"conv3x3_fwd: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (B, H, W, Cin) and "
                         "(3, 3, Cin, Cout)")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv3x3_fwd: f32 x and w, got {x.dtype} and "
                        f"{w.dtype}")
    if w.device != x.device:
        raise ValueError("conv3x3_fwd: x and w on different devices")
    if x.device.type == "cpu":
        return conv3x3_fwd_plain(x, w)
    _on_current_cuda("conv3x3_fwd", x)
    lib = _lib()
    x, w = x.contiguous(), w.contiguous()
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    if cp_async_reads(True, cin, cout)[0]:
        refuse_unaligned("conv3x3_fwd", x)
    y = torch.empty(B, H, W, cout, dtype=torch.float32, device=x.device)
    rc = lib.f2f_conv3x3(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W,
                         cin, cout, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "conv3x3_fwd", rc)
    conv3x3_fwd.launches += 1
    return y


conv3x3_fwd.launches = 0


def kernel_dx(g, w):
    """dX on kernel A."""
    return conv3x3_fwd(g, flip_io(w))


def plain_dx(g, w):
    return conv3x3_fwd_plain(g, flip_io(w))


def conv3x3(x, w, dxf=kernel_dx, dwf=dw_conv3x3):
    """3x3 SAME conv, x (B, H, W, Cin) f32, w (3, 3, Cin, Cout) f32 HWIO:
    forward and dX on kernel A, dW on kernel B. ``dxf``, ``dwf``: the
    backward's functions (their plain versions for the plain backward)."""
    return Conv3x3VJP.apply(x, w, conv3x3_fwd, dxf, dwf, torch.float32)


conv3x3_p2 = conv3x3
conv3x3_hybrid = conv3x3_dwflat


def conv3x3_bf16res(x, w, dwf=dw_conv3x3):
    """3x3 SAME conv with the library's f32 forward and dX, and dW from x
    and the cotangent rounded to bf16 (f32 sums, kernel B)."""
    return Conv3x3VJP.apply(x, w, _xla_conv, xla_dx, dwf, torch.bfloat16)


def _bf16_fwd(x, w):
    return _xla_conv(x.to(torch.bfloat16), w.to(torch.bfloat16))


def _bf16_dx(g, w):
    return _xla_conv(g.to(torch.bfloat16), flip_io(w).to(torch.bfloat16))


def conv3x3_bf16(x, w, dwf=dw_conv3x3):
    """3x3 SAME conv on a bf16 data path, f32 master weights ``w``: bf16
    forward and dX (operands and result), dW f32 from the bf16 operands on
    kernel B."""
    return Conv3x3VJP.apply(x, w, _bf16_fwd, _bf16_dx, dwf, torch.bfloat16)


def conv_function(conv_impl, plain_backward=False):
    """The (x, w) -> y convolution of a DnCNN ``conv_impl`` route: "pallas",
    "hybrid", "bf16res", "bf16" (the data path of "packed_bf16" and of
    "fused" on the module route), "xla" or "packed" (the library's f32
    convolution, with autograd's backward)."""
    if conv_impl in ("xla", "packed"):
        return _xla_conv
    dwf = dw_conv3x3_plain if plain_backward else dw_conv3x3
    if conv_impl == "pallas":
        dxf = plain_dx if plain_backward else kernel_dx
        return lambda x, w: conv3x3(x, w, dxf, dwf)
    route = {"hybrid": conv3x3_hybrid, "bf16res": conv3x3_bf16res,
             "bf16": conv3x3_bf16}[conv_impl]
    return lambda x, w: route(x, w, dwf=dwf)
