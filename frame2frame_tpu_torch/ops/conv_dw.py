"""The weight gradient of a 3x3 SAME convolution: one CUDA kernel for Hopper
(``csrc/conv3x3.cu`` ``f2f_dw_conv3x3``), its plain PyTorch version, and the
convolution whose backward takes it.

Counterpart of ``frame2frame_tpu/ops/conv_dw.py``: ``dw_conv3x3``,
``dw_conv3x3_batched`` and ``conv3x3_dwflat``. The same kernel also stands for
``_dw_nopad`` and ``_dw_nopad_p2`` of ``frame2frame_tpu/ops/pallas_conv.py``
(``ops/conv3x3.py``): the three TPU kernels compute one function and differ
only in how they fed the TPU's matrix unit (pair-packed 128-lane rows, row
tiles, im2col in VMEM), which means nothing here.

    dW[dy, dx, c, o] = sum_{b, h, w} x[b, h + dy - 1, w + dx - 1, c] g[b, h, w, o]

with zero outside the image: f32 or bf16 operands, products and sums in f32,
an f32 result. The JAX function asserts an even width, a constraint of its
pair packing; this one takes any size, and a whole batch in one launch.

Also here, because ``ops/conv3x3.py`` builds on them: ``_xla_conv`` (the
library's f32 convolution, TF32 off) and ``Conv3x3VJP``, the autograd
Function of a 3x3 convolution from three functions (forward, dX, dW), which
every ``conv_impl`` route of the DnCNN takes.

A wrapper given a CPU tensor computes the plain version; given a CUDA tensor
it launches the kernel or raises. ``dw_conv3x3.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load
from ._common import (
    _bind_error_string,
    _on_current_cuda,
    _partial_rows,
    _raise_on,
    conv2d,
)


def dw_conv3x3_plain(x, g):
    """Plain version of ``dw_conv3x3``: nine shifted einsums in f32 (bf16
    operands widened first, exactly)."""
    x, g = _batched(x), _batched(g)
    H, W = x.shape[1:3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float()
    return torch.stack([torch.stack([
        torch.einsum("bhwc,bhwo->co", xp[:, dy:dy + H, dx:dx + W], gf)
        for dx in range(3)]) for dy in range(3)])


def _batched(t):
    return t[None] if t.dim() == 3 else t


# The thin class: f32 operands with at most this many channels on one side
# (DnCNN's first and last layers, 1 or 3 channels), ``THIN_N`` of
# ``csrc/conv3x3.cu``.
THIN_N = 4
# the bodies by their code in ``csrc/conv3x3.cu`` (``enum Body``)
BODIES = ("FMA", "tensor cores", "thin", "bf16 tensor cores")


def conv_body(f32, cin, cout):
    """The body of ``csrc/conv3x3.cu`` that computes kernels A and B on
    these operands, as its ``body_of`` picks it (``f2f_conv3x3_body``): on
    bf16 operands (kernel B only) "bf16 tensor cores"; on f32 "tensor cores"
    (split f32) where Cin and Cout are multiples of 8, else "thin" where one
    of them is at most ``THIN_N``, else "FMA"."""
    if not f32:
        return BODIES[3]
    if cin % 8 == 0 and cout % 8 == 0:
        return BODIES[1]
    return BODIES[2] if min(cin, cout) <= THIN_N else BODIES[0]


def cp_async_reads(f32, cin, cout):
    """Which of (x, g) the kernels read from global memory in 16-byte
    chunks (``cp.async``), by ``conv_body``: both in the tensor-core bodies
    on f32; in the thin class the wide operand (x where Cin is wide, which
    is also kernel A's x; g where Cout is) if its channel count is a
    multiple of 4; on bf16 operands each whose channel count is a multiple
    of 8."""
    body = conv_body(f32, cin, cout)
    if body == "tensor cores":
        return True, True
    if body == "thin":
        if cin <= THIN_N:
            return False, cout % 4 == 0
        return cin % 4 == 0, False
    if body == "bf16 tensor cores":
        return cin % 8 == 0, cout % 8 == 0
    return False, False


def refuse_unaligned(name, *operands):
    """Raise unless each tensor of ``operands`` starts on a 16-byte
    boundary. ``.contiguous()`` leaves a contiguous view at an odd storage
    offset as it is, and a ``cp.async`` from it faults on the card with a
    sticky error that ends the process's CUDA context."""
    for t in operands:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: an operand read in 16-byte chunks "
                             f"starts {t.data_ptr() % 16} bytes past a "
                             "16-byte boundary")


@functools.cache
def _lib():
    lib = load("conv3x3")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.f2f_conv3x3.restype = ci
    lib.f2f_conv3x3.argtypes = [vp, vp, vp] + [ci] * 5 + [vp]
    lib.f2f_dw_conv3x3.restype = ci
    lib.f2f_dw_conv3x3.argtypes = [vp, vp, ci, vp, vp] + [ci] * 6 + [vp]
    lib.f2f_conv3x3_body.restype = ci
    lib.f2f_conv3x3_body.argtypes = [ci] * 4
    _bind_error_string(lib)
    return lib


def dw_conv3x3(x, g):
    """Weight gradient of a 3x3 SAME conv, summed over the batch.

    x: (H, W, Cin) or (B, H, W, Cin), the conv's input; g: the same with
    Cout, the cotangent of its output; both f32 or both bf16. Returns dW
    (3, 3, Cin, Cout) f32. Per-block partial sums are added in block order,
    in double: the same inputs give the same bits. On the card an operand
    read in 16-byte chunks (``cp_async_reads``) must start 16-byte aligned;
    a view that does not raises."""
    xb, gb = _batched(x), _batched(g)
    if (xb.dim() != 4 or gb.dim() != 4 or xb.shape[:3] != gb.shape[:3]
            or not xb.numel() or not gb.numel()):
        raise ValueError(f"dw_conv3x3: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} are not one (B, H, W, C) pair")
    if xb.dtype != gb.dtype or xb.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise TypeError(f"dw_conv3x3: x and g both f32 or both bf16, got "
                        f"{xb.dtype} and {gb.dtype}")
    if gb.device != xb.device:
        raise ValueError("dw_conv3x3: x and g on different devices")
    if xb.device.type == "cpu":
        return dw_conv3x3_plain(xb, gb)
    _on_current_cuda("dw_conv3x3", xb)
    lib = _lib()
    xb, gb = xb.contiguous(), gb.contiguous()
    B, H, W, cin = xb.shape
    cout = gb.shape[-1]
    reads = cp_async_reads(xb.dtype == torch.float32, cin, cout)
    refuse_unaligned("dw_conv3x3",
                     *(t for t, r in zip((xb, gb), reads) if r))
    rows = _partial_rows(xb.device.index)
    dw = torch.empty(3, 3, cin, cout, dtype=torch.float32, device=xb.device)
    partial = torch.empty(rows, 9, cin, cout, dtype=torch.float32,
                          device=xb.device)
    rc = lib.f2f_dw_conv3x3(
        xb.data_ptr(), gb.data_ptr(), int(xb.dtype == torch.float32),
        dw.data_ptr(), partial.data_ptr(), rows, B, H, W, cin, cout,
        torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, "dw_conv3x3", rc)
    dw_conv3x3.launches += 1
    return dw


dw_conv3x3.launches = 0


def dw_conv3x3_batched(x, g):
    """Batched dW, (B, H, W, Cin) x (B, H, W, Cout) -> (3, 3, Cin, Cout):
    one launch for the whole batch (the JAX function adds one launch an
    image)."""
    return dw_conv3x3(x, g)


def _xla_conv(x, w):
    """3x3 SAME conv of NHWC ``x`` with HWIO ``w`` on the library's
    convolution in the operands' dtype (f32 without TF32), the counterpart
    of the JAX package's ``lax.conv_general_dilated``."""
    out = conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1)


def flip_io(w):
    """The weights of dX as a convolution of the cotangent: spatially
    flipped, input and output channels swapped (HWIO)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


class Conv3x3VJP(torch.autograd.Function):
    """3x3 SAME conv of NHWC ``x`` with HWIO ``w`` from three functions:
    ``fwd(x, w)``, ``dxf(g, w)`` (dX, a convolution of the cotangent with
    ``flip_io(w)``) and ``dwf(x_saved, g)`` (dW, f32). The forward saves x
    in ``res_dtype`` and dW sees the cotangent in that dtype, as the JAX
    package's custom VJPs do. dX is skipped where x needs no gradient."""

    @staticmethod
    def forward(ctx, x, w, fwd, dxf, dwf, res_dtype):
        ctx.save_for_backward(x.to(res_dtype), w)
        ctx.dxf, ctx.dwf = dxf, dwf
        return fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        xr, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ctx.dxf(g, w)
        if ctx.needs_input_grad[1]:
            dw = ctx.dwf(xr, g.to(xr.dtype))
        return dx, dw, None, None, None, None


def xla_dx(g, w):
    """dX on the library's convolution, in f32."""
    return _xla_conv(g, flip_io(w))


def conv3x3_dwflat(x, w, dwf=dw_conv3x3):
    """3x3 SAME conv, x (B, H, W, Cin) f32, w (3, 3, Cin, Cout) f32 HWIO: the
    library's f32 forward and dX, dW on ``dw_conv3x3``. ``dwf``: the dW
    function (``dw_conv3x3_plain`` for the plain backward)."""
    return Conv3x3VJP.apply(x, w, _xla_conv, xla_dx, dwf, torch.float32)
