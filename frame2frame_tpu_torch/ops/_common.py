"""What the kernel modules (``fused_stack``, ``fused_ends``, ``conv3x3``,
``conv_dw``, ``flow/tvl1_inner``) share: the plain convolution and operand
rounding of the plain versions, the checks around a launch, and the port's
only calls of the library's convolutions (``conv2d`` with its backward,
``conv2d_input``, ``conv2d_weight``).

PyTorch lets cuDNN compute an f32 convolution in TF32 (a 10-bit mantissa)
unless the caller turned ``torch.backends.cudnn.allow_tf32`` off; the JAX
package computes them in f32. Every library convolution of the port
therefore runs inside ``_cudnn_f32()``, a local context that turns TF32 off
for the one call and gives the caller's flags back afterwards; ``conv2d``'s
backward too, which autograd would otherwise run after the context ended. On bf16
operands the flag changes nothing."""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

C = 64


def _cudnn_f32():
    """cuDNN for the convolution inside, in f32 (no TF32), the caller's
    other cuDNN flags kept."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` whose backward also runs inside ``_cudnn_f32()``:
    autograd's own backward of ``F.conv2d`` would run after the context has
    ended, under the caller's flags."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _cudnn_f32():
            return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_input(x.shape, w, g)
        if ctx.needs_input_grad[1]:
            dw = conv2d_weight(x, w.shape, g)
        return dx, dw


def conv2d(x, w):
    """3x3 SAME convolution of NCHW ``x`` with OIHW ``w``, in the operands'
    dtype (f32 operands in f32), differentiable: its dX and dW run in f32
    too."""
    return _Conv2d.apply(x, w)


def conv2d_input(shape, w, g):
    """dX of ``conv2d`` for an input of ``shape``, from the cotangent ``g``."""
    with _cudnn_f32():
        return torch.nn.grad.conv2d_input(shape, w, g, padding=1)


def conv2d_weight(x, shape, g):
    """dW of ``conv2d`` for OIHW weights of ``shape``, from the cotangent
    ``g``."""
    with _cudnn_f32():
        return torch.nn.grad.conv2d_weight(x, shape, g, padding=1)


def _conv_f32(a, w):
    """3x3 SAME conv of NHWC f32 ``a`` with HWIO ``w``, in f32."""
    out = conv2d(a.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1)


def _round_operand(x, mma_bf16):
    """A dot operand in f32, rounded to bf16 first if ``mma_bf16``."""
    x = x.float()
    return x.bfloat16().float() if mma_bf16 else x


def _bind_error_string(lib):
    lib.f2f_error_string.restype = ctypes.c_char_p
    lib.f2f_error_string.argtypes = [ctypes.c_int]


def _raise_on(lib, name, rc):
    if rc != 0:
        msg = lib.f2f_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")


@functools.cache
def _partial_rows(index):
    """Rows of per-block partial sums a kernel may write on CUDA device
    ``index``: at most two of its persistent blocks fit a multiprocessor."""
    return 2 * torch.cuda.get_device_properties(index).multi_processor_count


def _on_current_cuda(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: {x.device} is not the current CUDA device")
