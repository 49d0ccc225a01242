"""What the kernel modules (``fused_stack``, ``fused_ends``,
``flow/tvl1_inner``) share: the plain convolution and operand rounding of the
plain versions, and the checks around a launch."""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

C = 64


def _conv_f32(a, w):
    """3x3 SAME conv of NHWC f32 ``a`` with HWIO ``w``, in f32."""
    out = F.conv2d(a.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   padding=1)
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
