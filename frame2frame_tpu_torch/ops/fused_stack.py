"""The DnCNN 64->64 mid layers of the serving path: two CUDA kernels for
Hopper (``csrc/fused_stack.cu``) and their plain PyTorch versions.

Counterparts of ``frame2frame_tpu/ops/fused_stack.py``:

- ``fwd_layer`` <- ``fwd_layer`` with ``emit_stats=False`` (the eval "affine"
  route): ``z = conv3x3_SAME(relu(s * z_prev + b))``, chained on raw conv
  outputs. The batch-stat and ``emit_act`` outputs of the training forward
  are not ported here.
- ``fwd_layer_eval`` <- ``fwd_layer_eval`` (the eval "act" route):
  ``a = relu(s * conv3x3_SAME(a_prev, w) + b)``, chained post-activation.
  The TPU kernel folds the BN scale into its weights; the port applies it
  to the f32 accumulator, since rounding ``w * s`` to bf16 loses accuracy
  (``csrc/fused_stack.cu``).

Activations are NHWC ``(B, H, W, 64)``, contiguous, bf16 or f32. The TPU
pair-packed flat layout is not carried over: a batch is the batch
dimension, and SAME padding per image isolates its frames. Zero padding
applies to the activation after the affine and ReLU, as the TPU kernel masks
the activation at pad positions; padding ``z_prev`` first would leak
``relu(b)`` into the border.

A wrapper given a CPU tensor computes the plain version; given a CUDA tensor
it launches the kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load

EPS = 1e-5
C = 64


def _affine_from_stats(mean, var, gamma, beta):
    """Eval BatchNorm as a per-channel affine: (scale, shift, rstd)."""
    rstd = torch.rsqrt(var + EPS)
    s = gamma * rstd
    return s, beta - mean * s, rstd


def _conv_f32(a, w):
    """3x3 SAME conv of NHWC f32 ``a`` with HWIO ``w``, in f32."""
    out = F.conv2d(a.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   padding=1)
    return out.permute(0, 2, 3, 1)


def fwd_layer_plain(z_prev, w, s, b):
    """Plain version of ``fwd_layer``: f32 arithmetic, storage dtype out."""
    a = torch.relu(z_prev.float() * s.float() + b.float())
    return _conv_f32(a, w).to(z_prev.dtype).contiguous()


def fwd_layer_eval_plain(a_prev, w, s, b):
    """Plain version of ``fwd_layer_eval``: f32 arithmetic, input dtype out."""
    out = torch.relu(_conv_f32(a_prev.float(), w) * s.float() + b.float())
    return out.to(a_prev.dtype).contiguous()


def kernel_weights(w):
    """HWIO weights in the form the kernels take on ``w``'s device:
    contiguous bf16 on CUDA (the MMA operand type), unchanged on the CPU,
    where the plain versions compute in f32. Idempotent, so a caller may
    convert a stack of layers once and pass slices."""
    if w.device.type == "cpu":
        return w
    return w.to(torch.bfloat16).contiguous()


def _checked(name, x, w, s, b):
    """Validate one layer's inputs; returns contiguous (s, b)."""
    if x.dim() != 4 or x.shape[-1] != C:
        raise ValueError(f"{name}: expected (B, H, W, {C}), got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: bf16 or f32 storage, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: needs a contiguous 16-byte aligned tensor")
    if w.shape != (3, 3, C, C) or w.device != x.device:
        raise ValueError(f"{name}: w must be (3, 3, {C}, {C}) HWIO on {x.device}")
    for v in (s, b):
        if v.shape != (C,) or v.dtype != torch.float32 or v.device != x.device:
            raise ValueError(f"{name}: s and b must be ({C},) f32 on {x.device}")
    return s.contiguous(), b.contiguous()


@functools.cache
def _lib():
    lib = load("fused_stack")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.f2f_fwd_layer, lib.f2f_fwd_layer_eval):
        fn.restype = ci
        fn.argtypes = [vp, ci, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.f2f_error_string.restype = ctypes.c_char_p
    lib.f2f_error_string.argtypes = [ci]
    return lib


def _launch(name, x, w, s, b):
    """Run kernel ``f2f_<name>`` on CUDA tensors on the current device and
    return its output, in x's dtype. Raises if the launch is refused."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: {x.device} is not the current CUDA device")
    lib = _lib()
    wk = kernel_weights(w)
    out = torch.empty_like(x)
    B, H, W, _ = x.shape
    rc = getattr(lib, f"f2f_{name}")(
        x.data_ptr(), int(x.dtype == torch.float32), wk.data_ptr(),
        s.data_ptr(), b.data_ptr(), out.data_ptr(), B, H, W,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = lib.f2f_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")
    return out


def fwd_layer(z_prev, w, s, b):
    """One eval mid layer on the affine route.

    z_prev: (B, H, W, 64) bf16 or f32, the previous layer's raw conv output
    (or the first activation with s = 1, b = 0); w: (3, 3, 64, 64) HWIO;
    s, b: (64,) f32, the previous layer's eval BN affine. Returns the raw conv
    output z in z_prev's dtype (f32 accumulation)."""
    s, b = _checked("fwd_layer", z_prev, w, s, b)
    if z_prev.device.type == "cpu":
        return fwd_layer_plain(z_prev, w, s, b)
    out = _launch("fwd_layer", z_prev, w, s, b)
    fwd_layer.launches += 1
    return out


def fwd_layer_eval(a_prev, w, s, b):
    """One eval mid layer on the act route.

    a_prev: (B, H, W, 64) bf16 or f32, post-activation; w: (3, 3, 64, 64)
    HWIO; s, b: (64,) f32, this layer's eval BN affine. Returns
    relu(s * conv + b) in a_prev's dtype (f32 accumulation)."""
    s, b = _checked("fwd_layer_eval", a_prev, w, s, b)
    if a_prev.device.type == "cpu":
        return fwd_layer_eval_plain(a_prev, w, s, b)
    out = _launch("fwd_layer_eval", a_prev, w, s, b)
    fwd_layer_eval.launches += 1
    return out


fwd_layer.launches = 0
fwd_layer_eval.launches = 0
KERNELS = (fwd_layer, fwd_layer_eval)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts():
    return {k.__name__: k.launches for k in KERNELS}
