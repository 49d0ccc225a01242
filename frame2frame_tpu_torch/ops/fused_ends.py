"""The two ends of the DnCNN and its loss in the online fine-tune: four CUDA
kernels for Hopper (``csrc/fused_ends.cu``) and their plain PyTorch versions.

Counterparts of ``frame2frame_tpu/ops/fused_ends.py``:

- ``first_conv`` <- ``first_conv``: ``z1 = conv3x3_SAME(x, w_in)``, 1 -> 64
  channels, raw (the ReLU is the first mid layer's prologue).
- ``last_loss_fwd`` <- ``last_loss_fwd``: ``a = relu(s * z_L + b)``,
  ``noise = conv3x3_SAME(a, w_out)`` in f32, and the masked summed L1 loss
  ``sum |aux_c - aux_m * noise|``.
- ``last_loss_bwd`` <- ``last_loss_bwd``: with ``e = aux_m * sign(aux_c -
  aux_m * noise)`` (``sign(0) = 0``, so ``dL/dnoise = -e``): the cotangent
  ``g_L`` of ``a``, ``dW_out``, and the last BatchNorm's backward sums
  ``sum gp`` and ``sum gp * zhat_L`` with ``gp = g_L * [s * z_L + b > 0]``,
  taken from the f32 ``g_L`` before it is rounded.
- ``first_dw`` <- ``first_dw``: ``dW_in[t] = sum_p x[p + t] * da0[p] *
  [z1[p] > 0]``.

Images ``x``, ``aux_c``, ``aux_m`` and ``noise`` are ``(H, W)``, activations
``(1, H, W, 64)`` NHWC, weights HWIO in f32: one frame, as the JAX package's
flat step takes. ``x`` and the activations are in the chain's dtype (bf16 or
f32), ``aux_c``, ``aux_m`` and ``noise`` in f32. The TPU kernels embed the
one-channel image at two lanes of the pair-packed layout, read a prebuilt
odd slab and take negated flipped taps; none of that is carried over.
``g_L`` and ``dW_out`` come back with their final signs. ``last_loss_fwd``
does not emit the stored activation: ``last_loss_bwd`` rebuilds ``a`` from
``z_L``, which it reads anyway for the BatchNorm sums.

Zero padding applies to ``a`` after the affine and the ReLU, and to ``e``.
The affine that decides a ReLU or a mask is a rounded product plus a rounded
sum, in the kernels and here, as in ``ops/fused_stack.py``.

Rounding. The plain versions round as the TPU kernels do in interpret
mode: ``x`` and the forward weights in the chain's dtype, the activation
that ``dW_out`` contracts as it was stored (the chain's dtype), the
backward's weights and ``e`` not at all. ``mma_bf16`` rounds every dot
operand to bf16 instead, as the CUDA kernels and the TPU's matrix unit do on
either chain.

A wrapper given a CPU tensor computes the plain version; given a CUDA tensor
it launches the kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``; ``ops/fused_stack.py`` keeps the registry.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load
from ._common import (
    C,
    _bind_error_string,
    _conv_f32,
    _on_current_cuda,
    _partial_rows,
    _raise_on,
    _round_operand,
    conv2d_weight,
)

# rows of ``vecs`` (4, 64) f32 of ``last_loss_bwd``: the last BatchNorm's
# affine (gamma * rstd, beta - mean * gamma * rstd) and its normalisation
# (rstd, -mean * rstd)
E_S, E_B, E_RSTD, E_NMR = range(4)


def _image(x):
    """(H, W) -> (1, H, W, 1)."""
    return x[None, :, :, None]


def first_conv_plain(x, w, mma_bf16=False):
    """Plain version of ``first_conv``: f32 accumulation, x's dtype out."""
    acc = _conv_f32(_image(_round_operand(x, mma_bf16)),
                    _round_operand(w.to(x.dtype), mma_bf16))
    return acc.to(x.dtype).contiguous()


def last_loss_fwd_plain(z, s, b, w, aux_c, aux_m, mma_bf16=False):
    """Plain version of ``last_loss_fwd``: (noise (H, W) f32, loss)."""
    a = torch.relu(z.float() * s.float() + b.float())
    noise = _conv_f32(_round_operand(a, mma_bf16),
                      _round_operand(w.to(z.dtype), mma_bf16))[0, :, :, 0]
    return noise.contiguous(), (aux_c - aux_m * noise).abs().sum()


def last_loss_bwd_plain(noise, aux_c, aux_m, z, w, vecs, mma_bf16=False):
    """Plain version of ``last_loss_bwd``: (g_L, dW_out (3, 3, 64, 1) f32,
    stats (2, 64) f32)."""
    dt = z.dtype
    v = vecs.float()
    zf = z.float()
    y = zf * v[E_S] + v[E_B]
    ne = _image(_round_operand(
        -aux_m * torch.sign(aux_c - aux_m * noise), mma_bf16))
    g = _conv_f32(ne, _round_operand(w, mma_bf16).flip(0, 1).transpose(2, 3))
    a = _round_operand(torch.relu(y).to(dt), mma_bf16)
    dw = conv2d_weight(
        a.permute(0, 3, 1, 2), (1, C, 3, 3),
        ne.permute(0, 3, 1, 2)).permute(2, 3, 1, 0).contiguous()
    gp = g * (y > 0)
    zhat = zf * v[E_RSTD] + v[E_NMR]
    stats = torch.stack([gp.sum((0, 1, 2)), (gp * zhat).sum((0, 1, 2))])
    return g.to(dt).contiguous(), dw, stats


def first_dw_plain(da, z1, x, mma_bf16=False):
    """Plain version of ``first_dw``: dW_in (3, 3, 1, 64) f32."""
    gp = _round_operand(da.float() * (z1.float() > 0), mma_bf16)
    return conv2d_weight(
        _round_operand(x, mma_bf16)[None, None], (C, 1, 3, 3),
        gp.permute(0, 3, 1, 2)).permute(2, 3, 1, 0).contiguous()


def _check_act(name, z):
    if z.dim() != 4 or z.shape[0] != 1 or z.shape[-1] != C or not z.numel():
        raise ValueError(f"{name}: expected (1, H, W, {C}), got "
                         f"{tuple(z.shape)}")
    if z.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: bf16 or f32 storage, got {z.dtype}")
    if not z.is_contiguous() or z.data_ptr() % 16:
        raise ValueError(f"{name}: needs a contiguous 16-byte aligned tensor")


def _check_images(name, shape, dtype, device, **images):
    for key, x in images.items():
        if (tuple(x.shape) != tuple(shape) or x.dtype != dtype
                or x.device != device or not x.is_contiguous()
                or not x.numel()):
            raise ValueError(
                f"{name}: {key} must be a contiguous {tuple(shape)} "
                f"{dtype} image on {device}, got {tuple(x.shape)} {x.dtype} "
                f"on {x.device}")


def _check_f32(name, shape, device, **tensors):
    """Validate small f32 inputs; returns them contiguous, in order."""
    for key, x in tensors.items():
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != device):
            raise ValueError(f"{name}: {key} must be {shape} f32 on {device}")
    return [x.contiguous() for x in tensors.values()]


@functools.cache
def _lib():
    lib = load("fused_ends")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.f2f_first_conv.argtypes = [vp, ci, vp, vp, ci, ci, vp]
    lib.f2f_last_loss_fwd.argtypes = [vp, ci] + [vp] * 8 + [ci] * 3 + [vp]
    lib.f2f_last_loss_bwd.argtypes = ([vp] * 4 + [ci] + [vp] * 5 + [ci] * 3
                                      + [vp])
    lib.f2f_first_dw.argtypes = [vp] * 3 + [ci] + [vp] * 2 + [ci] * 3 + [vp]
    for fn in (lib.f2f_first_conv, lib.f2f_last_loss_fwd,
               lib.f2f_last_loss_bwd, lib.f2f_first_dw):
        fn.restype = ci
    _bind_error_string(lib)
    return lib


def _stream():
    return torch.cuda.current_stream().cuda_stream


def first_conv(x, w):
    """The input convolution of one frame.

    x: (H, W) bf16 or f32, the frame in the chain's dtype; w: (3, 3, 1, 64)
    HWIO f32. Returns z1 (1, H, W, 64) in x's dtype: the raw conv output,
    f32 accumulation, SAME zero padding."""
    name = "first_conv"
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be an (H, W) bf16 or f32 image, "
                         f"got {tuple(x.shape)} {x.dtype}")
    _check_images(name, x.shape, x.dtype, x.device, x=x)
    w, = _check_f32(name, (3, 3, 1, C), x.device, w=w)
    if x.device.type == "cpu":
        return first_conv_plain(x, w)
    _on_current_cuda(name, x)
    lib = _lib()
    H, W = x.shape
    z = torch.empty(1, H, W, C, dtype=x.dtype, device=x.device)
    rc = lib.f2f_first_conv(x.data_ptr(), int(x.dtype == torch.float32),
                            w.data_ptr(), z.data_ptr(), H, W, _stream())
    _raise_on(lib, name, rc)
    first_conv.launches += 1
    return z


def last_loss_fwd(z, s, b, w, aux_c, aux_m):
    """Last BatchNorm affine + ReLU, the output convolution and the loss.

    z: (1, H, W, 64) bf16 or f32, the last mid layer's raw conv output;
    s, b: (64,) f32, its BatchNorm's affine; w: (3, 3, 64, 1) HWIO f32;
    aux_c = mask * x - target and aux_m = mask: (H, W) f32. Returns (noise
    (H, W) f32 = conv(relu(s * z + b), w), loss = sum |aux_c - aux_m *
    noise|, a 0-dim f32). The loss is reduced in a fixed order: the same
    inputs give the same bits."""
    name = "last_loss_fwd"
    _check_act(name, z)
    dev = z.device
    _, H, W, _ = z.shape
    s, b = _check_f32(name, (C,), dev, s=s, b=b)
    w, = _check_f32(name, (3, 3, C, 1), dev, w=w)
    _check_images(name, (H, W), torch.float32, dev, aux_c=aux_c, aux_m=aux_m)
    if z.device.type == "cpu":
        return last_loss_fwd_plain(z, s, b, w, aux_c, aux_m)
    _on_current_cuda(name, z)
    lib = _lib()
    rows = _partial_rows(dev.index)
    noise = torch.empty(H, W, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    partial = torch.empty(rows, dtype=torch.float32, device=dev)
    rc = lib.f2f_last_loss_fwd(
        z.data_ptr(), int(z.dtype == torch.float32), s.data_ptr(),
        b.data_ptr(), w.data_ptr(), aux_c.data_ptr(), aux_m.data_ptr(),
        noise.data_ptr(), loss.data_ptr(), partial.data_ptr(), rows, H, W,
        _stream())
    _raise_on(lib, name, rc)
    last_loss_fwd.launches += 1
    return noise, loss


def last_loss_bwd(noise, aux_c, aux_m, z, w, vecs):
    """Backward of ``last_loss_fwd`` for a loss cotangent of 1.

    noise: the forward's (H, W) f32 output; aux_c, aux_m, z, w as there;
    vecs: (4, 64) f32, rows ``E_S`` .. ``E_NMR``. Returns (g_L (1, H, W, 64)
    in z's dtype, the cotangent of relu(s * z + b); dW_out (3, 3, 64, 1)
    f32; stats (2, 64) f32 = sum gp and sum gp * zhat_L with gp = g_L *
    [s * z + b > 0], from the f32 g_L). One call counts as one launch; it
    runs the kernel and its finishing sum."""
    name = "last_loss_bwd"
    _check_act(name, z)
    dev = z.device
    _, H, W, _ = z.shape
    w, = _check_f32(name, (3, 3, C, 1), dev, w=w)
    vecs, = _check_f32(name, (4, C), dev, vecs=vecs)
    _check_images(name, (H, W), torch.float32, dev, noise=noise, aux_c=aux_c,
                  aux_m=aux_m)
    if z.device.type == "cpu":
        return last_loss_bwd_plain(noise, aux_c, aux_m, z, w, vecs)
    _on_current_cuda(name, z)
    lib = _lib()
    rows = _partial_rows(dev.index)
    g = torch.empty_like(z)
    sums = torch.empty(11, C, dtype=torch.float32, device=dev)
    partial = torch.empty(rows, 11, C, dtype=torch.float32, device=dev)
    rc = lib.f2f_last_loss_bwd(
        noise.data_ptr(), aux_c.data_ptr(), aux_m.data_ptr(), z.data_ptr(),
        int(z.dtype == torch.float32), w.data_ptr(), vecs.data_ptr(),
        g.data_ptr(), sums.data_ptr(), partial.data_ptr(), rows, H, W,
        _stream())
    _raise_on(lib, name, rc)
    last_loss_bwd.launches += 1
    return g, sums[:9].view(3, 3, C, 1), sums[9:]


def first_dw(da, z1, x):
    """The input convolution's weight gradient.

    da: (1, H, W, 64) bf16 or f32, the cotangent of relu(z1); z1: the stored
    output of ``first_conv``, same shape and dtype; x: the (H, W) frame in
    the same dtype. Returns dW_in (3, 3, 1, 64) f32, reduced in a fixed
    order."""
    name = "first_dw"
    _check_act(name, da)
    _check_act(name, z1)
    if z1.shape != da.shape or z1.dtype != da.dtype or z1.device != da.device:
        raise ValueError(f"{name}: z1 must match da's shape, dtype and device")
    dev = da.device
    _, H, W, _ = da.shape
    _check_images(name, (H, W), da.dtype, dev, x=x)
    if da.device.type == "cpu":
        return first_dw_plain(da, z1, x)
    _on_current_cuda(name, da)
    lib = _lib()
    rows = _partial_rows(dev.index)
    dw = torch.empty(3, 3, 1, C, dtype=torch.float32, device=dev)
    partial = torch.empty(rows, 9, C, dtype=torch.float32, device=dev)
    rc = lib.f2f_first_dw(
        da.data_ptr(), z1.data_ptr(), x.data_ptr(),
        int(da.dtype == torch.float32), dw.data_ptr(), partial.data_ptr(),
        rows, H, W, _stream())
    _raise_on(lib, name, rc)
    first_dw.launches += 1
    return dw


for _wrapper in (first_conv, last_loss_fwd, last_loss_bwd, first_dw):
    _wrapper.launches = 0
