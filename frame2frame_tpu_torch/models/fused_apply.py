"""DnCNN forwards on the fused mid-layer kernels: eval mode (the serving
path) and training mode with batch-stat updates (the online fine-tune).

Counterpart of ``frame2frame_tpu/models/fused_apply.py``'s
``fused_train_apply``, ``fused_eval_apply`` and ``fused_eval_apply_batch``.
The 15 mid layers of DnCNN-17 run as ``ops/fused_stack`` kernels; the C<->64
end convs stay library convolutions (XLA computed them in the JAX package),
with bf16 operands and a bf16 result on the bf16 chain, and a weight gradient
accumulated and delivered in f32 (``_EndConvBf16``).

Two eval implementations (``eval_impl``):
- ``"affine"`` (default): activations chain as raw conv outputs; each
  ``fwd_layer`` applies the previous layer's eval BN affine + ReLU to its
  operand. The last affine + ReLU before ``conv_out`` is plain torch.
- ``"act-bf16"`` / ``"act-f32"``: activations chain post-activation in the
  named dtype; ``fwd_layer_eval`` applies the layer's eval BN affine + ReLU
  in its epilogue.

Frames are NHWC throughout; a batch is the batch dimension of one kernel
launch per layer, its frames isolated by per-image SAME padding.

``fused_train_apply_spatial`` and ``fused_eval_apply_spatial`` (the JAX
package's functions of the same names) split the mid stack of one frame by
rows over the devices of a mesh (``ops/fused_spatial.py``). The end convs
run on the whole frame on the mesh's first device: in the JAX package they
stay XLA ops that the SPMD partitioner splits, and the port has no
partitioner.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops._common import conv2d, conv2d_input, conv2d_weight
from ..ops.fused_stack import (
    _affine_from_stats,
    fused_mid_stack,
    fwd_layer,
    fwd_layer_eval,
    kernel_weights,
)
from ..ops.fused_spatial import (
    eval_mid_stack_spatial,
    fused_mid_stack_spatial,
    pad_h,
)
from .dncnn import DnCNN, update_running_stats

EVAL_IMPLS = ("affine", "act-bf16", "act-f32")


def _eval_impl(eval_impl=None):
    """The route of an eval-impl token: "affine" or "act"."""
    tok = eval_impl or "affine"
    if tok not in EVAL_IMPLS:
        raise ValueError(f"eval_impl must be one of {EVAL_IMPLS}, got {tok!r}")
    return "affine" if tok == "affine" else "act"


def _eval_chain_dtype(eval_impl=None):
    """Storage dtype of the act route's chain."""
    return torch.float32 if eval_impl == "act-f32" else torch.bfloat16


class _EndConvBf16(torch.autograd.Function):
    """3x3 SAME conv of NCHW ``x`` with f32 master weights ``w`` (OIHW) on a
    bf16 data path, as ``conv3x3_packed_bf16`` of the JAX package: forward
    and dX run on bf16 operands with bf16 results, the cotangent is cast to
    bf16, and dW is accumulated and returned in f32 from the bf16 operands.
    Autograd of a bf16 ``F.conv2d`` would round dW to bf16 instead."""

    @staticmethod
    def forward(ctx, x, w):
        x16, w16 = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(x16, w16)
        return conv2d(x16, w16)

    @staticmethod
    def backward(ctx, g):
        x16, w16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_input(x16.shape, w16, g16)
        if ctx.needs_input_grad[1]:
            dw = conv2d_weight(x16.float(), w16.shape, g16.float())
        return dx, dw


def _make_end_conv(store_dtype):
    """The C<->64 boundary convs on NHWC tensors: operands and result in
    ``store_dtype``. Shared by the train and eval forwards so their
    semantics cannot drift."""
    def end_conv(x, w):
        x = x.permute(0, 3, 1, 2)
        if store_dtype == torch.bfloat16:
            out = _EndConvBf16.apply(x, w)
        else:
            out = conv2d(x.to(store_dtype), w.to(store_dtype))
        return out.permute(0, 2, 3, 1).contiguous()
    return end_conv


def _mid_params(model):
    """All mid layers' kernel inputs at once, a few ops per forward rather
    than a few per layer: HWIO weights (L, 3, 3, 64, 64) in the kernels'
    form, and the eval BN affines s, b (L, 64)."""
    mids = [model.mid(i) for i in range(model.nmid)]
    w = torch.stack([conv.weight for conv, _ in mids]).permute(0, 3, 4, 2, 1)
    stats = [torch.stack([getattr(bn, k) for _, bn in mids])
             for k in ("running_mean", "running_var", "weight", "bias")]
    s, b, _ = _affine_from_stats(*stats)
    return kernel_weights(w), s, b


def _act_eval_mid_stack(model, a1, eval_impl):
    """Act-route mid stack: a1 (B, H, W, 64) -> last activation, in the
    chain's dtype."""
    w, s, b = _mid_params(model)
    cur = a1.to(_eval_chain_dtype(eval_impl)).contiguous()
    for i in range(model.nmid):
        cur = fwd_layer_eval(cur, w[i], s[i], b[i])
    return cur


def _affine_mid_stack(model, a1, store_dtype):
    """Affine-route mid stack: a1 (B, H, W, 64) -> last activation, f32."""
    w, s, b = _mid_params(model)
    cur = a1.to(store_dtype).contiguous()
    one = torch.ones(64, dtype=torch.float32, device=a1.device)
    cur = fwd_layer(cur, w[0], one, torch.zeros_like(one))
    for i in range(1, model.nmid):
        cur = fwd_layer(cur, w[i], s[i - 1], b[i - 1])
    return torch.addcmul(b[-1], cur, s[-1]).relu_()


def _spatial_pad(a1, mesh):
    """a1 (B, H, W, 64) with zero rows below, to ``pad_h(H, len(mesh))``
    rows: the pad rows of the stack input are zeros, and their cotangent
    is dropped."""
    H = a1.shape[1]
    return F.pad(a1, (0, 0, 0, 0, 0, pad_h(H, len(mesh)) - H))


def _spatial_eval_mid_stack(model, a1, store_dtype, eval_impl, mesh):
    """Either eval route's mid stack over the slabs of ``mesh``: a1 (B, H,
    W, 64) -> the last activation, as the unsplit routes return it."""
    H = a1.shape[1]
    route = _eval_impl(eval_impl)
    dtype = _eval_chain_dtype(eval_impl) if route == "act" else store_dtype
    w, s, b = _mid_params(model)
    return eval_mid_stack_spatial(w, s, b, _spatial_pad(a1, mesh), H, mesh,
                                  dtype, route)[:, :H]


@torch.no_grad()
def _eval_forward(model, x, store_dtype, eval_impl, mesh=None):
    end_conv = _make_end_conv(store_dtype)
    a1 = torch.relu(end_conv(x, model.conv_in.weight))
    if mesh is not None:
        a_out = _spatial_eval_mid_stack(model, a1, store_dtype, eval_impl,
                                        mesh)
    elif _eval_impl(eval_impl) == "act":
        a_out = _act_eval_mid_stack(model, a1, eval_impl)
    else:
        a_out = _affine_mid_stack(model, a1, store_dtype)
    noise = end_conv(a_out, model.conv_out.weight).float()
    return x - noise if model.residual else noise


def fused_train_apply(model, x, store_dtype=torch.bfloat16,
                      mid_stack=fused_mid_stack):
    """Training-mode DnCNN forward with batch statistics.

    x: (B, H, W, C) f32 (one frame in the online fine-tune). Returns the
    model's output convention (noise, or x - noise when ``model.residual``),
    differentiable in the model's parameters. BatchNorm normalises with the
    batch's biased variance, and the running statistics are updated in
    place, without gradient, with that same biased variance
    (``new = 0.9 * old + 0.1 * batch``, the JAX package's convention;
    ``nn.BatchNorm2d`` would store the unbiased one).
    ``store_dtype``: bf16 in production, f32 in the strict mode of the
    tests. ``mid_stack``: ``ops.fused_stack.fused_mid_stack`` or its plain
    twin."""
    end_conv = _make_end_conv(store_dtype)
    mids = [model.mid(i) for i in range(model.nmid)]
    a1 = torch.relu(end_conv(x, model.conv_in.weight))
    ws = torch.stack([conv.weight for conv, _ in mids]).permute(0, 3, 4, 2, 1)
    gammas = torch.stack([bn.weight for _, bn in mids])
    betas = torch.stack([bn.bias for _, bn in mids])
    a_out, means, vars_ = mid_stack(ws, gammas, betas, a1, store_dtype)
    noise = end_conv(a_out, model.conv_out.weight).float()
    update_running_stats(mids, means, vars_)
    return x - noise if model.residual else noise


def fused_eval_apply(model, x, store_dtype=torch.bfloat16, eval_impl=None):
    """Eval-mode forward of one frame, x: (1, H, W, C) f32 -> (1, H, W, C)
    in the model's output convention (noise, or x - noise when residual)."""
    if x.shape[0] != 1:
        raise ValueError(f"one frame expected, got a batch of {x.shape[0]}")
    return _eval_forward(model, x, store_dtype, eval_impl)


def _spatial_mid_stack(mesh):
    """``fused_train_apply``'s ``mid_stack`` over the slabs of ``mesh``."""
    def mid_stack(ws, gammas, betas, a1, store_dtype):
        H = a1.shape[1]
        a_out, means, vars_ = fused_mid_stack_spatial(
            ws, gammas, betas, _spatial_pad(a1, mesh), H, store_dtype, mesh)
        return a_out[:, :H], means, vars_
    return mid_stack


def fused_train_apply_spatial(model, x, mesh, store_dtype=torch.bfloat16):
    """``fused_train_apply`` with the mid stack of the frame split by rows
    over ``mesh`` (a tuple of devices, ``parallel.spatial.make_space_mesh``;
    the model and x on ``mesh[0]``): the one frame's semantics, BN batch
    statistics over all its pixels (sync-BN)."""
    return fused_train_apply(model, x, store_dtype,
                             mid_stack=_spatial_mid_stack(mesh))


def fused_eval_apply_spatial(model, x, mesh, store_dtype=torch.bfloat16,
                             eval_impl=None):
    """``fused_eval_apply`` with the mid stack of the frame split by rows
    over ``mesh``, on either eval route."""
    if x.shape[0] != 1:
        raise ValueError(f"one frame expected, got a batch of {x.shape[0]}")
    return _eval_forward(model, x, store_dtype, eval_impl, mesh)


def fused_eval_apply_batch(model, x, store_dtype=torch.bfloat16,
                           eval_impl=None):
    """Eval-mode forward of a batch, x: (B, H, W, C) f32 -> (B, H, W, C):
    one launch per mid layer for the whole batch."""
    return _eval_forward(model, x, store_dtype, eval_impl)


def can_fuse(model):
    """The fused kernels cover 64-feature DnCNNs with a mid stack whose
    ``conv_impl`` is ``"fused"``, as in the JAX package; any other
    ``conv_impl``, and any other model, takes the module route."""
    return (isinstance(model, DnCNN) and model.conv_impl == "fused"
            and model.features == 64 and model.num_layers >= 3)


def can_fuse_batch(model, x_shape, budget_bytes, eval_impl=None):
    """Whether a batch of ``x_shape`` (B, H, W, C) fits the one-launch-per-
    layer route within ``budget_bytes`` of device memory. The chain keeps
    about four (B, H, W, 64) activations alive at once (input, output, and
    the f32 upcasts around the end convs), each at the chain's element size.
    """
    _eval_impl(eval_impl)
    if not can_fuse(model):
        return False
    B, H, W, _ = x_shape
    elem = _eval_chain_dtype(eval_impl).itemsize  # bf16 unless "act-f32"
    return 4 * B * H * W * 64 * elem < budget_bytes
