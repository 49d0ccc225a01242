"""Eval-mode DnCNN forward on the fused mid-layer kernels (the serving path).

Counterpart of ``frame2frame_tpu/models/fused_apply.py``'s
``fused_eval_apply`` and ``fused_eval_apply_batch``. The 15 mid layers of
DnCNN-17 run as ``ops/fused_stack`` kernels; the C<->64 end convs stay plain
``F.conv2d`` (XLA computed them in the JAX package), with bf16 operands and a
bf16 result on the bf16 chain.

Two eval implementations (``eval_impl``):
- ``"affine"`` (default): activations chain as raw conv outputs; each
  ``fwd_layer`` applies the previous layer's eval BN affine + ReLU to its
  operand. The last affine + ReLU before ``conv_out`` is plain torch.
- ``"act-bf16"`` / ``"act-f32"``: activations chain post-activation in the
  named dtype; ``fwd_layer_eval`` applies the layer's eval BN affine + ReLU
  in its epilogue.

Frames are NHWC throughout; a batch is the batch dimension of one kernel
launch per layer, its frames isolated by per-image SAME padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fused_stack import (
    _affine_from_stats,
    fwd_layer,
    fwd_layer_eval,
    kernel_weights,
)

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


def _make_end_conv(store_dtype):
    """The C<->64 boundary convs on NHWC tensors: operands and result in
    ``store_dtype``."""
    def end_conv(x, w):
        out = F.conv2d(x.to(store_dtype).permute(0, 3, 1, 2),
                       w.to(store_dtype), padding=1)
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


@torch.no_grad()
def _eval_forward(model, x, store_dtype, eval_impl):
    end_conv = _make_end_conv(store_dtype)
    a1 = torch.relu(end_conv(x, model.conv_in.weight))
    if _eval_impl(eval_impl) == "act":
        a_out = _act_eval_mid_stack(model, a1, eval_impl)
    else:
        a_out = _affine_mid_stack(model, a1, store_dtype)
    noise = end_conv(a_out, model.conv_out.weight).float()
    return x - noise if model.residual else noise


def fused_eval_apply(model, x, store_dtype=torch.bfloat16, eval_impl=None):
    """Eval-mode forward of one frame, x: (1, H, W, C) f32 -> (1, H, W, C)
    in the model's output convention (noise, or x - noise when residual)."""
    if x.shape[0] != 1:
        raise ValueError(f"one frame expected, got a batch of {x.shape[0]}")
    return _eval_forward(model, x, store_dtype, eval_impl)


def fused_eval_apply_batch(model, x, store_dtype=torch.bfloat16,
                           eval_impl=None):
    """Eval-mode forward of a batch, x: (B, H, W, C) f32 -> (B, H, W, C):
    one launch per mid layer for the whole batch."""
    return _eval_forward(model, x, store_dtype, eval_impl)


def can_fuse(model):
    """The fused kernels cover 64-feature DnCNNs with a mid stack."""
    return model.features == 64 and model.num_layers >= 3


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
