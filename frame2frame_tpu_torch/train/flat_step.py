"""The whole-iteration step of the online fine-tune: one
``torch.autograd.Function`` over conv_in -> (conv + BatchNorm + ReLU)^L ->
last BatchNorm affine + ReLU -> conv_out -> masked summed L1, on kernels
from end to end.

Counterpart of ``frame2frame_tpu/train/flat_step.py``, same names
(``eligible``, ``flat_net_loss``, ``prep_frame``, ``run_flat_scan``). The
forward runs ``first_conv``, ``fwd_layer_train`` x L and ``last_loss_fwd``;
the backward ``last_loss_bwd``, ``bwd_layer`` x L and ``first_dw``
(``ops/fused_ends.py``, ``ops/fused_stack.py``). What depends on the frame
alone (the frame in the chain's dtype, ``aux_c = mask * x - target`` and
``aux_m = mask``) is built once, outside the iterations. The math is that of
``models/fused_apply.fused_train_apply`` with the image-space L1 of
``train/online.make_online_step``: ``loss = sum |mask * (x - net(x)) -
target|``. The routes differ where they round: this one keeps ``noise`` in
f32 and the cotangent in f32 up to ``g_L``'s store, the other rounds both to
bf16 around its end convolutions.

The JAX module works in the TPU's flat pair-packed layout and needs an even
width and an aligned tile geometry; this one works in image space (NHWC) and
takes any height and width.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

from ..models.dncnn import JaxRavel
from ..models.fused_apply import can_fuse, update_running_stats
from ..ops import fused_ends as fe
from ..ops import fused_stack as fs
from ..utils.profiling import annotate


def _layer_functions(mma_bf16=None, kernel_forward=False):
    """The six layer functions of one step: the kernel wrappers, or, with
    ``mma_bf16`` given, their plain versions (with ``kernel_forward``, of the
    backward only)."""
    kernels = SimpleNamespace(
        first_conv=fe.first_conv, fwd=fs.fwd_layer_train,
        last_loss_fwd=fe.last_loss_fwd, last_loss_bwd=fe.last_loss_bwd,
        bwd=fs.bwd_layer, first_dw=fe.first_dw)
    if mma_bf16 is None:
        return kernels
    plain = {
        "first_conv": fe.first_conv_plain, "fwd": fs.fwd_layer_train_plain,
        "last_loss_fwd": fe.last_loss_fwd_plain,
        "last_loss_bwd": fe.last_loss_bwd_plain, "bwd": fs.bwd_layer_plain,
        "first_dw": fe.first_dw_plain}
    forward = ("first_conv", "fwd", "last_loss_fwd")
    return SimpleNamespace(**{
        k: (getattr(kernels, k) if kernel_forward and k in forward
            else functools.partial(f, mma_bf16=mma_bf16))
        for k, f in plain.items()})


class _FlatNetLoss(torch.autograd.Function):
    """loss, means, vars of the DnCNN + masked summed L1 over ``fns``, the
    layer functions (``_layer_functions``)."""

    @staticmethod
    def forward(ctx, w_in, ws, gammas, betas, w_out, x, aux_c, aux_m, fns):
        count = x.numel()
        w_in, w_out = w_in.contiguous(), w_out.contiguous()
        wk = fs.kernel_weights(ws)
        z1 = fns.first_conv(x, w_in)
        zs, ss, bs, means, vars_ = fs.mid_forward(fns.fwd, wk, gammas, betas,
                                                  z1, count)
        noise, loss = fns.last_loss_fwd(zs[-1], ss[-1], bs[-1], w_out, aux_c,
                                        aux_m)
        ctx.save_for_backward(wk, w_out, x, aux_c, aux_m, noise, means, vars_,
                              ss, bs, z1, *zs)
        ctx.fns, ctx.count = fns, count
        ctx.mark_non_differentiable(means, vars_)
        return loss, means, vars_

    @staticmethod
    def backward(ctx, dloss, _dm, _dv):
        (wk, w_out, x, aux_c, aux_m, noise, means, vars_, ss, bs, z1,
         *zs) = ctx.saved_tensors
        fns = ctx.fns
        rstd, nmr = fs.bn_norm(means, vars_)
        # head: loss -> conv_out -> last BatchNorm affine + ReLU, with that
        # BatchNorm's backward sums out of the same kernel
        g, dw_out, stats = fns.last_loss_bwd(
            noise, aux_c, aux_m, zs[-1], w_out,
            torch.stack([ss[-1], bs[-1], rstd[-1], nmr[-1]]))
        dws, dgammas, dbetas, da0 = fs.mid_backward(
            fns.bwd, wk, zs, z1, ss, bs, means, rstd, nmr, ctx.count, g,
            stats[0], stats[1])
        dw_in = fns.first_dw(da0, z1, x)
        return (dw_in * dloss, dws * dloss, dgammas * dloss, dbetas * dloss,
                dw_out * dloss, None, None, None, None)


def _apply(diff, data, fns):
    return _FlatNetLoss.apply(diff["w_in"], diff["ws"], diff["gammas"],
                              diff["betas"], diff["w_out"], data["x"],
                              data["aux_c"], data["aux_m"], fns)


def flat_net_loss(diff, data):
    """(loss, means, vars) of the whole DnCNN and its masked summed L1 loss
    on the kernels.

    diff: ``{"w_in" (3, 3, 1, 64), "ws" (L, 3, 3, 64, 64), "gammas", "betas"
    (L, 64), "w_out" (3, 3, 64, 1)}``, HWIO f32, the differentiated
    parameters (any strides: a permuted view of a module's OIHW weight gets
    its gradient back through autograd); data: ``prep_frame``'s constants,
    whose ``x`` sets the chain's dtype. loss = ``sum |mask * (x - net(x)) -
    target|``, a 0-dim f32; means, vars: (L, 64), the BatchNorm batch
    statistics (biased variance), without gradient."""
    return _apply(diff, data, _layer_functions())


def flat_net_loss_plain(diff, data, mma_bf16=False, kernel_forward=False):
    """``flat_net_loss`` over the plain versions on any device: what
    ``chip_smoke.py`` holds the kernel route against on the card.
    ``kernel_forward`` keeps the kernels for the forward, so that both
    backwards start from the same stored activations and the same ``noise``,
    hence the same ReLU decisions and L1 signs."""
    return _apply(diff, data, _layer_functions(mma_bf16, kernel_forward))


def prep_frame(cur, mask, target, store_dtype=torch.bfloat16):
    """What one frame's iterations share, built once: ``{"x": the frame in
    the chain's dtype, "aux_c": mask * cur - target, "aux_m": mask}``, each
    (H, W), the last two f32. cur, mask, target: (H, W, 1) f32.
    ``store_dtype`` sets the dtype of the whole activation chain: bf16 in
    production, f32 in the strict mode of the tests."""
    def image(t, dtype):
        return t[..., 0].to(dtype).contiguous()

    return {"x": image(cur, store_dtype),
            "aux_c": image(mask * cur - target, torch.float32),
            "aux_m": image(mask.expand_as(cur), torch.float32)}


def eligible(model, x_shape, residual_model):
    """Whether the flat step covers fine-tuning ``model`` on frames of
    ``x_shape`` (H, W, C): ``conv_impl="fused"`` (``can_fuse``, as the JAX
    package asks), 64 features and a mid stack, one channel, the standard
    residual convention (denoised = x - the conv stack's output), all
    parameters on one device."""
    if not can_fuse(model):
        return False
    if x_shape[-1] != 1 or model.channels != 1:
        return False
    if bool(residual_model) != bool(model.residual):
        return False
    return len({p.device for p in model.parameters()}) == 1


def diff_of(model):
    """``flat_net_loss``'s ``diff`` as views of ``model``'s parameters."""
    mids = [model.mid(i) for i in range(model.nmid)]
    return {
        "w_in": model.conv_in.weight.permute(2, 3, 1, 0),
        "ws": torch.stack([conv.weight for conv, _ in mids]).permute(
            0, 3, 4, 2, 1),
        "gammas": torch.stack([bn.weight for _, bn in mids]),
        "betas": torch.stack([bn.bias for _, bn in mids]),
        "w_out": model.conv_out.weight.permute(2, 3, 1, 0),
    }


def run_flat_scan(model, tx, iters, opt_state, cur, mask, target, flat=None):
    """``iters`` Adam updates of ``model`` on one frame with the flat-step
    loss. cur, mask, target: (H, W, 1) f32. ``model``'s parameters and
    running statistics (biased batch variance, momentum 0.9) are updated in
    place; returns (opt_state, losses (iters,), one before each update).
    ``flat``: the model's ``JaxRavel``, where the caller keeps one. Spans:
    ``online.prep``, then one ``online.iter`` an update around
    ``online.forward``, ``online.backward`` and ``online.update``, the
    names of ``train/online.make_online_step``'s other route."""
    flat = flat or JaxRavel(model)
    mids = [model.mid(i) for i in range(model.nmid)]
    with annotate("online.prep"), torch.no_grad():
        data = prep_frame(cur, mask, target)
    losses = []
    for _ in range(iters):
        with annotate("online.iter"):
            with annotate("online.forward"), torch.enable_grad():
                loss, means, vars_ = flat_net_loss(diff_of(model), data)
            with annotate("online.backward"):
                loss.backward()
            with annotate("online.update"):
                update_running_stats(mids, means, vars_)
                updates, opt_state = tx.update(flat.ravel(grads=True),
                                               opt_state, flat.ravel())
                for p in flat.params:
                    p.grad = None
                flat.add(updates)
                losses.append(loss.detach())
    return opt_state, torch.stack(losses)
