"""Plain DnCNN-S (Zhang, Zuo, Chen, Meng, Zhang, "Beyond a Gaussian
Denoiser", IEEE TIP 2017, III-A) and its online fine-tune (frame2frame,
Ehret et al., CVPR 2019: the reference's ``blind_denoising.py``), in float32
PyTorch ops.

The network: a 3x3 convolution from the image's channels to 64 features and
a ReLU; ``nmid`` layers of a 3x3 convolution from 64 to 64 features without
bias, BatchNorm and a ReLU; a 3x3 convolution back to the image's channels.
The last convolution gives the noise, and the denoised image is the input
less the noise (the residual form the repository's checkpoints use).

BatchNorm follows the convention of the checkpoints (flax's): in training a
layer normalises with the batch's mean and biased variance (eps 1e-5) and
moves its running statistics by ``new = 0.9 old + 0.1 batch``, with that
biased variance; in evaluation it normalises with the running statistics.

The state is a dict of tensors keyed as ``torch`` names a ``DnCNN``'s
parameters and buffers: ``conv_in.weight``, ``conv_<i>.weight``,
``bn_<i>.weight``, ``bn_<i>.bias``, ``bn_<i>.running_mean``,
``bn_<i>.running_var``, ``conv_out.weight``; kernels OIHW.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import arithmetic, conv2d
from .warp import bilinear_warp_with_mask, occlusion_mask

EPS = 1e-5
MOMENTUM = 0.9


def state_from_tree(tree, device):
    """A flax checkpoint's ``{"params", "batch_stats"}`` tree (HWIO kernels)
    as the reference's state on ``device``, float32."""
    params, stats = tree["params"], tree["batch_stats"]

    def t(a, oihw=False):
        a = np.array(a, np.float32)
        if oihw:
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {"conv_in.weight": t(params["conv_in"]["kernel"], True),
           "conv_out.weight": t(params["conv_out"]["kernel"], True)}
    for i in range(nmid_of(params)):
        out[f"conv_{i}.weight"] = t(params[f"conv_{i}"]["kernel"], True)
        out[f"bn_{i}.weight"] = t(params[f"bn_{i}"]["scale"])
        out[f"bn_{i}.bias"] = t(params[f"bn_{i}"]["bias"])
        out[f"bn_{i}.running_mean"] = t(stats[f"bn_{i}"]["mean"])
        out[f"bn_{i}.running_var"] = t(stats[f"bn_{i}"]["var"])
    return out


def nmid_of(params):
    return sum(1 for k in params if k.startswith("conv_") and k[5:].isdigit())


def param_names(state):
    """The trainable entries of ``state``: every one but the running
    statistics."""
    return [k for k in state if "running_" not in k]


def forward(state, x, train=False, mode="f32"):
    """(denoised, [(mean, var)] of each mid layer's batch in training) for
    ``x`` (B, C, H, W); to be called inside ``arithmetic(mode)``."""
    nmid = sum(1 for k in state if k.startswith("bn_") and k.endswith("bias"))
    h = torch.relu(conv2d(x, state["conv_in.weight"], mode))
    stats = []
    for i in range(nmid):
        z = conv2d(h, state[f"conv_{i}.weight"], mode)
        if train:
            var, mean = torch.var_mean(z, dim=(0, 2, 3), unbiased=False)
            stats.append((mean.detach(), var.detach()))
        else:
            mean = state[f"bn_{i}.running_mean"]
            var = state[f"bn_{i}.running_var"]
        scale = state[f"bn_{i}.weight"] * torch.rsqrt(var + EPS)
        z = (z - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1)
        h = torch.relu(z + state[f"bn_{i}.bias"].view(1, -1, 1, 1))
    return x - conv2d(h, state["conv_out.weight"], mode), stats


@torch.no_grad()
def denoise(state, frames, mode="f32", chunk=1):
    """Eval-mode denoise of (B, H, W, C) frames, ``chunk`` frames a pass."""
    out = []
    with arithmetic(mode):
        for x in frames.split(chunk):
            y, _ = forward(state, x.permute(0, 3, 1, 2), False, mode)
            out.append(y.permute(0, 2, 3, 1))
    return torch.cat(out)


class Adam:
    """``torch.optim.Adam`` with L2 weight decay (the decay added to the
    gradient before the moments), a tensor at a time: the state is
    ``{"count": n, "m": {name: tensor}, "v": {name: tensor}}``."""

    def __init__(self, lr, weight_decay, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay, b1,
                                                        b2, eps)

    def init(self, params):
        return {"count": 0,
                "m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def step(self, params, grads, opt):
        """Update ``params`` in place; returns the new state."""
        count = opt["count"] + 1
        c1 = 1.0 - self.b1 ** count
        c2 = 1.0 - self.b2 ** count
        m, v = {}, {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            m[k] = self.b1 * opt["m"][k] + (1 - self.b1) * g
            v[k] = self.b2 * opt["v"][k] + (1 - self.b2) * g * g
            p += -self.lr * ((m[k] / c1) / (torch.sqrt(v[k] / c2) + self.eps))
        return {"count": count, "m": m, "v": v}


def finetune_frame(state, opt, adam, cur, prev, flow, iters, mode="f32"):
    """One frame of the online fine-tune: the previous frame warped by the
    flow and masked where the flow is occluded or leaves the frame, then
    ``iters`` Adam updates of the network in training mode on the summed
    masked L1 distance between the denoised current frame and that target,
    then the eval-mode denoise of the current frame with the updated
    weights. ``cur``, ``prev``: (H, W, C) in [0, 1]; ``flow``: (H, W, 2),
    current to previous coordinates. Updates ``state`` in place; returns
    (opt, denoised (H, W, C), losses (iters,), the first update's
    gradients)."""
    with torch.no_grad():
        warped, mask = bilinear_warp_with_mask(prev, flow)
        mask = occlusion_mask(flow, mask)
        target = (mask * warped).permute(2, 0, 1)[None]
        mask = mask.permute(2, 0, 1)[None]
    x = cur.permute(2, 0, 1)[None]
    names = param_names(state)
    nmid = len([k for k in names if k.endswith(".bias")])
    losses, first = [], None
    with arithmetic(mode):
        for _ in range(iters):
            params = {k: state[k].detach().requires_grad_(True)
                      for k in names}
            y, stats = forward({**state, **params}, x, True, mode)
            loss = (mask * y - target).abs().sum()
            grads = dict(zip(names, torch.autograd.grad(loss, list(
                params.values()))))
            if first is None:
                first = grads
            with torch.no_grad():
                for i, (mean, var) in enumerate(stats[:nmid]):
                    for key, batch in (("running_mean", mean),
                                       ("running_var", var)):
                        buf = state[f"bn_{i}.{key}"]
                        buf.mul_(MOMENTUM).add_(batch, alpha=1 - MOMENTUM)
                plain = {k: state[k] for k in names}
                opt = adam.step(plain, grads, opt)
            losses.append(float(loss.detach()))
        with torch.no_grad():
            deno, _ = forward(state, x, False, mode)
    return opt, deno[0].permute(1, 2, 0), torch.tensor(losses), first
