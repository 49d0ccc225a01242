"""DnCNN denoiser as a PyTorch module, with the weight converters.

Counterpart of ``frame2frame_tpu/models/dncnn.py``: Conv3x3(64, no bias) +
ReLU, (L-2) x [Conv3x3(64, no bias) + BatchNorm + ReLU], Conv3x3(C, no bias).
Submodules carry the Flax names ``conv_in``, ``conv_{i}``, ``bn_{i}`` and
``conv_out``, so a JAX variable tree maps onto the module name for name
(``from_jax_variables`` / ``to_jax_variables``), and the flat optimizer state
of ``train.online.torch_adam`` crosses over in the JAX package's
``ravel_pytree`` order (``opt_state_from_jax`` / ``opt_state_to_jax``). The
parameters have the same names and shapes under every ``conv_impl``.

Two output conventions, as in the JAX model:
- ``residual=False``: returns the predicted noise;
- ``residual=True``: returns the denoised image ``x - noise``.

``forward`` is the module route; frames are NHWC ``(B, H, W, C)`` at the
interface, as in the JAX package. ``conv_impl`` picks its convolutions as
the JAX model's does (``CONV_IMPLS``):

- ``"xla"``, ``"packed"``: the f32 graph on the library's convolution
  (TF32 off). The JAX package's pair packing is a TPU layout, and its
  packed BatchNorm the same math.
- ``"pallas"``, ``"hybrid"``, ``"bf16res"``: the f32 graph on
  ``ops/conv3x3.py``'s ``conv3x3``, ``conv3x3_hybrid``, ``conv3x3_bf16res``.
- ``"packed_bf16"``: bf16 convolution operands and activations
  (``conv3x3_bf16``, dW in f32 on kernel B for every layer); BatchNorm's
  statistics in f32, its affine cast to bf16 (``PackedBatchNorm``).
- ``"fused"`` (the port's default; the JAX package's ``init_dncnn`` picks it
  on its accelerator): the engine (``train/online.py``) runs the fused
  kernels where ``fused_apply.can_fuse``; the module route is what the JAX
  model runs for it, the ``"packed_bf16"`` graph.
- ``"packed_bf16"`` and ``"fused"`` on an odd width: the f32 graph, as the
  JAX model falls back per call (pair packing needs an even width).

``dtype`` (the JAX model's ``dtype``, ``load_model``'s ``model_dtype``) is
the activations' dtype on the unpacked routes ("xla", "pallas", "hybrid",
"bf16res", and "packed", "packed_bf16", "fused" on an odd width); the
parameters stay f32. There each convolution's output is cast to it: "xla"
convolves operands cast to it, as flax's ``nn.Conv(dtype=)`` does, while
"pallas", "hybrid" and "bf16res" convolve in f32 and cast the result, as
the JAX package's ``Conv3x3`` does, so kernels A and B see f32 operands.
BatchNorm computes in f32 and returns ``dtype``. On the packed routes at an
even width ``dtype`` changes nothing, as in the JAX model, whose packed
convolutions take their dtype from ``conv_impl``.

In training mode BatchNorm normalises with the batch's biased variance and
stores that biased variance in the running statistics (``nn.BatchNorm2d``
would store the unbiased one); the running statistics are updated once, after
the forward, so that a checkpointed group (``remat_every``) that runs its
forward again in the backward does not update them twice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.conv3x3 import conv_function
from . import sync_bn

CONV_IMPLS = ("fused", "xla", "packed", "packed_bf16", "pallas", "hybrid",
              "bf16res")
BN_MOMENTUM = 0.9  # flax convention: new = m * old + (1 - m) * batch


class DnCNN(nn.Module):
    """``remat_every`` > 0 checkpoints groups of that many mid layers in a
    training forward (``torch.utils.checkpoint``): only the groups' inputs
    are kept, and each group runs its forward again in the backward.
    ``plain_backward``, an attribute off by default, takes the plain
    versions of the kernels in the backward of the ``conv_impl`` routes
    (``ops.conv3x3.conv_function``)."""

    def __init__(self, channels=1, num_layers=17, features=64, residual=False,
                 conv_impl="fused", remat_every=0, dtype=torch.float32):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got "
                             f"{conv_impl!r}")
        self.dtype = dtype
        self.channels = channels
        self.num_layers = num_layers
        self.features = features
        self.residual = residual
        self.conv_impl = conv_impl
        self.remat_every = remat_every
        self.plain_backward = False
        # parameter holders: forward takes their weights, never calls them
        self.conv_in = nn.Conv2d(channels, features, 3, padding=1, bias=False)
        for i in range(num_layers - 2):
            setattr(self, f"conv_{i}",
                    nn.Conv2d(features, features, 3, padding=1, bias=False))
            setattr(self, f"bn_{i}",
                    nn.BatchNorm2d(features, eps=1e-5, momentum=0.1))
        self.conv_out = nn.Conv2d(features, channels, 3, padding=1, bias=False)

    @property
    def nmid(self):
        return self.num_layers - 2

    def mid(self, i):
        """(conv, bn) of mid layer i."""
        return getattr(self, f"conv_{i}"), getattr(self, f"bn_{i}")

    def forward(self, x):
        """x: (B, H, W, C) f32 -> noise or denoised image, (B, H, W, C) f32."""
        impl = self.conv_impl
        packed = (impl in ("packed", "packed_bf16", "fused")
                  and x.shape[2] % 2 == 0)
        if impl in ("packed_bf16", "fused"):
            impl = "bf16" if packed else "xla"
        bf16 = impl == "bf16"
        conv = conv_function(impl, self.plain_backward)
        bn = _bn_bf16 if bf16 else _bn_f32
        if not packed and self.dtype != torch.float32:
            conv, bn = _in_dtype(conv, bn, impl in ("xla", "packed"),
                                 self.dtype)
        h = x.to(torch.bfloat16) if bf16 else x
        h = torch.relu(conv(h, _kernel(self.conv_in)))

        def group(h, i0, k):
            stats = []
            for i in range(i0, i0 + k):
                conv_i, bn_i = self.mid(i)
                z, st = bn(bn_i, conv(h, _kernel(conv_i)), self.training)
                h = torch.relu(z)
                stats.append(st)
            return h, stats

        every = self.remat_every if torch.is_grad_enabled() else 0
        step = max(every or self.nmid, 1)
        stats = []
        for i0 in range(0, self.nmid, step):
            k = min(step, self.nmid - i0)
            if every:
                h, st = checkpoint(group, h, i0, k, use_reentrant=False)
            else:
                h, st = group(h, i0, k)
            stats += st
        noise = conv(h, _kernel(self.conv_out))
        if bf16:
            noise = noise.float()
        if self.training and stats:
            update_running_stats([self.mid(i) for i in range(self.nmid)],
                                 torch.stack([m for m, _ in stats]),
                                 torch.stack([v for _, v in stats]))
        return x - noise if self.residual else noise


def _in_dtype(conv, bn, library, dtype):
    """The convolution and BatchNorm of an unpacked route with activations
    in ``dtype`` (the JAX model's ``dtype``): the library's convolution on
    operands cast to ``dtype`` (flax's ``nn.Conv``), the other routes' in
    f32 with the result cast (the JAX package's ``Conv3x3``); BatchNorm in
    f32, its output cast (flax's ``nn.BatchNorm``)."""
    if library:
        def conv_d(h, w):
            return conv(h.to(dtype), w.to(dtype))
    else:
        def conv_d(h, w):
            return conv(h.float(), w).to(dtype)

    def bn_d(bn_i, z, training):
        y, st = bn(bn_i, z.float(), training)
        return y.to(dtype), st

    return conv_d, bn_d


def _kernel(conv):
    """An ``nn.Conv2d``'s OIHW weight as the HWIO view the convolutions
    take; autograd carries the gradient back through the view."""
    return conv.weight.permute(2, 3, 1, 0)


def _bn_f32(bn, z, training):
    """BatchNorm of NHWC f32 ``z``: (y, None) with the running statistics,
    (y, (mean, biased var)) with the batch's in training, the whole
    batch's inside a data-parallel shard (``sync_bn``)."""
    zc = z.permute(0, 3, 1, 2)
    if not training:
        y = F.batch_norm(zc, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
        return y.permute(0, 2, 3, 1), None
    if sync_bn.active():
        # the whole batch's statistics over the data-parallel shards
        mean = sync_bn.mean(z, (0, 1, 2))
        d = z - mean
        var = sync_bn.mean(d * d, (0, 1, 2))
        y = d * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
        return y, (mean.detach(), var.detach())
    with torch.no_grad():
        var, mean = torch.var_mean(z, dim=(0, 1, 2), unbiased=False)
    if z.device.type == "cpu":
        # the CPU's batch_norm on a channels-last view sums a channel's
        # statistics and gradients in f32 one value after another (4e-5 off
        # float64 at 61 440 values a channel on one thread); on contiguous
        # NCHW its reductions stay within 6e-7
        zc = zc.contiguous()
    y = F.batch_norm(zc, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    return y.permute(0, 2, 3, 1), (mean, var)


def _bn_bf16(bn, z, training):
    """The JAX package's ``PackedBatchNorm`` on NHWC bf16 ``z``: statistics
    in f32 (``E[z^2] - E[z]^2``), the per-channel affine cast to bf16 so the
    chain stays bf16."""
    if training:
        zf = z.float()
        if sync_bn.active():
            m = sync_bn.mean(zf, (0, 1, 2))
            v = sync_bn.mean(zf * zf, (0, 1, 2)) - m * m
        else:
            m = zf.mean((0, 1, 2))
            v = (zf * zf).mean((0, 1, 2)) - m * m
        stats = (m.detach(), v.detach())
    else:
        m, v, stats = bn.running_mean, bn.running_var, None
    inv = torch.rsqrt(v + bn.eps) * bn.weight
    return z * inv.to(z.dtype) + (bn.bias - m * inv).to(z.dtype), stats


@torch.no_grad()
def update_running_stats(mids, means, vars_):
    """``new = 0.9 * old + 0.1 * batch`` in place on the running statistics
    of ``mids`` (the (conv, bn) pairs), from the batch statistics (L, 64)."""
    for key, batch in (("running_mean", means), ("running_var", vars_)):
        bufs = [getattr(bn, key) for _, bn in mids]
        torch._foreach_mul_(bufs, BN_MOMENTUM)
        torch._foreach_add_(bufs, list(batch.unbind(0)),
                            alpha=1 - BN_MOMENTUM)


def init_dncnn(seed=0, channels=1, num_layers=17, residual=False,
               conv_impl="auto", remat_every=0, dtype=torch.float32):
    """A new DnCNN and its JAX-layout variables: ``(model, variables)``.

    Conv kernels are lecun-normal as flax initialises them (a normal
    truncated at two standard deviations, scaled to variance 1 / fan_in),
    drawn from a ``torch.Generator`` seeded with ``seed``: the values differ
    from ``jax.random.PRNGKey(seed)``'s. BatchNorm starts at scale 1, bias 0,
    mean 0, variance 1. ``conv_impl="auto"`` is ``"fused"``."""
    model = DnCNN(channels=channels, num_layers=num_layers, residual=residual,
                  conv_impl="fused" if conv_impl == "auto" else conv_impl,
                  remat_every=remat_every, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    # flax's truncated normal: unit variance after truncation at +-2
    std_of_truncated = 0.87962566103423978
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = math.sqrt(1.0 / (9 * m.in_channels)) / std_of_truncated
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
    return model, to_jax_variables(model)


def _hwio(w):
    """torch OIHW conv weight -> HWIO numpy."""
    return np.ascontiguousarray(w.detach().cpu().numpy().transpose(2, 3, 1, 0))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


def load_jax_variables(model, variables):
    """Copy a JAX ``{"params", "batch_stats"}`` tree (numpy leaves, HWIO conv
    kernels) into ``model`` in place; returns ``model``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    with torch.no_grad():
        def put(t, v):
            t.copy_(v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v, np.float32)))

        put(model.conv_in.weight, _oihw(params["conv_in"]["kernel"]))
        put(model.conv_out.weight, _oihw(params["conv_out"]["kernel"]))
        for i in range(model.nmid):
            conv, bn = model.mid(i)
            put(conv.weight, _oihw(params[f"conv_{i}"]["kernel"]))
            put(bn.weight, params[f"bn_{i}"]["scale"])
            put(bn.bias, params[f"bn_{i}"]["bias"])
            put(bn.running_mean, stats[f"bn_{i}"]["mean"])
            put(bn.running_var, stats[f"bn_{i}"]["var"])
    return model


def from_jax_variables(variables, residual=False, conv_impl="fused",
                       remat_every=0, dtype=torch.float32):
    """The JAX variable tree -> a ``DnCNN`` (CPU, f32 weights, activations
    in ``dtype``) holding its weights. Channels and depth are read from the
    tree."""
    params = variables["params"]
    k_in = np.asarray(params["conv_in"]["kernel"])
    nmid = sum(1 for k in params if k.startswith("conv_") and k[5:].isdigit())
    model = DnCNN(channels=k_in.shape[2], num_layers=nmid + 2,
                  features=k_in.shape[3], residual=residual,
                  conv_impl=conv_impl, remat_every=remat_every, dtype=dtype)
    return load_jax_variables(model, variables)


def to_jax_variables(model):
    """Inverse of ``from_jax_variables``: numpy f32 leaves, HWIO kernels."""
    def np32(t):
        return t.detach().cpu().float().numpy().copy()

    params = {"conv_in": {"kernel": _hwio(model.conv_in.weight)},
              "conv_out": {"kernel": _hwio(model.conv_out.weight)}}
    stats = {}
    for i in range(model.nmid):
        conv, bn = model.mid(i)
        params[f"conv_{i}"] = {"kernel": _hwio(conv.weight)}
        params[f"bn_{i}"] = {"scale": np32(bn.weight), "bias": np32(bn.bias)}
        stats[f"bn_{i}"] = {"mean": np32(bn.running_mean),
                            "var": np32(bn.running_var)}
    return {"params": params, "batch_stats": stats}


def param_leaves(model):
    """The model's parameters as (name, parameter) pairs in the order
    ``jax.flatten_util.ravel_pytree`` gives the JAX params: sorted names
    (``bn_0``, ``bn_1``, ``bn_10``, ..., ``conv_0``, ..., ``conv_in``,
    ``conv_out``), ``bias`` before ``scale`` within a BatchNorm."""
    bns = sorted(f"bn_{i}" for i in range(model.nmid))
    convs = sorted([f"conv_{i}" for i in range(model.nmid)]
                   + ["conv_in", "conv_out"])
    leaves = []
    for name in bns:
        bn = getattr(model, name)
        leaves += [(f"{name}.bias", bn.bias), (f"{name}.scale", bn.weight)]
    return leaves + [(f"{name}.kernel", getattr(model, name).weight)
                     for name in convs]


class JaxRavel:
    """``model``'s parameters as one f32 vector in the JAX package's
    ``ravel_pytree`` order (``param_leaves``; a conv kernel, OIHW here,
    ravels HWIO), and back.

    The order is applied by one gather through an index built once, so a
    fine-tune iteration costs a few launches here, not a few per parameter.
    The index lives on the device the parameters had at construction."""

    def __init__(self, model):
        self.params = [p for _, p in param_leaves(model)]
        self.sizes = [p.numel() for p in self.params]
        index, off = [], 0
        for p in self.params:
            i = torch.arange(off, off + p.numel(), device=p.device).view(p.shape)
            index.append((i.permute(2, 3, 1, 0) if p.dim() == 4 else i)
                         .reshape(-1))
            off += p.numel()
        self._to_jax = torch.cat(index)
        self._from_jax = torch.empty_like(self._to_jax)
        self._from_jax[self._to_jax] = torch.arange(off, device=index[0].device)

    def ravel(self, grads=False):
        """The parameters, or their ``.grad``, raveled."""
        leaves = [(p.grad if grads else p.detach()).reshape(-1)
                  for p in self.params]
        return torch.cat(leaves)[self._to_jax]

    @torch.no_grad()
    def add(self, flat):
        """``param += update`` in place for every parameter, ``flat`` in
        the order of ``ravel``."""
        parts = flat[self._from_jax].split(self.sizes)
        torch._foreach_add_(self.params, [u.view_as(p) for u, p
                                          in zip(parts, self.params)])


def opt_state_from_jax(state, device="cpu"):
    """The JAX ``torch_adam`` state ``{"count", "m", "v"}`` (numpy or JAX
    leaves) as the port's: ``count`` a Python int, ``m`` and ``v`` f32
    tensors on ``device`` in the same ``ravel_pytree`` order."""
    def vec(v):
        return torch.from_numpy(np.array(v, np.float32)).to(device)

    return {"count": int(np.asarray(state["count"])),
            "m": vec(state["m"]), "v": vec(state["v"])}


def opt_state_to_jax(state):
    """Inverse of ``opt_state_from_jax``: numpy leaves, ``count`` int32."""
    return {"count": np.asarray(state["count"], np.int32),
            "m": state["m"].detach().cpu().numpy().copy(),
            "v": state["v"].detach().cpu().numpy().copy()}


def import_torch_state_dict(state_dict, num_layers=17):
    """Convert a reference torch DnCNN ``state_dict`` (sequential
    ``[module.]dncnn.{idx}.*`` keys, OIHW weights) to JAX-layout variables
    (numpy, HWIO). Values may be torch tensors or numpy arrays."""
    def to_np(v):
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.array(v)

    flat = {}
    for k, v in state_dict.items():
        for prefix in ("module.", "net.", "dncnn."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        flat[k] = to_np(v)

    def conv_hwio(w):
        return np.transpose(w, (2, 3, 1, 0))

    # sequential indices: conv at 0; blocks of (conv, bn, relu) at
    # (2+3i, 3+3i); final conv at 2+3*(L-2)
    params = {"conv_in": {"kernel": conv_hwio(flat["0.weight"])}}
    batch_stats = {}
    for i in range(num_layers - 2):
        ci, bi = 2 + 3 * i, 3 + 3 * i
        params[f"conv_{i}"] = {"kernel": conv_hwio(flat[f"{ci}.weight"])}
        params[f"bn_{i}"] = {"scale": flat[f"{bi}.weight"],
                             "bias": flat[f"{bi}.bias"]}
        batch_stats[f"bn_{i}"] = {"mean": flat[f"{bi}.running_mean"],
                                  "var": flat[f"{bi}.running_var"]}
    params["conv_out"] = {
        "kernel": conv_hwio(flat[f"{2 + 3 * (num_layers - 2)}.weight"])}
    return {"params": params, "batch_stats": batch_stats}


def export_torch_state_dict(variables, num_layers=17):
    """Inverse of ``import_torch_state_dict``: JAX-layout variables -> a
    reference-style state dict (numpy, ``dncnn.{idx}.*`` keys, OIHW)."""
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})

    def conv_oihw(w):
        return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))

    sd = {"dncnn.0.weight": conv_oihw(params["conv_in"]["kernel"])}
    for i in range(num_layers - 2):
        ci, bi = 2 + 3 * i, 3 + 3 * i
        sd[f"dncnn.{ci}.weight"] = conv_oihw(params[f"conv_{i}"]["kernel"])
        sd[f"dncnn.{bi}.weight"] = np.asarray(params[f"bn_{i}"]["scale"])
        sd[f"dncnn.{bi}.bias"] = np.asarray(params[f"bn_{i}"]["bias"])
        sd[f"dncnn.{bi}.running_mean"] = np.asarray(
            batch_stats[f"bn_{i}"]["mean"])
        sd[f"dncnn.{bi}.running_var"] = np.asarray(
            batch_stats[f"bn_{i}"]["var"])
        sd[f"dncnn.{bi}.num_batches_tracked"] = np.asarray(0)
    sd[f"dncnn.{2 + 3 * (num_layers - 2)}.weight"] = conv_oihw(
        params["conv_out"]["kernel"])
    return sd


def load_torch_checkpoint(path, num_layers=17):
    """Load a reference ``.pth`` DnCNN checkpoint into JAX-layout variables."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and not any(hasattr(v, "shape")
                                         for v in obj.values()):
        obj = obj.get("state_dict", obj)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return import_torch_state_dict(obj, num_layers=num_layers)
