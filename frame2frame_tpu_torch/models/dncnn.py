"""DnCNN denoiser as a PyTorch module, with the weight converters.

Counterpart of ``frame2frame_tpu/models/dncnn.py``: Conv3x3(64, no bias) +
ReLU, (L-2) x [Conv3x3(64, no bias) + BatchNorm + ReLU], Conv3x3(C, no bias).
Submodules carry the Flax names ``conv_in``, ``conv_{i}``, ``bn_{i}`` and
``conv_out``, so a JAX variable tree maps onto the module name for name
(``from_jax_variables`` / ``to_jax_variables``).

Two output conventions, as in the JAX model:
- ``residual=False``: returns the predicted noise;
- ``residual=True``: returns the denoised image ``x - noise``.

``forward`` is the plain module graph; frames are NHWC ``(B, H, W, C)`` at
the interface, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class DnCNN(nn.Module):
    def __init__(self, channels=1, num_layers=17, features=64, residual=False):
        super().__init__()
        self.channels = channels
        self.num_layers = num_layers
        self.features = features
        self.residual = residual
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
        """x: (B, H, W, C) -> noise or denoised image, (B, H, W, C)."""
        h = torch.relu(self.conv_in(x.permute(0, 3, 1, 2)))
        for i in range(self.nmid):
            conv, bn = self.mid(i)
            h = torch.relu(bn(conv(h)))
        noise = self.conv_out(h).permute(0, 2, 3, 1)
        return x - noise if self.residual else noise


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


def from_jax_variables(variables, residual=False):
    """The JAX variable tree -> a ``DnCNN`` (CPU, f32) holding its weights.
    Channels and depth are read from the tree."""
    params = variables["params"]
    k_in = np.asarray(params["conv_in"]["kernel"])
    nmid = sum(1 for k in params if k.startswith("conv_") and k[5:].isdigit())
    model = DnCNN(channels=k_in.shape[2], num_layers=nmid + 2,
                  features=k_in.shape[3], residual=residual)
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
