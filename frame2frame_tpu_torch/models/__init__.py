"""Model registry and config-driven loading.

Counterpart of ``frame2frame_tpu/models/__init__.py``, the replacement for the
reference dispatch (lib/frame2frame/__init__.py:19-39): ``net_name`` selects
dncnn or fastdvdnet; ``extract_model_config`` collects the arch/io pairs
(lib/frame2frame/dncnn/io.py:68-80); ``load_model`` builds the model on a
device, restores pretrained weights and returns ``apply``.

``apply(vid)`` in eval mode serves a 64-feature DnCNN with
``conv_impl="fused"`` on a CUDA card through ``fused_apply.
fused_eval_apply_batch`` (one ``fwd_layer`` launch a mid layer for the whole
batch) wherever ``can_fuse_batch`` admits the batch into the card's free
memory, the rule of ``OnlineDenoiser.denoise_batch``; the JAX package takes
that route on its TPU unless ``F2F_FUSED=0``. Every other model, route or
device takes the module's own forward.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config, extract_pairs, optional
from ..utils.device import memory_budget, resolve_device
from . import dncnn, fastdvdnet
from .dncnn import DnCNN, init_dncnn, load_torch_checkpoint
from .fastdvdnet import FastDVDnet, FastDVDnetVideo, init_fastdvdnet
from .fused_apply import can_fuse_batch, fused_eval_apply_batch

FASTDVD_NAMES = ("fastdvd", "fastdvdnet", "fdvdnet", "fdvd")


def arch_pairs():
    # reference dncnn/io.py:68-70 defaults; conv_impl selects the DnCNN's
    # convolutions (models/dncnn.py), "fused" also the fused serving kernels
    return {"channels": 3, "num_of_layers": 17, "residual": True, "seed": 0,
            "model_dtype": "float32", "conv_impl": "xla"}


def io_pairs():
    # reference dncnn/io.py:73-80
    return {"pretrained_path": "", "pretrained_root": "", "pretrained_type": "",
            "pretrained_load": False, "net_name": "dncnn"}


def extract_model_config(cfg):
    pairs = dict(arch_pairs())
    pairs.update(io_pairs())
    return extract_pairs(cfg, pairs)


def load_model(cfg, device=None):
    """Build a model from a config on ``device`` (None: the CUDA card, and
    raises where there is none).

    Returns a Config with fields: model (the module, on the device, in eval
    mode), variables (its weights as the JAX package's tree of numpy arrays),
    apply, cfg (the extracted config) and video_model (FastDVDnet).

    ``apply(vid, **kw)`` -> the eval-mode output, without an autograd graph;
    ``apply(vid, train=True, **kw)`` -> ``(out, {"batch_stats": tree})``, the
    training-mode output (differentiable in ``model``'s parameters) and the
    moved running statistics in the JAX layout, as ``mutable=
    ["batch_stats"]`` returns them; the module's own statistics are left as
    they were. ``vid``: frames (B, H, W, C) for DnCNN, a video (B, T, H, W,
    C) for FastDVDnet (``kw``: ``noise_map``, ``sigma``); numpy arrays or
    tensors."""
    cfg = extract_model_config(cfg)
    mtype = optional(cfg, "net_name", "dncnn")
    if cfg.model_dtype != "float32":
        raise ValueError(f"model_dtype {cfg.model_dtype!r}: the port's models "
                         "hold f32 weights (conv_impl picks the bf16 graph)")
    device = resolve_device(device)
    if mtype == "dncnn":
        model, variables = init_dncnn(
            cfg.seed, channels=cfg.channels, num_layers=cfg.num_of_layers,
            residual=cfg.residual, conv_impl=cfg.conv_impl)
        arch = dncnn
    elif mtype in FASTDVD_NAMES:
        model, variables = init_fastdvdnet(cfg.seed, channels=cfg.channels)
        arch = fastdvdnet
    else:
        raise ValueError(f"Unknown model type [{mtype}]")

    if cfg.pretrained_load and cfg.pretrained_path:
        variables = load_checkpoint(variables, cfg.pretrained_path,
                                    num_layers=cfg.num_of_layers)
        arch.load_jax_variables(model, variables)
    model = model.to(device).eval()

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def apply(vid, train=False, **kw):
        x = tensor(vid)
        kw = {k: tensor(v) if isinstance(v, (np.ndarray, torch.Tensor)) else v
              for k, v in kw.items()}
        if train:
            return _train_apply(model, arch, x, kw)
        with torch.no_grad():
            if (mtype == "dncnn" and not kw and device.type == "cuda"
                    and can_fuse_batch(model, tuple(x.shape),
                                       memory_budget(device))):
                return fused_eval_apply_batch(model, x)
            return model(x, **kw)

    return Config(model=model, variables=variables, apply=apply, cfg=cfg,
                  video_model=mtype in FASTDVD_NAMES)


def _train_apply(model, arch, x, kw):
    """One training-mode forward; returns (out, {"batch_stats": the moved
    statistics}) and gives the module its statistics back."""
    buffers = [b for _, b in model.named_buffers()]
    kept = [b.clone() for b in buffers]
    model.train()
    try:
        out = model(x, **kw)
        stats = arch.to_jax_variables(model)["batch_stats"]
    finally:
        model.eval()
        with torch.no_grad():
            for b, k in zip(buffers, kept):
                b.copy_(k)
    return out, {"batch_stats": stats}


def load_checkpoint(variables, path, num_layers=17):
    """Pretrained weights: a reference ``.pth`` / ``.pt`` DnCNN checkpoint
    (torch interop), else a flax msgpack file restored into ``variables``'
    structure."""
    path = str(path)
    if path.endswith((".pth", ".pt")):
        new = load_torch_checkpoint(path, num_layers=num_layers)
        return {**variables, **new}
    from . import serialization

    return serialization.load_variables(path, like=variables)
