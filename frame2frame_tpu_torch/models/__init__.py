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

import itertools

import numpy as np
import torch

from ..config import Config, extract_pairs, optional
from ..utils.device import memory_budget, resolve_device
from ..utils.profiling import annotate, count
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
    tensors. Spans (``utils.profiling``): ``serve.apply``, its id the call's
    number, around ``serve.upload`` (``vid`` and the keyword arrays made
    tensors on the device), ``serve.route`` (the eval route's choice) and
    ``serve.forward``; the counters ``serve.route.fused`` and
    ``serve.route.module`` count the eval calls each route took."""
    cfg = extract_model_config(cfg)
    mtype = optional(cfg, "net_name", "dncnn")
    dtype = model_dtype(cfg.model_dtype)
    device = resolve_device(device)
    if mtype == "dncnn":
        model, variables = init_dncnn(
            cfg.seed, channels=cfg.channels, num_layers=cfg.num_of_layers,
            residual=cfg.residual, conv_impl=cfg.conv_impl, dtype=dtype)
        arch = dncnn
    elif mtype in FASTDVD_NAMES:
        model, variables = init_fastdvdnet(cfg.seed, channels=cfg.channels,
                                           dtype=dtype)
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

    calls = itertools.count(1)

    def apply(vid, train=False, **kw):
        with annotate("serve.apply", next(calls)):
            with annotate("serve.upload"):
                x = tensor(vid)
                kw = {k: tensor(v) if isinstance(v, (np.ndarray, torch.Tensor))
                      else v for k, v in kw.items()}
            if train:
                with annotate("serve.forward"):
                    return _train_apply(model, arch, x, kw)
            with torch.no_grad():
                with annotate("serve.route"):
                    fused = (mtype == "dncnn" and not kw
                             and device.type == "cuda"
                             and can_fuse_batch(model, tuple(x.shape),
                                                memory_budget(device)))
                count("serve.route.fused" if fused else "serve.route.module")
                with annotate("serve.forward"):
                    if fused:
                        return fused_eval_apply_batch(model, x)
                    return model(x, **kw)

    return Config(model=model, variables=variables, apply=apply, cfg=cfg,
                  video_model=mtype in FASTDVD_NAMES)


def model_dtype(name):
    """The torch dtype of a ``model_dtype`` name ("float32", "bfloat16",
    ...): the activations' dtype; the parameters stay f32."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"model_dtype {name!r} is not a floating dtype")
    return dtype


def arch_of(model):
    """The module of ``model``'s architecture (``dncnn`` or ``fastdvdnet``),
    which holds its JAX-tree converters."""
    if isinstance(model, DnCNN):
        return dncnn
    if isinstance(model, (FastDVDnet, FastDVDnetVideo)):
        return fastdvdnet
    raise TypeError(f"no converters for {type(model).__name__}")


def _train_forward(model, x, kw, read):
    """One training-mode forward; returns (out, ``read()`` taken while the
    module holds the moved statistics) and gives the module its statistics
    back."""
    buffers = [b for _, b in model.named_buffers()]
    kept = [b.clone() for b in buffers]
    model.train()
    try:
        out = model(x, **kw)
        moved = read()
    finally:
        model.eval()
        with torch.no_grad():
            for b, k in zip(buffers, kept):
                b.copy_(k)
    return out, moved


def _train_apply(model, arch, x, kw):
    """One training-mode forward; returns (out, {"batch_stats": the moved
    statistics}) and gives the module its statistics back."""
    out, stats = _train_forward(
        model, x, kw, lambda: arch.to_jax_variables(model)["batch_stats"])
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
