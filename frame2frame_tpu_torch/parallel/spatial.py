"""Spatial (single-frame) splitting: one frame divided by rows (H) over the
devices of a ``space`` mesh.

Counterpart of ``frame2frame_tpu/parallel/spatial.py``, the JAX package's
third scaling axis, for frames too large or too slow for one chip (1080p,
4K). ``jax.shard_map`` is one program driven by one controller; so is the
port: one process drives every slab, a mesh is an ordered tuple of
``torch.device``s, and a device may repeat (one card runs D slabs one after
another on its stream; the CPU tests run so). The fused mid stack is split
(``ops/fused_spatial.py``); the end convs, the warp, the occlusion mask, the
loss and Adam run on the whole frame on the mesh's first device, where the
JAX package lets XLA's SPMD partitioner split them. A model whose
``conv_impl`` is not ``"fused"`` runs unsplit (the partitioner would split
it there, with the same result).
"""

from __future__ import annotations

import torch

from ..ops.fused_spatial import as_device, gather_frame, pad_h, split_frame

__all__ = ["gather_frame", "make_space_mesh", "make_spatial_online_step",
           "pad_h", "split_frame"]


def make_space_mesh(n_space=None, devices=None, device=None):
    """A 1-D mesh along ``space``: a tuple of ``n_space`` devices.

    By default the card's devices (all of them, or the first ``n_space``),
    and it raises where there is no card. ``devices``: a list to take them
    from, in order (``[cuda:0] * 4`` splits a frame four ways on one card);
    ``device``: one device, repeated ``n_space`` times (``device="cpu"``
    for the CPU)."""
    if devices is None and device is not None:
        devices = [device] * (1 if n_space is None else n_space)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices= or device= to "
                               "build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [as_device(d) for d in devices]
    n = len(devices) if n_space is None else n_space
    if not 1 <= n <= len(devices):
        raise ValueError(f"a mesh of {n} from {len(devices)} devices")
    return tuple(devices[:n])


def make_spatial_online_step(model, tx, mesh, iters=20, residual_model=False,
                             store_dtype=torch.bfloat16):
    """The online fine-tune step of one frame split by rows over ``mesh``
    (the blind_denoising hot loop, blind_denoising.py:216-222).

    Returns ``step(opt_state, cur, prev, flow, eval_impl=None) -> (opt_state,
    deno, losses)``, ``train.online.make_online_step``'s step on the
    per-iteration body: cur, prev (H, W, C) and flow (H, W, 2) on
    ``mesh[0]``, where the model lives. A ``"fused"`` model's mid stack runs
    split, with BN statistics and gradients of the whole frame (sync-BN);
    any other runs unsplit."""
    from ..train.online import make_online_step

    return make_online_step(model, tx, iters=iters,
                            residual_model=residual_model,
                            spatial_mesh=tuple(mesh), store_dtype=store_dtype)
