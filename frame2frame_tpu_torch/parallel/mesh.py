"""The (data, time) device mesh of multi-device training.

Counterpart of ``frame2frame_tpu/parallel/mesh.py``. The JAX package shards
video batches over data-parallel replicas and long sequences over a
temporal axis with ``jax.sharding``; ``shard_map`` then runs one program
for every shard from one controller. So does the port, in one process and
without ``torch.distributed`` (on one card NCCL refuses two ranks):

- a mesh is an ordered ``(n_data, n_time)`` grid of ``torch.device``s, and a
  device may repeat (``[cuda:0] * 4`` runs four shards one after another on
  one card; the CPU tests run ``["cpu"] * 8``);
- a video sharded over the mesh is one ``(b_loc, t_loc, ...)`` block a
  device, its rows ``[d b_loc, (d + 1) b_loc)`` and frames ``[t t_loc,
  (t + 1) t_loc)`` (``shard_video``);
- a replicated value lives once, on the mesh's first device, and each shard
  computes with a copy on its own device (``.to``, which autograd carries
  back); sums over shards are taken there in shard order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fused_spatial import as_device

AXES = ("data", "time")


class Mesh:
    """An ``(n_data, n_time)`` grid of devices; ``devices[d][t]`` holds
    data shard d, time shard t. ``shape`` maps each axis name to its size,
    as ``jax.sharding.Mesh.shape`` does."""

    axis_names = AXES

    def __init__(self, devices):
        rows = [[as_device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty grid of devices")
        self.devices = tuple(tuple(r) for r in rows)

    @property
    def shape(self):
        return {"data": len(self.devices), "time": len(self.devices[0])}

    @property
    def size(self):
        return len(self.devices) * len(self.devices[0])

    @property
    def first(self):
        """The controller's device, where replicated values live."""
        return self.devices[0][0]

    def __repr__(self):
        grid = [[str(d) for d in r] for r in self.devices]
        return f"Mesh({self.shape}, {grid})"


def cards():
    """The CUDA devices; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices= to build a mesh "
                           "on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data=None, n_time=1, devices=None):
    """A (data, time) mesh of the first ``n_data * n_time`` of ``devices``
    (default: the cards, and raises where there is none), row-major: data
    shard d, time shard t on device ``d * n_time + t``. ``n_data`` defaults
    to all devices over ``n_time``."""
    devices = list(cards() if devices is None else devices)
    n = len(devices)
    if n_data is None:
        n_data = n // n_time
    if n_data < 1 or n_time < 1 or n_data * n_time > n:
        raise ValueError(f"a ({n_data}, {n_time}) mesh from {n} devices")
    return Mesh([devices[d * n_time:(d + 1) * n_time] for d in range(n_data)])


@dataclass(frozen=True)
class Sharding:
    """Where a value lives on ``mesh``: ``spec`` names the mesh axis of
    each leading dimension, as ``jax.sharding.PartitionSpec`` does; ``()``
    is replicated."""

    mesh: Mesh
    spec: tuple


def video_sharding(mesh):
    """(B, T, H, W, C) videos: the batch over ``data``, frames over
    ``time``."""
    return Sharding(mesh, ("data", "time"))


def replicated(mesh):
    return Sharding(mesh, ())


def place(sharding, x):
    """``x`` (a tensor or array) under ``sharding``: for ``("data",
    "time")`` the grid of blocks ``[d][t]``, each ``(B / n_data, T /
    n_time, ...)`` on its device; for ``("data",)`` the list of row blocks
    on the data shards' first devices; replicated, the tensor on the mesh's
    first device."""
    mesh, spec = sharding.mesh, sharding.spec
    x = torch.as_tensor(x)
    if spec == ():
        return x.to(mesh.first)
    n_data, n_time = mesh.shape["data"], mesh.shape["time"]
    if x.shape[0] % n_data:
        raise ValueError(f"{x.shape[0]} rows do not split over {n_data} "
                         "data shards")
    rows = x.chunk(n_data, 0)
    if spec == ("data",):
        return [r.to(mesh.devices[d][0]) for d, r in enumerate(rows)]
    if spec != ("data", "time"):
        raise ValueError(f"unknown spec {spec}")
    if x.shape[1] % n_time:
        raise ValueError(f"{x.shape[1]} frames do not split over {n_time} "
                         "time shards")
    return [[blk.to(mesh.devices[d][t]).contiguous()
             for t, blk in enumerate(r.chunk(n_time, 1))]
            for d, r in enumerate(rows)]


def shard_video(mesh, vid):
    """``vid`` (B, T, ...) as the grid of its blocks ``[d][t]``, each
    ``(b_loc, t_loc, ...)`` on device ``mesh.devices[d][t]``."""
    return place(video_sharding(mesh), vid)


def data_parallel_mesh(batch_size, devices=None):
    """The largest (data,)-only mesh for ``batch_size``, or None.

    ``devices`` default to the cards (and raise where there is none). No
    mesh below two devices or a batch of two; otherwise ``n_data`` is the
    largest divisor of the batch size that the devices can hold, and None
    where that is 1. The offline trainer (``train/trainer.py``) splits each
    batch over it with BatchNorm statistics of the whole batch, so that a
    step is the single-device step (``parallel/data.py``)."""
    devices = list(cards() if devices is None else devices)
    n = len(devices)
    if n < 2 or batch_size < 2:
        return None
    n_data = max(d for d in range(1, min(n, batch_size) + 1)
                 if batch_size % d == 0)
    if n_data < 2:
        return None
    return make_mesh(n_data=n_data, n_time=1, devices=devices[:n_data])


def shard_batch(mesh, batch):
    """A Config/dict of (B, ...) arrays split over the ``data`` axis:
    boolean and numeric arrays whose length divides become the list of
    their row blocks, one a data shard on its device; scalars, arrays whose
    length does not divide and ragged fields (per-sample names) pass
    through as they are."""
    n_data = mesh.shape["data"]
    spec = Sharding(mesh, ("data",))
    out = {}
    for k, v in dict(batch).items():
        if isinstance(v, torch.Tensor):
            arr = v
        else:
            try:
                arr = np.asarray(v)
            except ValueError:  # ragged list field
                out[k] = v
                continue
        numeric = isinstance(arr, torch.Tensor) or arr.dtype.kind in "biufc"
        if numeric and arr.ndim >= 1 and arr.shape[0] % n_data == 0:
            out[k] = place(spec, arr)
        else:
            out[k] = v
    return out


def replicate_tree(mesh, tree):
    """A pytree (nested dicts, lists, tuples) of arrays with every array
    leaf a tensor on the mesh's first device, where replicated values live;
    other leaves pass through."""
    if isinstance(tree, dict):
        return type(tree)({k: replicate_tree(mesh, v)
                           for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_tree(mesh, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.first, copy=True)
    if hasattr(tree, "shape"):
        return torch.from_numpy(np.array(tree)).to(mesh.first)
    return tree
