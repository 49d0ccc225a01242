"""BatchNorm statistics of a batch split over shards (sync-BN).

A data-parallel training forward (``parallel/data.py``) runs the model once
a shard, each on its own rows and device, in a thread of its own. While a
shard's forward runs, ``shard_of(group, k)`` names its group and index in
that thread, and the models' training BatchNorm (``dncnn._bn_f32``,
``dncnn._bn_bf16``, ``fastdvdnet._batch_norm``) takes its statistics with
``mean``: every shard's partial sums added by the group in shard order, so
that the statistics are the whole batch's and their gradient reaches every
shard's rows. Outside a shard, ``active()`` is False and the models run as
they always do.

``group.sum(k, part)`` is the one thing a group provides: it returns the
sum of every shard's ``part`` (on shard k's device, differentiable).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_local = threading.local()


@contextlib.contextmanager
def shard_of(group, k):
    """Shard ``k`` of ``group`` for the BatchNorm calls of this thread."""
    prev = getattr(_local, "shard", None)
    _local.shard = (group, k)
    try:
        yield
    finally:
        _local.shard = prev


def active():
    """Whether this thread runs a shard of a data-parallel forward."""
    return getattr(_local, "shard", None) is not None


def mean(x, dims):
    """The mean of ``x`` over ``dims`` and over every shard's ``x``: the
    shards' sums and element counts added in shard order."""
    group, k = _local.shard
    s = x.sum(dims)
    n = x.numel() // s.numel()
    tot = group.sum(k, torch.cat([s.reshape(-1), s.new_full((1,), float(n))]))
    return (tot[:-1] / tot[-1]).view_as(s)
