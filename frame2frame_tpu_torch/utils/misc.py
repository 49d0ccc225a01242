"""Misc helpers (the port's copy of ``frame2frame_tpu/utils/misc.py``, the
replacement for dev_basics.utils.misc, reference test.py:21-22)."""

from __future__ import annotations

import pickle
import random
from pathlib import Path

import numpy as np
import torch


def set_seed(seed):
    """Seed Python's, numpy's and torch's global generators (the CUDA
    cards' too) and return a CPU ``torch.Generator`` seeded with ``seed``:
    the port's counterpart of the JAX PRNG key that the JAX package returns
    (reference test.py:37,90)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def rslice(vid, region):
    """Slice a video by a (t0,t1,h0,h1,w0,w1) region tuple; None -> unchanged."""
    if region is None:
        return vid
    t0, t1, h0, h1, w0, w1 = region
    return vid[..., t0:t1, h0:h1, w0:w1, :] if vid.ndim >= 4 else vid


def get_region_gt(shape):
    """Central ground-truth region used by internal adaptation (test.py:198)."""
    t, h, w = shape[0], shape[-3], shape[-2]
    return [0, t, h // 4, 3 * h // 4, w // 4, 3 * w // 4]


def slice_flows(flows, tslice):
    """Slice fflow/bflow dicts along time."""
    if flows is None:
        return None
    return {k: v[:, tslice] for k, v in flows.items()}


def write_pickle(path, obj):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def read_pickle(path):
    """Unpickle ``path``: only files this program wrote (unpickling runs
    code)."""
    with open(path, "rb") as f:
        return pickle.load(f)
