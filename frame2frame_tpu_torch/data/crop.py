"""Random spatio-temporal cropping (the port's copy of
``frame2frame_tpu/data/crop.py``, the replacement for ``data_hub.cropping.
run_rand_crop``, used by the adaptation loops at warped_loss.py:77,99)."""

from __future__ import annotations

import numpy as np


def run_rand_crop(tensors, isize, rng=None):
    """Apply the SAME random spatial crop to every tensor in ``tensors``.

    tensors: list of arrays shaped (..., H, W, C) (NHWC-style; at least 3 dims).
    isize: (h, w) crop size.
    Returns the list of cropped tensors.
    """
    if rng is None:
        rng = np.random.default_rng()
    h, w = isize
    H, W = tensors[0].shape[-3], tensors[0].shape[-2]
    assert all(t.shape[-3] == H and t.shape[-2] == W for t in tensors)
    y0 = int(rng.integers(0, max(H - h, 0) + 1))
    x0 = int(rng.integers(0, max(W - w, 0) + 1))
    return [t[..., y0 : y0 + h, x0 : x0 + w, :] for t in tensors]
