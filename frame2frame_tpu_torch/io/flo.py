"""Middlebury .flo optical-flow file I/O (numpy only).

The port's own copy of ``frame2frame_tpu/io/flo.py``: files written by one
package are read by the other, byte for byte.

Byte layout defined by the reference reader (readFlowFile.py:16-31): magic float
202021.25, int32 width, int32 height, then ``2*w*h`` float32 values row-major,
interleaved ``(u, v)`` per pixel — the format written by the reference's C binary via
``iio_save_image_float_split`` (tvl1flow/main.c:183, iio.c:2966/103).
"""

from __future__ import annotations

import os

import numpy as np

TAG_FLOAT = 202021.25


def read_flo(path):
    """Read a .flo file -> float32 array of shape (H, W, 2)."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        tag = np.fromfile(f, np.float32, count=1)
        if tag.size != 1 or tag[0] != np.float32(TAG_FLOAT):
            raise ValueError(f"invalid .flo magic in {path!r}: {tag}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
        if data.size != 2 * w * h:
            raise ValueError(f"truncated .flo file {path!r}")
    return data.reshape(h, w, 2)


def write_flo(path, flow):
    """Write a (H, W, 2) float32 array as a .flo file (round-trips with read_flo)."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    path = os.fspath(path)
    with open(path, "wb") as f:
        np.float32(TAG_FLOAT).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)
