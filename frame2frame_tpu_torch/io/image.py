"""Image I/O for frame sequences (host side, numpy).

The port's own copy of ``frame2frame_tpu/io/image.py``, the replacement for
the reference's skimage/tifffile readers (blind_denoising.py:170-201,232-238)
and the C ``iio`` float reader (tvl1flow/main.c:44-51). PIL is imported inside
the functions that need it, so the module imports on a machine without it;
binary PGM files (``.pgm``) are read and written by ``read_pgm`` /
``write_pgm`` without PIL, to the values and bytes PIL gives.

Conventions matching the reference:
- ``read_gray`` returns float64 luma in [0, 1] for integer images, matching
  ``skimage.io.imread(..., as_gray=True)`` (weights 0.2125/0.7154/0.0721);
- ``%`` C-format path templates ("frame%03d.png") select frames
  (blind_denoising.py:171);
- tiff files are read and written as float32 without rescaling
  (blind_denoising.py:192-193,234).
"""

from __future__ import annotations

import os

import numpy as np

_GRAY_W = np.array([0.2125, 0.7154, 0.0721], dtype=np.float64)

TIFF_EXTS = (".tif", ".tiff")


def is_tiff(path):
    return os.fspath(path).lower().endswith(TIFF_EXTS)


def is_pgm(path):
    return os.fspath(path).lower().endswith(".pgm")


def read_image(path):
    """Read an image file -> numpy array (H, W) or (H, W, C), native dtype."""
    if is_pgm(path):
        return read_pgm(path)
    from PIL import Image

    return np.asarray(Image.open(os.fspath(path)))


def read_gray(path):
    """Read an image as grayscale float64: integer inputs are scaled to
    [0, 1], RGB collapses with the luma weights above (alpha dropped), as
    ``skimage.io.imread(path, as_gray=True)``."""
    arr = read_image(path)
    was_int = np.issubdtype(arr.dtype, np.integer)
    if arr.ndim == 3:
        if arr.shape[-1] == 4:
            arr = arr[..., :3]
        arr = arr.astype(np.float64) @ _GRAY_W
    else:
        arr = arr.astype(np.float64)
    if was_int:
        arr = arr / 255.0
    return arr


def read_frame(path_tmpl, index):
    """Read frame ``index`` from a C-format path template, as the reference
    loads frames (blind_denoising.py:170-201): tiff files raw (assumed
    pre-scaled), everything else as grayscale scaled back to [0, 255].
    Returns float64 (H, W)."""
    path = path_tmpl % index if "%" in path_tmpl else path_tmpl
    if is_tiff(path):
        return np.asarray(read_image(path), dtype=np.float64)
    return read_gray(path) * 255.0


def write_gray(path, img):
    """Write a grayscale image as the reference does
    (blind_denoising.py:232-238): tiff gets raw float32 (the caller already
    scaled by 255), other formats uint8 after clipping to [0, 255]."""
    path = os.fspath(path)
    img = np.asarray(img)
    if is_pgm(path):
        write_pgm(path, img)
        return
    from PIL import Image

    if is_tiff(path):
        Image.fromarray(img.astype(np.float32)).save(path)
        return
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)


def write_pgm(path, img, maxval=255):
    """Write a binary PGM (P5) grayscale image."""
    img = np.clip(np.asarray(img), 0, maxval).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n%d\n" % (img.shape[1], img.shape[0], maxval))
        f.write(img.tobytes())


def read_pgm(path):
    """Read a binary PGM (P5) grayscale image with maxval 255 -> uint8
    (H, W)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P5"):
        raise ValueError("not a binary PGM")
    # header: magic, width, height, maxval, one whitespace, then the raster
    parts = []
    idx = 2
    while len(parts) < 3:
        while idx < len(data) and data[idx:idx + 1].isspace():
            idx += 1
        if data[idx:idx + 1] == b"#":
            while data[idx:idx + 1] != b"\n":
                idx += 1
            continue
        start = idx
        while idx < len(data) and not data[idx:idx + 1].isspace():
            idx += 1
        parts.append(int(data[start:idx]))
    idx += 1  # the single whitespace after maxval
    w, h, maxval = parts
    if maxval != 255:
        raise ValueError(f"PGM with maxval {maxval}: only 8-bit frames with "
                         "maxval 255 are read")
    return np.frombuffer(data, np.uint8, count=w * h, offset=idx).reshape(h, w)
