"""Video (frame-sequence) I/O.

The port's own copy of ``frame2frame_tpu/io/video.py``, the replacement for
the reference's external ``dev_basics.utils.vid_io.save_video``
(test.py:26,240) — videos are directories of numbered frames. Grayscale
frames go through ``io/image.py`` (``.pgm`` without PIL); RGB frames need
PIL, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .image import read_frame, read_image, write_gray


def save_video(vid, out_dir, name, fstart=0, ext="png"):
    """Save a video to ``out_dir/name_%05d.ext``.

    vid: array or tensor (T, H, W[, C]) or (B, T, H, W, C) in [0, 255]
    (values are clipped). Returns the list of written filenames.
    """
    if hasattr(vid, "detach"):
        vid = vid.detach().cpu().numpy()
    vid = np.asarray(vid)
    if vid.ndim == 5:  # (B,T,H,W,C) -> first batch element
        vid = vid[0]
    if vid.ndim == 4 and vid.shape[-1] == 1:
        vid = vid[..., 0]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = []
    for t in range(vid.shape[0]):
        fn = out_dir / (f"{name}_{fstart + t:05d}.{ext}")
        frame = vid[t]
        if frame.ndim == 3:  # RGB
            from PIL import Image

            Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8)).save(fn)
        else:
            write_gray(fn, frame)
        fns.append(str(fn))
    return fns


def load_video_frames(path_tmpl, first, last):
    """Load frames [first, last] from a C-format template -> (T, H, W) float64."""
    return np.stack([read_frame(path_tmpl, i) for i in range(first, last + 1)])


def load_video_dir(vdir, ext=None):
    """Load all frames in a directory (sorted) -> (T, H, W[, C]) float array."""
    vdir = Path(vdir)
    fns = sorted(p for p in vdir.iterdir() if p.is_file())
    if ext is not None:
        fns = [p for p in fns if p.suffix.lstrip(".") == ext.lstrip(".")]
    frames = [np.asarray(read_image(p), dtype=np.float32) for p in fns]
    return np.stack(frames)
