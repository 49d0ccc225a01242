"""Quality metrics (copy of ``frame2frame_tpu/utils/metrics.psnr``)."""

from __future__ import annotations

import numpy as np


def psnr(img1, img2, peak=1.0):
    """Scalar PSNR over the full (squeezed) arrays, as blind_denoising.py:36-41."""
    x = (np.asarray(img1, dtype=np.float64).squeeze()
         - np.asarray(img2, dtype=np.float64).squeeze()).ravel()
    return 10.0 * np.log10(peak**2 / np.mean(x**2))
