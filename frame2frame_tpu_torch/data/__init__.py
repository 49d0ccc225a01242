from . import noise
from .crop import run_rand_crop
from .datasets import (
    VideoDataset,
    filter_subseq,
    load,
    pack_raw_bayer,
    slice_sample,
    synthetic_video,
)
from .noise import (
    GaussianNoise,
    MultiScaleGaussianNoise,
    PoissonGaussianNoise,
    add_jpeg_artifacts,
    choose_noise_transform,
)

__all__ = ["run_rand_crop"]


class sets:
    """data_hub-style namespace: ``sets.load(cfg, device=)`` (reference
    test.py:127)."""

    load = staticmethod(load)
