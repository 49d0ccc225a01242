"""Noise synthesis transforms.

Counterpart of ``frame2frame_tpu/data/noise.py``, the replacement for the
reference's external ``data_hub.transforms.noise.choose_noise_transform``
(lightning.py:125-126) with the harness's noise-type keys (lightning.py:86,
357-366): ``ntype`` in {"g", "pg", "msg"} with ``sigma`` / ``rate`` /
``sigma_min`` / ``sigma_max``.

The transforms act on [0, 255]-scale videos (numpy arrays or tensors; the
harness divides by 255 afterwards, lightning.py:293-294) and return tensors
on the video's device. Where the JAX package takes a PRNG key, they take a
``torch.Generator``: the same distributions, other values. Every draw goes
through one of the module-level functions ``_normal``, ``_poisson`` and
``_uniform``, each drawing on the generator's device and moving the result
to the video's, so a caller can replace them to feed a transform given
draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import optional


def _normal(generator, shape, dtype, device):
    """Standard normal draws of ``shape``."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def _poisson(generator, lam):
    """Poisson draws at the rates ``lam``."""
    return torch.poisson(lam.to(generator.device),
                         generator=generator).to(lam.device)


def _uniform(generator, shape, low, high, dtype, device):
    """Uniform draws of ``shape`` on [low, high)."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device).to(device)
    return low + (high - low) * u


class GaussianNoise:
    """AWGN with fixed sigma (in [0,255] scale)."""

    def __init__(self, sigma):
        self.sigma = float(sigma)
        self.ntype = "g"

    def __call__(self, generator, clean):
        clean = torch.as_tensor(clean)
        return clean + self.sigma * _normal(generator, clean.shape,
                                            clean.dtype, clean.device)


class PoissonGaussianNoise:
    """Poisson shot noise at ``rate`` photons/pixel plus AWGN sigma."""

    def __init__(self, rate, sigma=0.0):
        self.rate = float(rate)
        self.sigma = float(sigma)
        self.ntype = "pg"

    def __call__(self, generator, clean):
        clean = torch.as_tensor(clean)
        lam = (clean / 255.0).clamp(0.0, 1.0) * self.rate
        shot = _poisson(generator, lam).to(clean.dtype) / self.rate * 255.0
        return shot + self.sigma * _normal(generator, clean.shape,
                                           clean.dtype, clean.device)


class MultiScaleGaussianNoise:
    """AWGN with per-sample sigma drawn uniformly from [sigma_min, sigma_max].

    The drawn sigma is returned alongside the noisy video so sigma-map
    channels (``dd_in=4``, lightning.py:129-141) can be built.
    """

    def __init__(self, sigma_min, sigma_max):
        self.sigma_min = float(sigma_min)
        self.sigma_max = float(sigma_max)
        self.ntype = "msg"
        self.sigma = 0.5 * (self.sigma_min + self.sigma_max)

    def __call__(self, generator, clean, return_sigma=False):
        clean = torch.as_tensor(clean)
        # one sigma per leading batch element
        bshape = tuple(clean.shape[:1]) if clean.ndim >= 4 else ()
        sigma = _uniform(generator, bshape, self.sigma_min, self.sigma_max,
                         clean.dtype, clean.device)
        sig = sigma.reshape(bshape + (1,) * (clean.ndim - len(bshape)))
        noisy = clean + sig * _normal(generator, clean.shape, clean.dtype,
                                      clean.device)
        if return_sigma:
            return noisy, sigma
        return noisy


def choose_noise_transform(cfg):
    """Dispatch on cfg.ntype (g / pg / msg), mirroring the reference keys."""
    ntype = optional(cfg, "ntype", "g")
    if ntype == "g":
        return GaussianNoise(optional(cfg, "sigma", 25.0))
    if ntype == "pg":
        return PoissonGaussianNoise(optional(cfg, "rate", 10.0),
                                    optional(cfg, "sigma", 0.0))
    if ntype == "msg":
        return MultiScaleGaussianNoise(optional(cfg, "sigma_min", 5.0),
                                       optional(cfg, "sigma_max", 50.0))
    raise ValueError(f"Unknown noise type [{ntype}]")


def add_jpeg_artifacts(clean, quality=30):
    """JPEG compression artifacts (host-side, BASELINE.json config 3 noise
    sweep); needs PIL.

    clean: (T, H, W) or (T, H, W, C) uint8-range array. Returns same shape
    float32.
    """
    import io as _io

    from PIL import Image

    clean = np.asarray(clean)
    out = np.empty_like(clean, dtype=np.float32)
    for t in range(clean.shape[0]):
        frame = np.clip(clean[t], 0, 255).astype(np.uint8)
        img = Image.fromarray(frame)
        buf = _io.BytesIO()
        img.save(buf, format="JPEG", quality=quality)
        buf.seek(0)
        out[t] = np.asarray(Image.open(buf), dtype=np.float32)
    return out


def anscombe(x):
    """Anscombe variance-stabilizing transform f(x) = 2*sqrt(x + 3/8)
    (the reference's disabled stubs, instances_adapt.py:79-89). Input in
    photon-count-like units (non-negative)."""
    return 2.0 * np.sqrt(np.maximum(np.asarray(x, np.float64), 0.0) + 0.375)


def anscombe_inverse(y):
    """Unbiased closed-form approximation of the exact inverse Anscombe
    transform (Makitalo & Foi 2011)."""
    y = np.asarray(y, np.float64)
    return (0.25 * y**2 + 0.25 * np.sqrt(1.5) / np.maximum(y, 1e-8)
            - 11.0 / 8.0 / np.maximum(y**2, 1e-8)
            + 0.625 * np.sqrt(1.5) / np.maximum(y**3, 1e-8) - 0.125)
