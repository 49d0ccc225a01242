"""Learned noise simulator — the port of ``frame2frame_tpu/models/
noise_sim.py``, a working stand-in for the reference's external "stardeno"
noise model (lib/frame2frame/lightning.py:102-109,151-155).

The reference loads a pretrained camera-noise generator by module name and
resamples ``batch['noisy']`` from ``batch['clean']`` each training step
(``sample_noisy``). The same surface here:

- ``load_sim(cfg)``     -> simulator object (the reference's
  ``load_noise_sim``)
- ``sim.run_rgb(clean, generator=)`` -> resampled noisy video, same shape as
  clean, drawn from a ``torch.Generator`` (the JAX package takes a PRNG key)
- ``sim.fit(clean, noisy)``   -> MLE fit of the noise model on real pairs,
  by autograd and ``torch.optim.Adam`` (optax's ``adam`` in the JAX package,
  the same defaults)

Model: sigma(x) = softplus(a + b * x) per channel — signal-dependent
(Poissonian-like) noise with two learnable parameters per channel, fit by
maximizing the Gaussian likelihood of observed residuals. The parameters live
on the simulator's device: the CUDA card unless the caller names the CPU.
"""

from __future__ import annotations

import torch

from ..config import optional
from ..utils.device import resolve_device


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


class HeteroscedasticGaussianSim:
    """sigma(x) = softplus(a + b*x) per channel, pixel scale [0, 255]."""

    def __init__(self, channels=3, a=2.0, b=0.0, device=None):
        self.device = resolve_device(device)
        self.params = {
            "a": torch.full((channels,), float(a), device=self.device),
            "b": torch.full((channels,), float(b), device=self.device),
        }
        self.channels = channels

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def sigma(self, clean, params=None):
        p = self.params if params is None else params
        return _softplus(p["a"] + p["b"] * self._tensor(clean))

    def run_rgb(self, clean, generator=None):
        """Resample noise onto ``clean`` ((..., C) in [0, 255]);
        ``generator``: a ``torch.Generator`` on the simulator's device, or
        None for torch's global generator."""
        clean = self._tensor(clean)
        noise = torch.randn(clean.shape, generator=generator,
                            device=self.device)
        return clean + self.sigma(clean) * noise

    def fit(self, clean, noisy, steps=200, lr=0.05):
        """MLE fit on (clean, noisy) pairs: minimize
        mean(log sigma + r^2 / (2 sigma^2)), r = noisy - clean,
        sigma = softplus(a + b * clean) + 1e-3, by ``steps`` Adam updates
        (betas 0.9 / 0.999, eps 1e-8). Returns the loss before the last
        update."""
        clean = self._tensor(clean)
        r = self._tensor(noisy) - clean
        params = {k: v.clone().requires_grad_(True)
                  for k, v in self.params.items()}
        opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                               eps=1e-8)
        loss = None
        for _ in range(steps):
            opt.zero_grad()
            s = self.sigma(clean, params) + 1e-3
            loss = torch.mean(torch.log(s) + 0.5 * (r / s) ** 2)
            loss.backward()
            opt.step()
        self.params = {k: v.detach() for k, v in params.items()}
        return float(loss.detach())


def load_sim(cfg=None, device=None):
    """The reference's ``load_noise_sim`` entry point (lightning.py:107):
    build a simulator from a config (``sim_channels``, ``sim_sigma_a``,
    ``sim_sigma_b``) on ``device`` (None: the CUDA card)."""
    return HeteroscedasticGaussianSim(
        channels=optional(cfg, "sim_channels", 3),
        a=optional(cfg, "sim_sigma_a", 2.0),
        b=optional(cfg, "sim_sigma_b", 0.0),
        device=device,
    )
