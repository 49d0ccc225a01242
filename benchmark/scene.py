"""Frames of a moving mixed-texture scene, made on the device from a seed.

The scene is an analytic texture, six plane waves and eight soft discs
whose frequencies, phases, places and sizes come from the seed, sampled at
displaced coordinates, so sub-pixel motion needs no interpolation: frame k
samples the scene at p + k d(p), with a global translation of (0.6, -0.4)
px a frame, a smooth vertical wave of 0.3 px, and a rectangle that moves 3
px a frame faster than its surround, whose edges the occlusion mask must
reject. Frames are scaled to [0.1, 0.9] and get Gaussian noise of
``sigma``. Every seed gives the same sizes and motion; only the texture and
the noise differ.
"""

from __future__ import annotations

import math

import torch


def _texture(gen, device):
    """(waves (6, 5), discs (8, 4)) drawn from ``gen``: a wave is (fy, fx,
    phase, amplitude, 0), a disc (cy, cx, radius, amplitude) in units of
    the frame's height and width."""
    u = torch.rand(6 * 5 + 8 * 4, generator=gen, device=device,
                   dtype=torch.float64)
    w, d = u[:30].view(6, 5), u[30:].view(8, 4)
    waves = torch.stack([0.002 + 0.028 * w[:, 0], 0.002 + 0.028 * w[:, 1],
                         2 * math.pi * w[:, 2], 0.3 + 0.7 * w[:, 3]], 1)
    discs = torch.stack([d[:, 0], d[:, 1], 20 + 100 * d[:, 2],
                         2 * d[:, 3] - 1], 1)
    return waves, discs


def moving(n, height, width, seed, device, channels=1, sigma=25.0 / 255.0,
           first=0):
    """(clean, noisy) frames ``first`` .. ``first + n - 1`` of the scene,
    each (n, height, width, channels) float32 on ``device``. Channel c of
    frame k is grey frame k + c, as an RGB stream of one scene."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    waves, discs = _texture(gen, device)
    f64 = dict(dtype=torch.float64, device=device)
    yy = torch.arange(height, **f64)[:, None].expand(height, width)
    xx = torch.arange(width, **f64)[None, :].expand(height, width)
    rect = ((yy > 0.3 * height) & (yy < 0.6 * height)
            & (xx > 0.4 * width) & (xx < 0.7 * width))
    u = 0.6 + 3.0 * rect
    v = -0.4 + 0.3 * torch.sin(2 * math.pi * xx / 400.0)
    # the disc centres scale with the frame; the waves keep their
    # frequencies, so a larger frame shows more of the same texture
    cy, cx = discs[:, 0] * height, discs[:, 1] * width

    def grey(k):
        y, x = yy + k * v, xx + k * u
        img = torch.zeros_like(y)
        for fy, fx, ph, amp in waves.tolist():
            img += amp * torch.sin(2 * math.pi * (fy * y + fx * x) + ph)
        for j in range(discs.shape[0]):
            r = torch.hypot(y - cy[j], x - cx[j])
            img += discs[j, 3] * torch.sigmoid((discs[j, 2] - r) / 2.0)
        return img

    greys = torch.stack([grey(first + k) for k in range(n + channels - 1)])
    lo, hi = greys.amin(), greys.amax()
    greys = (0.1 + 0.8 * (greys - lo) / (hi - lo)).float()
    clean = torch.stack([greys[c:c + n] for c in range(channels)], -1)
    noise = torch.randn(clean.shape, generator=gen, device=device)
    return clean, clean + sigma * noise
