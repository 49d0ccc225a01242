"""Blind2Unblind self-supervised loss (Wang et al., CVPR 2022).

Counterpart of ``frame2frame_tpu/losses/b2u.py`` (the reference's
lib/frame2frame/b2u_loss.py): a global masker of ``width^2 = 16`` fixed
interleaved masks whose masked pixels are replaced by 3x3 cross-kernel
interpolation (b2u_loss.py:224-274), the re-visible training loss
``alpha*mean(diff^2) + mean((diff + beta*exp_diff)^2)`` with the beta ramp
(:79-95, thresholds 0.8/1.0 for sigma=30 noise else 0.4/1.0, :24-29), and
the masked-ensemble test-time forward with reflect pad-to-32 (:100-128).

The 16 masked forwards go through one model call of batch 16*B. The
interpolation filter is a weighted sum of shifted slices with zero padding;
the pad-to-32 reflects by index, since a pad as wide as the frame (any side
of 16 or less, or a short side beside a long one) is beyond
``F.pad(mode="reflect")``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.nls import _reflect_idx

_KERNEL = np.array([[0.5, 1.0, 0.5], [1.0, 0.0, 1.0], [0.5, 1.0, 0.5]])
_KERNEL = (_KERNEL / _KERNEL.sum()).astype(np.float32)


@lru_cache(maxsize=16)
def _fixed_masks_np(h, w, width=4):
    masks = np.zeros((width * width, h, w), np.float32)
    for i in range(width * width):
        dy, dx = divmod(i, width)
        masks[i, dy::width, dx::width] = 1.0
    return masks


def _fixed_masks(h, w, width=4, device=None):
    """(width^2, h, w) float32: mask i selects grid position i of each
    width x width cell (the 'fix_i' masks of b2u_loss.py:201-219)."""
    return torch.as_tensor(_fixed_masks_np(h, w, width), device=device)


def _cross_filter(img):
    """The 3x3 cross-kernel average of img (B, H, W, C), zero padding."""
    H, W = img.shape[1], img.shape[2]
    xp = F.pad(img, (0, 0, 1, 1, 1, 1))
    return sum(float(_KERNEL[dy, dx]) * xp[:, dy:dy + H, dx:dx + W]
               for dy in range(3) for dx in range(3) if _KERNEL[dy, dx])


def interpolate_mask(img, mask):
    """Replace masked pixels by the 3x3 cross-kernel neighbourhood average
    (b2u_loss.py:224-237). img: (B, H, W, C); mask: (H, W)."""
    m = mask[None, :, :, None]
    return _cross_filter(img) * m + img * (1.0 - m)


class Masker:
    """width^2-mask global masker (b2u_loss.py:240-274), 'interpolate' mode."""

    def __init__(self, width=4, mode="interpolate", mask_type="all"):
        assert mode == "interpolate"
        self.width = width
        self.mode = mode
        self.mask_type = mask_type

    def train(self, img):
        """img (B, H, W, C) -> (inputs (B, n, H, W, C), masks (n, H, W));
        n = width^2."""
        B, H, W, C = img.shape
        masks = _fixed_masks(H, W, self.width, img.device)  # (n, H, W)
        m = masks[None, :, :, :, None]
        filt = _cross_filter(img)[:, None]
        return filt * m + img[:, None] * (1.0 - m), masks

    def mask(self, img, idx):
        """Single fixed mask idx -> (masked_img, mask)."""
        m = _fixed_masks(img.shape[1], img.shape[2], self.width,
                         img.device)[idx]
        return interpolate_mask(img, m), m


class B2ULoss:
    """compute(apply_fn, noisy, epoch) -> (deno, loss); test(apply_fn, noisy)."""

    def __init__(self, lambda1=1.0, lambda2=2.0, nepochs=100, epoch_ratio=2.0,
                 ninfo=""):
        self.lambda1 = lambda1
        self.lambda2 = lambda2
        self.nepochs = nepochs
        self.epoch_ratio = epoch_ratio
        self.masker = Masker(width=4, mode="interpolate", mask_type="all")
        if "g-30" in ninfo or "pg-30" in ninfo:
            self.Thread1, self.Thread2 = 0.8, 1.0
        else:
            self.Thread1, self.Thread2 = 0.4, 1.0
        self.name = "b2u"

    @classmethod
    def for_test(cls):
        """Instance for the masked-ensemble eval pass only (the reference's
        run_ub2_test, test.py:49-71): only ``test()`` is meaningful on it."""
        return cls(lambda1=1.0, lambda2=2.0, nepochs=1, epoch_ratio=2.0,
                   ninfo="")

    def _beta(self, epoch):
        Lambda = epoch / self.nepochs
        if Lambda <= self.Thread1:
            return self.lambda2
        if Lambda <= self.Thread2:
            return self.lambda2 + (Lambda - self.Thread1) * (
                self.epoch_ratio - self.lambda2) / (self.Thread2 - self.Thread1)
        return self.epoch_ratio

    def compute(self, apply_fn, noisy, epoch):
        """noisy: (B, T, H, W, C) in [0,1]."""
        B, T, H, W, C = noisy.shape
        flat = noisy.reshape(B * T, H, W, C)
        n = self.masker.width**2

        inputs, masks = self.masker.train(flat)  # (BT, n, H, W, C), (n, H, W)
        out = apply_fn(inputs.reshape(B * T * n, H, W, C))
        out = out.reshape(B * T, n, H, W, C)
        noisy_output = (out * masks[None, :, :, :, None]).sum(1)
        diff = noisy_output - flat

        exp_output = apply_fn(flat).detach()
        exp_diff = exp_output - flat

        beta = self._beta(epoch)
        alpha = self.lambda1
        revisible = diff + beta * exp_diff
        loss = alpha * (diff**2).mean() + (revisible**2).mean()
        return noisy_output.reshape(B, T, H, W, C), loss

    def test(self, apply_fn, noisy):
        """Masked-ensemble inference with reflect pad-to-32
        (b2u_loss.py:100-128)."""
        B, T, H, W, C = noisy.shape
        flat = noisy.reshape(B * T, H, W, C)
        val = (max(H, W) + 31) // 32 * 32
        rows = _reflect_idx(torch.arange(val, device=flat.device), H)
        cols = _reflect_idx(torch.arange(val, device=flat.device), W)
        flat = flat.index_select(1, rows).index_select(2, cols)
        n = self.masker.width**2
        inputs, masks = self.masker.train(flat)
        out = apply_fn(inputs.reshape(-1, val, val, C))
        out = out.reshape(B * T, n, val, val, C)
        deno = (out * masks[None, :, :, :, None]).sum(1)
        return deno[:, :H, :W, :].reshape(B, T, H, W, C)
