"""Epoch-switched combination loss (lib/frame2frame/combo_loss.py:20-46):
loss0 (e.g. Nb2Nb) before the ``swap`` epoch, loss1 (e.g. stnls) after, with
an optional alpha-blend of both. Counterpart of
``frame2frame_tpu/losses/combo.py``."""

from __future__ import annotations


class ComboLoss:
    def __init__(self, loss0, loss1, swap=50, alpha=0.0):
        self.loss0 = loss0
        self.loss1 = loss1
        self.swap = swap
        self.alpha = alpha
        self.name = "combo"

    def __call__(self, apply_fn, noisy, flows, epoch, key=None, clean=None):
        if epoch < self.swap:
            return self.loss0.compute(apply_fn, noisy, epoch, key)
        B, T = noisy.shape[:2]
        deno = apply_fn(noisy.reshape((B * T,) + tuple(noisy.shape[2:])))
        deno = deno.reshape(noisy.shape)
        clean_in = noisy if clean is None else clean
        loss = self.loss1(noisy, clean_in, deno, flows, epoch, key)
        if self.alpha > 1e-10:
            _, loss0 = self.loss0.compute(apply_fn, noisy, epoch, key)
            loss = (1 - self.alpha) * loss + self.alpha * loss0
        return deno, loss
