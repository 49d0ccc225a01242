"""Supervised and noise2noise losses (lightning.py:347-366,412-420).

Counterpart of ``frame2frame_tpu/losses/basic.py``."""

from __future__ import annotations


def sup_loss(clean, deno, dist_crit="l2"):
    """Supervised loss (reference "sup" criterion, lightning.py:412-420)."""
    if dist_crit == "l1":
        return (clean - deno).abs().mean()
    if "l2" in dist_crit:
        return ((clean - deno) ** 2).mean()
    raise ValueError(f"Unknown dist_crit [{dist_crit}]")


def sup_fdvd_loss(clean, deno, dist_crit="l2"):
    """Supervised loss against the center frame only ("sup_fdvd",
    lightning.py:351-356)."""
    T = clean.shape[1]
    return sup_loss(clean[:, T // 2], deno, dist_crit)


def n2n_loss(noisy2, deno, dist_crit="l2"):
    """noise2noise: supervised against an independently re-noised target
    ("n2n", lightning.py:357-366); the caller samples noisy2."""
    return sup_loss(noisy2, deno, dist_crit)
