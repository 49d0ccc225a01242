"""Neighbor2Neighbor self-supervised loss (Huang et al., CVPR 2021).

Counterpart of ``frame2frame_tpu/losses/nb2nb.py`` (the reference's
lib/frame2frame/nb2nb_loss.py): random paired 2x2 subsampling masks (8
neighbour-pair choices a block, nb2nb_loss.py:66-97), subimages by block
selection (:100-120), and the regularised loss ``L_rec + Lambda * L_reg``
with a detached full-image denoise (:24-57, Lambda = epoch/nepochs *
epoch_ratio).

The masks are drawn from a ``torch.Generator`` (``key``), where the JAX
package takes a PRNG key: the same distribution, other values.
"""

from __future__ import annotations

import torch

# the 8 valid adjacent-pair choices inside a 2x2 block (nb2nb_loss.py:76-79);
# positions are row-major block indices: 0=(0,0) 1=(0,1) 2=(1,0) 3=(1,1)
_IDX_PAIRS = ((0, 1), (0, 2), (1, 3), (2, 3), (1, 0), (2, 0), (3, 1), (3, 2))


def generate_mask_pair(key, shape, device=None):
    """Per-2x2-block neighbour-pair selection.

    key: a ``torch.Generator``; shape: (B, H, W) of the image (H, W even).
    Returns (sel1, sel2) int64 tensors of shape (B, H//2, W//2) with values
    in {0..3} on ``device`` (None: the generator's) -- the block position
    each subimage takes."""
    B, H, W = shape
    device = key.device if device is None else device
    rd = torch.randint(0, 8, (B, H // 2, W // 2), generator=key,
                       device=key.device).to(device)
    pair = torch.tensor(_IDX_PAIRS, device=device)[rd]  # (B, h2, w2, 2)
    return pair[..., 0], pair[..., 1]


def generate_subimages(img, sel):
    """Select one pixel per 2x2 block: img (B, H, W, C), sel (B, H//2, W//2)
    in {0..3} -> (B, H//2, W//2, C)."""
    B, H, W, C = img.shape
    blocks = img.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    blocks = blocks.reshape(B, H // 2, W // 2, 4, C)
    idx = sel[..., None, None].expand(B, H // 2, W // 2, 1, C)
    return torch.gather(blocks, 3, idx)[..., 0, :]


class Nb2NbLoss:
    """compute(apply_fn, noisy, epoch, key) -> (deno, loss).

    apply_fn: differentiable denoiser (B*T, H, W, C) -> denoised image.
    noisy: (B, T, H, W, C) in [0, 1]; key: a ``torch.Generator``.
    """

    def __init__(self, lambda1=1.0, lambda2=1.0, nepochs=100, epoch_ratio=2.0):
        self.lambda1 = lambda1
        self.lambda2 = lambda2
        self.nepochs = nepochs
        self.epoch_ratio = epoch_ratio
        self.name = "nb2nb"

    def compute(self, apply_fn, noisy, epoch, key):
        B, T, H, W, C = noisy.shape
        flat = noisy.reshape(B * T, H, W, C)
        Lambda = (epoch / (1.0 * self.nepochs)) * self.epoch_ratio

        sel1, sel2 = generate_mask_pair(key, (B * T, H, W), noisy.device)
        noisy_sub1 = generate_subimages(flat, sel1)
        noisy_sub2 = generate_subimages(flat, sel2)

        deno_d = apply_fn(flat).detach()
        deno_sub1 = generate_subimages(deno_d, sel1)
        deno_sub2 = generate_subimages(deno_d, sel2)
        deno_diff = deno_sub1 - deno_sub2

        deno = apply_fn(noisy_sub1)
        diff = deno - noisy_sub2
        loss1 = (diff**2).mean()
        loss2 = Lambda * ((diff - deno_diff) ** 2).mean()
        loss_all = self.lambda1 * loss1 + self.lambda2 * loss2

        return deno_d.reshape(B, T, H, W, C), loss_all
