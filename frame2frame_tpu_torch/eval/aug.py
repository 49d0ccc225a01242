"""x8 test-time augmentation — counterpart of ``frame2frame_tpu/eval/aug.py``,
the replacement for ``dev_basics.aug_test.test_x8`` (reference
test.py:17,166-169): average the denoiser over the 8 dihedral transforms (4
rotations x optional transpose), inverting each transform on the output.
The variants of one frame shape go through one model call.
"""

from __future__ import annotations

import torch

from .chunks import fwd_form


def _transform(vid, i):
    """Apply dihedral transform i in 0..7 to (..., H, W, C)."""
    if i & 4:
        vid = vid.transpose(-3, -2)
    return torch.rot90(vid, k=i & 3, dims=(-3, -2))


def _inverse(vid, i):
    vid = torch.rot90(vid, k=-(i & 3), dims=(-3, -2))
    if i & 4:
        vid = vid.transpose(-3, -2)
    return vid


def test_x8(fwd_fxn, vid, flows=None):
    """Self-ensemble forward: mean of the 8 transform-conjugated outputs.

    fwd_fxn: (B, T, H, W, C) -> (B, T, H, W, C), called with flows None (as
    in the JAX package: a transformed frame has no flows). Square frames
    batch all 8 variants into one call; rectangular frames run variants
    [0, 2, 5, 7] batched, then [1, 3, 4, 6].
    """
    vid = torch.as_tensor(vid)
    H, W = vid.shape[-3], vid.shape[-2]
    call = fwd_form(fwd_fxn)

    def run(indices):
        batch = torch.cat([_transform(vid, i) for i in indices], dim=0)
        outs = call(batch, None).chunk(len(indices), dim=0)
        return [_inverse(o, i) for o, i in zip(outs, indices)]

    if H == W:
        outs = run(list(range(8)))
    else:
        # group variants by their (possibly swapped) spatial shape
        outs = run([0, 2, 5, 7]) + run([1, 3, 4, 6])
    return sum(outs) / len(outs)
