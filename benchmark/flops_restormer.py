"""Operations of the Restormer, counted from its shapes: two a multiply-add
of every convolution (the 3x3 dense and depthwise ones and the 1x1 ones)
and of both attention products (q k^T and A v, each (C / heads) values a
pixel a channel); the LayerNorms, norms, softmaxes, GELU and gating are
left out (a few operations a value). The network runs on the frame padded
to multiples of 8, and is counted there.
"""

from __future__ import annotations

from .reference import restormer


def block(c, heads, ffn_expansion_factor):
    """A transformer block's operations a pixel at ``c`` channels."""
    hid = int(c * ffn_expansion_factor)
    mdta = 2 * (c * 3 * c + 9 * 3 * c + 2 * c * (c // heads) + c * c)
    gdfn = 2 * (c * 2 * hid + 9 * 2 * hid + hid * c)
    return mdta + gdfn


def forward(h, w, config):
    """One forward of a (h, w) frame."""
    dim, nb, nr, heads, ffn = restormer.widths(config)
    ch = config["channels"]
    px = -(-h // 8) * 8 * (-(-w // 8) * 8)
    p1, p2, p3, p4 = px, px // 4, px // 16, px // 64
    blocks = (nb[0] * p1 * block(dim, heads[0], ffn)
              + nb[1] * p2 * block(2 * dim, heads[1], ffn)
              + nb[2] * p3 * block(4 * dim, heads[2], ffn)
              + nb[3] * p4 * block(8 * dim, heads[3], ffn)
              + nb[2] * p3 * block(4 * dim, heads[2], ffn)
              + nb[1] * p2 * block(2 * dim, heads[1], ffn)
              + (nb[0] + nr) * p1 * block(2 * dim, heads[0], ffn))
    convs = 2 * (9 * ch * dim * p1  # patch_embed
                 + 9 * dim * (dim // 2) * p1  # down1_2
                 + 9 * 2 * dim * dim * p2  # down2_3
                 + 9 * 4 * dim * 2 * dim * p3  # down3_4
                 + 9 * 8 * dim * 16 * dim * p4  # up4_3
                 + 8 * dim * 4 * dim * p3  # reduce_chan_level3
                 + 9 * 4 * dim * 8 * dim * p3  # up3_2
                 + 4 * dim * 2 * dim * p2  # reduce_chan_level2
                 + 9 * 2 * dim * 4 * dim * p2  # up2_1
                 + 9 * 2 * dim * ch * p1)  # output
    return blocks + convs


def finetune_frame(h, w, iters, config):
    """A fine-tuned frame: ``iters`` updates of a forward and its backward
    (the inputs' and the weights' gradients, each as many operations as
    the forward), then one eval forward."""
    return (3 * iters + 1) * forward(h, w, config)
