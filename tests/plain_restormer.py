"""A plain Restormer for the tests: the official module
(swz30/Restormer, ``basicsr/models/archs/restormer_arch.py``) in its
bias-free form, written again in float32 PyTorch ops with the
rearrangements as reshapes, the test scripts' padding, and one frame of the
online fine-tune (Adam with L2 decay on the summed masked L1 loss). It
imports torch alone: neither the port nor JAX.
"""

import torch
import torch.nn.functional as F
from torch import nn


class BiasFreeLayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):  # (b, hw, c)
        sigma = x.var(-1, keepdim=True, unbiased=False)
        return x / torch.sqrt(sigma + 1e-5) * self.weight


class LayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.body = BiasFreeLayerNorm(dim)

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.body(x.flatten(2).transpose(1, 2))
        return y.transpose(1, 2).reshape(b, c, h, w)


class FeedForward(nn.Module):
    def __init__(self, dim, ffn_expansion_factor):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1,
                                groups=hidden * 2, bias=False)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=False)

    def forward(self, x):
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class Attention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=False)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1,
                                    groups=dim * 3, bias=False)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        # 'b (head c) h w -> b head c (h w)'
        q, k, v = (t.reshape(b, self.num_heads, c // self.num_heads, h * w)
                   for t in (q, k, v))
        q = F.normalize(q, dim=-1)
        k = F.normalize(k, dim=-1)
        attn = (q @ k.transpose(-2, -1)) * self.temperature
        out = attn.softmax(dim=-1) @ v
        return self.project_out(out.reshape(b, c, h, w))


class TransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, ffn_expansion_factor):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_expansion_factor)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_c, embed_dim):
        super().__init__()
        self.proj = nn.Conv2d(in_c, embed_dim, 3, padding=1, bias=False)

    def forward(self, x):
        return self.proj(x)


class Downsample(nn.Module):
    def __init__(self, n_feat):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False),
            nn.PixelUnshuffle(2))

    def forward(self, x):
        return self.body(x)


class Upsample(nn.Module):
    def __init__(self, n_feat):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat * 2, 3, padding=1, bias=False),
            nn.PixelShuffle(2))

    def forward(self, x):
        return self.body(x)


class Restormer(nn.Module):
    def __init__(self, inp_channels=1, out_channels=1, dim=48,
                 num_blocks=(4, 6, 6, 8), num_refinement_blocks=4,
                 heads=(1, 2, 4, 8), ffn_expansion_factor=2.66):
        super().__init__()

        def blocks(n, d, h):
            return nn.Sequential(*[TransformerBlock(d, h, ffn_expansion_factor)
                                   for _ in range(n)])

        self.patch_embed = OverlapPatchEmbed(inp_channels, dim)
        self.encoder_level1 = blocks(num_blocks[0], dim, heads[0])
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = blocks(num_blocks[1], dim * 2, heads[1])
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = blocks(num_blocks[2], dim * 4, heads[2])
        self.down3_4 = Downsample(dim * 4)
        self.latent = blocks(num_blocks[3], dim * 8, heads[3])
        self.up4_3 = Upsample(dim * 8)
        self.reduce_chan_level3 = nn.Conv2d(dim * 8, dim * 4, 1, bias=False)
        self.decoder_level3 = blocks(num_blocks[2], dim * 4, heads[2])
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = nn.Conv2d(dim * 4, dim * 2, 1, bias=False)
        self.decoder_level2 = blocks(num_blocks[1], dim * 2, heads[1])
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = blocks(num_blocks[0], dim * 2, heads[0])
        self.refinement = blocks(num_refinement_blocks, dim * 2, heads[0])
        self.output = nn.Conv2d(dim * 2, out_channels, 3, padding=1,
                                bias=False)

    def forward(self, inp_img):
        e1 = self.encoder_level1(self.patch_embed(inp_img))
        e2 = self.encoder_level2(self.down1_2(e1))
        e3 = self.encoder_level3(self.down2_3(e2))
        latent = self.latent(self.down3_4(e3))
        d3 = self.reduce_chan_level3(torch.cat([self.up4_3(latent), e3], 1))
        d3 = self.decoder_level3(d3)
        d2 = self.reduce_chan_level2(torch.cat([self.up3_2(d3), e2], 1))
        d2 = self.decoder_level2(d2)
        d1 = self.decoder_level1(torch.cat([self.up2_1(d2), e1], 1))
        return self.output(self.refinement(d1)) + inp_img


def denoise(model, x):
    """The test scripts' call of ``model`` on NHWC ``x``: reflect-padded to
    multiples of 8 at the bottom and right, cropped back."""
    h, w = x.shape[1:3]
    img = x.permute(0, 3, 1, 2)
    ph = ((h + 8) // 8) * 8 - h if h % 8 else 0
    pw = ((w + 8) // 8) * 8 - w if w % 8 else 0
    img = F.pad(img, (0, pw, 0, ph), "reflect")
    return model(img)[:, :, :h, :w].permute(0, 2, 3, 1)


def finetune(model, opt, cur, mask, target, iters, lr, weight_decay,
             b1=0.9, b2=0.999, eps=1e-8):
    """``iters`` Adam updates of ``model`` (L2 decay added to the gradient)
    on the summed L1 distance between the masked denoised ``cur`` and
    ``target``, (H, W, C) frames. ``opt``: ``{"count", "m", "v"}`` with one
    tensor a parameter, or None to start. Returns (opt, losses)."""
    params = list(model.parameters())
    if opt is None:
        opt = {"count": 0, "m": [torch.zeros_like(p) for p in params],
               "v": [torch.zeros_like(p) for p in params]}
    losses = []
    for _ in range(iters):
        loss = (mask * denoise(model, cur[None])[0] - target).abs().sum()
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        count = opt["count"] + 1
        c = torch.tensor(float(count))
        c1 = float(1 - torch.tensor(b1) ** c)
        c2 = float(1 - torch.tensor(b2) ** c)
        m, v = [], []
        with torch.no_grad():
            for p, g, m0, v0 in zip(params, grads, opt["m"], opt["v"]):
                g = g + weight_decay * p
                m.append(b1 * m0 + (1 - b1) * g)
                v.append(b2 * v0 + (1 - b2) * g * g)
                p += -lr * ((m[-1] / c1) / (torch.sqrt(v[-1] / c2) + eps))
        opt = {"count": count, "m": m, "v": v}
    return opt, torch.tensor(losses)
