"""Restormer as a PyTorch module, with its weight converters.

The published architecture (Zamir, Arora, Khan, Hayat, Khan, Yang,
"Restormer: Efficient Transformer for High-Resolution Image Restoration",
CVPR 2022; official code swz30/Restormer,
``basicsr/models/archs/restormer_arch.py``), at the widths of its Gaussian
grey denoising models by default (``Denoising/Options/
GaussianGrayDenoising_Restormer.yml``): one channel in and out, ``dim`` 48,
``num_blocks`` (4, 6, 6, 8), 4 refinement blocks, ``heads`` (1, 2, 4, 8),
``ffn_expansion_factor`` 2.66, no biases, the bias-free LayerNorm. The port
builds that form only (``bias=False``, ``LayerNorm_type="BiasFree"``).

A transformer block computes ``x += MDTA(LN(x)); x += GDFN(LN(x))``:

- LN, the bias-free LayerNorm over the channels: ``x / sqrt(var_c(x) +
  1e-5) * w``;
- MDTA, the multi-Dconv-head transposed attention: a 1x1 convolution C->3C,
  a 3x3 depthwise one, q, k and v; q and k L2-normalised over the pixels of
  each channel; per head ``A = softmax(q k^T * t)``, a (C/h) x (C/h) matrix
  summed over every pixel of the frame; ``A v``; a 1x1 convolution C->C;
- GDFN, the gated depthwise feed-forward network: a 1x1 convolution
  C->2 floor(2.66 C), a 3x3 depthwise one, ``gelu(x1) * x2``, a 1x1
  convolution back to C.

The network is a four-level U-Net: a 3x3 convolution to ``dim``; encoder
levels of 4, 6 and 6 blocks at dim, 2 dim and 4 dim channels, each followed
by a 3x3 convolution to half its channels and PixelUnshuffle(2); 8 latent
blocks at 8 dim; going up, a 3x3 convolution to twice the channels and
PixelShuffle(2), the skip concatenated (levels 3 and 2 reduce it with a 1x1
convolution), decoder levels of 6, 6 and 4 blocks, the first level and the
refinement blocks at 2 dim channels at full resolution; a 3x3 convolution
to the image's channels, plus the input (a global residual). The module
returns the denoised frame.

Frames are NHWC at the interface (``(B, H, W, C)``), as the other models
take them; inside, the network runs on NCHW. A frame whose sides are not
multiples of 8 is reflect-padded at its bottom and right and cropped back,
as Restormer's test scripts do (540 rows become 544). The submodules follow
the official key layout (``encoder_level1.0.attn.qkv.weight``, ...), so an
official ``state_dict`` loads with ``load_state_dict``
(``load_checkpoint`` reads the official ``.pth``, whose weights sit under
``params``).

``dtype`` (``load_model``'s ``model_dtype``) is the activations' dtype; the
parameters stay f32 and every convolution and product takes them cast to
it. The LayerNorm's statistics, the L2 norms, the q k^T sums and the
softmax are taken in f32; the 3x3 convolutions run through ``ops/_common.
conv2d`` (f32 operands without TF32), the 1x1 convolutions and ``A v`` on
``torch.matmul``. The LayerNorm's weight is folded into the 1x1
convolution after it (``LN(x) W^T = (x / std_c(x)) (W diag(w))^T``).
Autograd differentiates the whole forward.

Spans (``utils.profiling``): ``restormer.encoder``, ``restormer.latent``,
``restormer.decoder`` and ``restormer.refine`` around the four stages of
the forward; the counters ``restormer.mdta`` and ``restormer.gdfn`` count
the calls of each; ``device_ms.restormer.mdta`` and
``device_ms.restormer.gdfn`` add up the device time of each half of a block
(its LayerNorm, the part, forward and backward) on a CUDA card
(``profiling.device_timed``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops._common import conv2d
from ..utils.profiling import annotate, count, device_timed

DIM = 48
NUM_BLOCKS = (4, 6, 6, 8)
NUM_REFINEMENT_BLOCKS = 4
HEADS = (1, 2, 4, 8)
FFN_EXPANSION_FACTOR = 2.66
LN_EPS = 1e-5
PAD_TO = 8  # three 2x downsamplings


def conv1x1(x, w):
    """A 1x1 convolution of NCHW ``x`` with the OI11 (or OI) weight ``w``
    (cast to ``x``'s dtype), as one batched product over the pixels. (A 2-D
    weight times the 3-D input would take ``torch.matmul``'s folded route,
    which copies the input and the result transposed.)"""
    B, K, H, W = x.shape
    w = w.flatten(1).to(x.dtype)
    y = torch.matmul(w.expand(B, -1, -1), x.reshape(B, K, H * W))
    return y.view(B, -1, H, W)


def conv3x3(x, w, groups=1):
    """A 3x3 convolution of NCHW ``x``, padded by one pixel, with ``w``
    cast to ``x``'s dtype (``ops/_common.conv2d``: f32 operands without
    TF32)."""
    return conv2d(x, w.to(x.dtype), groups=groups)


def normalize(x):
    """NCHW ``x`` over its channels' standard deviation, ``x / sqrt(var_c(x)
    + 1e-5)``: the bias-free LayerNorm without its weight, which the block
    folds into the 1x1 convolution that follows. The statistics in f32, the
    product in f32 rounded once to ``x``'s dtype."""
    c = x.shape[1]
    mean = x.mean(dim=1, keepdim=True, dtype=torch.float32)
    sq = torch.linalg.vector_norm(x, dim=1, keepdim=True,
                                  dtype=torch.float32).square() / c
    r = (sq - mean.square()).clamp_min(0).add(LN_EPS).rsqrt()
    return (x * r).to(x.dtype)


def attend(qkv, t, heads):
    """MDTA's core on the depthwise convolution's output ``qkv`` (B, 3C, H,
    W): per head, ``softmax(q^ k^T^ * t) v`` with q^, k^ the rows of q, k
    normalised over the pixels (``F.normalize``'s floor of 1e-12 on the
    norms). The norms, q k^T and the softmax in f32, ``A v`` in ``qkv``'s
    dtype."""
    q, k, v = _split(qkv, heads)
    p = _gram(q, k) / (_norm(q)[..., :, None] * _norm(k)[..., None, :])
    a = torch.softmax(p * t, dim=-1)
    out = torch.matmul(a.to(v.dtype), v)
    return out.view(qkv.shape[0], -1, *qkv.shape[2:])


def _split(qkv, heads):
    """q, k, v of NCHW ``qkv`` as (B, heads, C / heads, H W) views, channels
    in the official order (q, k, v, then heads, then the head's
    channels)."""
    B, C3, H, W = qkv.shape
    return qkv.view(B, 3, heads, C3 // (3 * heads), H * W).unbind(1)


def _norm(x):
    """The L2 norm of each row of ``x`` in f32, at least 1e-12."""
    return torch.linalg.vector_norm(x, dim=-1,
                                    dtype=torch.float32).clamp_min(1e-12)


GRAM_ROWS = 4096  # the least stretch of the pixels one product sums


def _gram(a, b):
    """``a b^T`` over the pixels (the last axis) in f32, for (B, h, c, N)
    ``a``, ``b``: the pixels cut into S equal stretches of at least
    ``GRAM_ROWS``, a batch of S products over strided views of one f32 copy
    a head, summed, so that a product with a (c x c) result and N terms
    runs on more than a few blocks of the card."""
    *lead, c, n = a.shape
    s = next(d for d in range(max(1, n // GRAM_ROWS), 0, -1) if n % d == 0)
    af = a.float().reshape(-1, c, s, n // s)
    bf = b.float().reshape(-1, c, s, n // s)
    out = torch.stack([torch.bmm(x.transpose(0, 1), y.permute(1, 2, 0))
                       .sum(0) for x, y in zip(af, bf)])
    return out.view(*lead, c, c)


class _Weight(nn.Module):
    """The official ``BiasFree_LayerNorm``'s weight."""

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))


class LayerNorm(nn.Module):
    """The official ``LayerNorm`` wrapper around ``BiasFree_LayerNorm``:
    its weight is ``body.weight``, which the block folds into the 1x1
    convolution after it (``normalize``)."""

    def __init__(self, dim):
        super().__init__()
        self.body = _Weight(dim)


class Attention(nn.Module):
    """MDTA (``temperature``, ``qkv``, ``qkv_dwconv``, ``project_out``)."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=False)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1,
                                    groups=dim * 3, bias=False)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=False)

    def forward(self, xn, scale):
        """MDTA of ``xn * scale``: the block's input normalised and its
        LayerNorm's weight."""
        count("restormer.mdta")
        w = self.qkv.weight.flatten(1) * scale
        qkv = conv3x3(conv1x1(xn, w), self.qkv_dwconv.weight,
                      groups=self.qkv_dwconv.groups)
        out = attend(qkv, self.temperature, self.num_heads)
        return conv1x1(out, self.project_out.weight)


class FeedForward(nn.Module):
    """GDFN (``project_in``, ``dwconv``, ``project_out``)."""

    def __init__(self, dim, ffn_expansion_factor):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1,
                                groups=hidden * 2, bias=False)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=False)

    def forward(self, xn, scale):
        """GDFN of ``xn * scale``: the block's input normalised and its
        LayerNorm's weight."""
        count("restormer.gdfn")
        w = self.project_in.weight.flatten(1) * scale
        h = conv3x3(conv1x1(xn, w), self.dwconv.weight,
                    groups=self.dwconv.groups)
        x1, x2 = h.chunk(2, dim=1)
        return conv1x1(F.gelu(x1) * x2, self.project_out.weight)


class TransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, ffn_expansion_factor):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_expansion_factor)

    def forward(self, x):
        x = x + device_timed("restormer.mdta", lambda h: self.attn(
            normalize(h), self.norm1.body.weight), x)
        return x + device_timed("restormer.gdfn", lambda h: self.ffn(
            normalize(h), self.norm2.body.weight), x)


class OverlapPatchEmbed(nn.Module):
    """A 3x3 convolution to ``dim`` channels (``proj``)."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.proj = nn.Conv2d(c_in, c_out, 3, padding=1, bias=False)


class Downsample(nn.Module):
    """A 3x3 convolution to half the channels, then PixelUnshuffle(2)."""

    def __init__(self, n_feat):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False),
            nn.PixelUnshuffle(2))

    def forward(self, x):
        return F.pixel_unshuffle(conv3x3(x, self.body[0].weight), 2)


class Upsample(nn.Module):
    """A 3x3 convolution to twice the channels, then PixelShuffle(2)."""

    def __init__(self, n_feat):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat * 2, 3, padding=1, bias=False),
            nn.PixelShuffle(2))

    def forward(self, x):
        return F.pixel_shuffle(conv3x3(x, self.body[0].weight), 2)


class Restormer(nn.Module):
    """The Restormer U-Net, (B, H, W, C) frames in [0, 1] -> the denoised
    frames."""

    def __init__(self, channels=1, dim=DIM, num_blocks=NUM_BLOCKS,
                 num_refinement_blocks=NUM_REFINEMENT_BLOCKS, heads=HEADS,
                 ffn_expansion_factor=FFN_EXPANSION_FACTOR,
                 dtype=torch.float32):
        super().__init__()
        self.channels, self.dtype = channels, dtype

        def blocks(n, d, h):
            return nn.Sequential(*[TransformerBlock(d, h, ffn_expansion_factor)
                                   for _ in range(n)])

        self.patch_embed = OverlapPatchEmbed(channels, dim)
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
        self.output = nn.Conv2d(dim * 2, channels, 3, padding=1, bias=False)

    def forward(self, x):
        B, H, W, _ = x.shape
        inp = pad(x.permute(0, 3, 1, 2))
        with annotate("restormer.encoder"):
            h = conv3x3(inp.to(self.dtype), self.patch_embed.proj.weight)
            e1 = self.encoder_level1(h)
            e2 = self.encoder_level2(self.down1_2(e1))
            e3 = self.encoder_level3(self.down2_3(e2))
            h = self.down3_4(e3)
        with annotate("restormer.latent"):
            h = self.latent(h)
        with annotate("restormer.decoder"):
            h = conv1x1(torch.cat([self.up4_3(h), e3], 1),
                        self.reduce_chan_level3.weight)
            h = self.decoder_level3(h)
            h = conv1x1(torch.cat([self.up3_2(h), e2], 1),
                        self.reduce_chan_level2.weight)
            h = self.decoder_level2(h)
            h = self.decoder_level1(torch.cat([self.up2_1(h), e1], 1))
        with annotate("restormer.refine"):
            h = self.refinement(h)
            out = conv3x3(h, self.output.weight).float() + inp
        return out[:, :, :H, :W].permute(0, 2, 3, 1).contiguous()


def pad(x):
    """NCHW ``x`` reflect-padded at its bottom and right to sides that are
    multiples of 8 (as the official test scripts pad)."""
    ph, pw = (-x.shape[2]) % PAD_TO, (-x.shape[3]) % PAD_TO
    return F.pad(x, (0, pw, 0, ph), mode="reflect") if ph or pw else x


def init_restormer(seed=0, channels=1, dtype=torch.float32, **widths):
    """A new ``Restormer`` and its variables: ``(model, variables)``.

    Every convolution is drawn as ``nn.Conv2d`` initialises it (uniform in
    +-1/sqrt(fan_in), fan_in = 9 or 1 times the input features of a group)
    from a ``torch.Generator`` seeded with ``seed``; LayerNorm weights and
    temperatures start at 1, as the official module's do."""
    model = Restormer(channels, dtype=dtype, **widths)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=gen)
    return model, to_jax_variables(model)


def to_jax_variables(model):
    """``model``'s weights as the registry's variables: ``{"params": the
    state dict nested by its dotted keys, numpy f32 (OIHW kernels, as the
    official checkpoint holds them), "batch_stats": {}}``. There is no JAX
    Restormer; the tree has the registry's shape so that the engine and
    ``load_model`` treat every model alike."""
    params = {}
    for key, v in model.state_dict().items():
        node = params
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v.detach().cpu().float().numpy().copy()
    return {"params": params, "batch_stats": {}}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def load_jax_variables(model, variables):
    """Copy ``to_jax_variables``' tree into ``model`` in place (every key
    of the module, none other); returns ``model``."""
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in _flat(variables["params"])}
    model.load_state_dict(sd)
    return model


def load_checkpoint(model, path):
    """An official Restormer checkpoint (``torch.save`` of ``{"params":
    state_dict}``, or of the state dict itself) into ``model``; returns
    ``model``."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ck.get("params", ck))
    return model
