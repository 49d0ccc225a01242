"""Plain Restormer (Zamir, Arora, Khan, Hayat, Khan, Yang, "Restormer:
Efficient Transformer for High-Resolution Image Restoration", CVPR 2022;
the official ``basicsr/models/archs/restormer_arch.py`` of swz30/Restormer)
in its bias-free grey denoising form, its seeded weights and its online
fine-tune (frame2frame, as ``dncnn.finetune_frame``), in float32 PyTorch
ops.

The network, on NCHW frames: a 3x3 convolution to ``dim`` channels; a
four-level U-Net of transformer blocks (``x += MDTA(LN(x)); x += GDFN(LN(
x))``: the bias-free LayerNorm over the channels, the transposed attention
over the pixels of each channel with q and k L2-normalised and a learnt
temperature a head, the gated depthwise feed-forward network with GELU);
3x3 convolutions with PixelUnshuffle / PixelShuffle between the levels, the
skips concatenated and, at levels 3 and 2, reduced by a 1x1 convolution;
refinement blocks at full resolution; a 3x3 convolution to the image's
channels plus the input. A frame whose sides are not multiples of 8 is
reflect-padded at its bottom and right and cropped back (the official test
scripts).

The state is a dict of tensors keyed as the official module's
``state_dict`` (``encoder_level1.0.attn.qkv.weight``, ...; OIHW kernels).
Every convolution and both attention products (q k^T and A v) take their
operands through ``precision.py``'s mode; the LayerNorm, the norms, the
softmax and GELU stay float32. In training each transformer block is
recomputed in the backward (``torch.utils.checkpoint``), so that a whole
540p frame in float32 fits one card: its block inputs (about 3 GB) and one
block's insides are held at once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import arithmetic, bf16, conv2d, fp8
from .warp import bilinear_warp_with_mask, occlusion_mask

EPS = 1e-5
PAD_TO = 8


def widths(config):
    """The configuration's widths as ``(dim, num_blocks,
    num_refinement_blocks, heads, ffn_expansion_factor)``."""
    return (config["dim"], tuple(config["num_blocks"]),
            config["num_refinement_blocks"], tuple(config["heads"]),
            config["ffn_expansion_factor"])


def _levels(config):
    """(prefix, blocks, channels, heads) of each stack of blocks, in the
    module's order."""
    dim, nb, nr, heads, _ = widths(config)
    return [("encoder_level1", nb[0], dim, heads[0]),
            ("encoder_level2", nb[1], 2 * dim, heads[1]),
            ("encoder_level3", nb[2], 4 * dim, heads[2]),
            ("latent", nb[3], 8 * dim, heads[3]),
            ("decoder_level3", nb[2], 4 * dim, heads[2]),
            ("decoder_level2", nb[1], 2 * dim, heads[1]),
            ("decoder_level1", nb[0], 2 * dim, heads[0]),
            ("refinement", nr, 2 * dim, heads[0])]


def layout(config):
    """(key, shape) of every weight, in the official module's order."""
    dim, _, _, _, ffn = widths(config)
    ch = config["channels"]
    stacks = {name: (n, c, h) for name, n, c, h in _levels(config)}

    def block(prefix, c, h):
        hid = int(c * ffn)
        return [(f"{prefix}.norm1.body.weight", (c,)),
                (f"{prefix}.attn.temperature", (h, 1, 1)),
                (f"{prefix}.attn.qkv.weight", (3 * c, c, 1, 1)),
                (f"{prefix}.attn.qkv_dwconv.weight", (3 * c, 1, 3, 3)),
                (f"{prefix}.attn.project_out.weight", (c, c, 1, 1)),
                (f"{prefix}.norm2.body.weight", (c,)),
                (f"{prefix}.ffn.project_in.weight", (2 * hid, c, 1, 1)),
                (f"{prefix}.ffn.dwconv.weight", (2 * hid, 1, 3, 3)),
                (f"{prefix}.ffn.project_out.weight", (c, hid, 1, 1))]

    def stack(name):
        n, c, h = stacks[name]
        return [kv for i in range(n) for kv in block(f"{name}.{i}", c, h)]

    def conv(key, c_out, c_in, k=3):
        return [(key, (c_out, c_in, k, k))]

    return (conv("patch_embed.proj.weight", dim, ch)
            + stack("encoder_level1") + conv("down1_2.body.0.weight",
                                             dim // 2, dim)
            + stack("encoder_level2") + conv("down2_3.body.0.weight", dim,
                                             2 * dim)
            + stack("encoder_level3") + conv("down3_4.body.0.weight",
                                             2 * dim, 4 * dim)
            + stack("latent") + conv("up4_3.body.0.weight", 16 * dim, 8 * dim)
            + conv("reduce_chan_level3.weight", 4 * dim, 8 * dim, 1)
            + stack("decoder_level3") + conv("up3_2.body.0.weight", 8 * dim,
                                             4 * dim)
            + conv("reduce_chan_level2.weight", 2 * dim, 4 * dim, 1)
            + stack("decoder_level2") + conv("up2_1.body.0.weight", 4 * dim,
                                             2 * dim)
            + stack("decoder_level1") + stack("refinement")
            + conv("output.weight", ch, 2 * dim))


def init(seed, device, config):
    """Weights made from ``seed`` on ``device``, as the official module
    initialises them: every kernel uniform in +-1/sqrt(fan_in)
    (``nn.Conv2d``'s default; fan_in is the kernel's size over one output
    channel), in ``layout``'s order from one ``torch.Generator``; the
    LayerNorm weights and the temperatures 1."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for key, shape in layout(config):
        if len(shape) == 4:
            bound = 1.0 / math.sqrt(math.prod(shape[1:]))
            u = torch.rand(shape, generator=gen, device=device)
            out[key] = (2.0 * u - 1.0) * bound
        else:
            out[key] = torch.ones(shape, device=device)
    return out


def _round(mode, *xs):
    """The operands of a product in ``mode``."""
    if mode == "fp8":
        return [fp8(x) for x in xs]
    if mode == "bf16":
        return [bf16(x) for x in xs]
    return list(xs)


def _conv(x, w, mode, groups=1):
    return conv2d(x, w, mode, padding=w.shape[-1] // 2, groups=groups)


def _layer_norm(x, w):
    sigma = x.var(1, keepdim=True, unbiased=False)
    return x / torch.sqrt(sigma + EPS) * w.view(1, -1, 1, 1)


def _stretches(x):
    """(b, heads, c, N) ``x`` as (b, heads, S, c, N / S): the pixels cut
    into S equal stretches of at least 4096, so that the sums over the
    pixels (q k^T, and A's gradient in the backward) run as S products
    summed, not as one product of a few blocks."""
    n = x.shape[-1]
    s = next(d for d in range(max(1, n // 4096), 0, -1) if n % d == 0)
    return x.reshape(*x.shape[:-1], s, n // s).transpose(-2, -3)


def _attention(s, p, x, heads, mode):
    b, c, h, w = x.shape
    qkv = _conv(_conv(x, s[p + "qkv.weight"], mode),
                s[p + "qkv_dwconv.weight"], mode, groups=3 * c)
    q, k, v = (t.reshape(b, heads, c // heads, h * w)
               for t in qkv.chunk(3, dim=1))
    q, k = _round(mode, F.normalize(q, dim=-1), F.normalize(k, dim=-1))
    qs, ks = _stretches(q), _stretches(k)
    attn = (qs @ ks.transpose(-2, -1)).sum(-3) * s[p + "temperature"]
    a, v = _round(mode, attn.softmax(dim=-1), v)
    out = (a.unsqueeze(-3) @ _stretches(v)).transpose(-2, -3)
    return _conv(out.reshape(b, c, h, w), s[p + "project_out.weight"], mode)


def _ffn(s, p, x, mode):
    h = _conv(_conv(x, s[p + "project_in.weight"], mode),
              s[p + "dwconv.weight"], mode,
              groups=s[p + "dwconv.weight"].shape[0])
    x1, x2 = h.chunk(2, dim=1)
    return _conv(F.gelu(x1) * x2, s[p + "project_out.weight"], mode)


def _block(s, p, heads, mode):
    def run(x):
        x = x + _attention(s, p + "attn.",
                           _layer_norm(x, s[p + "norm1.body.weight"]), heads,
                           mode)
        return x + _ffn(s, p + "ffn.",
                        _layer_norm(x, s[p + "norm2.body.weight"]), mode)

    return run


def _stack(s, name, n, heads, x, mode, recompute):
    for i in range(n):
        run = _block(s, f"{name}.{i}.", heads, mode)
        x = (checkpoint(run, x, use_reentrant=False) if recompute
             else run(x))
    return x


def pad(x):
    """NCHW ``x`` reflect-padded at its bottom and right to multiples of
    8."""
    ph, pw = (-x.shape[2]) % PAD_TO, (-x.shape[3]) % PAD_TO
    return F.pad(x, (0, pw, 0, ph), mode="reflect") if ph or pw else x


def forward(s, x, config, mode="f32", recompute=False):
    """The denoised ``x`` (B, C, H, W); to be called inside
    ``arithmetic(mode)``. ``recompute``: each block recomputed in the
    backward."""
    H, W = x.shape[2:]
    inp = pad(x)
    st = {name: (n, h) for name, n, _, h in _levels(config)}

    def stack(name, h):
        return _stack(s, name, *st[name], h, mode, recompute)

    def up(key, h):
        return F.pixel_shuffle(_conv(h, s[key], mode), 2)

    def down(key, h):
        return F.pixel_unshuffle(_conv(h, s[key], mode), 2)

    e1 = stack("encoder_level1", _conv(inp, s["patch_embed.proj.weight"],
                                       mode))
    e2 = stack("encoder_level2", down("down1_2.body.0.weight", e1))
    e3 = stack("encoder_level3", down("down2_3.body.0.weight", e2))
    h = stack("latent", down("down3_4.body.0.weight", e3))
    h = _conv(torch.cat([up("up4_3.body.0.weight", h), e3], 1),
              s["reduce_chan_level3.weight"], mode)
    h = stack("decoder_level3", h)
    h = _conv(torch.cat([up("up3_2.body.0.weight", h), e2], 1),
              s["reduce_chan_level2.weight"], mode)
    h = stack("decoder_level2", h)
    h = stack("decoder_level1",
              torch.cat([up("up2_1.body.0.weight", h), e1], 1))
    h = stack("refinement", h)
    return (_conv(h, s["output.weight"], mode) + inp)[:, :, :H, :W]


@torch.no_grad()
def denoise(state, frames, config, mode="f32"):
    """Denoise (B, H, W, C) frames, one a pass."""
    out = []
    with arithmetic(mode):
        for x in frames.split(1):
            y = forward(state, x.permute(0, 3, 1, 2), config, mode)
            out.append(y.permute(0, 2, 3, 1))
    return torch.cat(out)


def finetune_frame(state, opt, adam, cur, prev, flow, iters, config,
                   mode="f32"):
    """One frame of the online fine-tune, as ``dncnn.finetune_frame``: the
    previous frame warped by the flow and masked, ``iters`` Adam updates of
    every weight on the summed masked L1 distance between the denoised
    current frame and that target, then the denoise of the current frame
    with the updated weights. ``cur``, ``prev``: (H, W, C) in [0, 1];
    ``flow``: (H, W, 2). Updates ``state`` in place; returns (opt, denoised
    (H, W, C), losses (iters,), the first update's gradients)."""
    with torch.no_grad():
        warped, mask = bilinear_warp_with_mask(prev, flow)
        mask = occlusion_mask(flow, mask)
        target = (mask * warped).permute(2, 0, 1)[None]
        mask = mask.permute(2, 0, 1)[None]
    x = cur.permute(2, 0, 1)[None]
    names = list(state)
    losses, first = [], None
    with arithmetic(mode):
        for _ in range(iters):
            params = {k: state[k].detach().requires_grad_(True)
                      for k in names}
            y = forward(params, x, config, mode, recompute=True)
            loss = (mask * y - target).abs().sum()
            grads = dict(zip(names, torch.autograd.grad(
                loss, list(params.values()))))
            if first is None:
                first = grads
            opt = adam.step(state, grads, opt)
            losses.append(float(loss.detach()))
        with torch.no_grad():
            deno = forward(state, x, config, mode)
    return opt, deno[0].permute(1, 2, 0), torch.tensor(losses), first
