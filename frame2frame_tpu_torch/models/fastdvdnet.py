"""FastDVDnet video denoiser as a PyTorch module, with the weight converters.

Counterpart of ``frame2frame_tpu/models/fastdvdnet.py``, the published
architecture (Tassano, Delon, Veit, "FastDVDnet: Towards Real-Time Deep Video
Denoising Without Flow Estimation", CVPR 2020): a two-stage cascade of
modified U-Nets. Stage 1 (``temp1``) denoises three overlapping frame
triplets with shared weights; stage 2 (``temp2``) fuses the three
intermediate results into the denoised center frame. Each block is residual
(predicts noise of its center frame) and takes a per-pixel noise-level map.

Frames are NHWC at the interface, as in the JAX package: ``(B, 5, H, W, C)``
windows for ``FastDVDnet``, ``(B, T, H, W, C)`` videos for
``FastDVDnetVideo``, noise maps ``(B, H, W, 1)``; inside, the blocks run on
NCHW. The submodules follow the official torch key layout
(``temp{1,2}.<block>.convblock.N.*``), so an official state dict loads into
``FastDVDnet`` with ``load_state_dict`` after ``strip_prefix(sd,
"module.")``; ``import_fastdvdnet_state_dict`` / ``to_jax_variables`` give the
JAX package's variable tree and ``from_jax_variables`` takes it.

The convolutions are the library's in f32 with TF32 off (``ops/_common.
conv2d``; the modules' ``nn.Conv2d`` hold the weights and are never called).
BatchNorm follows flax's: in training it normalises with the batch's biased
variance and moves the running statistics by ``new = 0.9 * old + 0.1 *
batch`` with that biased variance, once a call of the block, so that
``temp1``'s statistics move three times a window, as under
``mutable=["batch_stats"]`` in the JAX package.

``dtype`` (the JAX model's ``dtype``, ``load_model``'s ``model_dtype``) is
the activations' dtype; the parameters stay f32. Every convolution takes
its operands cast to it, as flax's ``nn.Conv(dtype=)`` does, and BatchNorm
computes in f32 and returns it; the residual subtractions of the frames
give f32, as in the JAX model.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops._common import conv2d
from . import sync_bn
from .dncnn import BN_MOMENTUM

INTERM = 30  # features per frame group of InputCvBlock's grouped conv
CHS = (32, 64, 128)  # the published widths of the U-Net's three levels


def pixel_shuffle(x, r):
    """NHWC pixel shuffle in torch's channel order:
    in[..., c*r*r + i*r + j] -> out[..., h*r+i, w*r+j, c]."""
    return F.pixel_shuffle(x.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)


def _conv(c_in, c_out, stride=1, groups=1):
    return nn.Conv2d(c_in, c_out, 3, padding=1, stride=stride, groups=groups,
                     bias=False)


def _batch_norm(bn, x):
    """flax BatchNorm (momentum 0.9, eps 1e-5) of NCHW ``x``; in training
    the running statistics move in place, without gradient. The batch's
    variance is taken in two passes, not as flax's ``E[x^2] - E[x]^2``,
    whose cancellation costs the gradients of the coarse levels (8x10 pixels
    at a 32x40 input) several digits in f32. Inside a data-parallel shard
    (``sync_bn``) the statistics are the whole batch's."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    if sync_bn.active():
        # the whole batch's statistics over the data-parallel shards
        mean = sync_bn.mean(x, (0, 2, 3))
        d = x - mean.view(1, -1, 1, 1)
        var = sync_bn.mean(d * d, (0, 2, 3))
        with torch.no_grad():
            for buf, batch in ((bn.running_mean, mean), (bn.running_var, var)):
                buf.mul_(BN_MOMENTUM).add_(batch, alpha=1 - BN_MOMENTUM)
        scale = torch.rsqrt(var + bn.eps) * bn.weight
        return d * scale.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


def _run(seq, x, dtype):
    """The layers of a ``convblock`` on NCHW ``x``, activations in
    ``dtype``."""
    cast = dtype != torch.float32
    for m in seq:
        if isinstance(m, nn.Conv2d):
            w = m.weight.to(dtype) if cast else m.weight
            x = conv2d(x.to(dtype) if cast else x, w, m.stride[0], m.groups)
        elif isinstance(m, nn.BatchNorm2d):
            x = (_batch_norm(m, x.float()).to(dtype) if cast
                 else _batch_norm(m, x))
        elif isinstance(m, nn.ReLU):
            x = torch.relu(x)
        elif isinstance(m, nn.PixelShuffle):
            x = F.pixel_shuffle(x, m.upscale_factor)
        else:
            x = m(x)
    return x


class _Block(nn.Module):
    dtype = torch.float32  # the activations' dtype, set by FastDVDnet

    def forward(self, x):
        return _run(self.convblock, x, self.dtype)


class CvBlock(_Block):
    """(Conv3x3 + BN + ReLU) x2."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.convblock = nn.Sequential(
            _conv(c_in, c_out), nn.BatchNorm2d(c_out), nn.ReLU(),
            _conv(c_out, c_out), nn.BatchNorm2d(c_out), nn.ReLU())


class InputCvBlock(_Block):
    """Grouped conv over the (frame, noise-map) stacks, then projection."""

    def __init__(self, num_in_frames, channels, c_out):
        super().__init__()
        c_mid = num_in_frames * INTERM
        self.convblock = nn.Sequential(
            _conv(num_in_frames * (channels + 1), c_mid, groups=num_in_frames),
            nn.BatchNorm2d(c_mid), nn.ReLU(),
            _conv(c_mid, c_out), nn.BatchNorm2d(c_out), nn.ReLU())


class DownBlock(_Block):
    """Stride-2 conv (torch's one-pixel pad on every side) + BN + ReLU, then
    a ``CvBlock``."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.convblock = nn.Sequential(
            _conv(c_in, c_out, stride=2), nn.BatchNorm2d(c_out), nn.ReLU(),
            CvBlock(c_out, c_out))


class UpBlock(_Block):
    """``CvBlock``, conv to 4x the output features, pixel shuffle."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.convblock = nn.Sequential(
            CvBlock(c_in, c_in), _conv(c_in, c_out * 4), nn.PixelShuffle(2))


class OutputCvBlock(_Block):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.convblock = nn.Sequential(
            _conv(c_in, c_in), nn.BatchNorm2d(c_in), nn.ReLU(),
            _conv(c_in, c_out))


class DenBlock(nn.Module):
    """One modified U-Net stage: 3 frames + noise map -> denoised center
    frame, all NCHW."""

    def __init__(self, channels=3):
        super().__init__()
        c0, c1, c2 = CHS
        self.inc = InputCvBlock(3, channels, c0)
        self.downc0 = DownBlock(c0, c1)
        self.downc1 = DownBlock(c1, c2)
        self.upc2 = UpBlock(c2, c1)
        self.upc1 = UpBlock(c1, c0)
        self.outc = OutputCvBlock(c0, channels)

    def forward(self, in0, in1, in2, noise_map):
        x0 = self.inc(torch.cat(
            [in0, noise_map, in1, noise_map, in2, noise_map], dim=1))
        x1 = self.downc0(x0)
        x2 = self.downc1(x1)
        x2 = self.upc2(x2)
        x1 = self.upc1(x1 + x2)
        return in1 - self.outc(x0 + x1)


class FastDVDnet(nn.Module):
    """Two-stage cascade over 5 frames -> denoised center frame.

    ``frames``: (B, 5, H, W, C), or (B, H, W, 5*C) packed; ``noise_map``:
    (B, H, W, 1), sigma in the pixels' scale (zeros when None). Returns
    (B, H, W, C). H and W divisible by 4, as the JAX model needs."""

    def __init__(self, channels=3, dtype=torch.float32):
        super().__init__()
        self.channels = channels
        self.temp1 = DenBlock(channels)
        self.temp2 = DenBlock(channels)
        for m in self.modules():
            if isinstance(m, _Block):
                m.dtype = dtype

    def forward(self, frames, noise_map=None):
        if frames.dim() == 4:  # (B,H,W,5*C) packed -> unpack
            B, H, W, TC = frames.shape
            frames = frames.reshape(B, H, W, 5, TC // 5).permute(0, 3, 1, 2, 4)
        B, T, H, W, C = frames.shape
        if T != 5:
            raise ValueError(f"FastDVDnet takes 5-frame windows, got {T}")
        if noise_map is None:
            noise_map = frames.new_zeros(B, H, W, 1)
        nm = noise_map.permute(0, 3, 1, 2)
        f = [frames[:, t].permute(0, 3, 1, 2) for t in range(5)]
        x20 = self.temp1(f[0], f[1], f[2], nm)
        x21 = self.temp1(f[1], f[2], f[3], nm)
        x22 = self.temp1(f[2], f[3], f[4], nm)
        return self.temp2(x20, x21, x22, nm).permute(0, 2, 3, 1)


class FastDVDnetVideo(nn.Module):
    """Whole-video wrapper: denoises every frame using clamped 5-frame windows
    (standard FastDVDnet inference), (B, T, H, W, C) -> (B, T, H, W, C).
    ``sigma`` gives a constant noise map where ``noise_map`` is None."""

    def __init__(self, channels=3, dtype=torch.float32):
        super().__init__()
        self.channels = channels
        self.net = FastDVDnet(channels, dtype)

    def forward(self, vid, noise_map=None, sigma=None):
        B, T, H, W, C = vid.shape
        if noise_map is None and sigma is not None:
            noise_map = vid.new_full((B, H, W, 1), float(sigma))
        outs = []
        for t in range(T):
            idx = [min(max(t + d, 0), T - 1) for d in (-2, -1, 0, 1, 2)]
            outs.append(self.net(vid[:, idx], noise_map))
        return torch.stack(outs, dim=1)


def _layout():
    """(JAX path, torch module path, kind) of every conv and BatchNorm of
    ``FastDVDnet``: the official torch layout beside the JAX package's
    names."""
    out = []

    def cv(dst, src):
        for i, (ci, bi) in enumerate(((0, 1), (3, 4))):
            out.append((dst + (f"conv{i}",), f"{src}.convblock.{ci}", "conv"))
            out.append((dst + (f"bn{i}",), f"{src}.convblock.{bi}", "bn"))

    for t in ("temp1", "temp2"):
        out += [((t, "inc", "conv_group"), f"{t}.inc.convblock.0", "conv"),
                ((t, "inc", "bn0"), f"{t}.inc.convblock.1", "bn"),
                ((t, "inc", "conv_proj"), f"{t}.inc.convblock.3", "conv"),
                ((t, "inc", "bn1"), f"{t}.inc.convblock.4", "bn")]
        for jname, tname in (("down0", "downc0"), ("down1", "downc1")):
            out += [((t, jname, "down"), f"{t}.{tname}.convblock.0", "conv"),
                    ((t, jname, "bn"), f"{t}.{tname}.convblock.1", "bn")]
            cv((t, jname, "cv"), f"{t}.{tname}.convblock.3")
        for jname, tname in (("up2", "upc2"), ("up1", "upc1")):
            cv((t, jname, "cv"), f"{t}.{tname}.convblock.0")
            out.append(((t, jname, "up"), f"{t}.{tname}.convblock.1", "conv"))
        out += [((t, "outc", "conv0"), f"{t}.outc.convblock.0", "conv"),
                ((t, "outc", "bn"), f"{t}.outc.convblock.1", "bn"),
                ((t, "outc", "conv1"), f"{t}.outc.convblock.3", "conv")]
    return out


def _put(tree, path, value):
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def _get(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def import_fastdvdnet_state_dict(state_dict, video_wrapper=True):
    """An official FastDVDnet torch ``state_dict`` (Tassano et al., github
    fastdvdnet model.pth; keys ``temp{1,2}.<block>.convblock.N.*``, values
    tensors or numpy arrays, DataParallel's ``module.`` prefixes stripped) ->
    the JAX package's variables for ``FastDVDnet`` (``video_wrapper=False``)
    or ``FastDVDnetVideo``: numpy leaves, HWIO conv kernels (a grouped conv
    keeps I = in_ch / groups)."""
    def to_np(v):
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.array(v)

    sd = {(k[len("module."):] if k.startswith("module.") else k): to_np(v)
          for k, v in state_dict.items()}
    params, stats = {}, {}
    for path, key, kind in _layout():
        if kind == "conv":
            _put(params, path,
                 {"kernel": sd[key + ".weight"].transpose(2, 3, 1, 0)})
        else:
            _put(params, path, {"scale": sd[key + ".weight"],
                                "bias": sd[key + ".bias"]})
            _put(stats, path, {"mean": sd[key + ".running_mean"],
                               "var": sd[key + ".running_var"]})
    if video_wrapper:
        params, stats = {"net": params}, {"net": stats}
    return {"params": params, "batch_stats": stats}


def to_jax_variables(model):
    """A ``FastDVDnet`` or ``FastDVDnetVideo`` -> the JAX package's variable
    tree (numpy f32 leaves, HWIO kernels)."""
    video = isinstance(model, FastDVDnetVideo)
    net = model.net if video else model
    return import_fastdvdnet_state_dict(net.state_dict(), video_wrapper=video)


def load_jax_variables(model, variables):
    """Copy the JAX package's ``{"params", "batch_stats"}`` tree into
    ``model`` (``FastDVDnet`` or ``FastDVDnetVideo``, as the tree's ``net``
    level says) in place; returns ``model``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    video = "net" in params
    if video != isinstance(model, FastDVDnetVideo):
        raise ValueError("the variables are for a "
                         f"{'FastDVDnetVideo' if video else 'FastDVDnet'}, "
                         f"the model is a {type(model).__name__}")
    if video:
        params, stats = params["net"], stats.get("net", {})
        model_net = model.net
    else:
        model_net = model

    def put(t, v):
        t.copy_(torch.from_numpy(np.array(v, np.float32)))

    with torch.no_grad():
        for path, key, kind in _layout():
            m = model_net.get_submodule(key)
            p = _get(params, path)
            if kind == "conv":
                put(m.weight, np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
            else:
                s = _get(stats, path)
                put(m.weight, p["scale"])
                put(m.bias, p["bias"])
                put(m.running_mean, s["mean"])
                put(m.running_var, s["var"])
    return model


def from_jax_variables(variables, dtype=torch.float32):
    """The JAX variable tree -> a ``FastDVDnetVideo`` (a ``net`` level) or a
    ``FastDVDnet`` (CPU, f32 weights, activations in ``dtype``) holding its
    weights. The channels are read from the tree."""
    params = variables["params"]
    video = "net" in params
    net = params["net"] if video else params
    channels = np.asarray(net["temp2"]["outc"]["conv1"]["kernel"]).shape[-1]
    model = (FastDVDnetVideo if video else FastDVDnet)(channels, dtype)
    return load_jax_variables(model, variables)


def init_fastdvdnet(seed=0, channels=3, dtype=torch.float32):
    """A new ``FastDVDnetVideo`` and its JAX-layout variables: ``(model,
    variables)``.

    Conv kernels are lecun-normal as flax initialises them (a normal
    truncated at two standard deviations, scaled to variance 1 / fan_in,
    fan_in = 9 * input features of a group), drawn from a ``torch.Generator``
    seeded with ``seed``: the values differ from
    ``jax.random.PRNGKey(seed)``'s.
    BatchNorm starts at scale 1, bias 0, mean 0, variance 1."""
    model = FastDVDnetVideo(channels, dtype)
    gen = torch.Generator().manual_seed(seed)
    # flax's truncated normal: unit variance after truncation at +-2
    std_of_truncated = 0.87962566103423978
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / std_of_truncated
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
    return model, to_jax_variables(model)
