"""Plain FastDVDnet (Tassano, Delon, Veit, "FastDVDnet: Towards Real-Time
Deep Video Denoising Without Flow Estimation", CVPR 2020; the official
``m-tassano/fastdvdnet`` model) in PyTorch ops, eval mode.

Two stages of the same modified U-Net (``DenBlock``): stage 1 denoises the
triplets (0, 1, 2), (1, 2, 3), (2, 3, 4) of a 5-frame window with shared
weights, stage 2 fuses the three results into the centre frame. A DenBlock
takes three frames and a noise map: a grouped 3x3 convolution over the three
(frame, map) stacks to 3 x 30 features, a 3x3 convolution to 32; two
downsampling blocks (a stride-2 3x3 convolution, then two 3x3
convolutions) to 64 and 128 features; two upsampling blocks (two 3x3
convolutions, a 3x3 convolution to four times the features and a pixel
shuffle) with additive skips; two 3x3 convolutions back to the image's
channels; every convolution without bias and followed by BatchNorm and a
ReLU but the last of each up block and of the output. The block returns its
middle frame less its output. A video is served a frame at a time with the
window's indices clamped to the video.

The weights are a ``state_dict`` in the official key layout
(``temp{1,2}.<block>.convblock.<n>.*``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .precision import arithmetic, conv2d

INTERM = 30
CHS = (32, 64, 128)
EPS = 1e-5


def _cv_keys(pre, c_in, c_out):
    return [(f"{pre}.convblock.0", c_in, c_out, 1), (f"{pre}.convblock.3",
                                                     c_out, c_out, 1)]


def layout(channels=3):
    """[(key, c_in a group, c_out, level)] of every convolution of one
    DenBlock (``level``: the divisor of the output's height and width)."""
    c0, c1, c2 = CHS
    out = [("inc.convblock.0", channels + 1, 3 * INTERM, 1),
           ("inc.convblock.3", 3 * INTERM, c0, 1)]
    for name, ci, co, lev in (("downc0", c0, c1, 2), ("downc1", c1, c2, 4)):
        out.append((f"{name}.convblock.0", ci, co, lev))
        out += [(k, a, b, lev) for k, a, b, _ in
                _cv_keys(f"{name}.convblock.3", co, co)]
    for name, ci, co, lev in (("upc2", c2, c1, 4), ("upc1", c1, c0, 2)):
        out += [(k, a, b, lev) for k, a, b, _ in
                _cv_keys(f"{name}.convblock.0", ci, ci)]
        out.append((f"{name}.convblock.1", ci, 4 * co, lev))
    out += [("outc.convblock.0", c0, c0, 1),
            ("outc.convblock.3", c0, channels, 1)]
    return out


def _has_bn(key):
    # every convolution but the up blocks' last and the output's last
    return not (key.endswith("convblock.1") or key == "outc.convblock.3")


def shapes(channels=3):
    """{key: shape} of the whole model's ``state_dict`` (the BatchNorm
    counters left out)."""
    out = {}
    for stage in ("temp1", "temp2"):
        for key, ci, co, _ in layout(channels):
            out[f"{stage}.{key}.weight"] = (co, ci, 3, 3)
            if _has_bn(key):
                n = int(key.split(".")[-1]) + 1
                bn = f"{stage}.{key.rsplit('.', 1)[0]}.{n}"
                for p in ("weight", "bias", "running_mean", "running_var"):
                    out[f"{bn}.{p}"] = (co,)
    return out


def init(seed, device, channels=3):
    """Weights made from ``seed`` on ``device`` in one draw: every kernel
    normal with variance 1 / fan_in (the denoised frames then lie about as
    far from the noisy ones as sigma = 25/255 noise); BatchNorm scales and
    variances in [0.5, 1.5], biases and means of standard deviation 0.1."""
    shp = shapes(channels)
    sizes = [int(torch.Size(s).numel()) for s in shp.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (key, s), n in zip(shp.items(), sizes):
        z, u = normal[off:off + n].view(s), uniform[off:off + n].view(s)
        off += n
        if key.endswith(".weight") and len(s) == 4:
            out[key] = z * (1.0 / (s[1] * 9)) ** 0.5
        elif key.endswith(("weight", "running_var")):
            out[key] = 0.5 + u
        else:
            out[key] = 0.1 * z
    return out


def _bn(sd, key, x):
    n = int(key.split(".")[-1]) + 1
    bn = f"{key.rsplit('.', 1)[0]}.{n}"
    return F.batch_norm(x, sd[bn + ".running_mean"], sd[bn + ".running_var"],
                        sd[bn + ".weight"], sd[bn + ".bias"], False, 0.0, EPS)


def _den_block(sd, pre, in0, in1, in2, nm, mode):
    def conv(key, x, stride=1, groups=1, relu=True):
        y = conv2d(x, sd[f"{pre}.{key}.weight"], mode, stride, 1, groups)
        if _has_bn(key):
            y = _bn(sd, f"{pre}.{key}", y)
        return torch.relu(y) if relu else y

    def cv(key, x):
        return conv(f"{key}.convblock.3", conv(f"{key}.convblock.0", x))

    def down(name, x):
        return cv(f"{name}.convblock.3", conv(f"{name}.convblock.0", x, 2))

    def up(name, x):
        y = conv(f"{name}.convblock.1", cv(f"{name}.convblock.0", x),
                 relu=False)
        return F.pixel_shuffle(y, 2)

    x = torch.cat([in0, nm, in1, nm, in2, nm], dim=1)
    x0 = conv("inc.convblock.3", conv("inc.convblock.0", x, groups=3))
    x1 = down("downc0", x0)
    x2 = up("upc2", down("downc1", x1))
    x1 = up("upc1", x1 + x2)
    y = conv("outc.convblock.3", conv("outc.convblock.0", x0 + x1),
             relu=False)
    return in1 - y


def window(sd, frames, nm, mode="f32"):
    """The denoised centre frame (B, C, H, W) of a window (B, 5, C, H, W)
    with the noise map ``nm`` (B, 1, H, W)."""
    f = frames.unbind(1)
    mids = [_den_block(sd, "temp1", f[t], f[t + 1], f[t + 2], nm, mode)
            for t in range(3)]
    return _den_block(sd, "temp2", *mids, nm, mode)


@torch.no_grad()
def video(sd, vid, sigma, mode="f32"):
    """Every frame of ``vid`` (B, T, H, W, C) denoised with its clamped
    5-frame window and a constant noise map ``sigma``: (B, T, H, W, C)."""
    B, T, H, W, C = vid.shape
    x = vid.permute(0, 1, 4, 2, 3)
    nm = vid.new_full((B, 1, H, W), float(sigma))
    out = []
    with arithmetic(mode):
        for t in range(T):
            idx = [min(max(t + d, 0), T - 1) for d in (-2, -1, 0, 1, 2)]
            out.append(window(sd, x[:, idx], nm, mode))
    return torch.stack(out, 1).permute(0, 1, 3, 4, 2)
