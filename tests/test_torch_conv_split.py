"""The split-f32 products of kernels A and B on f32 operands
(``csrc/conv3x3.cu``: ``conv3x3_wg``, ``dw_tc_k``), emulated on the CPU.

Each operand x is split into a TF32 ``hi`` (round to nearest, ties away from
zero: ``cvt.rna.tf32.f32``) and ``lo = x - hi``, which the tensor core reads
truncated to TF32; a product is ``hi*lo + lo*hi + hi*hi``. Held against the
float64 result within ``chip_smoke.CONV_RTOL`` of its largest value, the bar
the card holds the kernels to; one TF32 pass (``hi*hi``) must miss that bar,
so that it is shown to tell f32 from TF32. The sums are taken in float64
here: the kernels' running sums are f32 adds rounded to nearest, checked on
the card against float64 by ``chip_smoke.conv_kernel_phase``."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import CONV_RTOL  # noqa: E402
from frame2frame_tpu_torch.models.serialization import (  # noqa: E402
    load_variables)

CKPT = (Path(__file__).resolve().parents[1] / "results" / "dncnn17_s25"
        / "checkpoint.msgpack")
H, W = 16, 32


def tf32_hi(x):
    """x rounded to TF32 on its int32 view, as ``cvt.rna.tf32.f32``."""
    u = x.view(torch.int32).to(torch.int64)
    return ((u + 0x1000) & 0xFFFFE000).to(torch.int32).view(torch.float32)


def tf32_trunc(x):
    """x as the tensor core reads an f32 register for a TF32 operand."""
    u = x.view(torch.int32).to(torch.int64)
    return (u & 0xFFFFE000).to(torch.int32).view(torch.float32)


def split(x):
    hi = tf32_hi(x)
    return hi, tf32_trunc(x - hi)


def conv(x, w):
    """3x3 SAME conv in float64, NHWC x and HWIO w."""
    y = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                   w.double().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def conv_dw(x, g):
    """Its weight gradient in float64, (3, 3, Cin, Cout)."""
    dw = torch.nn.grad.conv2d_weight(
        x.double().permute(0, 3, 1, 2), (g.shape[-1], x.shape[-1], 3, 3),
        g.double().permute(0, 3, 1, 2), padding=1)
    return dw.permute(2, 3, 1, 0)


def split_products(f, a, b):
    """f(a, b) of a bilinear f in split f32, and in one TF32 pass."""
    (ah, al), (bh, bl) = split(a), split(b)
    return f(ah, bl) + f(al, bh) + f(ah, bh), f(ah, bh)


def weights(kind):
    if kind == "dncnn17_mid":  # conv_8, a mid layer of the checkpoint, 64->64
        w = load_variables(CKPT)["params"]["conv_8"]["kernel"]
        return torch.from_numpy(np.array(w, np.float32))
    rng = np.random.default_rng(5)  # He-scaled 80 -> 72
    return torch.from_numpy((rng.standard_normal((3, 3, 80, 72))
                             * np.sqrt(2.0 / (9 * 80))).astype(np.float32))


@pytest.mark.parametrize("op", ["conv", "dw"])
@pytest.mark.parametrize("wkind", ["dncnn17_mid", "he_80_72"])
@pytest.mark.parametrize("inputs", ["relu", "signed"])
def test_split_f32_within_conv_rtol_and_tf32_not(op, wkind, inputs):
    w = weights(wkind)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(
        rng.standard_normal((1, H, W, w.shape[2])).astype(np.float32))
    if inputs == "relu":
        x = x.clamp_min(0)
    if op == "conv":
        a, b, f = x, w, conv
    else:  # dW of the layer, the cotangent a signed f32 image of Cout
        g = rng.standard_normal((1, H, W, w.shape[3])).astype(np.float32)
        a, b, f = x, torch.from_numpy(g), conv_dw
    ref = f(a, b)
    got, one_pass = split_products(f, a, b)
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item() / scale
    err_tf32 = (one_pass - ref).abs().max().item() / scale
    assert err <= CONV_RTOL, f"split f32 {err:.3e} of the largest value"
    assert err_tf32 > CONV_RTOL, f"one TF32 pass {err_tf32:.3e} passes"
