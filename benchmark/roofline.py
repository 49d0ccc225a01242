"""The least time a kernel could take on one NVIDIA H100 SXM (published
dense peaks at 700 W): the larger of its bytes at the HBM's 3.35 TB/s and
its operations at the peak of the type they run in. Each input is counted
as read once and each output as written once, whatever the kernel reads
again.
"""

from __future__ import annotations

from . import flops

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bf16": 989e12, "fp8": 1979e12, "tf32": 495e12,
                   "f32": 67e12}


def bound_ms(nbytes, ops, flop_per_s=PEAK_FLOP_PER_S["bf16"]):
    """(ms, "bytes" or "operations"): the larger of the two bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mid_fwd_layer(h, w, batch=1, features=64, elem=2, dtype="bf16"):
    """A mid layer's forward (3x3 conv, BatchNorm, ReLU): the activations
    in and out at ``elem`` bytes, the bf16 weights in."""
    act = batch * h * w * features * elem
    weights = 9 * features * features * 2
    return bound_ms(2 * act + weights,
                    flops.conv3x3(h, w, features, features, batch),
                    PEAK_FLOP_PER_S[dtype])


def mid_bwd_layer(h, w, batch=1, features=64, elem=2, dtype="bf16"):
    """A mid layer's backward: the output's gradient, the layer's
    pre-activation and the one before it in, the input's gradient out, at
    ``elem`` bytes; the bf16 weights in and their f32 gradient out; the
    input's and the weights' gradients, each a convolution's operations."""
    act = batch * h * w * features * elem
    weights = 9 * features * features * (2 + 4)
    return bound_ms(4 * act + weights,
                    2 * flops.conv3x3(h, w, features, features, batch),
                    PEAK_FLOP_PER_S[dtype])
