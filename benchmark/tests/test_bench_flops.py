"""The operation and byte counts, held by hand sums."""

import pytest

from benchmark import flops, roofline


def test_one_mid_layer_at_540p():
    # 2 * 540 * 960 * 64 * 64 * 9
    assert flops.conv3x3(540, 960, 64, 64) == 38_220_595_200
    assert flops.conv3x3(540, 960, 64, 64) / 1e9 == pytest.approx(38.22,
                                                                  abs=5e-3)


def test_dncnn17_forward_and_fine_tuned_frame():
    mid = 2 * 9 * 64 * 64
    ends = 2 * 2 * 9 * 64
    per_px = 15 * mid + ends
    assert flops.dncnn_forward(540, 960) == 540 * 960 * per_px
    assert flops.dncnn_forward(540, 960) / 1e9 == pytest.approx(574.5,
                                                                abs=0.05)
    assert flops.dncnn_finetune_frame(540, 960, 20) == \
        61 * flops.dncnn_forward(540, 960)
    assert flops.dncnn_forward(1080, 1920, batch=8) == \
        32 * flops.dncnn_forward(540, 960)


def test_fwd_layer_byte_bound_at_540p():
    # bf16 activations in and out: 2 * 2 * 518 400 * 64 bytes, and the
    # bf16 weights, at 3.35 TB/s
    ms, by = roofline.mid_fwd_layer(540, 960)
    assert by == "bytes"
    assert ms == pytest.approx((4 * 518_400 * 64 + 73_728) / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.0396, abs=5e-5)


def test_bwd_layer_bound_at_540p():
    ms, by = roofline.mid_bwd_layer(540, 960)
    assert by == "bytes"
    assert ms == pytest.approx(0.0793, abs=5e-5)
    # its operations alone, two convolutions at the bf16 peak
    assert 2 * 38_220_595_200 / 989e12 * 1e3 < ms


def test_fastdvdnet_window_by_hand_at_8x8():
    # one DenBlock at 8x8, RGB: (convolution, c_in a group, c_out, size)
    block = [(4, 90, 64), (90, 32, 64),
             (32, 64, 16), (64, 64, 16), (64, 64, 16),
             (64, 128, 4), (128, 128, 4), (128, 128, 4),
             (128, 128, 4), (128, 128, 4), (128, 256, 4),
             (64, 64, 16), (64, 64, 16), (64, 128, 16),
             (32, 32, 64), (32, 3, 64)]
    by_hand = sum(2 * 9 * ci * co * px for ci, co, px in block)
    assert flops.fastdvdnet_window(8, 8) == 4 * by_hand
    assert flops.fastdvdnet_video(8, 8, 5) == 5 * 4 * by_hand
