"""The fine-tune cell compares its leaves by group, and the bf16 witness
rounds what the configuration's chain rounds."""

import pytest
import torch

from benchmark.reference import precision
from benchmark.runners import finetune


def test_leaves_fall_into_their_groups():
    kinds = {k: finetune.leaf_kind(k) for k in (
        "conv_in.weight", "conv_3.weight", "conv_out.weight", "bn_3.weight",
        "bn_3.bias", "bn_3.running_mean", "bn_3.running_var")}
    assert kinds == {"conv_in.weight": "kernel", "conv_3.weight": "kernel",
                     "conv_out.weight": "kernel", "bn_3.weight": "bn_scale",
                     "bn_3.bias": "bn_bias",
                     "bn_3.running_mean": "running_mean",
                     "bn_3.running_var": "running_var"}


def norms(n=5):
    out = {f"conv_{i}.weight": 0.1 * (i + 1) for i in range(n)}
    out.update({f"bn_{i}.bias": 0.004 * (i + 1) for i in range(n)})
    return out


def test_a_group_left_unmoved_reads_one_and_the_others_nought():
    ref = norms()
    got = {k: (0.0 if k.endswith(".bias") else v) for k, v in ref.items()}
    gaps = finetune.group_median_gaps(got, ref, list(ref))
    assert gaps == {"bn_bias": 1.0, "kernel": 0.0}


def test_a_group_moved_double_reads_one_and_one_leaf_does_not_move_it():
    ref = norms()
    double = {k: (2 * v if k.startswith("conv") else v)
              for k, v in ref.items()}
    assert finetune.group_median_gaps(double, ref, list(ref))["kernel"] == \
        pytest.approx(1.0)
    one = dict(ref, **{"conv_4.weight": 0.0})
    assert finetune.group_median_gaps(one, ref, list(ref))["kernel"] == 0.0


def test_the_bf16_witness_rounds_operands_and_their_gradients():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 4, 8, 8, generator=g, requires_grad=True)
    w = torch.randn(4, 4, 3, 3, generator=g)
    with precision.arithmetic("bf16"):
        y = precision.conv2d(x, w, "bf16")
    xr, wr = (t.detach().bfloat16().float() for t in (x, w))
    assert torch.allclose(y, torch.nn.functional.conv2d(xr, wr, padding=1),
                          rtol=0, atol=1e-5)
    assert not torch.equal(xr, x.detach())
    y.backward(torch.randn(y.shape, generator=g))
    assert torch.equal(x.grad, x.grad.bfloat16().float())
