"""The Restormer cell's pieces on the CPU: the plain reference against the
program where both compute in float32, at small widths; the reference's
weights in the program module's order; the operation count at the
published widths; the leaf groups; the float8 control of a small run of
the cell, held against the program's readings."""

import pytest
import torch

from benchmark import flops_restormer, harness
from benchmark.reference import dncnn, restormer
from benchmark.runners import finetune_restormer

CPU = torch.device("cpu")
SMALL = {"dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
         "heads": [1, 2, 4, 8]}
SPEC = harness.load_spec()
CELL = "restormer_gray.finetune540"
CONFIG = harness.config_of(SPEC, "restormer_gray")


def program(config, weights):
    from frame2frame_tpu_torch.models.restormer import Restormer

    model = Restormer(config["channels"], config["dim"],
                      config["num_blocks"], config["num_refinement_blocks"],
                      config["heads"], config["ffn_expansion_factor"])
    model.load_state_dict(weights)
    return model.eval()


def frames(n, h, w, seed=4):
    g = torch.Generator().manual_seed(seed)
    return 0.1 + 0.8 * torch.rand(n, h, w, 1, generator=g)


def test_the_weights_are_the_program_modules_in_its_order():
    from frame2frame_tpu_torch.models.restormer import Restormer

    got = [(k, tuple(v.shape)) for k, v in Restormer().state_dict().items()]
    assert got == restormer.layout(CONFIG)
    assert sum(torch.Size(s).numel() for _, s in got) == CONFIG["parameters"]


@pytest.mark.parametrize("hw", [(16, 24), (18, 20)])
def test_the_forward_matches_the_programs_f32_module(hw):
    config = dict(CONFIG, **SMALL)
    weights = restormer.init(2**33 + 5, CPU, config)
    x = frames(2, *hw)
    ours = restormer.denoise(weights, x, config)
    with torch.no_grad():
        theirs = program(config, weights)(x)
    assert float((ours - theirs).norm() / (ours - x).norm()) < 1e-5


def test_the_finetune_matches_the_programs_f32_step():
    from frame2frame_tpu_torch.train.online import (make_online_step,
                                                    raveler, torch_adam)

    config = dict(CONFIG, **SMALL)
    weights = restormer.init(2**33 + 6, CPU, config)
    f = frames(2, 18, 20)
    flow = torch.zeros(18, 20, 2)
    flow[..., 0] = 0.6
    model = program(config, weights)
    tx = torch_adam(5e-5, 1e-5)
    step = make_online_step(model, tx, iters=3, residual_model=True)
    _, deno_p, losses_p = step(tx.init(raveler(model).ravel()), f[1], f[0],
                               flow)
    state = {k: v.clone() for k, v in weights.items()}
    adam = dncnn.Adam(5e-5, 1e-5)
    _, deno_r, losses_r, _ = restormer.finetune_frame(
        state, adam.init(state), adam, f[1], f[0], flow, 3, config)
    assert torch.allclose(losses_p.double(), losses_r.double(), rtol=1e-5)
    assert float((deno_p - deno_r).norm() / (deno_r - f[1]).norm()) < 1e-5
    # the weights moved by Adam's steps of lr: a gradient element near zero
    # may take a step of the other sign, so the change is held by its norm
    sd = model.state_dict()
    moved = torch.cat([(sd[k] - weights[k]).reshape(-1) for k in state])
    moved_r = torch.cat([(state[k] - weights[k]).reshape(-1) for k in state])
    assert float((moved - moved_r).norm() / moved_r.norm()) < 1e-3


def test_operations_at_the_published_widths():
    fwd = flops_restormer.forward(540, 960, CONFIG)
    px = 544 * 960
    # 2.149 M multiply-adds a pixel in the convolutions, 0.212 M in the
    # attention products
    assert fwd / px / 2 == pytest.approx(2.361e6, rel=1e-3)
    assert flops_restormer.finetune_frame(540, 960, 20, CONFIG) == 61 * fwd


def test_leaves_fall_into_their_groups():
    kinds = {k: finetune_restormer.leaf_kind(k) for k, _ in
             restormer.layout(dict(CONFIG, **SMALL))}
    assert kinds["latent.0.attn.temperature"] == "temperature"
    assert kinds["latent.0.norm2.body.weight"] == "ln_weight"
    assert kinds["latent.0.attn.qkv_dwconv.weight"] == "dw_kernel"
    assert kinds["latent.0.ffn.dwconv.weight"] == "dw_kernel"
    assert kinds["latent.0.ffn.project_in.weight"] == "kernel"
    assert kinds["up4_3.body.0.weight"] == "kernel"
    assert set(kinds.values()) == {"temperature", "ln_weight", "dw_kernel",
                                   "kernel"}


def test_float8_control_reads_far_from_the_program_on_the_cpu():
    # The cell's limits are set at 544x960 and 20 updates, where both the
    # bf16 program and the float8 control part from the reference by their
    # trajectories' drift; at this size the control's numbers stay under
    # those limits, so it is held against the program's instead.
    from benchmark import trace

    _, config, params, drv = harness.cell_parts(
        SPEC, CELL, {"height": 24, "width": 32, "frames": 5,
                     "sample_within": 1})
    config = dict(config, **SMALL, finetune=dict(config["finetune"],
                                                 iters=3))
    state = drv.setup(config, params, 2**31 + 3, [CPU], trace.Spans())
    drv.window(state, 0.5, trace.Slice(False, 0.0, 0))
    program, control = drv.judge(state, control=True)
    limits = harness.limits_of(CELL)
    assert set(program) == set(control) == set(limits)
    assert not [k for k in limits if program[k] > limits[k]]
    assert all(control[k] >= 3 * program[k] for k in limits
               if k != "flow_epe_px")


def test_the_attention_sums_its_stretches_as_one_product():
    # 96 x 128 pixels: three stretches of 4096
    config = dict(CONFIG, **SMALL)
    s = restormer.init(2**33 + 8, CPU, config)
    p = "encoder_level2.0.attn."
    x = torch.randn(1, 16, 96, 128, generator=torch.Generator().manual_seed(1))
    got = restormer._attention(s, p, x, 2, "f32")
    qkv = restormer._conv(restormer._conv(x, s[p + "qkv.weight"], "f32"),
                          s[p + "qkv_dwconv.weight"], "f32", groups=48)
    q, k, v = (t.reshape(1, 2, 8, -1).double() for t in qkv.chunk(3, 1))
    q = torch.nn.functional.normalize(q, dim=-1)
    k = torch.nn.functional.normalize(k, dim=-1)
    a = ((q @ k.transpose(-2, -1)) * s[p + "temperature"].double()).softmax(-1)
    want = torch.nn.functional.conv2d(
        (a @ v).reshape(1, 16, 96, 128).float(), s[p + "project_out.weight"])
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
