"""The plain references agree with the program where both compute in
float32 on the CPU, at small sizes: the references are independent copies,
so this is what ties them to the semantics the program serves."""

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.harness import ROOT
from benchmark.reference import dncnn, fastdvdnet, msgpack, tvl1, warp

CPU = torch.device("cpu")
WEIGHTS = ROOT / "benchmark" / "weights" / "dncnn17_s25.msgpack"


def frames(n, h, w, seed=5, channels=1):
    return scene.moving(n, h, w, seed, CPU, channels=channels)[1]


def test_msgpack_reader_reads_what_the_program_reads():
    from frame2frame_tpu_torch.models.serialization import load_variables

    ours, theirs = msgpack.read(WEIGHTS), load_variables(WEIGHTS)

    def leaves(t, p=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{p}/{k}")
        else:
            yield p, t

    a, b = dict(leaves(ours)), dict(leaves(theirs))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_tvl1_matches_the_programs_plain_solver_bit_for_bit():
    from frame2frame_tpu_torch.flow.tvl1 import make_tvl1_solver

    f = frames(2, 48, 64)[..., 0] * 255.0
    params = dict(tvl1.DENOISING_PARAMS)
    ours = tvl1.solve(f[1], f[0], **params)
    theirs = make_tvl1_solver(64, 48, device="cpu", **params)(f[1], f[0])
    assert float(ours.abs().max()) > 0.1
    assert torch.equal(ours, theirs)


def test_warp_and_mask_match_the_program():
    from frame2frame_tpu_torch.ops import warp as pw

    img = frames(1, 20, 30)[0]
    flow = torch.randn(20, 30, 2) * 2
    a, m = warp.bilinear_warp_with_mask(img, flow)
    b, n = pw.bilinear_warp_with_mask(img, flow)
    assert torch.equal(a, b) and torch.equal(m, n)
    assert torch.equal(warp.occlusion_mask(flow, m),
                       pw.occlusion_mask(flow, n))


def program_dncnn(tree):
    from frame2frame_tpu_torch.models.dncnn import from_jax_variables

    return from_jax_variables(tree, residual=True, conv_impl="xla").eval()


def test_dncnn_eval_forward_matches_the_programs_f32_route():
    tree = msgpack.read(WEIGHTS)
    x = frames(2, 24, 32)
    ours = dncnn.denoise(dncnn.state_from_tree(tree, CPU), x)
    with torch.no_grad():
        theirs = program_dncnn(tree)(x)
    assert float((ours - theirs).abs().max()) < 1e-5


def test_dncnn_finetune_frame_matches_the_programs_f32_step():
    from frame2frame_tpu_torch.train.online import (make_online_step,
                                                    torch_adam)
    from frame2frame_tpu_torch.models.dncnn import JaxRavel

    tree = msgpack.read(WEIGHTS)
    f = frames(2, 24, 32)
    flow = torch.zeros(24, 32, 2)
    flow[..., 0] = 0.6
    model = program_dncnn(tree)
    tx = torch_adam(5e-5, 1e-5)
    step = make_online_step(model, tx, iters=3, residual_model=True,
                            store_dtype=torch.float32)
    opt, deno_p, losses_p = step(tx.init(JaxRavel(model).ravel()), f[1],
                                 f[0], flow)
    state = dncnn.state_from_tree(tree, CPU)
    adam = dncnn.Adam(5e-5, 1e-5)
    _, deno_r, losses_r, _ = dncnn.finetune_frame(
        state, adam.init({k: state[k] for k in dncnn.param_names(state)}),
        adam, f[1], f[0], flow, 3)
    assert torch.allclose(losses_p.double(), losses_r.double(), rtol=1e-5)
    assert float((deno_p - deno_r).abs().max()) < 1e-4
    # near the pretrained minimum a gradient element is a small sum of
    # large terms, and Adam makes a sign that falls the other way a whole
    # step of lr: a few elements may lie a step or two apart
    sd = model.state_dict()
    for k, v in state.items():
        d = (sd[k] - v).abs()
        assert float(d.max()) <= 2 * 3 * 5e-5, k
        assert float((d <= 1e-6 + 1e-4 * v.abs()).float().mean()) >= 0.99, k


def test_fastdvdnet_matches_the_programs_module():
    from frame2frame_tpu_torch.models.fastdvdnet import FastDVDnetVideo

    model = FastDVDnetVideo(3).eval()
    sd = fastdvdnet.init(2**33 + 1, CPU)
    res = model.net.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert all("num_batches" in k for k in res.missing_keys)
    vid = frames(5, 32, 48, channels=3)[None]
    with torch.no_grad():
        theirs = model(vid, sigma=25 / 255)
    ours = fastdvdnet.video(sd, vid, 25 / 255)
    removed = float((vid - ours).norm())
    assert float((ours - theirs).norm()) < 1e-5 * removed


@pytest.mark.parametrize("mode", ["fp8"])
def test_the_control_rounds_the_operands(mode):
    tree = msgpack.read(WEIGHTS)
    x = frames(1, 24, 32)
    state = dncnn.state_from_tree(tree, CPU)
    f32 = dncnn.denoise(state, x)
    low = dncnn.denoise(state, x, mode)
    rel = float((low - f32).norm() / (x - f32).norm())
    assert rel > 0.05
