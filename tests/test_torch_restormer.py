"""Restormer in the port (``models/restormer.py``) against the plain copy of
the official module (``tests/plain_restormer.py``), in f32 on the CPU, at
dim 8, blocks (1, 1, 1, 1), one refinement block and heads (1, 2, 4, 8):

- the eval forward, on a frame whose sides are multiples of 8 and on one
  that takes the reflect pad;
- two frames of ``OnlineDenoiser.process_frame`` (two updates each) against
  the plain fine-tune from the same weights: losses, the denoised frame,
  the parameters' change and Adam's moments;
- the variable tree's round trip and the official checkpoint's keys;
- ``load_model`` at the published grey widths (26,109,076 parameters);
- the spans and counters, recorded only under a profiler, and the device
  timer's pairing of events in the forward and the backward;
- the fused routes' guards, which answer False for a model that is not a
  DnCNN.
"""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).parent))

import plain_restormer  # noqa: E402

from frame2frame_tpu_torch import load_model  # noqa: E402
from frame2frame_tpu_torch.models import arch_of, fused_apply  # noqa: E402
from frame2frame_tpu_torch.models import restormer  # noqa: E402
from frame2frame_tpu_torch.ops.warp import (  # noqa: E402
    bilinear_warp_with_mask, occlusion_mask)
from frame2frame_tpu_torch.train import flat_step, online  # noqa: E402
from frame2frame_tpu_torch.utils import profiling  # noqa: E402

SMALL = {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement_blocks": 1,
         "heads": (1, 2, 4, 8)}
NBLOCKS = 8  # three encoder levels, the latent, three decoder, refinement
SHAPES = [(16, 24), (18, 20)]  # the second is padded to 24 x 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for this file, as in ``test_torch_fastdvdnet``:
    beside five other workers on eight cores, torch's thread a core turned
    a 0.7 s fine-tune test into 50 s."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(seed=3):
    model, variables = restormer.init_restormer(seed, **SMALL)
    return model.eval(), variables


def plain_of(model):
    ref = plain_restormer.Restormer(**SMALL)
    ref.load_state_dict(model.state_dict())
    return ref


def frames(h, w, n=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return 0.1 + 0.8 * torch.rand(n, h, w, 1, generator=g)


def rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


@pytest.mark.parametrize("hw", SHAPES)
def test_eval_forward_matches_the_plain_module(hw):
    model, _ = small()
    x = frames(*hw, n=2)
    with torch.no_grad():
        got = model(x)
        want = plain_restormer.denoise(plain_of(model), x)
    assert got.shape == x.shape
    # f32 both, the same operations in another order: rounding alone
    assert rel(got - x, want - x) < 1e-5


@pytest.mark.parametrize("hw", SHAPES)
def test_process_frame_matches_the_plain_finetune(hw):
    model, variables = small(seed=5)
    ref = plain_of(model)
    start = [p.detach().clone() for p in ref.parameters()]
    engine = online.OnlineDenoiser(model, variables, lr=1e-3,
                                   weight_decay=1e-5, iters=2,
                                   residual_model=True, device="cpu")
    f = frames(*hw, seed=1)
    g = torch.Generator().manual_seed(2)
    opt = None
    for i in (1, 2):
        flow = 0.7 * torch.randn(*hw, 2, generator=g)
        deno, losses = engine.process_frame(f[i], f[i - 1], flow)
        warped, mask = bilinear_warp_with_mask(f[i - 1], flow)
        mask = occlusion_mask(flow, mask)
        opt, want = plain_restormer.finetune(ref, opt, f[i], mask,
                                             mask * warped, 2, 1e-3, 1e-5)
        assert torch.allclose(losses.double(), want.double(), rtol=1e-5)
        with torch.no_grad():
            deno_ref = plain_restormer.denoise(ref, f[i][None])[0]
        assert rel(deno - f[i], deno_ref - f[i]) < 1e-5
    got = [p.detach().reshape(-1) for p in engine.model.parameters()]
    want = [p.detach().reshape(-1) for p in ref.parameters()]
    assert rel(torch.cat(got), torch.cat(want)) < 1e-5
    first = torch.cat([s.reshape(-1) for s in start])
    # the change alone: from the second update on, Adam's step is m / sqrt(v)
    # with m a sum of gradients of both signs for some elements, which
    # magnifies their rounding (the moments agree to 2e-6, the changes to
    # 2e-5 - 2.5e-5 on these two frames)
    assert rel(torch.cat(got) - first, torch.cat(want) - first) < 1e-4
    for key in ("m", "v"):
        want = torch.cat([t.reshape(-1) for t in opt[key]])
        assert rel(engine.opt_state[key], want) < 1e-5, key
    assert engine.opt_state["count"] == opt["count"] == 4


def test_variables_round_trip_in_the_official_layout():
    model, variables = small(seed=7)
    leaf = variables["params"]["encoder_level1"]["0"]["attn"]["qkv"]["weight"]
    assert leaf.shape == (24, 8, 1, 1) and leaf.dtype == np.float32
    assert variables["batch_stats"] == {}
    other, _ = small(seed=8)
    arch_of(other).load_jax_variables(other, variables)
    for (k, a), (j, b) in zip(model.state_dict().items(),
                              other.state_dict().items()):
        assert k == j and torch.equal(a, b), k
    # the official module's keys, every one of them
    assert set(model.state_dict()) == set(plain_of(model).state_dict())


def test_load_model_at_the_published_widths_and_from_a_checkpoint(tmp_path):
    loaded = load_model({"net_name": "restormer", "channels": 1},
                        device="cpu")
    n = sum(p.numel() for p in loaded.model.parameters())
    assert n == 26_109_076
    assert arch_of(loaded.model) is restormer
    saved, _ = small(seed=9)
    path = tmp_path / "net_g.pth"
    torch.save({"params": saved.state_dict()}, path)
    got = load_model({"net_name": "restormer", "channels": 1, **SMALL,
                      "pretrained_load": True, "pretrained_path": str(path)},
                     device="cpu")
    for k, v in saved.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v), k
    x = frames(8, 16, n=1).numpy()
    with torch.no_grad():
        assert torch.equal(got.apply(x), got.model(torch.from_numpy(x)))


def test_spans_and_counters_only_under_a_profiler():
    model, variables = small()
    x = frames(16, 24, n=1)
    profiling.clear()
    with torch.no_grad():
        model(x)
    assert profiling.recorded() == {"spans": [], "counters": {}}
    engine = online.OnlineDenoiser(model, variables, iters=2,
                                   residual_model=True, device="cpu")
    f = frames(16, 24, seed=4)
    with profile(activities=[ProfilerActivity.CPU]):
        engine.process_frame(f[1], f[0], torch.zeros(16, 24, 2))
    rec = profiling.recorded()
    profiling.clear()
    stages = ("restormer.encoder", "restormer.latent", "restormer.decoder",
              "restormer.refine")
    for name in stages:
        parents = [s.parent for s in rec["spans"] if s.name == name]
        # two updates' forwards and the eval denoise
        assert parents == ["online.forward"] * 2 + ["online.denoise"], name
    assert rec["counters"] == {"online.route.iter": 1,
                               "restormer.mdta": 3 * NBLOCKS,
                               "restormer.gdfn": 3 * NBLOCKS}


class _FakeEvent:
    """A timing event whose clock is a count of the events made."""

    ticks = itertools.count()

    def __init__(self):
        self.t = next(self.ticks)

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return float(other.t - self.t)


def test_device_timer_pairs_the_forward_and_the_backward(monkeypatch):
    monkeypatch.setattr(profiling, "TIMED_DEVICES", ("cpu",))
    monkeypatch.setattr(profiling, "_event", lambda device: _FakeEvent())
    model, _ = small()
    x = frames(16, 24, n=1)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        model(x).sum().backward()
        pending = list(profiling._pending)
    rec = profiling.recorded()
    profiling.clear()
    # one pair a part of a block in the forward, one in the backward
    names = [n for n, _, _ in pending]
    assert names.count("device_ms.restormer.mdta") == 2 * NBLOCKS
    assert names.count("device_ms.restormer.gdfn") == 2 * NBLOCKS
    assert all(b.t > a.t for _, a, b in pending)
    assert rec["counters"]["device_ms.restormer.mdta"] == sum(
        b.t - a.t for n, a, b in pending if n.endswith("mdta"))
    assert profiling._pending == []
    with torch.no_grad():  # no profiler: nothing pends
        model(x)
    assert profiling._pending == []


def test_can_fuse_answers_false_for_a_model_that_is_not_a_dncnn():
    model, _ = small()
    assert fused_apply.can_fuse(model) is False
    assert fused_apply.can_fuse_batch(model, (1, 16, 24, 1), 1 << 40) is False


def test_flat_step_is_not_eligible_for_a_model_that_is_not_a_dncnn():
    model, _ = small()
    assert flat_step.eligible(model, (16, 24, 1), True) is False
    with pytest.raises(ValueError, match="flat step runs only a DnCNN"):
        online.make_online_step(model, online.torch_adam(1e-3), iters=1,
                                residual_model=True, flat_step=True)


@pytest.mark.parametrize("n", [3 * 4096 + 3, 8191])
def test_the_gram_of_long_rows_sums_its_stretches(n):
    # 12291 = 3 x 4097: three stretches; 8191 is prime: one
    g = torch.Generator().manual_seed(n)
    a = torch.randn(1, 2, 5, n, generator=g)
    b = torch.randn(1, 2, 5, n, generator=g)
    want = a.double() @ b.double().transpose(-1, -2)
    got = restormer._gram(a, b)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
