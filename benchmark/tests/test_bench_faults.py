"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU at a small size (the
harness's look for a card is skipped by handing it the CPU), with one fault
planted in the program where it produces its answer: a step that returns
its state unchanged, half of the batch left out (the rest weighted to keep
the mean), an answer altered. The cells have no exchange between cards.
"""

import time

import pytest
import torch

import frame2frame_tpu_torch
from benchmark import harness
from frame2frame_tpu_torch.train import online

CPU = [torch.device("cpu")]
SEED = 2**32 + 17
FINETUNE = {"height": 32, "width": 48, "frames": 6, "warmup_frames": 2,
            "sample_within": 1}
SERVE = {"height": 32, "width": 48, "sample_within": 2, "sample_calls": 2}


def run(cell, overrides, seconds=1.0):
    return harness.run_cell(cell, SEED, seconds, False, time.perf_counter(),
                            devices=CPU, overrides=overrides,
                            log=lambda m: None)


def failed(out, names):
    """The numbers among ``names`` that the run held above their limits
    (a number that never came reads "inf")."""
    return [n for n in names
            if float(out["checks"][n]["value"]) > out["checks"][n]["limit"]]


def keep_state_unchanged(monkeypatch):
    process = online.OnlineDenoiser.process_frame

    def unchanged(self, cur, prev, flow):
        kept = {k: v.clone() for k, v in self.model.state_dict().items()}
        opt = self.opt_state
        out = process(self, cur, prev, flow)
        self.model.load_state_dict(kept)
        self.opt_state = opt
        return out

    monkeypatch.setattr(online.OnlineDenoiser, "process_frame", unchanged)


def leave_half_the_frame_out(monkeypatch):
    scan = online.run_flat_scan

    def half(model, tx, iters, opt_state, cur, mask, target, **kw):
        rows = mask.shape[0] // 2
        mask, target = 2 * mask, 2 * target
        mask[rows:] = 0
        target[rows:] = 0
        return scan(model, tx, iters, opt_state, cur, mask, target, **kw)

    monkeypatch.setattr(online, "run_flat_scan", half)


def alter_the_denoised_frame(monkeypatch):
    process = online.OnlineDenoiser.process_frame

    def altered(self, cur, prev, flow):
        deno, losses = process(self, cur, prev, flow)
        return deno + 0.05, losses

    monkeypatch.setattr(online.OnlineDenoiser, "process_frame", altered)


@pytest.mark.parametrize("fault, caught_by", [
    (keep_state_unchanged, [
        "adam_m_worst_gap", "stats_worst_gap", "update_worst_gap",
        "adam_m_median_gap.bn_bias", "adam_m_median_gap.bn_scale",
        "adam_m_median_gap.kernel", "update_median_gap.bn_bias",
        "update_median_gap.bn_scale", "update_median_gap.kernel",
        "update_median_gap.running_mean", "update_median_gap.running_var"]),
    (leave_half_the_frame_out, ["loss_rel"]),
    (alter_the_denoised_frame, ["deno_rel"]),
])
def test_finetune_fault_is_not_correct(monkeypatch, fault, caught_by):
    fault(monkeypatch)
    out = run("dncnn17.finetune540", FINETUNE, seconds=0.5)
    assert not out["correct"]
    assert failed(out, caught_by) == caught_by


def wrap_apply(monkeypatch, change):
    load = frame2frame_tpu_torch.load_model

    def load_broken(cfg, device=None):
        loaded = load(cfg, device=device)
        apply = loaded.apply

        def broken(x, **kw):
            return change(apply, torch.as_tensor(x), kw)

        loaded.apply = broken
        return loaded

    monkeypatch.setattr(frame2frame_tpu_torch, "load_model", load_broken)


def half_batch(apply, x, kw):
    # the frames axis: the batch of an image model, the clip of a video one
    axis = 0 if x.dim() == 4 else 1
    n = x.shape[axis] // 2
    done = apply(x.narrow(axis, 0, n), **kw)
    rest = x.narrow(axis, n, x.shape[axis] - n)
    return torch.cat([done, rest], axis)


def altered(apply, x, kw):
    return apply(x, **kw) + 0.05


@pytest.mark.parametrize("cell", ["dncnn17.serve1080", "fastdvdnet.serve540"])
@pytest.mark.parametrize("change", [half_batch, altered])
def test_serve_fault_is_not_correct(monkeypatch, cell, change):
    wrap_apply(monkeypatch, change)
    out = run(cell, SERVE)
    assert not out["correct"]
    assert failed(out, ["deno_rel"]) == ["deno_rel"]
