"""The online fine-tune of one frame stream through a Restormer, in a closed
loop, as ``runners/finetune.py`` runs a DnCNN's (whose stream, ``frame``
and ``window`` this runner takes as they are): TV-L1 flows solved ahead on
the card by ``AsyncFlowSolver``, each frame fine-tuned on the previous one
warped by its flow and denoised by ``OnlineDenoiser.process_frame`` on the
engine's per-iteration route, and every denoised frame read back before the
next is handed in.

The model is ``load_model({"net_name": "restormer", ...})`` at the
configuration's widths and ``model_dtype``, with weights made on the card
from the seed by the plain reference's ``init``, which the reference starts
from too. Set-up fine-tunes the first ``warmup_frames`` frames through the
window's own loop body; the judge follows them from those weights in
float32 (its own flows, warps, masks, updates and denoise), and one frame of
the window, drawn from the seed, from the program's state just before it.
The leaves are compared by group: convolution kernels, depthwise kernels,
LayerNorm weights and temperatures; there are no running statistics. The
losses are not compared: from seeded weights the bf16 chain's losses part
from the float32 reference's by up to half as much as the float8
control's (the worst of a frame's 20 losses 0.0020-0.0166 over 7 seeds,
the control's 0.035-0.101 over 3, on an H100), so no limit leaves the
program three times of room below the control.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import flops_restormer, scene
from ..reference import dncnn as ref_dncnn
from ..reference import restormer as ref_restormer
from ..reference import tvl1 as ref_tvl1
from .finetune import frame, leaf_gaps, pingpong, window

__all__ = ["setup", "window", "counters", "judge"]

MODEL_DTYPES = {"bf16": "bfloat16", "f32": "float32"}


def _program_cfg(config):
    return {"net_name": config["net_name"], "channels": config["channels"],
            "dim": config["dim"], "num_blocks": config["num_blocks"],
            "num_refinement_blocks": config["num_refinement_blocks"],
            "heads": config["heads"],
            "ffn_expansion_factor": config["ffn_expansion_factor"],
            "model_dtype": MODEL_DTYPES[config["precision"]]}


def unravel(vec, shapes):
    """An optimizer vector in the module's order (the engine's ravel of a
    model with no JAX tree) as {name: tensor}, ``shapes`` in that order."""
    out, off = {}, 0
    for name, s in shapes.items():
        n = int(np.prod(s))
        out[name] = vec[off:off + n].reshape(s).clone()
        off += n
    if off != vec.numel():
        raise ValueError(f"optimizer vector of {vec.numel()} values, "
                         f"leaves of {off}")
    return out


def _module_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def setup(config, params, seed, devices, spans):
    from frame2frame_tpu_torch import load_model
    from frame2frame_tpu_torch.models import arch_of
    from frame2frame_tpu_torch.train.online import (AsyncFlowSolver,
                                                    OnlineDenoiser)

    dev = devices[0]
    parts = {}
    t = time.perf_counter()
    H, W = params["height"], params["width"]
    _, noisy = scene.moving(params["frames"], H, W, seed, dev,
                            sigma=params["sigma"])
    host = noisy.cpu().numpy()
    del noisy
    parts["frames"] = time.perf_counter() - t
    t = time.perf_counter()
    ft = config["finetune"]
    loaded = load_model(_program_cfg(config), device=dev)
    loaded.model.load_state_dict(ref_restormer.init(seed, dev, config))
    engine = OnlineDenoiser(loaded.model,
                            arch_of(loaded.model).to_jax_variables(
                                loaded.model),
                            lr=ft["lr"], weight_decay=ft["weight_decay"],
                            iters=ft["iters"],
                            residual_model=config["residual"], device=dev)
    del loaded
    solver = AsyncFlowSolver(W, H, params["flow"],
                             lookahead=params["lookahead"], device=dev)
    parts["model"] = time.perf_counter() - t
    st = SimpleNamespace(config=config, params=params, dev=dev, seed=seed,
                         host=host, engine=engine, solver=solver,
                         spans=spans, setup_parts=parts, snap=None,
                         sample_out=None)
    st.prev = torch.from_numpy(host[0]).to(dev)
    st.shapes = {k: tuple(v.shape) for k, v in
                 engine.model.state_dict().items()}
    warm = {"flows": [], "denos": []}
    for i in range(1, params["warmup_frames"] + 1):
        t = time.perf_counter()
        deno, _, flow = frame(st, i)
        warm["flows"].append(flow.cpu())
        warm["denos"].append(torch.from_numpy(deno))
        if i == 1:
            warm["m1"] = unravel(engine.opt_state["m"].detach().cpu(),
                                 st.shapes)
        parts[f"frame {i}"] = time.perf_counter() - t
    warm["state"] = {k: v.cpu() for k, v in
                     _module_state(engine.model).items()}
    st.warm = warm
    st.next = params["warmup_frames"] + 1
    rng = np.random.default_rng(seed)
    st.sample = st.next + int(rng.integers(0, params["sample_within"]))
    return st


def counters(st):
    p, c = st.params, st.config
    return {"flow_solve_s": list(st.solver.solve_times[st.solves0:]),
            "flops_per_item": flops_restormer.finetune_frame(
                p["height"], p["width"], c["finetune"]["iters"], c)}


def _free(st):
    st.engine = st.solver = st.prev = None
    gc.collect()
    torch.cuda.empty_cache()


def _frame_pair(st, i):
    n = len(st.host)
    cur = torch.from_numpy(st.host[pingpong(i, n)]).to(st.dev)
    prev = torch.from_numpy(st.host[pingpong(i - 1, n)]).to(st.dev)
    return cur, prev


def reference_run(st, init, mode="f32", flow_dtype=torch.float32):
    """The warm-up frames fine-tuned by the plain reference from ``init``:
    flows, denoised frames, the optimizer's first moments after the first
    frame, the weights after the last, the first update's gradients."""
    ft = st.config["finetune"]
    adam = ref_dncnn.Adam(ft["lr"], ft["weight_decay"])
    state = {k: v.clone() for k, v in init.items()}
    opt = adam.init(state)
    out = {"flows": [], "denos": []}
    for i in range(1, st.params["warmup_frames"] + 1):
        cur, prev = _frame_pair(st, i)
        flow = ref_tvl1.solve(cur[..., 0] * 255.0, prev[..., 0] * 255.0,
                              dtype=flow_dtype, **st.params["flow"])
        opt, deno, _, grads = ref_restormer.finetune_frame(
            state, opt, adam, cur, prev, flow, ft["iters"], st.config, mode)
        out["flows"].append(flow.cpu())
        out["denos"].append(deno.cpu())
        if i == 1:
            out["m1"] = {k: v.cpu() for k, v in opt["m"].items()}
            out["grad1"] = {k: v.cpu() for k, v in grads.items()}
    out["state"] = {k: v.cpu() for k, v in state.items()}
    return out


def leaf_kind(name):
    """The group a leaf is compared in: ``temperature``, ``ln_weight`` (a
    LayerNorm's), ``dw_kernel`` (a depthwise convolution's) or ``kernel``
    (every other convolution's)."""
    if name.endswith(".temperature"):
        return "temperature"
    if ".norm" in name:
        return "ln_weight"
    if name.endswith("dwconv.weight"):
        return "dw_kernel"
    return "kernel"


def group_median_gaps(got, ref, keys):
    """For each group of ``keys`` (``leaf_kind``), the median of its leaves'
    gaps, each against the group's median reference norm."""
    out = {}
    for kind in sorted({leaf_kind(k) for k in keys}):
        gaps = leaf_gaps(got, ref, [k for k in keys if leaf_kind(k) == kind])
        out[kind] = float(np.median(list(gaps.values())))
    return out


def _deno_rel(out, ref, x):
    return float((out - ref).double().norm() / (x - ref).double().norm())


def compare(st, got, ref, init):
    """The numbers that decide ``correct`` for the warm-up frames, as the
    DnCNN cell's but the losses: the flows, the denoised frames; the worst
    leaf's gap of the weights' change and of Adam's first moments; for each
    group of leaves (``leaf_kind``) the median leaf's gap of both. Leaves
    whose first gradient in the reference is under a thousandth of the
    median leaf's are left out."""
    def norm(t):
        return float(t.double().norm())

    g = {k: norm(v) for k, v in ref["grad1"].items()}
    med = float(np.median(list(g.values())))
    moved = [k for k in init if g[k] >= 1e-3 * med]
    sides = []
    for run in (got, ref):
        sides.append({"update": {k: norm(run["state"][k] - init[k].cpu())
                                 for k in init},
                      "m1": {k: norm(v) for k, v in run["m1"].items()}})
    na, nb = sides
    xs = [_frame_pair(st, i)[0].cpu()
          for i in range(1, st.params["warmup_frames"] + 1)]
    numbers = {
        "flow_epe_px": max(float((a - b).norm(dim=-1).mean())
                           for a, b in zip(got["flows"], ref["flows"])),
        "deno_rel": max(_deno_rel(a, b, x) for a, b, x in
                        zip(got["denos"], ref["denos"], xs)),
        "update_worst_gap": max(leaf_gaps(na["update"], nb["update"],
                                          moved).values()),
        "adam_m_worst_gap": max(leaf_gaps(na["m1"], nb["m1"],
                                          moved).values()),
    }
    for kind, v in group_median_gaps(na["update"], nb["update"],
                                     moved).items():
        numbers[f"update_median_gap.{kind}"] = v
    for kind, v in group_median_gaps(na["m1"], nb["m1"], moved).items():
        numbers[f"adam_m_median_gap.{kind}"] = v
    return numbers


def _sample_numbers(st):
    """The sampled window frame, fine-tuned by the reference from the
    program's state just before it: its denoised frame."""
    if st.snap is None or st.sample_out is None:
        return {"deno_rel": float("inf")}
    ft = st.config["finetune"]
    mstate, opt_state = st.snap
    state = {k: v.float() for k, v in mstate.items()}
    opt = {"count": opt_state["count"],
           "m": unravel(opt_state["m"], st.shapes),
           "v": unravel(opt_state["v"], st.shapes)}
    cur, prev = _frame_pair(st, st.sample)
    flow = ref_tvl1.solve(cur[..., 0] * 255.0, prev[..., 0] * 255.0,
                          **st.params["flow"])
    adam = ref_dncnn.Adam(ft["lr"], ft["weight_decay"])
    _, deno, _, _ = ref_restormer.finetune_frame(
        state, opt, adam, cur, prev, flow, ft["iters"], st.config)
    return {"deno_rel": _deno_rel(st.sample_out[0], deno.cpu(), cur.cpu())}


def judge(st, control=False):
    """Free the program, then the numbers that decide ``correct``: the
    warm-up frames against the reference's, the worse of those and the
    sampled window frame's for the denoised frames. With
    ``control``, also the numbers of the control (the reference with its
    products on float8 operands and the flows in bfloat16) against the
    reference."""
    _free(st)
    init = ref_restormer.init(st.seed, st.dev, st.config)
    ref = reference_run(st, init)
    numbers = compare(st, st.warm, ref, init)
    sample = _sample_numbers(st)
    for k, v in sample.items():
        numbers[k] = max(numbers[k], v)
    if not control:
        return numbers
    ctl = reference_run(st, init, mode=st.config["control"],
                        flow_dtype=torch.bfloat16)
    return numbers, compare(st, ctl, ref, init)
