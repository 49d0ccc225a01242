"""The online fine-tune of one frame stream, in a closed loop: TV-L1 flows
solved ahead on the card by ``AsyncFlowSolver``, each frame fine-tuned on
the previous one warped by its flow and denoised by
``OnlineDenoiser.process_frame``, and every denoised frame read back to the
host before the next frame is handed in.

The stream is the moving scene of ``scene.py``, held on the host as decoded
frames and played forward and back (so every pair of neighbours moves by
one frame's motion). Set-up fine-tunes the first ``warmup_frames`` frames
through the window's own loop body; the plain reference follows those
frames from the configuration's weights in float32 (its own TV-L1 flows,
warps, masks, updates and denoise), and one frame of the window, drawn from
the seed, from the program's state just before it.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import flops, scene
from ..harness import ROOT
from ..reference import dncnn as ref_dncnn
from ..reference import msgpack
from ..reference import tvl1 as ref_tvl1


def pingpong(i, n):
    """The frame shown at step ``i`` of a stream of ``n`` frames played
    forward and back."""
    r = i % (2 * (n - 1))
    return r if r < n else 2 * (n - 1) - r


def ravel_order(nmid):
    """(name, JAX leaf) of the trainable leaves in the order the program's
    optimizer ravels them (``jax.flatten_util.ravel_pytree`` over sorted
    names: each BatchNorm's bias before its scale, then the kernels)."""
    bns = sorted(f"bn_{i}" for i in range(nmid))
    convs = sorted([f"conv_{i}" for i in range(nmid)] + ["conv_in",
                                                         "conv_out"])
    return ([(f"{b}.{p}", p) for b in bns for p in ("bias", "weight")]
            + [(f"{c}.weight", "kernel") for c in convs])


def unravel(vec, shapes):
    """A raveled optimizer vector as {name: tensor} in the module's layout
    (OIHW kernels; the vector holds them HWIO)."""
    nmid = sum(1 for k in shapes if k.startswith("bn_") and
               k.endswith(".bias"))
    out, off = {}, 0
    for name, kind in ravel_order(nmid):
        s = shapes[name]
        n = int(np.prod(s))
        part = vec[off:off + n]
        off += n
        if kind == "kernel":
            part = part.view(s[2], s[3], s[1], s[0]).permute(3, 2, 0, 1)
        out[name] = part.reshape(s).contiguous()
    if off != vec.numel():
        raise ValueError(f"optimizer vector of {vec.numel()} values, "
                         f"leaves of {off}")
    return out


def _module_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if "num_batches" not in k}


def setup(config, params, seed, devices, spans):
    from frame2frame_tpu_torch import load_model
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
    loaded = load_model({
        "net_name": config["net_name"], "channels": config["channels"],
        "num_of_layers": config["num_of_layers"],
        "residual": config["residual"], "conv_impl": config["conv_impl"],
        "pretrained_load": True,
        "pretrained_path": str(ROOT / config["weights"])}, device=dev)
    engine = OnlineDenoiser(loaded.model, loaded.variables, lr=ft["lr"],
                            weight_decay=ft["weight_decay"],
                            iters=ft["iters"],
                            residual_model=config["residual"], device=dev)
    del loaded
    solver = AsyncFlowSolver(W, H, params["flow"],
                             lookahead=params["lookahead"], device=dev)
    parts["model"] = time.perf_counter() - t
    st = SimpleNamespace(config=config, params=params, dev=dev,
                         host=host, engine=engine, solver=solver,
                         spans=spans, setup_parts=parts, snap=None,
                         sample_out=None)
    st.prev = torch.from_numpy(host[0]).to(dev)
    warm = {"flows": [], "denos": [], "losses": []}
    for i in range(1, params["warmup_frames"] + 1):
        t = time.perf_counter()
        deno, losses, flow = frame(st, i)
        warm["flows"].append(flow.cpu())
        warm["denos"].append(torch.from_numpy(deno))
        warm["losses"].append(losses.cpu())
        if i == 1:
            shapes = {k: tuple(v.shape) for k, v in
                      _module_state(engine.model).items()}
            warm["m1"] = unravel(engine.opt_state["m"].detach().cpu(),
                                 shapes)
        parts[f"frame {i}"] = time.perf_counter() - t
    warm["state"] = {k: v.cpu() for k, v in
                     _module_state(engine.model).items()}
    st.warm = warm
    st.next = params["warmup_frames"] + 1
    rng = np.random.default_rng(seed)
    st.sample = st.next + int(rng.integers(0, params["sample_within"]))
    return st


def frame(st, i):
    """Step ``i`` of the stream through the program: (denoised frame on
    the host, losses on the device, flow on the device)."""
    n = len(st.host)
    spans = st.spans
    for j in range(i, i + st.solver.lookahead + 1):
        st.solver.prefetch(j, st.host[pingpong(j, n)],
                           st.host[pingpong(j - 1, n)])
    with spans("h2d"):
        cur = torch.from_numpy(st.host[pingpong(i, n)]).to(st.dev)
    with spans("flow.get"):
        flow = st.solver.get(i)
    with spans("process_frame"):
        deno, losses = st.engine.process_frame(cur, st.prev, flow)
        if st.dev.type == "cuda":
            # the frame's work on its stream done (the flow's stream runs
            # on), so that ``readback`` holds the copy alone
            torch.cuda.current_stream(st.dev).synchronize()
    with spans("readback"):
        out = deno.cpu().numpy()
    st.prev = cur
    return out, losses, flow


def window(st, seconds, slice_):
    recs = []
    t0 = time.perf_counter()
    end = t0 + seconds
    st.solves0 = len(st.solver.solve_times)
    i = st.next
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        slice_.before(now - t0)
        traced = slice_.active
        if i == st.sample:
            st.snap = (_module_state(st.engine.model),
                       {k: (v.detach().clone() if torch.is_tensor(v) else v)
                        for k, v in st.engine.opt_state.items()})
        out, losses, _ = frame(st, i)
        if i == st.sample:
            st.sample_out = (torch.from_numpy(out), losses.cpu())
        recs.append({"t0": now, "t1": time.perf_counter(), "items": 1,
                     "traced": traced})
        slice_.after()
        i += 1
    st.solver.close()
    return recs


def counters(st):
    p, c = st.params, st.config
    return {"flow_solve_s": list(st.solver.solve_times[st.solves0:]),
            "flops_per_item": flops.dncnn_finetune_frame(
                p["height"], p["width"], c["finetune"]["iters"],
                c["channels"], c["features"], c["num_of_layers"] - 2)}


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
    flows, denoised frames, losses, the optimizer's first moments after the
    first frame, the state after the last, the first update's gradients."""
    ft = st.config["finetune"]
    adam = ref_dncnn.Adam(ft["lr"], ft["weight_decay"])
    state = {k: v.clone() for k, v in init.items()}
    opt = adam.init({k: state[k] for k in ref_dncnn.param_names(state)})
    out = {"flows": [], "denos": [], "losses": []}
    for i in range(1, st.params["warmup_frames"] + 1):
        cur, prev = _frame_pair(st, i)
        flow = ref_tvl1.solve(cur[..., 0] * 255.0, prev[..., 0] * 255.0,
                              dtype=flow_dtype, **st.params["flow"])
        opt, deno, losses, grads = ref_dncnn.finetune_frame(
            state, opt, adam, cur, prev, flow, ft["iters"], mode)
        out["flows"].append(flow.cpu())
        out["denos"].append(deno.cpu())
        out["losses"].append(losses)
        if i == 1:
            out["m1"] = {k: v.cpu() for k, v in opt["m"].items()}
            out["grad1"] = {k: v.cpu() for k, v in grads.items()}
    out["state"] = {k: v.cpu() for k, v in state.items()}
    return out


def leaf_kind(name):
    """The group a leaf is compared in: ``kernel`` (a convolution's),
    ``bn_scale``, ``bn_bias``, ``running_mean`` or ``running_var``."""
    if name.startswith("conv"):
        return "kernel"
    return {"weight": "bn_scale", "bias": "bn_bias"}.get(
        name.split(".")[1], name.split(".")[1])


def leaf_norms(run, init):
    """Each leaf's norm of the change from ``init`` after the warm-up
    frames (the running statistics' too) and of Adam's first moments after
    the first frame, of one side (the program's warm-up or a reference
    run)."""
    return {"update": {k: float((run["state"][k] - init[k].cpu()).double()
                                .norm()) for k in init},
            "m1": {k: float(v.double().norm()) for k, v in run["m1"].items()}}


def leaf_gaps(got, ref, keys):
    """Each leaf's gap between two norms, taken against the larger of the
    leaf's reference norm and the median reference norm of ``keys``."""
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def group_median_gaps(got, ref, keys):
    """For each group of ``keys`` (``leaf_kind``), the median of its
    leaves' gaps, each against the group's median reference norm."""
    out = {}
    for kind in sorted({leaf_kind(k) for k in keys}):
        gaps = leaf_gaps(got, ref, [k for k in keys if leaf_kind(k) == kind])
        out[kind] = float(np.median(list(gaps.values())))
    return out


def _deno_rel(out, ref, x):
    return float((out - ref).double().norm() / (x - ref).double().norm())


def compare(st, got, ref, init):
    """The numbers that decide ``correct`` for the warm-up frames: the
    flows, the losses, the denoised frames; the worst leaf's gap of the
    change of the trainable leaves, of the running statistics' change and
    of Adam's first moments; and for each group of leaves (``leaf_kind``)
    the median leaf's gap of the change and of the moments. Leaves whose
    first gradient in the reference is under a thousandth of the median
    leaf's are left out of the change and the moments (none is, at the
    checkpoint)."""
    names = ref_dncnn.param_names(init)
    g = {k: float(ref["grad1"][k].double().norm()) for k in names}
    med = float(np.median(list(g.values())))
    moved = [k for k in names if g[k] >= 1e-3 * med]
    stats = [k for k in init if "running_" in k]
    na, nb = leaf_norms(got, init), leaf_norms(ref, init)
    xs = [_frame_pair(st, i)[0].cpu()
          for i in range(1, st.params["warmup_frames"] + 1)]
    numbers = {
        "flow_epe_px": max(float((a - b).norm(dim=-1).mean())
                           for a, b in zip(got["flows"], ref["flows"])),
        "loss_rel": max(float(((a.double() - b.double()).abs()
                               / b.double().abs()).max())
                        for a, b in zip(got["losses"], ref["losses"])),
        "deno_rel": max(_deno_rel(a, b, x) for a, b, x in
                        zip(got["denos"], ref["denos"], xs)),
        "update_worst_gap": max(leaf_gaps(na["update"], nb["update"],
                                          moved).values()),
        "stats_worst_gap": max(leaf_gaps(na["update"], nb["update"],
                                         stats).values()),
        "adam_m_worst_gap": max(leaf_gaps(na["m1"], nb["m1"],
                                          moved).values()),
    }
    for kind, v in group_median_gaps(na["update"], nb["update"],
                                     moved + stats).items():
        numbers[f"update_median_gap.{kind}"] = v
    for kind, v in group_median_gaps(na["m1"], nb["m1"], moved).items():
        numbers[f"adam_m_median_gap.{kind}"] = v
    return numbers


def _init_state(st):
    return ref_dncnn.state_from_tree(
        msgpack.read(ROOT / st.config["weights"]), st.dev)


def _sample_numbers(st):
    """The sampled window frame, fine-tuned by the reference from the
    program's state just before it: its losses and its denoised frame."""
    if st.snap is None or st.sample_out is None:
        return {"loss_rel": float("inf"), "deno_rel": float("inf")}
    ft = st.config["finetune"]
    mstate, opt_state = st.snap
    state = {k: v.float() for k, v in mstate.items()}
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    opt = {"count": opt_state["count"],
           "m": unravel(opt_state["m"], shapes),
           "v": unravel(opt_state["v"], shapes)}
    cur, prev = _frame_pair(st, st.sample)
    flow = ref_tvl1.solve(cur[..., 0] * 255.0, prev[..., 0] * 255.0,
                          **st.params["flow"])
    adam = ref_dncnn.Adam(ft["lr"], ft["weight_decay"])
    _, deno, losses, _ = ref_dncnn.finetune_frame(
        state, opt, adam, cur, prev, flow, ft["iters"])
    deno_p, losses_p = st.sample_out
    return {"loss_rel": float(((losses_p.double() - losses.double()).abs()
                               / losses.double().abs()).max()),
            "deno_rel": _deno_rel(deno_p, deno.cpu(), cur.cpu())}


def judge(st, control=False):
    """Free the program, then the numbers that decide ``correct``: the
    warm-up frames against the reference's, the worse of those and the
    sampled window frame's for the losses and the denoised frames. With
    ``control``, also the numbers of the control (the reference with the
    chain in float8 and the flows in bfloat16) against the reference."""
    _free(st)
    init = _init_state(st)
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
