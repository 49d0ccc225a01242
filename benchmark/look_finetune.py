"""The look behind the fine-tune cell's comparison of leaves: for each seed,
each leaf's norm of the change after the warm-up frames and of Adam's
first moments after the first frame, on every side:

- ``program``: the timed path (the cell's own set-up, a short window);
- ``ref``: the plain reference in float32, which ``correct`` is judged by;
- ``bf16``: the plain reference with its chain rounded to bfloat16, the
  precision the configuration states (a witness, judged by nothing);
- ``fp8``: the control (float8 chain, bfloat16 flows);
- ``port_f32`` (the first ``--port-seeds`` seeds): the program's f32 route
  (``conv_impl="xla"``, cuDNN with TF32 off) fed the same frames and flows;

and, in the reference's first update, how far each leaf's gradient cancels:
``|sum g| / sum |g|`` over the frame's pixels, elementwise, as a ratio of
norms, for the last convolution and each BatchNorm's scale and bias.

    python3 benchmark/look_finetune.py --seeds 1,2,3 [--seconds 8] \\
        [--control-seeds 4] [--port-seeds 4] [--out look.jsonl]

Each seed prints one JSON line to standard output and to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CELL = "dncnn17.finetune540"


def cancellation(state, cur, prev, flow):
    """{leaf: |sum g| / sum |g|} in the reference's first update from
    ``state``, for ``conv_out.weight`` and each ``bn_<i>.weight`` and
    ``bn_<i>.bias``: the norm of the gradient over the norm of the sums of
    its terms' magnitudes."""
    import torch
    from torch.nn.grad import conv2d_weight

    from benchmark.reference import dncnn as ref
    from benchmark.reference.precision import arithmetic, conv2d
    from benchmark.reference.warp import (bilinear_warp_with_mask,
                                          occlusion_mask)

    with torch.no_grad():
        warped, mask = bilinear_warp_with_mask(prev, flow)
        mask = occlusion_mask(flow, mask)
        target = (mask * warped).permute(2, 0, 1)[None]
        mask = mask.permute(2, 0, 1)[None]
    x = cur.permute(2, 0, 1)[None]
    nmid = sum(1 for k in state if k.startswith("bn_") and k.endswith("bias"))
    with arithmetic("f32"):
        # a leaf that asks for a gradient, so that autograd records the graph
        w_in = state["conv_in.weight"].detach().requires_grad_(True)
        h = torch.relu(conv2d(x, w_in))
        us, zhats = [], []
        for i in range(nmid):
            z = conv2d(h, state[f"conv_{i}.weight"])
            var, mean = torch.var_mean(z, dim=(0, 2, 3), unbiased=False)
            zhat = (z - mean.view(1, -1, 1, 1)) * torch.rsqrt(
                var + ref.EPS).view(1, -1, 1, 1)
            u = (zhat * state[f"bn_{i}.weight"].view(1, -1, 1, 1)
                 + state[f"bn_{i}.bias"].view(1, -1, 1, 1))
            us.append(u)
            zhats.append(zhat.detach())
            h = torch.relu(u)
        out = conv2d(h, state["conv_out.weight"])
        loss = (mask * (x - out) - target).abs().sum()
        grads = torch.autograd.grad(loss, us + [out])
    ratio = {}
    w = state["conv_out.weight"]
    g = conv2d_weight(h.detach(), w.shape, grads[-1], padding=1)
    a = conv2d_weight(h.detach().abs(), w.shape, grads[-1].abs(), padding=1)
    ratio["conv_out.weight"] = float(g.norm() / a.norm())
    for i, (gu, zhat) in enumerate(zip(grads[:-1], zhats)):
        ratio[f"bn_{i}.bias"] = float(gu.sum((0, 2, 3)).norm()
                                      / gu.abs().sum((0, 2, 3)).norm())
        ratio[f"bn_{i}.weight"] = float((gu * zhat).sum((0, 2, 3)).norm()
                                        / (gu * zhat).abs().sum(
                                            (0, 2, 3)).norm())
    return ratio


def port_f32_run(st, flows):
    """The warm-up frames through the program's f32 route from the
    configuration's weights, with the program's own flows: the state after
    the last and Adam's first moments after the first."""
    import torch

    from benchmark.harness import ROOT
    from benchmark.runners import finetune as ft
    from frame2frame_tpu_torch import load_model
    from frame2frame_tpu_torch.train.online import OnlineDenoiser

    c, f = st.config, st.config["finetune"]
    loaded = load_model({
        "net_name": c["net_name"], "channels": c["channels"],
        "num_of_layers": c["num_of_layers"], "residual": c["residual"],
        "conv_impl": "xla", "pretrained_load": True,
        "pretrained_path": str(ROOT / c["weights"])}, device=st.dev)
    eng = OnlineDenoiser(loaded.model, loaded.variables, lr=f["lr"],
                         weight_decay=f["weight_decay"], iters=f["iters"],
                         residual_model=c["residual"], device=st.dev)
    out = {}
    for i in range(1, st.params["warmup_frames"] + 1):
        cur, prev = ft._frame_pair(st, i)
        eng.process_frame(cur, prev, flows[i - 1].to(st.dev))
        if i == 1:
            shapes = {k: tuple(v.shape) for k, v in
                      ft._module_state(eng.model).items()}
            out["m1"] = ft.unravel(eng.opt_state["m"].detach().cpu(), shapes)
    out["state"] = {k: v.cpu() for k, v in
                    ft._module_state(eng.model).items()}
    del eng, loaded
    torch.cuda.empty_cache()
    return out


def look(seed, dev, seconds, control, port, overrides=None):
    import torch

    from benchmark import harness, trace
    from benchmark.reference import tvl1 as ref_tvl1
    from benchmark.runners import finetune as ft

    _, config, params, drv = harness.cell_parts(harness.load_spec(), CELL,
                                                overrides)
    st = drv.setup(config, params, seed, [dev], trace.Spans())
    drv.window(st, seconds, trace.Slice(False, 0.0, 0))
    ft._free(st)
    init = ft._init_state(st)
    ref = ft.reference_run(st, init)
    numbers = ft.compare(st, st.warm, ref, init)
    for k, v in ft._sample_numbers(st).items():
        numbers[k] = max(numbers[k], v)
    sides = {"program": st.warm, "ref": ref,
             "bf16": ft.reference_run(st, init, mode="bf16")}
    ctl_numbers = None
    if control:
        sides["fp8"] = ft.reference_run(st, init, mode=config["control"],
                                        flow_dtype=torch.bfloat16)
        ctl_numbers = ft.compare(st, sides["fp8"], ref, init)
    if port:
        sides["port_f32"] = port_f32_run(st, st.warm["flows"])
    cur, prev = ft._frame_pair(st, 1)
    flow = ref_tvl1.solve(cur[..., 0] * 255.0, prev[..., 0] * 255.0,
                          **params["flow"])
    return {"seed": seed, "program": numbers, "control": ctl_numbers,
            "bf16": ft.compare(st, sides["bf16"], ref, init),
            "norms": {k: ft.leaf_norms(v, init) for k, v in sides.items()},
            "grad1": {k: float(v.double().norm())
                      for k, v in ref["grad1"].items()},
            "cancel": cancellation(init, cur, prev, flow)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--port-seeds", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", default=None,
                    help="traffic parameters replaced, as a JSON object")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    dev = torch.device(args.device)
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = look(seed, dev, args.seconds, k < args.control_seeds,
                   k < args.port_seeds,
                   json.loads(args.params) if args.params else None)
        got["s"] = time.perf_counter() - t
        line = json.dumps(got)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
