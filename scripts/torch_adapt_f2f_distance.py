"""How far one f2f adaptation window of the PyTorch port lies from the JAX
package's, measured against the port's own float64 run, on the CPU.

The case: the pretrained DnCNN-17 (``results/dncnn17_s25``) on the f32
"xla" route, a 5-frame 96x128 crop of ``chip_smoke.adapt_clip()`` (the
moving texture, sigma 25/255), one window of ``get_loss_fxn(cfg, "f2f")``
with 96x128 crops (the whole crop: both packages cut the same one), TV-L1
flows solved in the window, Adam at 1e-4 on a cosine schedule. Three runs,
with ``adapt_train_bn`` off and on:

- the JAX package in f32 (its warped loss cannot run in float64: the scan
  carry of its loss is f32);
- the port in f32;
- the port in float64 (the model's parameters and the crops; the flows
  are solved from the float64 denoised crops).

For each it prints the PSNR of the denoised clip before and after the
window; between the two f32 runs, the share of weights whose updates
differ by more than half a learning rate, and the first quantities of the
window (crops, flows, loss, gradient by parameter kind); each f32 run's
flows, loss and gradient against the float64 run's; and each f32 run's
distance from the float64 run, in PSNR (dB) and in the parameter vector
(the L2 norm of the difference, and that over the float64 update's norm).
Torch's CPU results move with its thread count (``OMP_NUM_THREADS``):
compare runs made alike.

The rule, written before the first run: the gap is rounding noise if the
port's f32 run lies no farther from the float64 run than JAX's f32 run
does, within ``RULE`` times, on both metrics (the rule of
``tests/test_torch_bf16_graph.py``). The verdict is the last line.

    JAX_PLATFORMS=cpu python scripts/torch_adapt_f2f_distance.py

It imports both packages, so it lives beside them and not in the port.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

NF = 5
ROWS, COLS = slice(200, 296), slice(300, 428)
LR = 1e-4
RULE = 1.25


def clip():
    """(noisy, clean) (1, 5, 96, 128, 1) f32 in [0, 1]-ish."""
    import chip_smoke as cs

    (vid_n, vid_c), _ = cs.adapt_clip()
    return (np.ascontiguousarray(vid_n[:, :NF, ROWS, COLS]),
            np.ascontiguousarray(vid_c[:, :NF, ROWS, COLS]))


def window_cfg(train_bn):
    return dict(adapt_isize="96_128", adapt_nepochs=1, nbatch_sample=1,
                flow=True, flow_method="tvl1", adapt_train_bn=train_bn,
                adapt_nsteps=1)


def psnr(deno, clean):
    d = np.clip(np.asarray(deno, np.float64), 0.0, 1.0)
    mse = float(np.mean((d - np.asarray(clean, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / mse)


def _port_name(layer, leaf):
    return f"{layer}.{ {'kernel': 'weight', 'scale': 'weight'}.get(leaf, leaf)}"


def _oihw(v):
    v = np.asarray(v, np.float64)
    return v.transpose(3, 2, 0, 1) if v.ndim == 4 else v


def jax_window(variables, train_bn):
    """The JAX package's window in f32: its crops, flows, loss, gradient
    and parameters before and after (by the port's names and layout), and
    the clip's PSNR before and after."""
    import frame2frame_tpu as jpkg
    from frame2frame_tpu.config import Config
    from frame2frame_tpu.models.dncnn import DnCNN
    from frame2frame_tpu.train import adapt as jadapt
    from frame2frame_tpu.train import schedules as jsched
    from frame2frame_tpu.train.state import TrainState

    noisy, clean = clip()
    tx, sched = jsched.make_optimizer(Config(
        {"scheduler_name": "cosa", "lr_init": LR, "nepochs": 1}),
        steps_per_epoch=1)
    model = DnCNN(channels=1, num_layers=17, residual=True, conv_impl="xla")
    st = TrainState.create(model, variables, tx, residual=True)
    rec = {}

    def params(p):
        return {_port_name(layer, leaf): _oihw(v)
                for layer, leaves in p.items() for leaf, v in leaves.items()}

    def deno_clip(state):
        return np.asarray(state.eval_apply(noisy.reshape((NF,) + noisy.shape[2:])))

    rec["psnr_before"] = psnr(deno_clip(st), clean[0])
    rec["before"] = params(st.params)
    wrapper = jpkg.get_loss_fxn(Config(window_cfg(train_bn)), "f2f")
    crops, run_flows = wrapper._crops, jadapt.flow_api.run_flows
    update = jadapt.apply_gradients

    def read_crops(*a, **kw):
        out = crops(*a, **kw)
        rec["crops"] = np.asarray(out[0], np.float64)
        return out

    def read_flows(*a, **kw):
        out = run_flows(*a, **kw)
        rec["flows"] = {k: np.asarray(out[k], np.float64)
                        for k in ("fflow", "bflow")}
        return out

    def read_grad(state, g, *a, **kw):
        rec["grad"] = params(g)
        return update(state, g, *a, **kw)

    wrapper._crops = read_crops
    jadapt.flow_api.run_flows, jadapt.apply_gradients = read_flows, read_grad
    try:
        st, info = wrapper(st, noisy, clean, seed=0, sched=sched)
    finally:
        jadapt.flow_api.run_flows, jadapt.apply_gradients = run_flows, update
    rec["loss"] = float(info.loss[0])
    rec["after"] = params(st.params)
    rec["psnr_after"] = psnr(deno_clip(st), clean[0])
    return rec


def port_window(torch, variables, train_bn, dtype):
    """The port's window on the CPU in ``dtype``, read as ``jax_window``
    reads JAX's."""
    import frame2frame_tpu_torch as port
    from frame2frame_tpu_torch.models import load_model
    from frame2frame_tpu_torch.train import adapt as adapt_mod
    from frame2frame_tpu_torch.train.schedules import make_optimizer
    from frame2frame_tpu_torch.train.state import TrainState

    noisy, clean = clip()
    loaded = load_model({"net_name": "dncnn", "channels": 1,
                         "num_of_layers": 17, "residual": True,
                         "conv_impl": "xla"}, device="cpu")
    tx, sched = make_optimizer({"scheduler_name": "cosa", "lr_init": LR,
                                "nepochs": 1}, steps_per_epoch=1)
    st = TrainState.create(loaded.model, variables, tx, residual=True)
    st.model.to(dtype)
    rec = {}

    def params():
        return {n: p.detach().double().numpy().copy()
                for n, p in st.model.named_parameters()}

    def deno_clip():
        return st.eval_apply(noisy.reshape((NF,) + noisy.shape[2:])).double()

    rec["psnr_before"] = psnr(deno_clip().numpy(), clean[0])
    rec["before"] = params()
    wrapper = port.get_loss_fxn(window_cfg(train_bn), "f2f")
    crops, run_flows = wrapper._crops, adapt_mod.flow_api.run_flows
    update = adapt_mod.apply_gradients

    def read_crops(*a, **kw):
        out = crops(*a, **kw)
        rec["crops"] = np.asarray(out[0], np.float64)
        return out

    def read_flows(*a, **kw):
        out = run_flows(*a, **kw)
        rec["flows"] = {k: out[k].double().numpy() for k in ("fflow", "bflow")}
        return out

    def read_grad(state, *a, **kw):
        rec["grad"] = {n: p.grad.detach().double().numpy().copy()
                       for n, p in state.model.named_parameters()}
        return update(state, *a, **kw)

    wrapper._crops = read_crops
    adapt_mod.flow_api.run_flows = read_flows
    adapt_mod.apply_gradients = read_grad
    try:
        st, info = wrapper(st, noisy, clean, seed=0, sched=sched)
    finally:
        adapt_mod.flow_api.run_flows = run_flows
        adapt_mod.apply_gradients = update
    rec["loss"] = float(info.loss[0])
    rec["after"] = params()
    rec["psnr_after"] = psnr(deno_clip().numpy(), clean[0])
    return rec


def flat(p):
    return np.concatenate([np.ravel(p[n]) for n in sorted(p)])


def compare(jx, pt, p64):
    """The numbers the rule reads, and the window's first quantities
    between the two f32 runs."""
    import chip_smoke as cs

    up_j = flat(jx["after"]) - flat(jx["before"])
    up_p = flat(pt["after"]) - flat(pt["before"])
    up_64 = flat(p64["after"]) - flat(p64["before"])
    fl = {k: float(np.abs(jx["flows"][k] - pt["flows"][k]).max())
          for k in ("fflow", "bflow")}
    out = {
        "psnr": {name: [r["psnr_before"], r["psnr_after"]]
                 for name, r in (("jax_f32", jx), ("port_f32", pt),
                                 ("port_f64", p64))},
        "loss": {"jax_f32": jx["loss"], "port_f32": pt["loss"],
                 "port_f64": p64["loss"]},
        "updates_apart_over_half_lr": float(
            np.mean(np.abs(up_j - up_p) > 0.5 * LR)),
        "f32_runs_apart": {
            "crops_max_abs": float(np.abs(jx["crops"] - pt["crops"]).max()),
            "flows_max_abs_px": fl,
            "flows_max_px": float(np.abs(pt["flows"]["fflow"]).max()),
            "loss_rel": abs(jx["loss"] - pt["loss"]) / abs(pt["loss"]),
            "grad": cs.grad_distance(jx["grad"], pt["grad"])},
        "flows_vs_f64_max_px": {
            name: max(float(np.abs(r["flows"][k] - p64["flows"][k]).max())
                      for k in ("fflow", "bflow"))
            for name, r in (("jax_f32", jx), ("port_f32", pt))},
        "loss_vs_f64_rel": {name: abs(r["loss"] - p64["loss"]) / p64["loss"]
                            for name, r in (("jax_f32", jx),
                                            ("port_f32", pt))},
        "grad_vs_f64": {"jax_f32": cs.grad_distance(jx["grad"], p64["grad"]),
                        "port_f32": cs.grad_distance(pt["grad"],
                                                     p64["grad"])},
    }
    n64 = float(np.linalg.norm(up_64))
    for name, r, up in (("jax_f32", jx, up_j), ("port_f32", pt, up_p)):
        d = float(np.linalg.norm(flat(r["after"]) - flat(p64["after"])))
        out[f"{name}_vs_f64"] = {
            "psnr_db": abs(r["psnr_after"] - p64["psnr_after"]),
            "params_l2": d, "params_over_update": d / n64,
            "updates_apart_over_half_lr": float(
                np.mean(np.abs(up - up_64) > 0.5 * LR))}
    jd, pd = out["jax_f32_vs_f64"], out["port_f32_vs_f64"]
    out["ratio"] = {"psnr": pd["psnr_db"] / max(jd["psnr_db"], 1e-12),
                    "params": pd["params_l2"] / jd["params_l2"]}
    out["noise"] = bool(pd["psnr_db"] <= RULE * jd["psnr_db"]
                        and pd["params_l2"] <= RULE * jd["params_l2"])
    return out


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import chip_smoke as cs
    from frame2frame_tpu_torch.models import load_model

    variables = load_model({
        "net_name": "dncnn", "channels": 1, "num_of_layers": 17,
        "residual": True, "conv_impl": "xla", "pretrained_load": True,
        "pretrained_path": str(cs.CKPT)}, device="cpu").variables
    results = {}
    for tb in (False, True):
        t0 = time.perf_counter()
        jx = jax_window(variables, tb)
        pt = port_window(torch, variables, tb, torch.float32)
        p64 = port_window(torch, variables, tb, torch.float64)
        res = compare(jx, pt, p64)
        res["s"] = time.perf_counter() - t0
        results[f"train_bn={tb}"] = res
        print(f"train_bn={tb}: " + json.dumps(res), file=sys.stderr,
              flush=True)
    verdict = all(r["noise"] for r in results.values())
    print(json.dumps(results))
    print(json.dumps({"rule": f"port f32 within {RULE} x JAX f32's distance "
                      "from the port's float64, PSNR and parameters",
                      "rounding_noise": verdict}))


if __name__ == "__main__":
    main()
