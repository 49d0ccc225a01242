"""How far the held-out PSNR after adapting on the bf16 graph ("fused")
lies from the f32 graph's ("xla"), in the JAX package and in the PyTorch
port, on the CPU.

For each loss of ``chip_smoke.ADAPT_LOSSES`` each package runs the windows
of ``chip_smoke.py``'s ``adapt_phase`` (the pretrained DnCNN-17, the
7-frame 540p clip, 128x128 crops, TV-L1 flows, Adam at 1e-4 on a cosine
schedule over the windows, seed 21) through its own ``get_loss_fxn(cfg,
t)`` from the same weights, once with ``conv_impl="fused"`` and once with
"xla", then denoises the two held-out frames. It prints, per package and
loss, the mean held-out PSNR before and after on each route and the gap
``|after(fused) - after(xla)|`` (dB), as one JSON object.
``chip_smoke.ADAPT_JAX_FUSED_PSNR_GAP`` holds the JAX package's gaps: the
card's gap is held to ``BF16_GRAPH_RATIO`` times them.

    JAX_PLATFORMS=cpu python scripts/torch_adapt_fused_psnr_gap.py
        [--losses f2f,stnls,sup] [--port]

``--port`` also runs the port on the CPU (its kernels' plain versions).
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

NF = {"f2f": 5, "stnls": 3, "sup": 3}


def psnr(clean, deno):
    d = np.clip(np.asarray(deno, np.float64), 0.0, 1.0)
    mse = float(np.mean((d - np.asarray(clean, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / mse)


def jax_run(lt, conv_impl, variables):
    """The JAX package's windows of loss ``lt`` on ``conv_impl``: the mean
    held-out PSNR before and after."""
    import chip_smoke as cs
    import frame2frame_tpu as jpkg
    from frame2frame_tpu.config import Config
    from frame2frame_tpu.models.dncnn import DnCNN
    from frame2frame_tpu.train import schedules as jsched
    from frame2frame_tpu.train.state import TrainState

    (vid_n, vid_c), (held_n, held_c) = cs.adapt_clip()
    nwin = max(cs.ADAPT_T - NF[lt] + 1, 1)
    tx, sched = jsched.make_optimizer(Config(
        {"scheduler_name": "cosa", "lr_init": cs.ADAPT_LR, "nepochs": 1}),
        steps_per_epoch=nwin)
    model = DnCNN(channels=1, num_layers=17, residual=True,
                  conv_impl=conv_impl)
    st = TrainState.create(model, variables, tx, residual=True)

    def held(state):
        return float(np.mean([psnr(held_c[k], np.asarray(
            state.eval_apply(held_n[k:k + 1]))[0])
            for k in range(cs.ADAPT_HELD)]))

    before = held(st)
    st, _ = jpkg.get_loss_fxn(Config(cs.ADAPT_CFG), lt)(
        st, vid_n, vid_c, seed=cs.ADAPT_SEED, sched=sched)
    return before, held(st)


def port_run(lt, conv_impl):
    """The port's windows on the CPU, as ``adapt_phase`` runs them on the
    card."""
    import chip_smoke as cs
    import frame2frame_tpu_torch as port

    (vid_n, vid_c), (held_n, held_c) = cs.adapt_clip()
    wrapper = port.get_loss_fxn(dict(cs.ADAPT_CFG), lt)
    st, sched = cs.adapt_state(conv_impl, device="cpu",
                               nwin=wrapper.windows(cs.ADAPT_T))

    def held(state):
        return float(np.mean([psnr(held_c[k], state.eval_apply(
            held_n[k:k + 1])[0].float().numpy())
            for k in range(cs.ADAPT_HELD)]))

    before = held(st)
    st, _ = wrapper(st, vid_n, vid_c, seed=cs.ADAPT_SEED, sched=sched)
    return before, held(st)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--losses", default=None,
                    help="comma-separated losses (default: ADAPT_LOSSES)")
    ap.add_argument("--port", action="store_true",
                    help="also run the port on the CPU")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")

    import chip_smoke as cs
    from frame2frame_tpu_torch.models import load_model

    losses = (args.losses.split(",") if args.losses else cs.ADAPT_LOSSES)
    variables = load_model({
        "net_name": "dncnn", "channels": 1, "num_of_layers": 17,
        "residual": True, "conv_impl": "xla", "pretrained_load": True,
        "pretrained_path": str(cs.CKPT)}, device="cpu").variables
    out = {}
    runs = [("jax", lambda lt, ci: jax_run(lt, ci, variables))]
    if args.port:
        runs.append(("port_cpu", port_run))
    for lt in losses:
        for name, run in runs:
            t0 = time.perf_counter()
            (b_f, a_f), (b_x, a_x) = run(lt, "fused"), run(lt, "xla")
            out.setdefault(name, {})[lt] = {
                "fused": [b_f, a_f], "xla": [b_x, a_x],
                "gap_db": abs(a_f - a_x), "s": time.perf_counter() - t0}
            print(f"{name} {lt}: " + json.dumps(out[name][lt]),
                  file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
