"""How far the bf16 graph's gradient lies from f32 on the adaptation's first
windows, in the JAX package and in the PyTorch port, on the CPU.

For each loss of ``chip_smoke.ADAPT_LOSSES`` both packages run the first
window of ``chip_smoke.py``'s ``adapt_phase`` (the pretrained DnCNN-17, the
7-frame 540p clip, the same 128x128 crops, no flow, Adam at 1e-4) through
their own ``get_loss_fxn(cfg, t)`` on ``conv_impl="fused"`` (the bf16 graph
of "packed_bf16") and on the f32 "xla" route, and read the window's
parameter gradient where the wrapper hands it to its update. For each
package and parameter kind (``chip_smoke.GRAD_KINDS``: the convolutions'
weights, the BatchNorm scales, the BatchNorm biases, each kind as one
vector) it prints the bf16 gradient's distance from the same package's f32
gradient (``|bf16 - f32| / |f32|``), cosine and norm ratio, as one JSON
object. ``chip_smoke.ADAPT_JAX_BF16_GRAD_REL`` holds the JAX package's
distances: the card's "fused" gradient is held to ``BF16_GRAPH_RATIO``
times them.

    JAX_PLATFORMS=cpu python scripts/torch_adapt_bf16_grad.py

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


def jax_first_window(lt, conv_impl, variables):
    """The JAX package's first window of loss ``lt`` on ``conv_impl``: the
    gradient it hands to ``apply_gradients``, by the port's parameter
    names."""
    import chip_smoke as cs
    import frame2frame_tpu as jpkg
    from frame2frame_tpu.config import Config
    from frame2frame_tpu.models.dncnn import DnCNN
    from frame2frame_tpu.train import adapt as jadapt
    from frame2frame_tpu.train import schedules as jsched
    from frame2frame_tpu.train.state import TrainState

    (vid_n, vid_c), _ = cs.adapt_clip()
    tx, sched = jsched.make_optimizer(Config(
        {"scheduler_name": "cosa", "lr_init": cs.ADAPT_LR, "nepochs": 1}),
        steps_per_epoch=1)
    model = DnCNN(channels=1, num_layers=17, residual=True,
                  conv_impl=conv_impl)
    st = TrainState.create(model, variables, tx, residual=True)
    grads, update = {}, jadapt.apply_gradients

    def read(state, g, *a, **kw):
        for layer, leaves in g.items():
            for leaf, v in leaves.items():
                name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
                grads[f"{layer}.{name}"] = np.asarray(v, np.float64)
        return update(state, g, *a, **kw)

    cfg = Config(dict(cs.ADAPT_CFG, flow=False, adapt_nsteps=1))
    jadapt.apply_gradients = read
    try:
        jpkg.get_loss_fxn(cfg, lt)(st, vid_n, vid_c, seed=cs.ADAPT_SEED,
                                   sched=sched)
    finally:
        jadapt.apply_gradients = update
    return grads


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--losses", default=None,
                    help="comma-separated losses (default: ADAPT_LOSSES)")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import chip_smoke as cs
    from frame2frame_tpu_torch.models import load_model

    losses = (args.losses.split(",") if args.losses else cs.ADAPT_LOSSES)
    variables = load_model({
        "net_name": "dncnn", "channels": 1, "num_of_layers": 17,
        "residual": True, "conv_impl": "xla", "pretrained_load": True,
        "pretrained_path": str(cs.CKPT)}, device="cpu").variables
    out = {}
    for lt in losses:
        t0 = time.perf_counter()
        jx = jax_first_window(lt, "xla", variables)
        jf = jax_first_window(lt, "fused", variables)
        tx = cs.adapt_first_window(torch, lt, "xla", device="cpu")["grad"]
        tf = cs.adapt_first_window(torch, lt, "fused", device="cpu")["grad"]
        out[lt] = {"jax": cs.grad_distance(jf, jx),
                   "port_cpu": cs.grad_distance(tf, tx),
                   "port_vs_jax_f32": cs.grad_distance(
                       {n: np.asarray(g) for n, g in tx.items()},
                       {n: _oihw(g) for n, g in jx.items()}),
                   "s": time.perf_counter() - t0}
        print(f"{lt}: " + json.dumps(out[lt]), file=sys.stderr, flush=True)
    print(json.dumps(out))


def _oihw(g):
    """A JAX gradient in the port's layout: HWIO kernels as OIHW."""
    return g.transpose(3, 2, 0, 1) if g.ndim == 4 else g


if __name__ == "__main__":
    main()
