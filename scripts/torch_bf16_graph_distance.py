"""How far the bf16 graph of ``conv_impl="packed_bf16"`` lies from f32, in the
JAX package and in the PyTorch port, on the CPU.

Both packages fine-tune the pretrained DnCNN-17
(``results/dncnn17_s25/checkpoint.msgpack``) on frames 1 .. ``--frames`` of
``chip_smoke.py``'s moving texture (its ``moving_frames``, at the size
given) through ``OnlineDenoiser.process_frame``, 20 Adam updates a frame, on
"packed_bf16" and on the f32 "xla" route. For each package the bf16 route's
distance from its own f32 route is the worst relative loss deviation over
the updates of all frames and the worst PSNR difference of the denoised
frames against the clean ones; the port's f32 route is held against the
JAX package's f32 route as well. Prints one JSON object.

    JAX_PLATFORMS=cpu python scripts/torch_bf16_graph_distance.py --hw 135x240

``--seed`` draws another texture and noise (default 3, ``chip_smoke.py``'s);
one draw cannot tell which graph is closer when the two f32 routes lie as
far apart as a bf16 distance, so compare several.

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
CKPT = REPO / "results" / "dncnn17_s25" / "checkpoint.msgpack"
ROUTES = ("xla", "packed_bf16")


def frames(h, w, n, seed):
    """(clean, noisy, flows) of ``n`` frames of ``chip_smoke.moving_frames``
    at h x w, drawn from ``seed``."""
    import chip_smoke

    chip_smoke.H, chip_smoke.W = h, w
    return chip_smoke.moving_frames(n, seed)


def run_jax(impl, noisy, flows, iters, frames_run):
    from frame2frame_tpu.models.dncnn import DnCNN
    from frame2frame_tpu.models.serialization import load_variables
    from frame2frame_tpu.train.online import OnlineDenoiser

    variables = load_variables(CKPT)
    model = DnCNN(channels=1, num_layers=17, residual=True, conv_impl=impl)
    eng = OnlineDenoiser(model, variables, iters=iters, residual_model=True)
    out = []
    for k in frames_run:
        deno, losses = eng.process_frame(noisy[k], noisy[k - 1], flows[k])
        out.append((np.asarray(deno, np.float32), np.asarray(losses)))
    return out


def run_torch(impl, noisy, flows, iters, frames_run):
    from frame2frame_tpu_torch.models.dncnn import from_jax_variables
    from frame2frame_tpu_torch.models.serialization import load_variables
    from frame2frame_tpu_torch.train.online import OnlineDenoiser

    variables = load_variables(CKPT)
    model = from_jax_variables(variables, residual=True, conv_impl=impl)
    eng = OnlineDenoiser(model, variables, iters=iters, residual_model=True,
                         device="cpu")
    out = []
    for k in frames_run:
        deno, losses = eng.process_frame(noisy[k], noisy[k - 1], flows[k])
        out.append((deno.numpy(), losses.numpy()))
    return out


def distance(clean, frames_run, got, ref):
    """(worst |loss / loss_ref - 1| in %, worst |PSNR - PSNR_ref| in dB)."""
    from frame2frame_tpu_torch.utils.metrics import psnr

    loss = psnr_db = 0.0
    for k, (dg, lg), (dr, lr) in zip(frames_run, got, ref):
        loss = max(loss, float(np.abs(lg / lr - 1).max()))
        psnr_db = max(psnr_db, abs(psnr(clean[k], dg) - psnr(clean[k], dr)))
    return 100.0 * loss, psnr_db


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", default="135x240", help="frame size, HxW")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--frames", type=int, default=2,
                    help="frames fine-tuned in a row, from frame 1")
    ap.add_argument("--seed", type=int, default=3,
                    help="seed of the texture and its noise (3: chip_smoke's)")
    args = ap.parse_args(argv)
    h, w = (int(v) for v in args.hw.split("x"))

    import jax

    jax.config.update("jax_platforms", "cpu")
    clean, noisy, flows = frames(h, w, args.frames + 1, args.seed)
    frames_run = tuple(range(1, args.frames + 1))
    runs, secs = {}, {}
    for pkg, run in (("jax", run_jax), ("torch", run_torch)):
        for impl in ROUTES:
            t0 = time.perf_counter()
            runs[pkg, impl] = run(impl, noisy, flows, args.iters,
                                  frames_run)
            secs[f"{pkg}/{impl}"] = time.perf_counter() - t0
            print(f"{pkg} {impl}: {secs[f'{pkg}/{impl}']:.1f} s", flush=True)
    from frame2frame_tpu_torch.utils.metrics import psnr

    result = {"hw": [h, w], "seed": args.seed, "iters": args.iters,
              "frames": list(frames_run),
              "seconds": secs, "psnr_noisy": [psnr(clean[k], noisy[k])
                                              for k in frames_run]}
    for (pkg, impl), run in runs.items():
        result[f"{pkg}/{impl}"] = {
            "psnr": [psnr(clean[k], d)
                     for k, (d, _) in zip(frames_run, run)],
            "first_last_loss": [[float(ls[0]), float(ls[-1])]
                                for _, ls in run]}
    for pkg in ("jax", "torch"):
        loss, db = distance(clean, frames_run, runs[pkg, "packed_bf16"],
                            runs[pkg, "xla"])
        result[f"{pkg}_bf16_from_f32"] = {"loss_pct": loss, "psnr_db": db}
    loss, db = distance(clean, frames_run, runs["torch", "xla"],
                        runs["jax", "xla"])
    result["torch_f32_from_jax_f32"] = {"loss_pct": loss, "psnr_db": db}
    j = result["jax_bf16_from_f32"]
    t = result["torch_bf16_from_f32"]
    result["ratio_torch_to_jax"] = {
        k: (t[k] / j[k] if j[k] else None) for k in ("loss_pct", "psnr_db")}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
