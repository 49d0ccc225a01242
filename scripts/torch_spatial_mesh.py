"""The H-split online fine-tune and eval denoise of one frame with its slabs
on several cards, against the same slabs all on the first card and against
the unsplit step.

    python3 scripts/torch_spatial_mesh.py [--slabs D] [--sizes 540,1080,2160]
        [--out chiprun_out/spatial_mesh.json]

The pretrained DnCNN-17 (``results/dncnn17_s25``) on the bf16 chain, 20
Adam updates of one frame: the 540p scene of ``chip_smoke.moving_frames``,
scaled up bilinearly for the larger sizes with fresh noise (sigma 25/255).
Slab k lies on card k mod the card count; D defaults to the card count.
For each frame height:

- the step over the cards against the step with every slab on cuda:0 (the
  same kernels, the same sums in the same order: the same bits are
  expected, and printed) and both against the unsplit per-iteration step,
  held by the bounds ``chip_smoke.py`` holds the split step by (losses
  0.5 %, frame rms 5e-3);
- host ms of a step (20 updates; the median of 3 after the first call,
  each ending when every card is done), and the most memory each card held
  during the first call above what it held before it; a step that does
  not fit is recorded so;
- the split eval denoise over the cards against the unsplit one, bit for
  bit, and its host ms (the unsplit one where it fits).

Prints the card line and one JSON line a height, writes them all to
``--out``, and exits 1 if a hold failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TIMED_CALLS = 3
SERVE_CALLS = 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slabs", type=int, default=None,
                    help="slabs a frame (default: the card count)")
    ap.add_argument("--sizes", default="540,1080,2160",
                    help="frame heights, multiples of 540 (4320: 8K, which "
                         "does not fit on one card unsplit)")
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "spatial_mesh.json"))
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_spatial_mesh: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from frame2frame_tpu_torch.models.dncnn import (
        JaxRavel, from_jax_variables)
    from frame2frame_tpu_torch.models.serialization import load_variables
    from frame2frame_tpu_torch.ops import _build
    from frame2frame_tpu_torch.parallel.spatial import (
        make_space_mesh, make_spatial_online_step)
    from frame2frame_tpu_torch.train.online import (
        make_denoise, make_online_step, torch_adam)
    from frame2frame_tpu_torch.utils.metrics import psnr

    card = cs.card_line()
    print(card, flush=True)
    _build.build_all()
    n_cards = torch.cuda.device_count()
    D = args.slabs or n_cards
    dev = torch.device("cuda", 0)
    meshes = {
        "cards": make_space_mesh(devices=[torch.device("cuda", k % n_cards)
                                          for k in range(D)]),
        "one_card": make_space_mesh(devices=[dev] * D),
        "unsplit": None}
    variables = load_variables(cs.CKPT)
    clean, noisy, flows = cs.moving_frames(2)
    rng = np.random.default_rng(13)

    def sync():
        for i in range(n_cards):
            torch.cuda.synchronize(i)

    def frames_at(h):
        scale = h // cs.H
        if scale == 1:
            return ([torch.from_numpy(a).to(dev)
                     for a in (noisy[1], noisy[0], flows[1])], clean[1])

        def up(a):
            x = torch.from_numpy(a).to(dev).permute(2, 0, 1)[None]
            x = F.interpolate(x, scale_factor=scale, mode="bilinear",
                              align_corners=False)
            return x[0].permute(1, 2, 0).contiguous()

        cl = [up(clean[k]) for k in (1, 0)]
        frame = [c + cs.SIGMA * torch.from_numpy(rng.standard_normal(
            c.shape, dtype=np.float32)).to(dev) for c in cl]
        frame.append(scale * up(flows[1]))
        return frame, cl[0].cpu().numpy()

    def run(mesh, frame):
        model = from_jax_variables(variables, residual=True).to(dev)
        tx = torch_adam(5e-5, 1e-5)
        state = tx.init(JaxRavel(model).ravel())
        if mesh is None:
            step = make_online_step(model, tx, iters=cs.ITERS,
                                    residual_model=True, flat_step=False)
        else:
            step = make_spatial_online_step(model, tx, mesh, iters=cs.ITERS,
                                            residual_model=True)
        sync()
        before = []
        for i in range(n_cards):
            torch.cuda.reset_peak_memory_stats(i)
            before.append(torch.cuda.memory_allocated(i))
        t0 = time.perf_counter()
        _, deno, losses = step(state, *frame)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak = [(torch.cuda.max_memory_allocated(i) - before[i]) / 2 ** 30
                for i in range(n_cards)]
        out = {"deno": deno.cpu().numpy(), "losses": losses.cpu().numpy(),
               "peak_gib": peak, "first_ms": first_ms}
        ts = []
        for _ in range(TIMED_CALLS):
            t0 = time.perf_counter()
            step(state, *frame)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        out["ms"] = float(np.median(ts))
        return out, model

    def serve_ms(fn, x):
        fn(x)
        sync()
        ts = []
        for _ in range(SERVE_CALLS):
            t0 = time.perf_counter()
            fn(x)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    failures, results = [], []
    for h in (int(v) for v in args.sizes.split(",")):
        frame, ref = frames_at(h)
        res = {"height": h, "width": frame[0].shape[1], "slabs": D,
               "cards": n_cards, "card": card}
        runs = {}
        for name, mesh in meshes.items():
            try:
                runs[name], model = run(mesh, frame)
            except torch.cuda.OutOfMemoryError:
                res[name] = "does not fit"
                torch.cuda.empty_cache()
                continue
            r = runs[name]
            res[name] = {"ms": r["ms"], "first_ms": r["first_ms"],
                         "peak_gib_by_card": r["peak_gib"],
                         "loss_first": float(r["losses"][0]),
                         "loss_last": float(r["losses"][-1]),
                         "psnr": psnr(ref, r["deno"])}
            if name == "cards":
                split = make_denoise(model, residual_model=True,
                                     spatial_mesh=meshes["cards"])
                whole = make_denoise(model, residual_model=True)
                res["serve"] = {"ms_split": serve_ms(split, frame[0])}
                try:
                    with torch.no_grad():
                        err = float((split(frame[0]) - whole(frame[0]))
                                    .abs().max())
                    res["serve"].update(max_abs_diff_unsplit=err,
                                        ms_unsplit=serve_ms(whole, frame[0]))
                    if err != 0:
                        failures.append(f"{h}p serve: split off by {err}")
                except torch.cuda.OutOfMemoryError:
                    res["serve"]["unsplit"] = "does not fit"
                    torch.cuda.empty_cache()
            del model
            torch.cuda.empty_cache()
        pairs = (("cards", "one_card"), ("cards", "unsplit"),
                 ("one_card", "unsplit"))
        for a, b in pairs:
            if a not in runs or b not in runs:
                continue
            ra, rb = runs[a], runs[b]
            dl = float(np.abs(ra["losses"] / rb["losses"] - 1).max())
            d = ra["deno"] - rb["deno"]
            drms = float(np.sqrt(np.mean(d ** 2)))
            res[f"{a}_vs_{b}"] = {
                "same_bits": bool(np.array_equal(ra["losses"], rb["losses"])
                                  and np.array_equal(ra["deno"], rb["deno"])),
                "worst_loss_rel_err": dl, "rms_denoised_diff": drms,
                "max_abs_denoised_diff": float(np.abs(d).max())}
            if dl > cs.TRAIN_LOSS_RTOL or drms > cs.ROUTES_DENO_RMS:
                failures.append(f"{h}p {a} against {b}: losses {dl}, "
                                f"frame rms {drms}")
        if "cards" not in runs:
            failures.append(f"{h}p: the split over the cards does not fit")
        print(json.dumps(res), flush=True)
        results.append(res)
        del frame, runs
        torch.cuda.empty_cache()

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "results": results,
                               "failures": failures}, indent=1))
    for f in failures:
        print(f"torch_spatial_mesh: FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
