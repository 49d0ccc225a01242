"""The accuracy artifact of the PyTorch port, the twin of
``scripts/accuracy_artifact.py``: the reference algorithm's PSNR at the
reference workload's shape (blind_denoising.py:279-288: 300 frames, 540p,
DnCNN-17 grayscale, sigma=25, 20 fine-tune iterations a frame).

1. ``pretrain``: the 17-layer sigma=25 supervised pretrain on production-
   sized synthetic data (``PRETRAIN_CFG``, the JAX script's recipe) through
   the port's offline trainer; writes ``checkpoint.msgpack`` and
   ``recipe.json``.
2. ``trajectory``: the 300-frame 540p workload (``OnlineDenoiser``
   on "fused", 20 Adam updates a frame, the in-process TV-L1 of
   ``AsyncFlowSolver``) from ``--checkpoint`` (default: the committed
   ``results/dncnn17_s25/checkpoint.msgpack``, read by the port's
   ``models/serialization.load_variables``); writes the per-frame PSNR
   file ``psnr_540p_300f.txt`` and ``trajectory_stats.json`` (with the
   card's name and power limit).
3. ``oracle``: the trajectory against a torch oracle of the reference
   algorithm (the same weights through ``export_torch_state_dict``, the
   same frames and flows) on a prefix at reduced resolution; writes
   ``oracle_deviation.json``. ``oracle_spot``: one 540p frame, the same
   comparison; writes ``oracle_540p_spot.json``.

Every file goes to ``results/dncnn17_s25_torch/`` (``--out``), never into
``results/dncnn17_s25/``, which holds the JAX package's artifacts.

    python scripts/torch_accuracy_artifact.py [pretrain|trajectory|oracle|
        oracle_spot|all] [nframes H W] [--device cpu|cuda|cuda:N]
        [--checkpoint PATH] [--out DIR]

Without ``--device`` the runs take the CUDA card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OUT = REPO / "results" / "dncnn17_s25_torch"
CKPT = REPO / "results" / "dncnn17_s25" / "checkpoint.msgpack"
SIGMA = 25
LAYERS = 17

PRETRAIN_CFG = dict(
    net_name="dncnn", channels=1, num_of_layers=LAYERS, residual=True,
    conv_impl="xla", seed=0,
    dname="synthetic", texture="mixed", nvideos=48, nframes_data=8,
    isize_data=(96, 96),
    ntype="g", sigma=SIGMA, crit_name="sup", dist_crit="l2",
    nepochs=40, lr_init=1e-3, scheduler_name="cosa", flow=False,
    rate=-1, log_csv=True,
)


def card_line():
    """``nvidia-smi``'s name and power limit of the first card, or None on
    a host without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def frames_540p(nframes, h=540, w=960, seed=77):
    """A long synthetic sequence: mixed texture, (1, 1) px a frame, sigma=25
    noise, the JAX script's frames (T, H, W) in [0, 1]: (clean, noisy)."""
    from frame2frame_tpu_torch.data.datasets import synthetic_video

    clean = synthetic_video(seed, nframes=nframes, h=h, w=w, channels=1,
                            texture="mixed")[..., 0] / 255.0
    rng = np.random.default_rng(seed + 1)
    noisy = np.clip(
        clean + rng.normal(0, SIGMA / 255.0, clean.shape).astype(np.float32),
        0, 1).astype(np.float32)
    return clean.astype(np.float32), noisy


def pretrain(out=OUT, device=None):
    from frame2frame_tpu_torch.config import Config
    from frame2frame_tpu_torch.models.serialization import save_variables
    from frame2frame_tpu_torch.train import trainer

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = Config(dict(PRETRAIN_CFG, checkpoint_dir=str(out / "ckpts"),
                      uuid="dncnn17-s25"))
    t0 = time.time()
    res = trainer.run(cfg, device=device)
    dt = time.time() - t0
    state = res.state
    save_variables(out / "checkpoint.msgpack", state.variables)
    recipe = dict(PRETRAIN_CFG)
    # the final epoch's validation PSNR, the shipped checkpoint's quality
    recipe["val_psnr"] = float(res.final.get("val_psnr", float("nan")))
    recipe["val_psnr_epoch_mean"] = float(res.get("val_psnr", float("nan")))
    recipe["train_seconds"] = round(dt, 1)
    recipe["steps"] = int(state.step)
    recipe["card"] = card_line()
    (out / "recipe.json").write_text(json.dumps(recipe, indent=1))
    print(f"pretrain done in {dt:.0f}s: val_psnr="
          f"{recipe['val_psnr']:.2f} dB -> {out / 'checkpoint.msgpack'}")


def load_engine(ckpt=CKPT, conv_impl="fused", iters=20, device=None):
    """``OnlineDenoiser`` over the DnCNN-17 of ``ckpt``: (engine, the JAX
    tree of its weights)."""
    from frame2frame_tpu_torch.models.dncnn import init_dncnn
    from frame2frame_tpu_torch.models.serialization import load_variables
    from frame2frame_tpu_torch.train.online import OnlineDenoiser

    model, init_vars = init_dncnn(0, channels=1, num_layers=LAYERS,
                                  residual=True, conv_impl=conv_impl)
    variables = load_variables(ckpt, like=init_vars)
    return OnlineDenoiser(model, variables, iters=iters, residual_model=True,
                          device=device), variables


def _names(h, w, nframes):
    if (h, w, nframes) == (540, 960, 300):
        return "psnr_540p_300f.txt", "trajectory_stats.json"
    return (f"psnr_{h}x{w}_{nframes}f.txt",
            f"trajectory_stats_{h}x{w}_{nframes}f.json")


def trajectory(nframes=300, h=540, w=960, out=OUT, ckpt=CKPT, device=None):
    """The streaming workload from ``ckpt``: each frame fine-tuned 20
    updates on the flow to the frame before (``AsyncFlowSolver``, the
    in-process TV-L1) and denoised; writes its PSNRs and stats."""
    import torch

    from frame2frame_tpu_torch.flow.tvl1 import DENOISING_PARAMS
    from frame2frame_tpu_torch.train.online import AsyncFlowSolver
    from frame2frame_tpu_torch.utils.metrics import psnr

    clean, noisy = frames_540p(nframes, h=h, w=w)
    eng, _ = load_engine(ckpt, device=device)
    solver = AsyncFlowSolver(w, h, dict(DENOISING_PARAMS), lookahead=3,
                             device=eng.device)

    def flow_for(i):
        for j in range(i, min(i + solver.lookahead, nframes - 1) + 1):
            solver.prefetch(j, noisy[j][..., None], noisy[j - 1][..., None])
        return solver.get(i)

    psnrs, noisy_psnrs = [], []  # frames are 2D; the engine takes (H, W, 1)
    t0 = time.time()
    try:
        for i in range(1, nframes):
            deno, _ = eng.process_frame(noisy[i][..., None],
                                        noisy[i - 1][..., None], flow_for(i))
            d = deno.float().cpu().numpy()
            psnrs.append(psnr(clean[i], d[..., 0]))
            noisy_psnrs.append(psnr(clean[i], noisy[i]))
            if i % 25 == 0:
                print(f"frame {i}: deno {psnrs[-1]:.2f} dB "
                      f"(noisy {noisy_psnrs[-1]:.2f})", flush=True)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
    finally:
        solver.close()
    dt = time.time() - t0

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    name, sname = _names(h, w, nframes)
    with open(out / name, "w") as f:
        f.writelines(f"{v}\n" for v in psnrs)
    tail = psnrs[len(psnrs) // 3:]
    stats = {
        "frames": nframes, "h": h, "w": w, "sigma": SIGMA,
        "iters_per_frame": 20,
        "noisy_psnr_mean": round(float(np.mean(noisy_psnrs)), 3),
        "deno_psnr_mean": round(float(np.mean(psnrs)), 3),
        "deno_psnr_tail_mean": round(float(np.mean(tail)), 3),
        "deno_psnr_last": round(float(psnrs[-1]), 3),
        "gain_db": round(float(np.mean(psnrs) - np.mean(noisy_psnrs)), 3),
        "seconds_total": round(dt, 1),
        "seconds_per_frame": round(dt / (nframes - 1), 3),
        "checkpoint": str(Path(ckpt).resolve().relative_to(REPO))
        if Path(ckpt).resolve().is_relative_to(REPO) else str(ckpt),
        "device": str(eng.device),
        "card": card_line() if eng.device.type == "cuda" else None,
    }
    (out / sname).write_text(json.dumps(stats, indent=1))
    print(json.dumps(stats))
    return stats


def build_torch_dncnn(channels=1, num_of_layers=LAYERS):
    """Torch oracle of the SaoYan DnCNN layout (conv/bn indices as in the
    reference checkpoints)."""
    import torch.nn as nn

    layers = [
        nn.Conv2d(channels, 64, 3, padding=1, bias=False),
        nn.ReLU(inplace=True),
    ]
    for _ in range(num_of_layers - 2):
        layers += [
            nn.Conv2d(64, 64, 3, padding=1, bias=False),
            nn.BatchNorm2d(64),
            nn.ReLU(inplace=True),
        ]
    layers.append(nn.Conv2d(64, channels, 3, padding=1, bias=False))
    return nn.Sequential(*layers)


def torch_warped_loss(out, prev, flow):
    """Oracle of WarpedLoss.forward (blind_denoising.py:44-122), CPU torch
    with align_corners=True grid_sample + scipy binary_dilation."""
    import torch
    import torch.nn.functional as F
    from scipy.ndimage import binary_dilation

    B, C, Hh, Ww = prev.shape
    xx = torch.arange(Ww).view(1, -1).repeat(Hh, 1)
    yy = torch.arange(Hh).view(-1, 1).repeat(1, Ww)
    grid = torch.stack([xx, yy], 0)[None].float()
    vgrid = grid + flow
    vgrid[:, 0] = 2.0 * vgrid[:, 0] / max(Ww - 1, 1) - 1.0
    vgrid[:, 1] = 2.0 * vgrid[:, 1] / max(Hh - 1, 1) - 1.0
    vgrid = vgrid.permute(0, 2, 3, 1)
    warped = F.grid_sample(prev, vgrid, align_corners=True)
    mask = F.grid_sample(torch.ones_like(prev), vgrid, align_corners=True)
    mask = (mask >= 0.9999).float()

    of = flow
    a = torch.zeros_like(warped)
    b = torch.zeros_like(warped)
    a[:, :, :-1, :] = of[0, 0, 1:, :] - of[0, 0, :-1, :]
    b[:, :, :, :-1] = of[0, 1, :, 1:] - of[0, 1, :, :-1]
    occ = (torch.abs(a + b) > 0.75).numpy()
    ball = np.zeros((3, 3))
    ball[1, 0] = ball[0, 1] = ball[1, 1] = ball[2, 1] = ball[1, 2] = 1
    occ[0, 0] = binary_dilation(occ[0, 0], ball)
    occ[:, :, 0, :] = 1
    occ[:, :, -1, :] = 1
    occ[:, :, :, 0] = 1
    occ[:, :, :, -1] = 1
    mask = mask * torch.tensor(1.0 - occ, dtype=torch.float32)
    return torch.sum(torch.abs(mask * out - mask * warped))


def _oracle_net(variables):
    """The oracle's net on the CPU with the engine's weights (the
    submodule net's ``dncnn.`` prefix stripped: the oracle is the bare
    Sequential; reference lightning.py:605-611)."""
    import torch

    from frame2frame_tpu_torch.models.dncnn import export_torch_state_dict

    net = build_torch_dncnn(num_of_layers=LAYERS)
    sd = export_torch_state_dict(variables, num_layers=LAYERS)
    net.load_state_dict(
        {k.removeprefix("dncnn."): torch.tensor(v) for k, v in sd.items()},
        strict=False)
    optim = torch.optim.Adam(net.parameters(), lr=5e-5, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-5)
    return net, optim


def _solve_flows(noisy, h, w, device):
    from frame2frame_tpu_torch.flow.tvl1 import (DENOISING_PARAMS,
                                                 make_tvl1_solver)

    solve = make_tvl1_solver(w, h, device=device, **DENOISING_PARAMS)
    return [solve(noisy[i] * 255.0, noisy[i - 1] * 255.0).float().cpu()
            .numpy() for i in range(1, len(noisy))]


def oracle(nframes=25, h=192, w=256, out=OUT, ckpt=CKPT, device=None):
    """Trajectory deviation against the torch oracle of the reference
    algorithm (blind_denoising.py:187-256) from the same weights, frames
    and flows."""
    import torch

    from frame2frame_tpu_torch.utils.metrics import psnr

    clean, noisy = frames_540p(nframes + 1, h=h, w=w, seed=99)
    eng, variables = load_engine(ckpt, device=device)
    flows = _solve_flows(noisy, h, w, eng.device)

    ours = []
    for i in range(1, nframes + 1):
        deno, _ = eng.process_frame(noisy[i][..., None],
                                    noisy[i - 1][..., None], flows[i - 1])
        ours.append(psnr(clean[i], deno.float().cpu().numpy()[..., 0]))

    net, optim = _oracle_net(variables)
    ref = []
    prev = torch.tensor(noisy[0])[None, None]
    for i in range(1, nframes + 1):
        cur = torch.tensor(noisy[i])[None, None]
        flow = torch.tensor(flows[i - 1]).permute(2, 0, 1)[None]
        net.train()
        for _ in range(20):
            optim.zero_grad()
            loss = torch_warped_loss(cur - net(cur), prev, flow)
            loss.backward()
            optim.step()
        net.eval()
        with torch.no_grad():
            deno = (cur - net(cur))[0, 0].numpy()
        ref.append(psnr(clean[i], deno))
        prev = cur
        print(f"oracle frame {i}: ours {ours[i - 1]:.3f} vs torch "
              f"{ref[i - 1]:.3f} dB", flush=True)

    dev = np.abs(np.asarray(ours) - np.asarray(ref))
    half = nframes // 2
    stats = {
        "frames": nframes, "h": h, "w": w,
        "ours_psnr": [round(float(v), 3) for v in ours],
        "torch_psnr": [round(float(v), 3) for v in ref],
        "max_abs_dev_db": round(float(dev.max()), 4),
        "mean_abs_dev_db": round(float(dev.mean()), 4),
        "mean_abs_dev_db_first_half": round(float(dev[:half].mean()), 4),
        "mean_abs_dev_db_second_half": round(float(dev[half:].mean()), 4),
        "device": str(eng.device),
    }
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "oracle_deviation.json").write_text(json.dumps(stats, indent=1))
    print(json.dumps(stats))
    return stats


def oracle_spot(h=540, w=960, iters=20, out=OUT, ckpt=CKPT, device=None):
    """One frame at the workload's resolution fine-tuned ``iters`` updates
    by the engine and by the oracle from the same weights: the loss
    trajectories and the denoised frames."""
    import torch

    from frame2frame_tpu_torch.utils.metrics import psnr

    clean, noisy = frames_540p(2, h=h, w=w, seed=101)
    eng, variables = load_engine(ckpt, iters=iters, device=device)
    flow = _solve_flows(noisy, h, w, eng.device)[0]
    deno_e, losses_e = eng.process_frame(noisy[1][..., None],
                                         noisy[0][..., None], flow)
    deno_e = deno_e.float().cpu().numpy()[..., 0]
    losses_e = np.asarray(torch.as_tensor(losses_e).cpu(), np.float64)

    net, optim = _oracle_net(variables)
    prev = torch.tensor(noisy[0])[None, None]
    cur = torch.tensor(noisy[1])[None, None]
    flow_t = torch.tensor(flow).permute(2, 0, 1)[None]
    losses_t = []
    net.train()
    for it in range(iters):
        optim.zero_grad()
        loss = torch_warped_loss(cur - net(cur), prev, flow_t)
        loss.backward()
        optim.step()
        losses_t.append(float(loss))
    net.eval()
    with torch.no_grad():
        deno_t = (cur - net(cur))[0, 0].numpy()

    rel = np.abs(losses_e - np.asarray(losses_t)) / np.asarray(losses_t)
    stats = {
        "h": h, "w": w, "iters": iters,
        "ours_loss_first_last": [round(float(losses_e[0]), 2),
                                 round(float(losses_e[-1]), 2)],
        "torch_loss_first_last": [round(losses_t[0], 2),
                                  round(losses_t[-1], 2)],
        "max_rel_loss_dev": round(float(rel.max()), 5),
        "ours_deno_psnr": round(float(psnr(clean[1], deno_e)), 3),
        "torch_deno_psnr": round(float(psnr(clean[1], deno_t)), 3),
        "deno_max_abs_diff": round(float(np.abs(deno_e - deno_t).max()), 5),
        "deno_psnr_dev_db": round(float(abs(psnr(clean[1], deno_e)
                                             - psnr(clean[1], deno_t))), 4),
        "device": str(eng.device),
    }
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "oracle_540p_spot.json").write_text(json.dumps(stats, indent=1))
    print(json.dumps(stats))
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", nargs="?", default="all",
                    choices=["pretrain", "trajectory", "oracle",
                             "oracle_spot", "all"])
    ap.add_argument("scale", nargs="*", type=int,
                    help="nframes H W of the trajectory and oracle phases")
    ap.add_argument("--device", default=None)
    ap.add_argument("--checkpoint", default=str(CKPT))
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    if out == (REPO / "results" / "dncnn17_s25").resolve():
        raise ValueError(f"{out} holds the JAX package's artifacts")
    kw = dict(out=out, ckpt=args.checkpoint, device=args.device)
    if args.phase in ("pretrain", "all"):
        pretrain(out=out, device=args.device)
    if args.phase in ("trajectory", "all"):
        trajectory(*args.scale, **kw)
    if args.phase in ("oracle", "all"):
        oracle(*args.scale, **kw)
    if args.phase in ("oracle_spot", "all"):
        oracle_spot(**kw)


if __name__ == "__main__":
    main()
