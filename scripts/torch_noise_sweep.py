"""Model-blind noise sweep of the PyTorch port, the twin of
``scripts/noise_sweep.py``: AWGN sigma in {10, 25, 50}, Poisson-Gaussian
and JPEG artifacts on synthetic sequences, each through the whole pipeline
(a small DnCNN pretrained at the condition's residual level by
``train.trainer.run``, then the streaming ``blind_denoising`` CLI with its
own TV-L1 flow), reporting denoised against noisy PSNR per condition.

The frames are written as PGM (``io/image.write_pgm``): the streaming CLI
reads them without PIL. The JPEG condition needs PIL (``data.noise.
add_jpeg_artifacts``).

    python scripts/torch_noise_sweep.py [--fast] [--device cpu|cuda|cuda:N]

Without ``--device`` the runs take the CUDA card; on a host without one,
pass ``--device cpu`` (``main(["--device", "cpu"])`` from Python).
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def make_sequence(noise, workdir, nframes=5, h=64, w=64, seed=7):
    """The condition's clean and noisy frames as ``clean%03d.pgm`` /
    ``noisy%03d.pgm`` in ``workdir``: (frames, std of the noise)."""
    from frame2frame_tpu_torch.data.datasets import synthetic_video
    from frame2frame_tpu_torch.data.noise import add_jpeg_artifacts
    from frame2frame_tpu_torch.io.image import write_pgm

    rng = np.random.default_rng(seed)
    vid = synthetic_video(seed, nframes=nframes, h=h, w=w)[..., 0]
    if noise["kind"] == "g":
        noisy = vid + rng.normal(0, noise["sigma"], vid.shape)
    elif noise["kind"] == "pg":
        lam = np.clip(vid / 255.0, 0, 1) * noise["rate"]
        noisy = rng.poisson(lam) / noise["rate"] * 255.0 + rng.normal(
            0, noise.get("sigma", 0), vid.shape)
    elif noise["kind"] == "jpeg":
        noisy = add_jpeg_artifacts(vid, quality=noise["quality"])
    else:
        raise ValueError(noise)
    noisy = np.clip(noisy, 0, 255)
    for t in range(nframes):
        write_pgm(Path(workdir) / f"clean{t + 1:03d}.pgm", vid[t])
        write_pgm(Path(workdir) / f"noisy{t + 1:03d}.pgm", noisy[t])
    return nframes, float(np.std(noisy - vid))


def pretrain_cfg(resid_std, workdir, fast=False):
    """The small denoiser's training config at the measured residual level
    (model-blind: the online stage adapts to the real noise statistics).
    Low-noise conditions get more capacity and longer pretraining: the
    denoiser's quality ceiling must exceed the noisy input's PSNR."""
    from frame2frame_tpu_torch.config import Config

    sigma_eq = max(resid_std, 5.0)
    low_noise = sigma_eq < 12
    return Config(net_name="dncnn", channels=1,
                  num_of_layers=7 if low_noise else 5, seed=0,
                  dname="synthetic", nvideos=6 if low_noise else 3,
                  nframes_data=3,
                  isize_data=(48, 48), ntype="g", sigma=sigma_eq,
                  crit_name="sup",
                  nepochs=10 if fast else (50 if low_noise else 30),
                  lr_init=1e-3, scheduler_name="cosa", flow=False,
                  checkpoint_dir=str(Path(workdir) / "ckpt"), log_csv=False)


def run_condition(noise, fast=False, device=None, cfg_fn=pretrain_cfg):
    """(mean noisy PSNR, mean denoised PSNR) of frames 2.. of the
    condition's sequence."""
    from frame2frame_tpu_torch.cli.blind_denoising import main as cli
    from frame2frame_tpu_torch.io.image import read_frame
    from frame2frame_tpu_torch.train import trainer
    from frame2frame_tpu_torch.utils.metrics import psnr

    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        n, resid_std = make_sequence(noise, td)
        cfg = cfg_fn(resid_std, td, fast)
        out = trainer.run(cfg, device=device)
        argv = ["--input", str(td / "noisy%03d.pgm"),
                "--ref", str(td / "clean%03d.pgm"),
                "--output", str(td / "out%03d.pgm"),
                "--first", "1", "--last", str(n), "--iter", "10",
                "--layers", str(cfg.num_of_layers), "--compute_flow",
                "--network", out["checkpoint"],
                "--output_psnr", str(td / "psnr.txt"),
                "--output_network", str(td / "final.msgpack")]
        r = cli(argv, device=device)
        noisy_psnrs = [
            psnr(np.asarray(read_frame(str(td / "clean%03d.pgm"), i)) / 255,
                 np.asarray(read_frame(str(td / "noisy%03d.pgm"), i)) / 255)
            for i in range(2, n + 1)
        ]
        return float(np.mean(noisy_psnrs)), float(np.mean(r["psnr"]))


CONDITIONS = [
    {"name": "awgn-10", "kind": "g", "sigma": 10},
    {"name": "awgn-25", "kind": "g", "sigma": 25},
    {"name": "awgn-50", "kind": "g", "sigma": 50},
    {"name": "pg-30", "kind": "pg", "rate": 30, "sigma": 5},
    {"name": "jpeg-q20", "kind": "jpeg", "quality": 20, "sigma": 15},
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    print(f"{'condition':10s} {'noisy':>7s} {'deno':>7s} {'gain':>6s}")
    rows = []
    for cond in CONDITIONS:
        noisy, deno = run_condition(cond, fast=args.fast, device=args.device)
        rows.append((cond["name"], noisy, deno))
        print(f"{cond['name']:10s} {noisy:7.2f} {deno:7.2f} {deno - noisy:+6.2f}")
    return rows


if __name__ == "__main__":
    main()
