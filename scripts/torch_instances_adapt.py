"""Per-video test-time instance adaptation study of the PyTorch port, the
twin of ``scripts/instances_adapt.py`` (reference
instances_adapt.py:307-516): load a video, split its frames into an adapt
and an eval set, fine-tune a pretrained denoiser with a self-supervised
loss (f2f / f2f_plus / stnls / sup / none), then evaluate on the held-out
frames, sweeping a config grid through the port's cached experiment runner
(``.cache_f2f_torch/instances_adapt``).

Raw bursts come as ``.npy`` (a packed (T, H, W, 4) video or a (T, H, W)
mosaic stack); a directory of ``.dng`` / ``.tif`` frames or a ``.tiff``
stack needs ``tifffile`` or PIL, imported only where such a file is read.

    python scripts/torch_instances_adapt.py [--device cpu|cuda|cuda:N]

Without ``--device`` the runs take the CUDA card; on a host without one,
pass ``--device cpu`` (``main(device="cpu")`` from Python).
"""

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def split_vids(noisy, clean, ntrain):
    """Frame split: first ntrain frames adapt, the rest evaluate
    (instances_adapt.py:169-175)."""
    return ((noisy[:, :ntrain], clean[:, :ntrain]),
            (noisy[:, ntrain:], clean[:, ntrain:]))


def load_raw_burst(cfg):
    """Decode a raw camera burst into a packed (T, H/2, W/2, 4) video in
    [0, 1]: the reference's Canon burst ingestion (instances_adapt.py:91-158)
    without its hard-coded path.

    ``raw_path``: a packed ``.npy`` (T, H, W, 4); a mosaic ``.npy`` or
    ``.tiff`` stack (T, H, W); or a directory of per-frame raw mosaics
    (.dng/.tif/.tiff, read with tifffile where it imports, else PIL).
    ``raw_black_level`` / ``raw_white_level`` normalize sensor counts;
    ``use_anscombe`` applies the variance-stabilizing transform
    (instances_adapt.py:79-89).
    """
    from frame2frame_tpu_torch.config import optional
    from frame2frame_tpu_torch.data.datasets import pack_raw_bayer
    from frame2frame_tpu_torch.data.noise import anscombe

    def read_raw(p):
        try:
            import tifffile

            return np.asarray(tifffile.imread(str(p)), np.float32)
        except ImportError:
            from PIL import Image

            return np.asarray(Image.open(str(p)), np.float32)

    path = Path(cfg["raw_path"])
    if path.is_dir():
        files = sorted(p for p in path.iterdir()
                       if p.suffix.lower() in (".dng", ".tif", ".tiff"))
        if not files:
            raise FileNotFoundError(f"no raw frames in {path}")
        arr = pack_raw_bayer(np.stack([read_raw(p) for p in files]))
    else:
        arr = (np.load(path).astype(np.float32) if path.suffix == ".npy"
               else read_raw(path))
        if arr.ndim == 3 and arr.shape[-1] != 4:  # mosaic stack (T, H, W)
            arr = pack_raw_bayer(arr)
        elif arr.ndim == 2:
            arr = pack_raw_bayer(arr[None])
    black = float(optional(cfg, "raw_black_level", 0.0))
    white = float(optional(cfg, "raw_white_level", float(arr.max())))
    arr = np.clip(arr - black, 0.0, None) / max(white - black, 1e-8)
    if optional(cfg, "use_anscombe", False):
        # photon-scale the normalized values before stabilizing
        gain = float(optional(cfg, "anscombe_gain", 1000.0))
        arr = anscombe(arr * gain) / anscombe(np.asarray(gain))
    return arr.astype(np.float32)


def get_videos(cfg, device=None):
    """Load (noisy, clean) videos (B=1, T, H, W, C) in [0, 1], numpy."""
    from frame2frame_tpu_torch.config import optional
    from frame2frame_tpu_torch.data import sets

    raw_path = optional(cfg, "raw_path", None)
    if raw_path:  # raw bursts: no clean reference exists (self-supervised)
        noisy = load_raw_burst(cfg)[None]
        return noisy, noisy.copy()
    data, _ = sets.load(cfg, device=device)
    sample = data.te[optional(cfg, "vid_index", 0)]
    return (sample["noisy"][None] / 255.0, sample["clean"][None] / 255.0)


def set_pretrained_path(cfg):
    """sigma -> pretrained-checkpoint selection (instances_adapt.py:348-379):
    a JSON table ``{net_name: {sigma: file}}`` at
    ``pretrained_root/sigma_table.json``, else the file
    ``{net_name}-sigma{sigma}.msgpack``; sets cfg.pretrained_path (and
    pretrained_load) when a checkpoint is found."""
    import json

    from frame2frame_tpu_torch.config import optional

    root = optional(cfg, "pretrained_root", None)
    if not root:
        return cfg
    root = Path(root)
    net = cfg.get("net_name", "dncnn")
    sigma = cfg.get("sigma", 25)
    table_path = root / "sigma_table.json"
    name = None
    if table_path.exists():
        table = json.loads(table_path.read_text())
        name = table.get(net, {}).get(str(sigma))
    if name is None:
        cand = root / f"{net}-sigma{sigma}.msgpack"
        name = cand.name if cand.exists() else None
    if name is not None:
        cfg["pretrained_path"] = str(root / name)
        cfg["pretrained_load"] = True
    return cfg


def run_training(cfg, state, noisy, clean, sched=None):
    """Adapt with the configured loss (instances_adapt.py:195-236): BN frozen
    in eval during adaptation (:200-206), Adam + cosine schedule (:184-193)."""
    from frame2frame_tpu_torch import get_loss_fxn

    loss_fxn = get_loss_fxn(cfg, cfg.get("loss_type", "f2f"))
    return loss_fxn(state, noisy, clean, sched=sched)


def run_testing(cfg, state, noisy, clean):
    """Chunked eval forward (the port's ``eval/chunks.py``) + metrics on the
    host (instances_adapt.py:239-305)."""
    import torch

    from frame2frame_tpu_torch.eval.chunks import chunk, extract_chunks_config
    from frame2frame_tpu_torch.utils.metrics import compute_psnrs, compute_ssims

    def fwd(vid, fl=None):
        B, T = vid.shape[:2]
        out = state.eval_apply(vid.reshape((B * T,) + tuple(vid.shape[2:])))
        return out.reshape(tuple(vid.shape[:2]) + tuple(out.shape[1:]))

    fwd_fxn = chunk(extract_chunks_config(cfg), fwd)
    vid = torch.as_tensor(np.asarray(noisy), dtype=state.dtype,
                          device=state.device)
    deno = fwd_fxn(vid).clamp(0.0, 1.0).float().cpu().numpy()
    return {
        "psnrs": compute_psnrs(deno, np.asarray(clean), div=1.0).tolist(),
        "ssims": compute_ssims(deno, np.asarray(clean), div=1.0).tolist(),
    }


def run(cfg, device=None):
    """One experiment (instances_adapt.py:307-344) on ``device`` (None: the
    CUDA card)."""
    from frame2frame_tpu_torch.config import Config, optional
    from frame2frame_tpu_torch.models import load_model
    from frame2frame_tpu_torch.train.schedules import make_optimizer
    from frame2frame_tpu_torch.train.state import TrainState
    from frame2frame_tpu_torch.utils.device import resolve_device
    from frame2frame_tpu_torch.utils.misc import set_seed

    cfg = Config(cfg)
    device = resolve_device(device)
    set_seed(optional(cfg, "seed", 123))
    set_pretrained_path(cfg)

    noisy, clean = get_videos(cfg, device)
    ntrain = optional(cfg, "ntrain_frames", max(noisy.shape[1] // 2, 3))
    (tr_n, tr_c), (te_n, te_c) = split_vids(noisy, clean, ntrain)

    ms = load_model(cfg, device=device)
    ocfg = Config(cfg)
    ocfg.scheduler_name = "cosa"
    ocfg.nepochs = optional(cfg, "adapt_nepochs", 1)
    ocfg.lr_init = optional(cfg, "adapt_lr", 1e-4)
    tx, sched = make_optimizer(ocfg)
    state = TrainState.create(ms.model, ms.variables, tx, residual=True)

    if cfg.get("loss_type", "f2f") != "none":
        state, info = run_training(cfg, state, tr_n, tr_c, sched=sched)
    else:
        info = Config(loss=[], lr=[])

    results = run_testing(cfg, state, te_n, te_c)
    results["adapt_loss"] = list(map(float, info.get("loss", [])))
    return results


def collect_grids():
    """The sweep grids (instances_adapt.py:388-434)."""
    base = {
        "net_name": "dncnn", "channels": 1, "num_of_layers": 9,
        "dname": "synthetic", "nvideos": 1, "nframes_data": 8,
        "isize_data": [96, 96], "ntype": "g", "sigma": 25,
        "adapt_isize": "64_64", "adapt_nepochs": 1, "nbatch_sample": 1,
        "spatial_chunk_size": 256, "spatial_chunk_overlap": 0.1,
        "temporal_chunk_size": 3,
    }
    grids = [{"loss_type": ["f2f", "sup", "none"]}]
    return base, grids


def main(device=None, grids=None):
    """Sweep ``collect_grids()`` (or ``grids``: ``(base, grids)``) and print
    each run's mean PSNR."""
    from frame2frame_tpu_torch import cache

    base, grid = grids or collect_grids()
    exps = cache.load_edata(base, grid)
    records = cache.run_exps(exps, run, cache_dir=cache.CACHE_DIR,
                             proj_name="instances_adapt", device=device)
    for rec in records:
        res = rec.get("results", {})
        psnrs = res.get("psnrs", [])
        tag = rec["cfg"].get("loss_type", "?")
        if psnrs:
            print(f"{tag:8s} psnr={np.mean(psnrs):.2f}")
    return records


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
