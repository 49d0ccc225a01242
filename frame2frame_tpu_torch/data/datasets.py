"""Video dataset registry.

Counterpart of ``frame2frame_tpu/data/datasets.py``, the replacement for
the reference's external ``data_hub.sets.load`` + ``filter_subseq``
(test.py:127-130): named datasets of video sequences with frame-subrange
selection, noise synthesis, and optional precomputed flows.

Two built-in families:
- ``dir``: directory-backed datasets (derf-hd/set8/davis-style layout:
  ``root/<vid_name>/<frame>.png``; ``.pgm`` frames are read without PIL);
- ``synthetic``: seeded on-the-fly moving-texture sequences (used by the
  tests and the smoke run; no external data required), the same bits as
  the JAX package's.

Samples are Config dicts with the harness's field names: noisy, clean,
fnums, index, region (lightning.py:290-301, test.py:143-147). Videos are
(T, H, W, C) float32 numpy arrays in [0, 255]. A sample's noise is drawn
from a ``torch.Generator`` seeded with ``split_seed * 7919 + index``, the
integer the JAX package seeds its PRNG key with.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import Config, optional
from ..flow import api as flow_api
from ..io.flo import read_flo, write_flo
from .noise import choose_noise_transform


def pack_raw_bayer(raw):
    """Pack a Bayer mosaic (T, H, W) into 4 half-resolution color planes
    (T, H/2, W/2, 4) — the raw-burst packing of the reference's instance
    adaptation study (instances_adapt.py:125-129, RGGB order)."""
    raw = np.asarray(raw)
    if raw.ndim == 2:
        raw = raw[None]
    return np.stack(
        [raw[:, 0::2, 0::2], raw[:, 0::2, 1::2],
         raw[:, 1::2, 0::2], raw[:, 1::2, 1::2]],
        axis=-1,
    )


def synthetic_video(seed, nframes=10, h=128, w=128, channels=1, shift=(1, 1),
                    texture="smooth"):
    """Seeded moving texture, (T, H, W, C) float32 in [0, 255].

    ``texture``:
    - "smooth" (default): single-scale Gaussian-filtered noise — cheap, the
      unit-test fixture;
    - "mixed": multi-scale detail + hard edges (random step/disc structures)
      — a richer clean-image manifold for production-scale pretraining,
      where a denoiser must learn to preserve edges, not just smooth.
    """
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    dy, dx = shift
    pad = max(abs(dy), abs(dx)) * nframes + 4
    Hp, Wp = h + 2 * pad, w + 2 * pad
    if texture == "smooth":
        base = gaussian_filter(rng.random((Hp, Wp)) * 255, 3.0)
    else:
        # multi-scale pink-ish noise...
        base = np.zeros((Hp, Wp))
        for s, amp in ((1.0, 0.5), (2.0, 1.0), (4.0, 2.0), (8.0, 4.0)):
            base += amp * gaussian_filter(rng.standard_normal((Hp, Wp)), s)
        # ...plus hard-edged structures (steps and discs)
        yy, xx = np.mgrid[0:Hp, 0:Wp]
        for _ in range(rng.integers(4, 9)):
            kind = rng.integers(2)
            lvl = rng.uniform(-6, 6)
            if kind == 0:  # half-plane step at a random angle/offset
                th = rng.uniform(0, np.pi)
                c = rng.uniform(0.3, 0.7) * (Hp * np.sin(th) + Wp * np.cos(th))
                base += lvl * (yy * np.sin(th) + xx * np.cos(th) > c)
            else:  # disc
                cy, cx = rng.uniform(0, Hp), rng.uniform(0, Wp)
                r = rng.uniform(0.05, 0.3) * min(Hp, Wp)
                base += lvl * ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
    base = 255 * (base - base.min()) / max(base.max() - base.min(), 1e-9)
    frames = []
    for t in range(nframes):
        y0 = pad + dy * t
        x0 = pad + dx * t
        f = base[y0 : y0 + h, x0 : x0 + w].astype(np.float32)
        frames.append(np.repeat(f[..., None], channels, axis=-1))
    return np.stack(frames)


class VideoDataset:
    """A split: list of samples, each a full video (noise added lazily,
    seeded).

    With ``cfg.read_flows`` true, samples carry precomputed ``fflow``/
    ``bflow`` fields like the reference datasets (lightning.py:299-301,
    test.py:157-162): TV-L1 flows solved once from the clean video on
    ``device`` (None: the CUDA card, raising where there is none; only a
    solve needs it) and cached — as ``.flo`` sidecars under
    ``<video_dir>/.flows/`` for directory-backed videos (``flow_dirs``), the
    files the JAX package reads and writes, in memory otherwise.
    """

    def __init__(self, videos, names, cfg, split_seed=0, flow_dirs=None,
                 device=None):
        self._videos = videos  # list of callables () -> (T,H,W,C) clean
        self.names = names
        self.cfg = cfg
        self.noise = choose_noise_transform(cfg)
        self.split_seed = split_seed
        self.groups = names  # data_hub-compatible alias
        self.flow_dirs = flow_dirs or [None] * len(videos)
        self.device = device
        self._flow_cache = {}

    def __len__(self):
        return len(self._videos)

    def _flows(self, index, clean):
        """fflow/bflow (T, H, W, 2) for video ``index``; solved once,
        cached."""
        if index in self._flow_cache:
            return self._flow_cache[index]
        fdir = self.flow_dirs[index]
        T = clean.shape[0]
        if fdir is not None:
            fdir = Path(fdir) / ".flows"
            paths = [(fdir / f"f_{t:05d}.flo", fdir / f"b_{t:05d}.flo")
                     for t in range(T)]
            if all(pf.exists() and pb.exists() for pf, pb in paths):
                ff = np.stack([read_flo(pf) for pf, _ in paths])
                bf = np.stack([read_flo(pb) for _, pb in paths])
                self._flow_cache[index] = (ff, bf)
                return ff, bf
        flows = flow_api.run_flows(clean[None], device=self.device)
        ff = flows.fflow[0].cpu().numpy().astype(np.float32)
        bf = flows.bflow[0].cpu().numpy().astype(np.float32)
        if fdir is not None:
            fdir.mkdir(parents=True, exist_ok=True)
            for t in range(T):
                write_flo(fdir / f"f_{t:05d}.flo", ff[t])
                write_flo(fdir / f"b_{t:05d}.flo", bf[t])
        self._flow_cache[index] = (ff, bf)
        return ff, bf

    def __getitem__(self, index):
        clean = np.asarray(self._videos[index](), dtype=np.float32)
        gen = torch.Generator().manual_seed(self.split_seed * 7919 + index)
        # msg noise draws a per-sample sigma; the sample must carry the DRAWN
        # value so dd_in=4 sigma-map channels match the actual corruption
        # (reference lightning.py:129-141)
        if getattr(self.noise, "ntype", "") == "msg":
            # the [None] makes the whole video one "sample": a single sigma
            # is drawn for all frames (reference: one sigma per batch element)
            noisy, sigma = self.noise(gen, torch.from_numpy(clean)[None],
                                      return_sigma=True)
            noisy = noisy[0]
            sigma = float(sigma.reshape(-1)[0])
        else:
            noisy = self.noise(gen, torch.from_numpy(clean))
            sigma = getattr(self.noise, "sigma", 0.0)
        T = clean.shape[0]
        sample = Config(
            noisy=noisy.numpy().astype(np.float32),
            clean=clean,
            fnums=np.arange(T),
            index=index,
            region=None,
            sigma=sigma,
            vid_name=self.names[index],
        )
        if optional(self.cfg, "read_flows", False):
            ff, bf = self._flows(index, clean)
            sample.fflow = ff
            sample.bflow = bf
        return sample


def _load_dir_split(root, cfg, split_seed, device=None):
    from ..io.video import load_video_dir

    root = Path(root)
    vids = sorted(p for p in root.iterdir() if p.is_dir())
    names = [p.name for p in vids]

    def make_loader(p):
        def load():
            v = load_video_dir(p)
            if v.ndim == 3:
                v = v[..., None]
            return v

        return load

    return VideoDataset([make_loader(p) for p in vids], names, cfg, split_seed,
                        flow_dirs=vids, device=device)


def _load_synthetic_split(cfg, split_seed, device=None):
    n = optional(cfg, "nvideos", 3)
    nframes = optional(cfg, "nframes_data", 10)
    h, w = optional(cfg, "isize_data", (128, 128))
    channels = optional(cfg, "channels", 1)
    texture = optional(cfg, "texture", "smooth")
    names = [f"vid{i:02d}" for i in range(n)]
    makers = [
        (lambda s: (lambda: synthetic_video(s, nframes, h, w, channels,
                                            texture=texture)))(
            1000 * split_seed + i
        )
        for i in range(n)
    ]
    return VideoDataset(makers, names, cfg, split_seed, device=device)


def load(cfg, device=None):
    """Load a dataset by cfg.dname -> (data, loaders).

    data: Config(tr=..., val=..., te=...) of VideoDataset splits, whose
    flows (``read_flows``) solve on ``device``.
    loaders: simple iteration helpers (batch-of-one), mirroring data_hub's
    return convention (test.py:127).
    """
    dname = optional(cfg, "dname", "synthetic")
    if dname in ("synthetic", "toy"):
        data = Config({k: _load_synthetic_split(cfg, s, device)
                       for s, k in enumerate(("tr", "val", "te"))})
    else:  # directory-backed (derf-hd / set8 / davis style)
        root = Path(optional(cfg, "data_root", "./data")) / dname
        if not root.exists():
            raise FileNotFoundError(
                f"dataset root {root} not found (dname={dname}); use dname="
                f"'synthetic' or provide data_root/<dname>/<vid>/frames"
            )
        data = Config({k: _load_dir_split(root, cfg, s, device)
                       for s, k in enumerate(("tr", "val", "te"))})
    # cfg.batch_size > 1 collates that many samples per TRAIN batch (val/te
    # stay batch-of-one like data_hub)
    bs = optional(cfg, "batch_size", 1)
    loaders = Config({k: _SimpleLoader(v, batch_size=(bs if k == "tr" else 1))
                      for k, v in data.items()})
    return data, loaders


class _SimpleLoader:
    """Batching iterator over a VideoDataset.

    batch_size=1 yields each sample with a leading singleton batch axis
    (data_hub's convention, test.py:127). batch_size>1 stacks same-shaped
    video samples along a new batch axis and DROPS the trailing partial
    batch, so every step sees the full batch size; non-array fields are
    collected into lists. A split smaller than the batch would yield no
    batch at all (the JAX package then trains nothing and writes untrained
    checkpoints): iterating one raises ``ValueError``.
    """

    def __init__(self, dset, batch_size=1):
        self.dset = dset
        self.batch_size = max(int(batch_size), 1)

    def _collate(self, samples):
        out = Config()
        for k in samples[0]:
            vals = [s[k] for s in samples]
            if getattr(vals[0], "ndim", 0) >= 3:
                out[k] = np.stack(vals)
            else:
                out[k] = vals[0] if len(vals) == 1 else vals
        return out

    def __iter__(self):
        bs = self.batch_size
        if bs > len(self.dset):
            raise ValueError(f"batch_size {bs} exceeds the split's "
                             f"{len(self.dset)} samples: no batch")
        if bs == 1:
            for i in range(len(self.dset)):
                s = self.dset[i]
                yield Config({k: (v[None] if getattr(v, "ndim", 0) >= 3
                                  else v) for k, v in s.items()})
            return
        for j in range(len(self.dset) // bs):
            yield self._collate([self.dset[j * bs + b] for b in range(bs)])

    def __len__(self):
        return len(self.dset) // self.batch_size


def filter_subseq(dset, vid_name, frame_start, frame_end):
    """Indices of dataset samples matching ``vid_name`` restricted to the
    frame range — equivalent of ``data_hub.filter_subseq`` (test.py:128-129).

    Mutates nothing; returns indices whose sample will be sliced by the
    caller via ``slice_sample``.
    """
    return [i for i, n in enumerate(dset.names)
            if n == vid_name or vid_name in n]


def slice_sample(sample, frame_start=0, frame_end=-1):
    """Restrict a sample's videos to [frame_start, frame_end] inclusive."""
    if frame_end < 0:
        return sample
    sl = slice(frame_start, frame_end + 1)
    out = Config(sample)
    for k in ("noisy", "clean", "fflow", "bflow"):
        if k in sample:
            out[k] = sample[k][sl]
    out.fnums = sample.fnums[sl]
    return out
