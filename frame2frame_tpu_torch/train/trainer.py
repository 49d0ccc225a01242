"""Offline training loop — counterpart of ``frame2frame_tpu/train/trainer.py``,
the replacement for the external ``dev_basics.trte.train.run`` +
PyTorch-Lightning Trainer the reference launchers depend on
(scripts/trte_dncnn/train.py:20,39-45), with MetricsCallback-style
accumulation (lightning.py:554-601) and checkpoints.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import Config, optional
from ..data import sets
from ..models import load_model
from ..models.serialization import save_variables
from ..ops.fused_spatial import as_device
from ..parallel.data import DataParallel
from ..parallel.mesh import data_parallel_mesh
from ..utils.device import resolve_device
from .lit import TrainModule
from .schedules import make_optimizer
from .state import TrainState


class MetricsAccumulator:
    """Accumulates per-step/per-epoch metric dicts (MetricsCallback
    equivalent, lightning.py:554-601)."""

    def __init__(self):
        self.metrics = {}

    def append(self, m):
        for k, v in m.items():
            self.metrics.setdefault(k, []).append(v)

    def summary(self):
        return {k: (float(np.mean(v)) if np.ndim(v[0]) == 0 else v)
                for k, v in self.metrics.items()}


class CSVLogger:
    """Streams metric rows to a CSV file (lightning CSVLogger equivalent,
    lightning.py:63). Columns grow as new metric keys appear."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._keys = None
        self._rows = []

    def log(self, metrics):
        row = {k: v for k, v in metrics.items() if np.ndim(v) == 0}
        self._rows.append(row)
        keys = sorted({k for r in self._rows for k in r})
        if keys != self._keys:
            # column set changed: rewrite (rare — only when new metric keys
            # appear); otherwise append one line, O(1) per step
            self._keys = keys
            with open(self.path, "w") as f:
                f.write(",".join(self._keys) + "\n")
                for r in self._rows:
                    f.write(",".join(str(r.get(k, ""))
                                     for k in self._keys) + "\n")
            return
        with open(self.path, "a") as f:
            f.write(",".join(str(row.get(k, "")) for k in self._keys) + "\n")


def run(cfg, device=None, devices=None):
    """Train a model per config on ``device`` (None: the first of
    ``devices``, else the CUDA card, and raises where there is none);
    returns a results Config.

    Config keys: model (net_name/channels/...), data (dname/...), lit
    (crit_name/nepochs/lr_init/...), plus: checkpoint_dir, seed,
    limit_train_batches, log_csv.

    As in the JAX package, the learning-rate schedule's epoch is
    ``len(data.tr)`` updates, the split's sample count, whatever the batch
    size (ADVICE.md: with ``batch_size`` > 1 an epoch holds fewer updates,
    so an epoch schedule runs slower than its name says); the port keeps it
    so that it trains as JAX does at every batch size. Each step draws from
    one ``torch.Generator`` on the device seeded with ``seed``, where JAX
    splits a PRNG key.

    Data parallelism, as in the JAX package: with ``data_parallel`` (True
    by default) each batch's training forward is split over
    ``data_parallel_mesh(batch_size, devices)`` with the whole batch's
    BatchNorm statistics (``parallel/data.py``), so that a step is the
    single-device step. ``devices`` default to ``device`` alone, so that
    the mesh engages only where the caller names its devices: on an H100
    the split step took longer than the whole batch on one card (ROADMAP,
    Queue 3), and the whole batch fits there. A repeated device runs its
    shards one after another; the mesh must start on ``device``. Where the
    mesh is None (one device, a batch of one, or no divisor of the batch
    size above 1) the step runs on ``device``; ``state.data_parallel`` in
    the results holds the mesh, or None.
    """
    cfg = Config(cfg)
    if device is None and devices is not None:
        device = devices[0]
    device = as_device(resolve_device(device))
    mesh = None
    if optional(cfg, "data_parallel", True):
        mesh = data_parallel_mesh(optional(cfg, "batch_size", 1),
                                  [device] if devices is None else devices)
        if mesh is not None and mesh.first != device:
            raise ValueError(f"the data mesh starts on {mesh.first}, the "
                             f"model lives on {device}")
    key = torch.Generator(device).manual_seed(optional(cfg, "seed", 123))

    ms = load_model(cfg, device=device)
    residual = optional(cfg, "residual", True)
    module = TrainModule(cfg, ms.model, residual=residual,
                         video_model=ms.get("video_model", False))
    nepochs = max(optional(cfg, "nepochs", 1), 1)

    data, loaders = sets.load(cfg, device=device)
    spe = max(len(data.tr), 1)
    tx, sched = make_optimizer(module.cfg, steps_per_epoch=spe)
    state = TrainState.create(ms.model, ms.variables, tx, residual=residual)
    if mesh is not None:
        state = state.replace(data_parallel=DataParallel(ms.model, mesh))

    ckpt_dir = Path(optional(cfg, "checkpoint_dir", "./output/checkpoints"))
    uuid = optional(cfg, "uuid", "default")
    limit = optional(cfg, "limit_train_batches", -1)

    acc = MetricsAccumulator()
    csv_logger = None
    if optional(cfg, "log_csv", True):
        csv_logger = CSVLogger(ckpt_dir / f"{uuid}-metrics.csv")
    for epoch in range(nepochs):
        for i, batch in enumerate(loaders.tr):
            if limit > 0 and i >= limit:
                break
            state, metrics = module.training_step(state, batch, epoch, key)
            metrics["lr"] = float(sched(state.step - 1))
            metrics["epoch"] = epoch
            acc.append(metrics)
            if csv_logger is not None:
                csv_logger.log(metrics)

        # validation at epoch end (lightning val loop analogue)
        val = MetricsAccumulator()
        for batch in loaders.val:
            val.append(module.eval_step(state, batch, prefix="val"))
        acc.append(val.summary())

        save_variables(ckpt_dir / f"{uuid}-epoch{epoch:03d}.msgpack",
                       state.variables)

    save_variables(ckpt_dir / f"{uuid}-final.msgpack", state.variables)

    out = Config(acc.summary())
    # summary() averages across epochs; also expose the LAST epoch's value
    # per metric — the one that describes the shipped (final) checkpoint
    out.final = Config({k: (float(v[-1]) if np.ndim(v[-1]) == 0 else v[-1])
                        for k, v in acc.metrics.items()})
    out.state = state
    out.checkpoint = str(ckpt_dir / f"{uuid}-final.msgpack")
    return out
