"""Experiment manager: config grids, uuid-keyed result caching with
skip-done, and a results-to-records collector.

The port's own copy of ``frame2frame_tpu/cache/__init__.py``, the
replacement for the reference's external ``cache_io``
(scripts/trte_dncnn/train.py:33-45, test.py:32-47, instances_adapt.py:433,
512-516): the same uuid for the same config (``config.cfg_uuid``), the same
cache layout (``<cache_dir>/<proj_name>/<uuid>.pkl`` and ``.json``), the
same skip-done and ``clear``, and the same local wandb JSONL.

Where the port departs:

- ``run_exps(..., device=None)`` calls ``run_fn(cfg)`` when ``device`` is
  None (the port's entry points then take the CUDA card) and
  ``run_fn(cfg, device=device)`` when one is given; a dispatched job carries
  its device in the job file, never in the config, so the uuid does not
  depend on it.
- The default cache root is ``.cache_f2f_torch``: the same config has the
  same uuid in both packages, so a shared root would read the JAX
  package's results back as the port's.
- ``_to_plain`` turns tensors into numpy arrays on the host, so that a
  cache written on a card opens on a host without one.

Dispatch backends (``enable_dispatch``): None/"serial" (in-process),
"process" (one interpreter per experiment, one worker per card by default)
and "slurm" (one sbatch job per experiment when the scheduler exists, else
the process pool); see ``cache/dispatch.py``. ``use_wandb`` logs every run's
config and summary through wandb when it imports, else a local
wandb-compatible JSONL logger under ``<cache_dir>/wandb/``.
"""

from __future__ import annotations

import json
import traceback
from pathlib import Path

from ..config import Config, cfg_uuid, mesh_grids
from ..utils.misc import read_pickle, write_pickle

CACHE_DIR = ".cache_f2f_torch"


def get_uuids(exps, cache_dir):
    """Deterministic uuid per experiment config."""
    return [cfg_uuid(e) for e in exps]


def load_edata(base, grids):
    """Expand grids (dict-of-lists or list thereof) over a base config."""
    if isinstance(grids, dict):
        grids = [grids]
    return mesh_grids(base, grids)


class ExpCache:
    """uuid-keyed on-disk result cache (pickle per experiment)."""

    def __init__(self, cache_dir):
        self.root = Path(cache_dir)
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, uuid):
        return self.root / f"{uuid}.pkl"

    def done(self, uuid):
        return self.path(uuid).exists()

    def read(self, uuid):
        return read_pickle(self.path(uuid))

    def write(self, uuid, cfg, results):
        write_pickle(self.path(uuid), {"cfg": dict(cfg), "results": results})
        meta = self.root / f"{uuid}.json"
        meta.write_text(json.dumps({k: str(v) for k, v in cfg.items()},
                                   indent=1))

    def clear(self, uuid):
        self.path(uuid).unlink(missing_ok=True)


class WandbCompatLogger:
    """Local wandb-compatible run logger: one JSONL file per run with
    config + summary. Used when wandb does not import, so ``use_wandb=True``
    always leaves inspectable run logs."""

    def __init__(self, root, project):
        self.root = Path(root) / "wandb" / project
        self.root.mkdir(parents=True, exist_ok=True)

    def log_run(self, uuid, cfg, results):
        path = self.root / f"{uuid}.jsonl"
        with open(path, "w") as f:
            f.write(json.dumps({"event": "init", "run": uuid,
                                "config": {k: str(v) for k, v in cfg.items()}})
                    + "\n")
            f.write(json.dumps({"event": "summary",
                                "summary": _json_safe(results)}) + "\n")


def _json_safe(obj):
    try:
        json.dumps(obj)
        return obj
    except TypeError:
        if isinstance(obj, dict):
            return {k: _json_safe(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_json_safe(v) for v in obj]
        if hasattr(obj, "tolist"):
            return obj.tolist()
        return str(obj)


def _wandb_log(logger_state, cache_root, proj_name, uuid, cfg, results):
    # once-per-experiment marker: resumed sweeps re-walk cached entries on
    # every invocation, which would otherwise create duplicate wandb runs
    marker_dir = Path(cache_root) / "wandb_logged"
    marker = marker_dir / f"{proj_name}.{uuid}"
    # the marker records WHICH sink took the run ("wandb" or "local"), so a
    # run that fell back to the local JSONL logger is upgraded to wandb on a
    # later re-walk
    prev = None
    if marker.exists():
        try:
            prev = marker.read_text().strip() or "wandb"
        except OSError:
            prev = "wandb"
    if prev == "wandb":
        return
    sink = "local"
    try:
        import wandb

        run = wandb.init(project=proj_name, name=uuid, reinit=True,
                         config={k: str(v) for k, v in cfg.items()})
        run.summary.update(_json_safe(results))
        run.finish()
        sink = "wandb"
        if prev == "local":
            # upgraded: drop the fallback JSONL record so the run isn't
            # counted in both sinks
            try:
                (Path(cache_root) / "wandb" / proj_name
                 / f"{uuid}.jsonl").unlink(missing_ok=True)
            except OSError:
                pass
    except Exception:  # wandb missing or not logged in: local JSONL logger
        if prev == "local":
            return  # already captured locally; wandb still unavailable
        if logger_state.get("local") is None:
            logger_state["local"] = WandbCompatLogger(cache_root, proj_name)
        logger_state["local"].log_run(uuid, cfg, results)
    try:
        marker_dir.mkdir(parents=True, exist_ok=True)
        marker.write_text(sink)
    except OSError:
        pass


def call_run_fn(run_fn, cfg, device=None):
    """``run_fn(cfg)``, or ``run_fn(cfg, device=device)`` when a device is
    given."""
    return run_fn(cfg) if device is None else run_fn(cfg, device=device)


def run_exps(exps, run_fn, uuids=None, cache_dir=CACHE_DIR,
             clear=False, skip_loop=False, proj_name="f2f",
             enable_dispatch=None, records_fn=None, use_wandb=False,
             preset_uuids=False, results_fn=None, verbose=True,
             dispatch_nprocs=None, slurm_opts=None, device=None):
    """Run a list of experiment configs through ``run_fn``, caching by
    uuid, skipping completed ones (cache_io.run_exps semantics).

    ``device`` (None, a string or a ``torch.device``): None calls
    ``run_fn(cfg)``, else ``run_fn(cfg, device=device)``, in process or in
    the dispatched jobs. ``enable_dispatch``: "slurm" (sbatch per pending
    experiment; process-pool fallback without a scheduler) or "process"
    (a local pool of interpreters, ``dispatch_nprocs`` of them, by default
    one a card); the shared uuid cache gives cross-job skip-done/resume. A
    run that raises is recorded as ``{"error": traceback}`` and skipped as
    done on the next call, as in the JAX package. ``use_wandb`` logs each
    run's config+summary (wandb if it imports, local JSONL otherwise).

    Returns the list of {"cfg", "results", "uuid"} records.
    """
    cache = ExpCache(Path(cache_dir) / proj_name)
    if uuids is None:
        uuids = get_uuids(exps, cache_dir)
    if device is not None:
        device = str(device)

    if clear:
        for uuid in uuids:
            cache.clear(uuid)

    if enable_dispatch in ("slurm", "process"):
        from . import dispatch as _dispatch

        spec = _dispatch.fn_spec(run_fn)
        jobs = [
            _dispatch.write_job(cache.root / "pending", uuid,
                                dict(cfg, uuid=uuid), spec, cache.root,
                                device=device)
            for cfg, uuid in zip(exps, uuids) if not cache.done(uuid)
        ]
        _dispatch.dispatch(jobs, backend=enable_dispatch,
                           nprocs=dispatch_nprocs, slurm_opts=slurm_opts,
                           verbose=verbose, device=device)

    wandb_state = {}
    records = []
    for cfg, uuid in zip(exps, uuids):
        cfg = Config(cfg)
        cfg.uuid = uuid
        if cache.done(uuid) and not skip_loop:
            rec = cache.read(uuid)
            rec["uuid"] = uuid
            records.append(rec)
            if verbose:
                print(f"[cache] skip {uuid}")
            if use_wandb:
                _wandb_log(wandb_state, Path(cache_dir), proj_name, uuid,
                           rec["cfg"], rec.get("results", {}))
            continue
        if verbose:
            print(f"[run ] {uuid}")
        try:
            results = call_run_fn(run_fn, cfg, device)
        except Exception:
            traceback.print_exc()
            results = {"error": traceback.format_exc()}
        results = _to_plain(results)
        cache.write(uuid, cfg, results)
        records.append({"cfg": dict(cfg), "results": results, "uuid": uuid})
        if use_wandb:
            _wandb_log(wandb_state, Path(cache_dir), proj_name, uuid, cfg,
                       results)
    return records


def _to_plain(obj):
    """Results made picklable on any host: tensors as numpy arrays on the
    host; leaves that are neither plain values nor arrays (a
    ``TrainState``) dropped from their dict."""
    import numpy as np
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            try:
                out[k] = _to_plain(v)
            except Exception:
                continue
        return out
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if hasattr(obj, "tolist") or isinstance(obj, (int, float, str, bool,
                                                  type(None), np.ndarray)):
        return obj
    raise TypeError(type(obj))


def records_to_frame(records):
    """Flatten records to a pandas DataFrame (cache_io results collection);
    pandas is imported here only."""
    import pandas as pd

    rows = []
    for rec in records:
        row = dict(rec["cfg"])
        res = rec.get("results", {})
        for k, v in res.items():
            row[k] = v
        row["uuid"] = rec.get("uuid", "")
        rows.append(row)
    return pd.DataFrame(rows)


class train_stages:
    """Staged-config reader: a JSON file of {base, grids} expanded to
    experiment lists (cache_io.train_stages.run equivalent)."""

    @staticmethod
    def run(path, cache_dir=CACHE_DIR, update=True):
        path = Path(path)
        spec = json.loads(path.read_text())
        exps = load_edata(spec.get("base", {}), spec.get("grids", [{}]))
        return exps, get_uuids(exps, cache_dir)
