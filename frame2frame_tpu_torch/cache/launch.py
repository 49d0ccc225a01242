"""The body of the offline launchers (``scripts/torch_trte_dncnn/`` and
``scripts/torch_trte_net/``, each a ``train.py`` and a ``test.py``): expand a
staged config grid (``exps/trte_*/*.cfg``, read, never edited) and run each
experiment through the port's ``train.trainer.run`` or ``eval.test.run``
with uuid-keyed caching and skip-done (cache_io.run_exps semantics,
reference scripts/trte_dncnn/train.py:25-45, test.py:16,32-47).

Results are cached under ``.cache_f2f_torch/<proj_name>`` in the working
directory (the JAX launchers' ``.cache_f2f`` holds the same uuids). The
summary is printed from the records, without pandas.
"""

from __future__ import annotations

import numpy as np

from . import CACHE_DIR, run_exps, train_stages


def records_table(records, cols):
    """The records' ``cols`` (config or result keys, and "uuid") as text
    rows, one a record: the summary of a sweep without pandas."""
    rows = []
    for rec in records:
        row = dict(rec["cfg"], **rec.get("results", {}))
        row["uuid"] = rec.get("uuid", "")
        rows.append("  ".join(f"{c}={row.get(c)}" for c in cols))
    return "\n".join(rows)


def mean_psnrs(records):
    """``[(uuid, mean PSNR)]`` of the records that have PSNRs."""
    out = []
    for rec in records:
        psnrs = rec.get("results", {}).get("psnrs", [])
        if len(psnrs):
            out.append((rec["uuid"], float(np.mean(np.concatenate(
                [np.atleast_1d(p) for p in psnrs])))))
    return out


def _run(cfg_path, proj_name, run_fn, enable_dispatch, use_wandb, device):
    exps, uuids = train_stages.run(cfg_path)
    print(f"Running {len(exps)} experiments")
    return run_exps(exps, run_fn, uuids=uuids, cache_dir=CACHE_DIR,
                    enable_dispatch=enable_dispatch, use_wandb=use_wandb,
                    proj_name=proj_name, device=device)


def train(cfg_path, proj_name, enable_dispatch=None, use_wandb=False,
          device=None, run_fn=None):
    """Train each config of ``cfg_path``; print sigma and the validation
    metrics. ``enable_dispatch`` "process" or "slurm" farms one job per
    config (cache_io.run_exps(..., enable_dispatch="slurm",
    use_wandb=True), scripts/trte_dncnn/train.py:42-45). ``run_fn``
    replaces ``trainer.run``; a dispatched one must be importable by its
    module or file."""
    if run_fn is None:
        from ..train import trainer
        run_fn = trainer.run
    records = _run(cfg_path, proj_name, run_fn, enable_dispatch, use_wandb,
                   device)
    print(records_table(records, ("sigma", "val_psnr", "val_ssim", "uuid")))
    return records


def test(cfg_path, proj_name, enable_dispatch=None, use_wandb=False,
         device=None):
    """Evaluate each config of ``cfg_path``; print each run's mean PSNR."""
    from ..eval import test as evaluate

    records = _run(cfg_path, proj_name, evaluate.run, enable_dispatch,
                   use_wandb, device)
    for uuid, p in mean_psnrs(records):
        print(uuid, "psnr:", p)
    return records


def cli(main):
    """Parse a launcher's command line (``--dispatch process|slurm``,
    ``--wandb``, ``--device cpu|cuda|cuda:N``) and call its ``main``.
    Without ``--device`` the runs take the CUDA card."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dispatch", default=None, choices=["slurm", "process"])
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(enable_dispatch=args.dispatch, use_wandb=args.wandb,
         device=args.device)
