"""Sweep dispatch backends for the experiment runner (``cache/__init__.py``):
the reference's ``cache_io.run_exps(..., enable_dispatch="slurm")`` surface
(scripts/trte_dncnn/train.py:42, instances_adapt.py:516). One config a job;
the uuid-keyed cache gives cross-job skip-done and resume.

The port's own copy of ``frame2frame_tpu/cache/dispatch.py``. Backends:

- "slurm": one ``sbatch`` submission per pending experiment (needs the
  ``sbatch`` binary; the job writes its result into the shared cache
  directory, so any host sharing the filesystem takes part);
- "process": a bounded local pool of interpreters, one a job, also the
  fallback when ``sbatch`` is missing.

Where the port departs: every job opens its device and builds the kernels
it launches, so the pool holds one worker a CUDA card by default (the JAX
package takes half the CPU cores), and one with ``device="cpu"``;
``nprocs`` overrides it. Where the job's device is None or ``"cuda"``
without an index, worker slot k runs its jobs with
``CUDA_VISIBLE_DEVICES=k`` (modulo the cards), so each job runs on its own
card; a device with an index is taken as it is. The pool's slots are
threads that wait on their interpreters.

The worker (``python -m frame2frame_tpu_torch.cache.dispatch <job>``)
re-imports the run function by spec ("module::qualname", or
"/path/to/file.py::qualname" for __main__ scripts), calls it with the job's
device (``cache.call_run_fn``) and writes the cache entry itself.
"""

from __future__ import annotations

import os
import pickle
import queue
import shlex
import shutil
import subprocess
import sys
import time
from pathlib import Path

WORKER = "frame2frame_tpu_torch.cache.dispatch"


def fn_spec(run_fn):
    """Importable spec for a function: module::qualname, or file::qualname
    for functions defined in a __main__ script."""
    mod = run_fn.__module__
    if mod == "__main__":
        path = getattr(sys.modules.get("__main__"), "__file__", None)
        if path is None:
            raise ValueError("cannot dispatch a __main__ function without a file")
        return f"{os.path.abspath(path)}::{run_fn.__qualname__}"
    return f"{mod}::{run_fn.__qualname__}"


def load_fn(spec):
    mod_part, qual = spec.split("::")
    if mod_part.endswith(".py"):
        import importlib.util

        name = Path(mod_part).stem
        s = importlib.util.spec_from_file_location(name, mod_part)
        module = importlib.util.module_from_spec(s)
        sys.modules.setdefault(name, module)
        s.loader.exec_module(module)
    else:
        import importlib

        module = importlib.import_module(mod_part)
    fn = module
    for part in qual.split("."):
        fn = getattr(fn, part)
    return fn


def write_job(pending_dir, uuid, cfg, spec, cache_dir, device=None):
    """Serialize one job description (``device``: None or a string, kept
    out of the config); returns its path."""
    pending_dir = Path(pending_dir)
    pending_dir.mkdir(parents=True, exist_ok=True)
    job = pending_dir / f"{uuid}.job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"cfg": dict(cfg), "uuid": uuid, "fn_spec": spec,
                     "cache_dir": str(cache_dir),
                     "device": None if device is None else str(device)}, f)
    return job


def worker_main(job_path):
    """Entry point inside a dispatched job: run the config, write the cache."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    from ..config import Config
    from . import ExpCache, _to_plain, call_run_fn

    run_fn = load_fn(job["fn_spec"])
    cfg = Config(job["cfg"])
    cfg.uuid = job["uuid"]
    try:
        results = _to_plain(call_run_fn(run_fn, cfg, job.get("device")))
    except Exception:
        import traceback

        traceback.print_exc()
        results = {"error": traceback.format_exc()}
    ExpCache(job["cache_dir"]).write(job["uuid"], cfg, results)
    return 0


def _child_env(card=None):
    """The parent's environment with its sys.path on PYTHONPATH, so run
    functions from path-inserted modules (tests, notebook sessions) import
    inside dispatched jobs; ``card``: the one CUDA card the job sees."""
    env = dict(os.environ)
    extra = [p for p in sys.path if p]
    env["PYTHONPATH"] = os.pathsep.join(
        extra + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    if card is not None:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        env["CUDA_VISIBLE_DEVICES"] = (visible.split(",")[card] if visible
                                       else str(card))
    return env


def _submit_slurm(job, slurm_opts):
    env = _child_env()
    script = (f"#!/bin/bash\n"
              f"export PYTHONPATH={shlex.quote(env['PYTHONPATH'])}\n"
              f"{shlex.quote(sys.executable)} -m {WORKER} "
              f"{shlex.quote(str(job))}\n")
    sh = Path(str(job) + ".sh")
    sh.write_text(script)
    cmd = ["sbatch"] + list(slurm_opts or []) + [str(sh)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"sbatch failed: {out.stderr}")
    return out.stdout.strip()


def worker_cards(device=None):
    """The CUDA cards the pool spreads its workers over: the card count
    where ``device`` is None or ``"cuda"`` without an index, else 0 (the
    job's device is taken as it is)."""
    if device is not None and str(device) != "cuda":
        return 0
    import torch

    return torch.cuda.device_count()


def dispatch(jobs, backend="process", nprocs=None, slurm_opts=None,
             poll_s=2.0, timeout_s=24 * 3600, verbose=True, device=None):
    """Run job files through the chosen backend; blocks until all cache
    entries exist (or a local worker fails hard). ``device``: the jobs'
    device, which sizes the process pool (one worker a card, one on the
    CPU or on a given card) unless ``nprocs`` does."""
    jobs = [Path(j) for j in jobs]
    if not jobs:
        return
    if backend == "slurm" and shutil.which("sbatch") is None:
        if verbose:
            print("[dispatch] sbatch not found; falling back to process pool")
        backend = "process"

    if backend == "slurm":
        for j in jobs:
            sid = _submit_slurm(j, slurm_opts)
            if verbose:
                print(f"[dispatch] {j.stem}: {sid}")
        _wait_for_cache(jobs, poll_s, timeout_s)
    elif backend == "process":
        from concurrent.futures import ThreadPoolExecutor

        cards = worker_cards(device)
        nprocs = nprocs or max(cards, 1)
        slots = queue.Queue()
        for k in range(nprocs):
            slots.put(k % cards if cards else None)

        def run(job):
            card = slots.get()
            try:
                return _run_job_subprocess(str(job), card)
            finally:
                slots.put(card)

        ok_jobs = []
        with ThreadPoolExecutor(max_workers=nprocs) as pool:
            futs = [pool.submit(run, j) for j in jobs]
            for j, fu in zip(jobs, futs):
                rc = fu.result()
                if rc == 0:
                    ok_jobs.append(j)
                if verbose:
                    print(f"[dispatch] {j.stem}: rc={rc}")
        # keep the job pickles of failed runs so they can be inspected and
        # re-dispatched (as _wait_for_cache keeps them on a timeout)
        _cleanup_jobs(ok_jobs)
    else:
        raise ValueError(f"unknown dispatch backend [{backend}]")


def _run_job_subprocess(job_path, card=None):
    """Isolate each experiment in its own interpreter (its own CUDA context
    and kernel libraries), on ``card`` where given."""
    out = subprocess.run([sys.executable, "-m", WORKER, job_path],
                         env=_child_env(card))
    return out.returncode


def _wait_for_cache(jobs, poll_s, timeout_s):
    # the (job -> target cache file) mapping is static: read each job pickle
    # once up front instead of on every poll
    targets = {}
    for j in jobs:
        with open(j, "rb") as f:
            meta = pickle.load(f)
        targets[j] = Path(meta["cache_dir"]) / f"{meta['uuid']}.pkl"
    t0 = time.time()
    remaining = set(jobs)
    while remaining and time.time() - t0 < timeout_s:
        done = {j for j in remaining if targets[j].exists()}
        remaining -= done
        if remaining:
            time.sleep(poll_s)
    if remaining:
        raise TimeoutError(f"{len(remaining)} dispatched jobs never completed")
    _cleanup_jobs(jobs)


def _cleanup_jobs(jobs):
    """Remove consumed job artifacts (*.job.pkl and the slurm *.sh shim) so
    repeated sweeps don't accumulate stale pickles under <cache>/pending."""
    for j in jobs:
        for p in (Path(j), Path(str(j) + ".sh")):
            try:
                p.unlink()
            except OSError:
                pass


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1]))
