"""The benchmark's core, driven by ``BENCHMARK.json`` and by files found by
name:

- a cell (an entry of ``workloads``) names its configuration, whose file
  (``configs/<config>.json``) holds the model and its source, and its
  traffic mix, ``traffic/<mix>.json``, which names the runner of its kind
  (``runners/<runner>.py``) and holds its parameters;
- ``limits/<cell>.json`` holds the limit of each number that decides
  ``correct``;
- each metric is read by ``metrics/<metric>.py``'s ``read(run)``, which
  returns a number or None where it finds nothing to read.

A runner is a module with ``setup(config, params, seed, devices, spans)``
-> state, ``window(state, seconds, slice_)`` -> records (one a frame or a
call: ``t0``, ``t1``, ``items``, ``traced``), ``counters(state)`` -> dict,
and ``judge(state)`` -> {number: value}, which frees the program and runs
the plain reference. Nothing here names a cell, a configuration or a
metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from . import trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "frame2frame_tpu")


def load_spec(root=ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(spec, name):
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(spec, name, root=ROOT):
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_of(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits_of(cell):
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def runner(name):
    return importlib.import_module(f"benchmark.runners.{name}")


def reader(metric):
    """``metrics/<metric>.py`` as a module (a metric's name may hold dots,
    so it is loaded by its path)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(spec, cell, overrides=None):
    """(workload entry, configuration, traffic parameters with
    ``overrides`` replaced, runner module) of ``cell``."""
    w = workload(spec, cell)
    mix = traffic_of(w["traffic"])
    return (w, config_of(spec, w["config"]),
            {**mix["params"], **(overrides or {})}, runner(mix["runner"]))


def metrics_of(spec, cell, traced):
    """The cell's metrics: its end-to-end ones untraced, its per-layer ones
    traced; a metric without ``workloads`` belongs to every cell."""
    group = spec["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules():
    """Top-level names of loaded modules that the program may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(res.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def card_state():
    """The card's SM and memory clocks (MHz), temperature (C) and power
    draw (W), as ``nvidia-smi`` reads them, for the log; None where it
    cannot."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
             "temperature.gpu,power.draw", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def host_state():
    """What the host did to this process, for the log: its context
    switches, voluntary and forced, its minor page faults, the load
    average, and the CPU the main thread last ran on."""
    import os
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        cpu = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                  .split()[36])
    except (OSError, IndexError, ValueError):
        cpu = None
    return {"vcsw": ru.ru_nvcsw, "ivcsw": ru.ru_nivcsw,
            "minflt": ru.ru_minflt, "load1": os.getloadavg()[0], "cpu": cpu}


def _number(v):
    """``v`` for the result line: a non-finite reading as its name, which
    JSON has no number for."""
    return v if v is None or math.isfinite(v) else str(v)


def quarter_medians(records):
    """The median latency (ms) of each quarter of the window's records."""
    out = []
    for k in range(4):
        part = sorted(r["t1"] - r["t0"] for r in
                      records[k * len(records) // 4:
                              (k + 1) * len(records) // 4])
        if part:
            out.append(part[len(part) // 2] * 1e3)
    return out


class Run:
    """What the metric readers read: the cell's configuration and traffic
    parameters, the records of the window, its host spans, the runner's
    counters, the traced slice (None untraced), the number of cards."""

    def __init__(self, config, params, records, spans, counters, slice_,
                 cards, window_s):
        self.config, self.params = config, params
        self.records, self.spans = records, spans
        self.counters, self.trace = counters, slice_
        self.cards, self.window_s = cards, window_s


def run_cell(cell, seed, seconds, traced, t_start, devices=None,
             overrides=None, log=print):
    """One run of ``cell``: set-up, the window, the judgement; returns the
    result line's object. ``devices``: None takes the cards the cell asks
    for (``run.py`` has checked that there are enough); tests pass the CPU.
    ``overrides``: traffic parameters replaced (tests run small sizes)."""
    import torch

    spec = load_spec()
    w, config, params, drv = cell_parts(spec, cell, overrides)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(w["chips"])]
    cuda = devices[0].type == "cuda"
    spans = trace.Spans()
    state = drv.setup(config, params, seed, devices, spans)
    if cuda:
        for d in devices:
            torch.cuda.synchronize(d)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in state.setup_parts.items()))
    slice_ = trace.Slice(traced and cuda, seconds * params["trace_from"],
                         params["trace_items"])
    slice_.warm()
    card0 = card_state() if cuda else None
    host0 = host_state()
    t0 = time.perf_counter()
    records = drv.window(state, seconds, slice_)
    slice_.stop()
    host1 = host_state()
    log("host over the window: " + ", ".join(
        f"{k} {host1[k] - host0[k]}" for k in ("vcsw", "ivcsw", "minflt"))
        + f", load {host0['load1']:.2f} -> {host1['load1']:.2f}, cpu "
        f"{host0['cpu']} -> {host1['cpu']}; card (SM MHz, mem MHz, C, W) "
        f"{card0} -> {card_state() if cuda else None}")
    window_s = records[-1]["t1"] - t0
    peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
            if cuda else 0)
    counters = drv.counters(state)
    tr = None
    if slice_.prof is not None:
        t_r = time.perf_counter()
        tr = trace.reduce(slice_.prof, slice_.host, spans.done, slice_.count,
                          len(devices))
        slice_.prof = None
        log(f"trace reduced in {time.perf_counter() - t_r:.1f} s: "
            f"{len(tr['ops'])} device operations over {tr['items']} items, "
            f"markers {tr['markers']} found, the closing one "
            f"{tr['lag_s'] * 1e3:.2f} ms after its clock read")
    run = Run(config, params, records, spans, counters, tr, len(devices),
              window_s)
    log(f"window {window_s:.3f} s, {len(records)} records; median ms by "
        "quarter: " + ", ".join(f"{q:.2f}" for q in quarter_medians(records))
        + "; host spans, mean ms: " + ", ".join(
            f"{n} {sum(d) / len(d) * 1e3:.2f}" for n in sorted(
                {n for n, _, _ in spans.done})
            if (d := spans.durations(n, since=t0))))
    metrics = {}
    for m in metrics_of(spec, cell, traced):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t_j = time.perf_counter()
    numbers = drv.judge(state)
    log(f"reference and comparison {time.perf_counter() - t_j:.1f} s")
    limits = limits_of(cell)
    correct = set(numbers) == set(limits) and all(
        numbers[k] <= limits[k] for k in limits)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": (torch.cuda.get_device_name(devices[0]) if cuda
                       else "cpu"),
              "count": len(devices), "memory_peak_bytes": peak}
    if cuda:
        device["power_limit_w"] = power_limit_w()
    if tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
    out = {"correct": correct,
           "attempted": sum(r["items"] for r in records),
           "failed": 0,  # an item that raises ends the run
           "metrics": metrics, "device": device}
    if tr is not None:
        out["breakdown"] = trace.breakdown(tr)
    out["checks"] = {k: {"value": _number(numbers.get(k)),
                         "limit": limits.get(k)}
                     for k in sorted(set(numbers) | set(limits))}
    return out
