"""Reductions the metric readers share: rates and tails over the whole
window, the device's idle share and the kernels of the traced slice."""

from __future__ import annotations

import numpy as np

from . import roofline


def rate(run):
    """Items completed over the window's seconds."""
    return sum(r["items"] for r in run.records) / run.window_s


def tail_ms(run, q=95):
    """The ``q``-th percentile of every record's latency, in ms."""
    return float(np.percentile([(r["t1"] - r["t0"]) * 1e3
                                for r in run.records], q))


def untraced_s(run):
    """Mean seconds a record takes outside the profiled slice."""
    ts = [r["t1"] - r["t0"] for r in run.records if not r["traced"]]
    return sum(ts) / len(ts) if ts else None


def mfu_percent(run, ops_per_record):
    """Model operations a record over its mean time and the cards' stated
    peak (the configuration's arithmetic), in percent."""
    t = untraced_s(run)
    if t is None:
        return None
    peak = run.config["peak_flop_per_s"] * run.cards
    return 100.0 * ops_per_record / (t * peak)


def idle_percent(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def is_kernel(name):
    return not name.startswith(("Memcpy", "Memset", "cudaMemcpy"))


def slice_ops(run, match=None):
    """(name, start, end, card) of the slice's kernels (``match`` in the
    name, when given) that began inside the slice."""
    if run.trace is None:
        return []
    lo, hi = run.trace["window"]
    return [o for o in run.trace["ops"]
            if lo <= o[1] < hi and is_kernel(o[0])
            and (match is None or match in o[0])]


def roofline_percent(run, match, bound):
    """The least time of the kernels whose name holds ``match`` (``bound``
    ms a launch, from ``roofline.py``) over the time they took, in
    percent; None where the slice ran none."""
    ops = slice_ops(run, match)
    if not ops:
        return None
    took_ms = sum(e - s for _, s, e, _ in ops) * 1e3
    return 100.0 * len(ops) * bound / took_ms


def mid_layer_bound(run, kind):
    """A mid layer's forward or backward bound (ms a launch) at the cell's
    frame size and batch, in the configuration's chain."""
    p, c = run.params, run.config
    fn = roofline.mid_fwd_layer if kind == "fwd" else roofline.mid_bwd_layer
    ms, _ = fn(p["height"], p["width"], p.get("batch", 1), c["features"],
               c["chain_bytes"], c["precision"])
    return ms
