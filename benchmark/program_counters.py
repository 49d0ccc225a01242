"""The program's own counters (``frame2frame_tpu_torch.utils.profiling``),
which it adds to only while a profiler runs: in a run of the benchmark,
the traced slice."""

from __future__ import annotations


def per_item(run, name):
    """The program's counter ``name`` over the traced slice's items; None
    untraced, or where the program has no recorder or no such counter."""
    if run.trace is None or not run.trace["items"]:
        return None
    try:
        from frame2frame_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    value = recorded()["counters"].get(name)
    return None if value is None else value / run.trace["items"]
