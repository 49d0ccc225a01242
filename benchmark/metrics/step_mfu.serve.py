"""A call's forward operations (counted from shapes by ``flops.py``) over
the mean wall time of a call outside the profiled slice, the cell's cards and
the configuration's peak, in percent."""

from benchmark.reduce import mfu_percent


def read(run):
    return mfu_percent(run, run.counters["flops_per_call"])
