"""A fine-tuned frame's model operations (its updates' forwards and
backwards and its eval denoise, counted from shapes by ``flops.py``) over
the mean wall time of a frame outside the profiled slice, the cell's cards
and the configuration's peak, in percent."""

from benchmark.reduce import mfu_percent


def read(run):
    return mfu_percent(run, run.counters["flops_per_item"])
