"""Device kernels the profiled slice ran a frame, summed over the cards:
what the host had to issue."""

from benchmark.reduce import slice_ops


def read(run):
    if run.trace is None or not run.trace["items"]:
        return None
    return len(slice_ops(run)) / run.trace["items"]
