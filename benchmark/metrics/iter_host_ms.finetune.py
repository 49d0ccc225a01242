"""The mean host time of one update of the fine-tune step in the profiled
slice: the program's ``online.iter`` span (``train/flat_step.py``
``run_flat_scan``), which issues the update's forward, backward and
optimizer kernels, in ms."""

from benchmark import program_trace


def read(run):
    d = program_trace.durations(run, "online.iter")
    return sum(d) / len(d) * 1e3 if d else None
