"""Stage timers (``ExpTimer``, ``TimeIt``: the replacement for
dev_basics.utils.timer, reference test.py:24,135) and device timing with CUDA
events (``cuda_time_ms``)."""

from __future__ import annotations

import statistics
import time

import torch


class ExpTimer:
    """Named wall-clock stage timer. ``timer_<name>`` keys mirror the
    reference's result columns (test.py:109-112)."""

    def __init__(self):
        self._start = {}
        self.times = {}

    def start(self, name):
        self._start[name] = time.perf_counter()

    def stop(self, name):
        dt = time.perf_counter() - self._start.pop(name)
        self.times[f"timer_{name}"] = self.times.get(f"timer_{name}", 0.0) + dt
        return dt

    def items(self):
        return self.times.items()

    def __getitem__(self, name):
        return self.times[name]

    def __contains__(self, name):
        return name in self.times


class TimeIt:
    """Context manager: ``with TimeIt(timer, "flow"): ...`` (reference
    test.py:157). With ``sync`` it waits for the CUDA device before the clock
    stops, so queued device work counts (the JAX package's
    ``effects_barrier``); where CUDA was never initialised, as on a host
    without a card, there is nothing to wait for."""

    def __init__(self, timer, name, sync=True):
        self.timer = timer
        self.name = name
        self.sync = sync

    def __enter__(self):
        self.timer.start(self.name)
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.timer.stop(self.name)
        return False


def cuda_time_ms(fn, iters=20, repeats=3, warmup=3, head_start_cycles=0):
    """Milliseconds per call of ``fn()`` on the current CUDA stream: CUDA
    events around ``iters`` back-to-back calls, so host work overlaps the
    device as it does in a chain of layers; the median of ``repeats`` such
    runs, after ``warmup`` untimed calls.

    ``head_start_cycles``: the device first spins for that many clock cycles,
    ahead of the first event, while the host queues the calls. For a kernel
    shorter than its wrapper's host time the events then measure the device
    and not the host's queueing."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if head_start_cycles:
            torch.cuda._sleep(head_start_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)
