"""Device timing with CUDA events."""

from __future__ import annotations

import statistics

import torch


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
