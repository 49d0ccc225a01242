"""Device timing with CUDA events."""

from __future__ import annotations

import statistics

import torch


def cuda_time_ms(fn, iters=20, repeats=3, warmup=3):
    """Milliseconds per call of ``fn()`` on the current CUDA stream: CUDA
    events around ``iters`` back-to-back calls, so host work overlaps the
    device as it does in a chain of layers; the median of ``repeats`` such
    runs, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)
