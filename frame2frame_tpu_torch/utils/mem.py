"""Device-memory metering (the replacement for dev_basics.utils.gpu_mem,
reference test.py:23,192), read from the CUDA caching allocator's counters
(``torch.cuda.max_memory_allocated`` / ``memory_allocated``) and reported in
GB as the reference's ``(mem_res, mem_alloc)`` pairs. The CPU has no device
memory to meter: ``device="cpu"`` reads zeros, as the JAX package does off an
accelerator. A card that fails to answer raises."""

from __future__ import annotations

import torch

from .device import resolve_device


def device_mem_gb(device=None):
    """(peak_gb, allocated_gb) of ``device``; None means the CUDA card, and
    raises where there is none."""
    device = resolve_device(device)
    if device.type == "cpu":
        return 0.0, 0.0
    return (torch.cuda.max_memory_allocated(device) / 1e9,
            torch.cuda.memory_allocated(device) / 1e9)


def print_peak_gpu_stats(verbose, tag, reset=True, device=None):
    """(peak_gb, allocated_gb), printed when ``verbose``; ``reset`` starts a
    new peak on a card afterwards."""
    device = resolve_device(device)
    peak, alloc = device_mem_gb(device)
    if verbose:
        print(f"[{tag}] peak={peak:.3f}GB alloc={alloc:.3f}GB")
    if reset and device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return peak, alloc


class GpuMemer:
    """Named memory meter; items() yields (name, (mem_res, mem_alloc))."""

    def __init__(self):
        self.mems = {}

    def __setitem__(self, name, val):
        self.mems[name] = val

    def items(self):
        return self.mems.items()


class MemIt:
    """Context manager recording (peak, alloc) after a stage (test.py:192)."""

    def __init__(self, memer, name, device=None):
        self.memer = memer
        self.name = name
        self.device = resolve_device(device)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.memer[self.name] = device_mem_gb(self.device)
        return False
