"""Device tracing and memory snapshots for the CLI's ``--profile``.

Counterpart of ``frame2frame_tpu/utils/profiling.py``'s ``trace_if`` and
``write_memory_profile``. The formats are PyTorch's, not JAX's: the trace is
a Chrome trace of ``torch.profiler`` (CPU ops and, on a CUDA card, device
kernels; it opens in Perfetto or ``chrome://tracing``), not an XLA profile,
and the memory profile is a pickled ``torch.cuda.memory`` snapshot (it
opens in PyTorch's memory viz), not a pprof file.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace_if(trace_dir):
    """A ``torch.profiler`` record of the block written to
    ``<trace_dir>/trace.json`` when ``trace_dir`` is set; nothing otherwise.
    The device's kernels are recorded where a CUDA card is present."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def write_memory_profile(path):
    """Write a snapshot of the CUDA caching allocator's memory (segments and
    blocks) to ``path``; raises where there is no CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a device memory snapshot needs "
                           "a card")
    torch.cuda.memory._dump_snapshot(path)
    return path
