"""Device tracing, the program's spans and counters, and memory snapshots
for the CLI's ``--profile``.

Counterpart of ``frame2frame_tpu/utils/profiling.py``'s ``trace_if``,
``annotate`` and ``write_memory_profile``. The formats are PyTorch's, not
JAX's: the trace is a Chrome trace of ``torch.profiler`` (CPU ops and, on a
CUDA card, device kernels; it opens in Perfetto or ``chrome://tracing``),
not an XLA profile, and the memory profile is a pickled ``torch.cuda.memory``
snapshot (it opens in PyTorch's memory viz), not a pprof file.

Spans and counters: ``annotate(name, id=None)`` marks a stage of the
program and ``count(name, n=1)`` adds to a counter. Both record only while a
``torch.profiler`` session runs (in any thread of the process); otherwise
``annotate`` returns one shared null context after a single flag read, and
nothing is recorded or allocated. A span is ``Span(name, parent, id,
thread, t0, t1)``: ``parent`` is the enclosing span's name on the same
thread, ``id`` the frame or call it belongs to (the enclosing span's where
not given), ``thread`` the recording thread's ``threading.get_ident()``,
and ``t0``, ``t1`` are ``time.perf_counter`` seconds. Spans are kept in
memory (``recorded``, ``clear``); ``trace_if`` writes them out.

Device-time counters: ``device_timed(name, fn, x)`` runs ``fn(x)`` and,
while a profiler runs and ``x`` is on a CUDA card, records CUDA events on
the current stream at either end of it, in the forward and, through an
identity autograd function at each end, in the backward; each pair's
elapsed time is added to the counter ``device_ms.<name>`` (ms) once both
events have completed (``resolve_device_times``; ``recorded`` waits for
them).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import namedtuple

import torch
from torch.autograd import profiler as _autograd_profiler

Span = namedtuple("Span", "name parent id thread t0 t1")

_spans = []
_counters = {}
_counters_lock = threading.Lock()
_open = threading.local()  # .stack: the spans open on this thread
_NULL = contextlib.nullcontext()
_pending = []  # (counter, start event, end event) not yet resolved
TIMED_DEVICES = ("cuda",)


@contextlib.contextmanager
def trace_if(trace_dir):
    """A ``torch.profiler`` record of the block written to
    ``<trace_dir>/trace.json``, and the program's spans and counters
    recorded in it to ``<trace_dir>/spans.json``, when ``trace_dir`` is set;
    nothing otherwise. The device's kernels are recorded where a CUDA card
    is present."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    write_spans(os.path.join(trace_dir, "spans.json"))


class _Span:
    __slots__ = ("name", "id", "parent", "t0", "_rf")

    def __init__(self, name, id):
        self.name, self.id = name, id

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        up = stack[-1] if stack else None
        self.parent = up.name if up is not None else None
        if self.id is None and up is not None:
            self.id = up.id
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._rf.__exit__(*exc)
        _open.stack.pop()
        _spans.append(Span(self.name, self.parent, self.id,
                           threading.get_ident(), self.t0, t1))
        return False


def annotate(name, id=None):
    """A span of the program called ``name`` while a profiler runs, and a
    ``torch.profiler.record_function`` region of that name (the JAX
    package's ``TraceAnnotation``), which the profiler keeps on the thread
    that started it; ``id``: the frame or call the span belongs to, by
    default the enclosing span's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, id)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        with _counters_lock:
            _counters[name] = _counters.get(name, 0) + n


def _event(device):
    """A CUDA timing event recorded on ``device``'s current stream."""
    e = torch.cuda.Event(enable_timing=True)
    e.record(torch.cuda.current_stream(device))
    return e


class _Pair:
    """The events at the two ends of one timed call, for its forward and
    then for its backward."""

    __slots__ = ("name", "device", "start")

    def __init__(self, name, device):
        self.name, self.device, self.start = name, device, None

    def begin(self):
        self.start = _event(self.device)

    def end(self):
        stop = _event(self.device)
        with _counters_lock:
            _pending.append((self.name, self.start, stop))


class _Edge(torch.autograd.Function):
    """The identity, marking one end of a timed call: the forward meets the
    first edge first, the backward the last."""

    @staticmethod
    def forward(ctx, x, pair, first):
        ctx.pair, ctx.first = pair, first
        if first:
            pair.begin()
        else:
            pair.end()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.first:
            ctx.pair.end()
        else:
            ctx.pair.begin()
        return g, None, None


def device_timed(name, fn, x):
    """``fn(x)``, with its device time in the forward and in the backward
    added to the counter ``device_ms.<name>`` while a profiler runs and
    ``x`` lies on a CUDA card; ``fn(x)`` alone otherwise."""
    if (not _autograd_profiler._is_profiler_enabled
            or x.device.type not in TIMED_DEVICES):
        return fn(x)
    pair = _Pair(f"device_ms.{name}", x.device)
    return _Edge.apply(fn(_Edge.apply(x, pair, True)), pair, False)


def resolve_device_times(wait=False):
    """Add the elapsed time of each pending pair of events whose end has
    completed (every pair, waiting for it, with ``wait``) to its
    counter."""
    with _counters_lock:
        left = []
        for name, start, stop in _pending:
            if wait:
                stop.synchronize()
            elif not stop.query():
                left.append((name, start, stop))
                continue
            _counters[name] = _counters.get(name, 0.0) + start.elapsed_time(
                stop)
        _pending[:] = left


def recorded():
    """``{"spans": [Span], "counters": {name: n}}`` recorded so far, spans
    in the order they closed; the device times of every timed call
    included (``device_timed``: waits for them)."""
    resolve_device_times(wait=True)
    with _counters_lock:
        counters = dict(_counters)
    return {"spans": list(_spans), "counters": counters}


def clear():
    """Forget every span, counter and pending device time recorded so
    far."""
    _spans.clear()
    with _counters_lock:
        _counters.clear()
        _pending.clear()


def write_spans(path):
    """Write ``recorded()`` to ``path`` as JSON: each span an object of
    ``Span``'s fields, times in ``time.perf_counter`` seconds, and the main
    thread's ident, which tells the caller's spans from a worker's."""
    rec = recorded()
    with open(path, "w") as f:
        json.dump({"clock": "time.perf_counter",
                   "main_thread": threading.main_thread().ident,
                   "spans": [s._asdict() for s in rec["spans"]],
                   "counters": rec["counters"]}, f)
    return path


def write_memory_profile(path):
    """Write a snapshot of the CUDA caching allocator's memory (segments and
    blocks) to ``path``; raises where there is no CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a device memory snapshot needs "
                           "a card")
    torch.cuda.memory._dump_snapshot(path)
    return path
