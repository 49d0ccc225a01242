"""The program's own spans, put on the profiled slice's clock.

The program records its spans (``frame2frame_tpu_torch.utils.profiling``:
``Span(name, parent, id, thread, t0, t1)`` by ``time.perf_counter``) while a
profiler runs, which in a run of the benchmark is the traced slice. The
slice's markers give the offset from the host clock to the trace's, and
``trace.reduce`` shifts the benchmark's own spans by it without keeping it:
it is recovered here as a shifted span less the same span unshifted. A
program without the recorder, or a run without a slice, reads None.
"""

from __future__ import annotations

import threading
from collections import defaultdict, namedtuple

from .trace import idle_gaps

Span = namedtuple("Span", "name parent id thread t0 t1")
# how far apart two readings of one offset may lie, in seconds: float
# rounding of host times of a few thousand seconds
ROUNDING_S = 1e-9


def offset(run):
    """Seconds that put a host time on the trace's clock: the first of the
    window's benchmark spans (``run.trace["spans"]``) less the same span in
    ``run.spans.done``, where the spans that follow it match too; None
    where the slice holds none of them."""
    shifted = run.trace["spans"]
    done = run.spans.done
    if not shifted:
        return None
    for k in range(len(done) - len(shifted) + 1):
        off = shifted[0][1] - done[k][1]
        if all(n == m and abs(a + off - sa) <= ROUNDING_S
               and abs(b + off - sb) <= ROUNDING_S
               for (n, a, b), (m, sa, sb) in zip(done[k:], shifted)):
            return off
    return None


def recorded_spans():
    """The program's spans recorded in this process; None where the program
    has no recorder."""
    try:
        from frame2frame_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return None if recorded is None else recorded()["spans"]


def spans(run):
    """The program's spans that lie wholly in the slice's window, on the
    trace's clock; None untraced, or where the program records no span."""
    if run.trace is None:
        return None
    recorded = recorded_spans()
    off = offset(run)
    if not recorded or off is None:
        return None
    lo, hi = run.trace["window"]
    out = [Span(*s[:4], s[4] + off, s[5] + off) for s in recorded]
    return [s for s in out if lo <= s.t0 and s.t1 <= hi] or None


def durations(run, name):
    """Seconds of each of the window's spans called ``name``; None where
    there is none."""
    got = spans(run)
    d = [s.t1 - s.t0 for s in got or () if s.name == name]
    return d or None


def _self_intervals(thread_spans):
    """(start, end, name) pieces of each span's time that no span inside
    it covers, for spans of one thread (which nest), sorted by start."""
    out, stack = [], []  # stack: [span, time its self part resumes]

    def close_until(t):
        while stack and stack[-1][0].t1 <= t:
            s, at = stack.pop()
            if s.t1 > at:
                out.append((at, s.t1, s.name))
            if stack:
                stack[-1][1] = s.t1

    for s in sorted(thread_spans, key=lambda s: (s.t0, -s.t1)):
        close_until(s.t0)
        if stack:
            up = stack[-1]
            if s.t0 > up[1]:
                out.append((up[1], s.t0, up[0].name))
        stack.append([s, s.t0])
    close_until(float("inf"))
    return sorted(out)


def idle_by_span(run, thread=None):
    """Card 0's idle time in the window (``trace.idle_gaps`` over every
    device operation) split by the innermost of ``thread``'s spans open
    while it lasted (default: the main thread), in seconds, "none" where
    no span was open; None where ``spans(run)`` is. The parts sum to the
    window's idle time."""
    got = spans(run)
    if got is None:
        return None
    if thread is None:
        thread = threading.main_thread().ident
    lo, hi = run.trace["window"]
    gaps = idle_gaps([(a, b) for _, a, b, d in run.trace["ops"] if d == 0],
                     lo, hi)
    pieces = _self_intervals([s for s in got if s.thread == thread])
    out = defaultdict(float)
    j = 0
    for gs, ge in gaps:
        left = ge - gs
        while j < len(pieces) and pieces[j][1] <= gs:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < ge:
            part = min(ge, pieces[k][1]) - max(gs, pieces[k][0])
            if part > 0:
                out[pieces[k][2]] += part
                left -= part
            k += 1
        if left > 0:
            out["none"] += left
    return dict(out)
