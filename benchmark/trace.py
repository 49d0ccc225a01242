"""Host spans and the profiler's slice of a run, and their reduction.

``Spans`` records each named host span (``with spans("flow.get"):``) by the
host clock. ``Slice`` runs ``torch.profiler`` over a bounded number of items
from the middle of the window, and puts the host clock on the trace's with
marker kernels. ``reduce`` turns the profiler's
events into what the metric readers take: the device operations (kernels,
copies, sets) by card, the slice's span on the card, the idle share as the
union of the device intervals (operations that overlap on two streams count
once), and the breakdown.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

BREAKDOWN_ENTRIES = 10


class Spans:
    """Named host spans: (name, t0, t1) by ``time.perf_counter``."""

    def __init__(self):
        self.done = []

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        yield
        self.done.append((name, t0, time.perf_counter()))

    def durations(self, name, since=0.0):
        """Seconds of each span called ``name`` that began at or after
        ``since``."""
        return [t1 - t0 for n, t0, t1 in self.done if n == name and t0 >= since]


MARKER = "spin_kernel"  # the kernel of ``torch.cuda._sleep``
# seconds after the profiler opens at which a marker is launched; the last
# opens the slice. In 50 s runs on an H100 the profiler dropped the markers
# launched 0.05 s and 0.25 s after it opened in some runs (in every
# fine-tune run), and none launched 0.5 s or later; the earlier markers
# show how long after opening the device's operations are kept
PROBES_S = (0.05, 0.25, 0.5, 1.0, 2.0)
END_SETTLE_S = 0.5  # after the closing marker, before the profiler stops
# how far a marker's offset from the host clock may lie from the opening
# marker's; the markers lie 0.2 s apart or more, so none passes for another
MATCH_S = 0.02
# how long after its clock read the closing marker may start: its launch
# waits while another thread (the flow solver's) holds the interpreter, by
# up to 73 ms in 50 s fine-tune runs on an H100
LAG_S = 0.5


def _marker():
    """Synchronize, read the host clock, launch the marker kernel and
    synchronize: the host time just before the marker's launch."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return t


class Slice:
    """The profiler (device activity only, which costs the host little)
    over ``items`` items, started at the first item that begins once
    ``start_s`` seconds of the window have passed. ``active`` says whether
    the item now running is profiled. Markers, each launched right after a
    read of the host clock, put the host spans on the trace's clock: one at
    each of ``PROBES_S`` after the profiler opens, the last of which opens
    the slice, and one that closes it. ``host`` holds their host times."""

    def __init__(self, enabled, start_s, items):
        self.enabled, self.start_s, self.items = enabled, start_s, items
        self.prof = None
        self.active = False
        self.count = 0
        self.host = None

    def warm(self):
        """Open and close the profiler once, so that the slice does not
        pay its first start."""
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]):
                _marker()

    def before(self, elapsed):
        if (self.enabled and self.prof is None and self.count == 0
                and elapsed >= self.start_s):
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            opened = time.perf_counter()
            self.host = []
            for at in PROBES_S:
                time.sleep(max(0.0, opened + at - time.perf_counter()))
                self.host.append(_marker())
            self.active = True

    def after(self):
        if not self.active:
            return
        self.count += 1
        if self.count >= self.items:
            self.stop()

    def stop(self):
        if self.active:
            self.host.append(_marker())
            time.sleep(END_SETTLE_S)
            self.prof.__exit__(None, None, None)
            self.active = False


def match_markers(marks, host):
    """{index into ``host``: (start, end) of its marker on the trace's
    clock} for the markers found, ``marks``, sorted by time. They are taken
    from the last, since the profiler drops markers only at its start: the
    last found is the last launched, and so on back. A marker is kept where
    its offset from the host clock lies within ``MATCH_S`` of the offset of
    the one taken for the slice's opening marker (the second to last),
    which one earlier marker at least has to share; the closing marker
    where it starts no more than ``MATCH_S`` before and ``LAG_S`` after its
    clock read on that offset."""
    pairs = dict(zip(range(len(host) - 1, -1, -1), reversed(marks)))
    first, last = len(host) - 2, len(host) - 1
    if first not in pairs:
        return {}
    off = pairs[first][0] - host[first]
    found = {i: m for i, m in pairs.items()
             if i != last and abs(m[0] - host[i] - off) <= MATCH_S}
    if len(found) < 2:
        # no earlier marker sides with the opening one: the markers are not
        # the ones taken for them (the probes' uneven spacing sees to that)
        return {}
    if last in pairs and -MATCH_S <= pairs[last][0] - host[last] - off <= LAG_S:
        found[last] = pairs[last]
    return found


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_seconds(intervals, lo, hi):
    """Seconds of [lo, hi) that the intervals cover, each overlap once."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in _union(intervals))


def idle_gaps(intervals, lo, hi):
    """The gaps of [lo, hi) that no interval covers, as (start, end)."""
    gaps, t = [], lo
    for s, e in _union(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def reduce(prof, host, spans, items, cards):
    """The slice as a dict: ``ops`` [(name, start_s, end_s, card)] of the
    device, ``window`` (start_s, end_s) from the end of the opening marker
    to the closing marker's clock read (after a sync of the card, so every
    operation of the slice's items has ended by then), ``spans`` [(name,
    start_s, end_s)] of the host in the window, ``items``, ``busy_s`` (the
    union of the device intervals in the window, the mean over ``cards``),
    ``window_s``, ``markers`` (which of the markers were found) and
    ``lag_s`` (how long after its clock read the closing marker started).
    Host times are put on the trace's clock by the opening marker's offset.
    Times are seconds on the trace's clock. Raises where the opening or the
    closing marker is not found: the slice's edges are then unknown."""
    import torch

    ops, marks = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if MARKER in e.name:
            marks.append((start, end))
        else:
            ops.append((e.name, start, end, e.device_index))
    found = match_markers(sorted(marks), host)
    first, last = len(host) - 2, len(host) - 1
    if first not in found or last not in found:
        raise RuntimeError(
            f"the slice's {'opening' if first not in found else 'closing'} "
            f"marker is not found: {len(marks)} markers in the trace at "
            f"{[m[0] for m in marks]} s, launched at {host} s on the host")
    offset = found[first][0] - host[first]
    lo, hi = found[first][1], host[last] + offset
    spans = [(n, a + offset, b + offset) for n, a, b in spans
             if a + offset < hi and b + offset > lo]
    busy = [union_seconds([(s, t) for _, s, t, d in ops if d == c], lo, hi)
            for c in range(cards)]
    return {"ops": ops, "window": (lo, hi), "spans": spans, "items": items,
            "busy_s": sum(busy) / cards, "window_s": hi - lo,
            "cards": cards, "markers": f"{sorted(found)} of {len(host)}",
            "lag_s": found[last][0] - hi}


def breakdown(tr):
    """The device operations that took the most time (summed by name over
    the cards), and the idle time of the device (card 0) split by the host
    span open while it lasted (the benchmark's spans do not nest; "none"
    where no span was open)."""
    by_op = defaultdict(float)
    for name, s, e, _ in tr["ops"]:
        by_op[name[:80]] += e - s
    lo, hi = tr["window"]
    by_span = defaultdict(float)
    for s, e in idle_gaps([(a, b) for _, a, b, d in tr["ops"] if d == 0],
                          lo, hi):
        left = e - s
        for name, a, b in tr["spans"]:
            part = min(b, e) - max(a, s)
            if part > 0:
                by_span[name] += part
                left -= part
        if left > 1e-12:
            by_span["none"] += left
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[n, t] for n, t in top],
            "idle_gaps": [[n, t] for n, t in gaps]}
