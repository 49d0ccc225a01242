"""The flow solver's own host time a solve in the profiled slice: the
program's ``flow.solve`` span (``AsyncFlowSolver``'s worker thread) less
its ``flow.wait`` (the worker blocked on its stream), the mean over the
solves that lie in the slice, in ms."""

from collections import defaultdict

from benchmark import program_trace


def read(run):
    got = program_trace.spans(run)
    if not got:
        return None
    waits = defaultdict(float)
    for s in got:
        if s.name == "flow.wait":
            waits[s.id] += s.t1 - s.t0
    own = [s.t1 - s.t0 - waits[s.id] for s in got if s.name == "flow.solve"]
    return sum(own) / len(own) * 1e3 if own else None
