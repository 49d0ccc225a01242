"""Card 0's idle time in the profiled slice while the main thread was inside
the program's ``online.iter`` spans (an update being issued: the spans and
their ``online.forward``, ``online.backward``, ``online.update``), per
traced frame, in ms."""

from benchmark import program_trace

STEP = ("online.iter", "online.forward", "online.backward", "online.update")


def read(run):
    got = program_trace.spans(run)
    if not got or not any(s.name == "online.iter" for s in got):
        return None
    idle = program_trace.idle_by_span(run)
    return sum(idle.get(n, 0.0) for n in STEP) / run.trace["items"] * 1e3
