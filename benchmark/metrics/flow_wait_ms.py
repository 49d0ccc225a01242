"""The mean host time a frame of the window spent blocked in
``AsyncFlowSolver.get`` (the benchmark's span around the call), in ms."""


def read(run):
    waits = run.spans.durations("flow.get", since=run.records[0]["t0"])
    return sum(waits) / len(waits) * 1e3 if waits else None
