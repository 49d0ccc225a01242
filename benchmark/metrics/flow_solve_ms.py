"""The median of the flow solver's own clock over the window's solves
(``AsyncFlowSolver.solve_times``: the frames' upload to the solve's end on
its stream), in ms."""

import numpy as np


def read(run):
    times = run.counters.get("flow_solve_s")
    return float(np.median(times)) * 1e3 if times else None
