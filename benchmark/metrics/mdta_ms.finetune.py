"""The device time of the Restormer's attention halves a traced frame, in
ms: every block's LayerNorm and MDTA, forward and backward, timed by the
program's CUDA events around each call (its counter
``device_ms.restormer.mdta``)."""

from benchmark.program_counters import per_item


def read(run):
    return per_item(run, "device_ms.restormer.mdta")
