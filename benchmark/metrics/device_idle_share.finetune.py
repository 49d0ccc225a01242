"""The share of the profiled slice's wall time in which no operation ran
on a card (the union of the device intervals, overlapping streams counted
once), the mean over the cell's cards, in percent."""

from benchmark.reduce import idle_percent


def read(run):
    return idle_percent(run)
