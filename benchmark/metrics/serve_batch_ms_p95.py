"""The 95th percentile over every call of the window, from its frames on
the host to its output on the host, in ms."""

from benchmark.reduce import tail_ms


def read(run):
    return tail_ms(run, 95)
