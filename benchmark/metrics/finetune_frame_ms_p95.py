"""The 95th percentile over every frame of the window, from the frame
handed in to its denoised output on the host, in ms."""

from benchmark.reduce import tail_ms


def read(run):
    return tail_ms(run, 95)
