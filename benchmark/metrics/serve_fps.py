"""Frames denoised and read back over the window's seconds."""

from benchmark.reduce import rate


def read(run):
    return rate(run)
