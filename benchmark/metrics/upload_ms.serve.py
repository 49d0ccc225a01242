"""The mean host time of a serving call's upload in the profiled slice:
the program's ``serve.upload`` span (``load_model(cfg).apply`` making its
input a tensor on the card, a pageable copy), in ms."""

from benchmark import program_trace


def read(run):
    d = program_trace.durations(run, "serve.upload")
    return sum(d) / len(d) * 1e3 if d else None
