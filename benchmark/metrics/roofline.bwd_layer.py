"""The mid layers' backward kernels (``bwd_layer``) of the profiled
slice: their least time by ``roofline.mid_bwd_layer`` over the device time
they took, in percent."""

from benchmark.reduce import mid_layer_bound, roofline_percent


def read(run):
    return roofline_percent(run, "bwd_layer", mid_layer_bound(run, "bwd"))
