"""The mid layers' eval-forward kernels (``conv3x3_fwd``) of the
profiled slice: their least time by ``roofline.mid_fwd_layer`` at the
call's batch over the device time they took, in percent."""

from benchmark.reduce import mid_layer_bound, roofline_percent


def read(run):
    return roofline_percent(run, "conv3x3_fwd", mid_layer_bound(run, "fwd"))
