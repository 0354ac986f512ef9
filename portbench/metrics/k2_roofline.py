"""K2's share of its byte roofline (``k2_roofline.<cell kind>``): the
bytes of its launches in the window (``roofline.k2_bytes`` of each call's
frames) at 3.35 TB/s, over the profiler's time of K2's kernels there."""

from portbench import roofline


def read(ctx):
    return roofline.k2_share(ctx)
