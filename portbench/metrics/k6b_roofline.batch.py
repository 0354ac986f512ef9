"""K6b's share of its byte roofline in the batch cell: the bytes of its
launches in the window (``roofline.k6b_bytes`` of a call's frames) at
3.35 TB/s, over the profiler's time of K6b there."""

from portbench import roofline


def read(ctx):
    sec, n = roofline.kernel_time(ctx.trace.device_ops, roofline.K6B_KERNELS)
    if not n or not ctx.requests:
        return None
    per = sum(roofline.k6b_bytes([ctx.frames[i] for i in r.frames])
              for r in ctx.requests) / len(ctx.requests)
    return roofline.share(per * n, sec)
