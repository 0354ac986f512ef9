"""Device milliseconds per request of every kernel in the window but K2's
(copies and sets left out): the pixel stage of ``decode()``, K5
(``ops.idct_exact_cuda``) and the torch ops of ``ops.pixel``."""

from portbench import roofline


def read(ctx):
    ns = sum(b - a for n, a, b in ctx.trace.device_ops
             if not roofline.K2_KERNELS.search(n)
             and not roofline.COPIES.search(n))
    if not ns or not ctx.requests:
        return None
    return ns * 1e-6 / len(ctx.requests)
