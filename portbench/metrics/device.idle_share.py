"""Percent of the window in which no kernel, copy or set ran on the card
(the profiler's device operations): ``device.idle_share.<cell kind>``."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
