"""Median milliseconds from a worker taking a request to its RGB being
ready on the card (the queue excluded), over the requests done in the
window: the single-image entry, ``models.decoder.decode``."""

import statistics


def read(ctx):
    svc = [r.done - r.taken for r in ctx.requests]
    return statistics.median(svc) * 1e3 if svc else None
