"""Nearest-rank 95th percentile of the latency, due time to RGB ready, of
the requests done in the traced window: the tail of the single-image
entry.  Per layer, not end to end: its spread between runs on the card's
machine passes what the benchmark's largest bound admits (PERF.md)."""

import math


def read(ctx):
    lat = sorted(r.done - r.due for r in ctx.requests)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
