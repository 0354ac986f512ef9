"""Mean over the window's ``decode()`` calls of wall minus thread CPU
time, summed over the program's four host stage spans (``decode.parse``,
``entropy.prepare_scan``, ``entropy.enqueue``, ``pixel.enqueue``;
``entropy.flags``, a wait by design, left out): the time a worker was off
the CPU inside them, such as waiting for the interpreter lock or another
lock held by the other worker.  A mean, not a median: on the card's host
a thread's CPU clock advances in 10 ms ticks, so one call's CPU time is
0 or a tick, while the sum over the window's calls is its CPU time."""

import statistics

from portbench import stages


def read(ctx):
    st = stages.of(ctx)
    if not st:
        return None
    return statistics.mean(c.offcpu_ns(stages.HOST_STAGES)
                           for c in st.calls) * 1e-6
