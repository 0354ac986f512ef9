"""Median over the window's ``decode()`` calls of the time inside the
call's ``decode`` span (the program's root span of a call) in which no
device operation of any stream ran (the profiler's kernels, copies and
sets of the window)."""

from portbench import stages


def read(ctx):
    st = stages.of(ctx)
    if not st or not st.busy:
        return None
    return stages.median_ms(st.idle_ns(c.root.start_ns, c.root.end_ns)
                        for c in st.calls)
