"""Chunks that K2's serial seal re-decoded, the mean over the window's
``decode()`` calls that launched K2 (those with a ``k2.chunks`` count):
the program's ``k2.seal_redecodes`` counter (``ops.entropy_cuda.
count_stats``), where one thread walks a segment's CTA boundaries.  None
for a program without the counters."""

from portbench import stages


def read(ctx):
    st = stages.of(ctx)
    if not st:
        return None
    calls = {c.root.call_id for c in st.calls}
    launched = {c.call_id for c in st.counts
                if c.name == "k2.chunks" and c.call_id in calls}
    if not launched:
        return None
    return sum(c.n for c in st.counts if c.name == "k2.seal_redecodes"
               and c.call_id in launched) / len(launched)
