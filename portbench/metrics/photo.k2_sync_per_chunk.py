"""K2's chunk decodes in its sync launches per chunk, over the window's
``decode()`` calls: the program's ``k2.sync_decodes`` counter summed over
its ``k2.chunks`` (``ops.entropy_cuda.count_stats``).  Every chunk but a
segment's last is decoded once from a guessed entry; what lies above that
is the speculation's re-decodes.  None for a program without the
counters."""

from portbench import stages


def read(ctx):
    st = stages.of(ctx)
    if not st:
        return None
    calls = {c.root.call_id for c in st.calls}
    tot = {"k2.sync_decodes": 0, "k2.chunks": 0}
    for c in st.counts:
        if c.name in tot and c.call_id in calls:
            tot[c.name] += c.n
    if not tot["k2.chunks"]:
        return None
    return tot["k2.sync_decodes"] / tot["k2.chunks"]
