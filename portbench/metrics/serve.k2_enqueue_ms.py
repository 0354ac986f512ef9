"""Median over the window's ``decode()`` calls of the program's
``entropy.enqueue`` span: K2's host side in ``ops.entropy_cuda``, the
table cache (``device_tables``), the words' and segment counts' uploads
and ``decode_segments``' launches."""

from portbench import stages


def read(ctx):
    st = stages.of(ctx)
    return st.stage_ms("entropy.enqueue") if st else None
