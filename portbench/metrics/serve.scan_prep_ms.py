"""Median over the window's ``decode()`` calls of the program's
``entropy.prepare_scan`` span: the host's unstuffing and packing of the
restart segments into words, ``ops.scan_prep.prepare_scan``."""

from portbench import stages


def read(ctx):
    st = stages.of(ctx)
    return st.stage_ms("entropy.prepare_scan") if st else None
