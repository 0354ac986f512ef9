"""Median over the window's ``decode()`` calls of the program's
``pixel.enqueue`` span: the pixel stage's host side, the quantisation
tables' uploads, the gather maps (``_comp_srcs``) and the launches of
``ops.pixel.pixel_pipeline_from_scan``."""

from portbench import stages


def read(ctx):
    st = stages.of(ctx)
    return st.stage_ms("pixel.enqueue") if st else None
