"""Median over the window's ``decode()`` calls of the program's
``decode.parse`` span: the host parse of the JPEG's markers,
``io.parser.parse``."""

from portbench import stages


def read(ctx):
    st = stages.of(ctx)
    return st.stage_ms("decode.parse") if st else None
