"""The program's cache-miss counters summed over the window:
``tables.build`` (``ops.entropy_cuda.device_tables`` built a table set),
``layout.comp_src_upload`` (``models.decoder._comp_srcs`` uploaded a
geometry's gather maps), ``kernels.load`` and ``kernels.build`` (a CUDA
library loaded, and built by nvcc first).  0 when the warm-up filled every
cache."""

from portbench import stages


def read(ctx):
    st = stages.of(ctx)
    if not st:
        return None
    return sum(c.n for c in st.counts if c.name in stages.COUNTERS)
