"""Share (%) of the window's ``decode()`` calls whose pixel stage was one
launch of K6b: the calls that carry an increment of the program's
``pixel.k6b`` counter (``models.decoder._k6b_pixels``).  None for a
program whose decoder has no such route (no ``k6b_route``)."""

from portbench import stages


def _counts_k6b() -> bool:
    try:
        from jpeg_decoder_tpu_torch.models import decoder
    except ImportError:
        return False
    return hasattr(decoder, "k6b_route")


def read(ctx):
    st = stages.of(ctx)
    if not st or not _counts_k6b():
        return None
    fused = {c.call_id for c in st.counts if c.name == "pixel.k6b"}
    return 100.0 * sum(c.root.call_id in fused
                       for c in st.calls) / len(st.calls)
