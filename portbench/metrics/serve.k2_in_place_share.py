"""Share (%) of the window's ``decode()`` calls whose K2 launch read the
scan's bytes in place, nothing packed on the host: the calls that carry an
increment of the program's ``entropy.scan_in_place`` counter
(``ops.entropy_cuda.decode_scan_baseline``).  None for a program whose K2
has no such form (no ``entropy_cuda.decode_scan_bytes``)."""

from portbench import stages


def _counts_in_place() -> bool:
    try:
        from jpeg_decoder_tpu_torch.ops import entropy_cuda
    except ImportError:
        return False
    return hasattr(entropy_cuda, "decode_scan_bytes")


def read(ctx):
    st = stages.of(ctx)
    if not st or not _counts_in_place():
        return None
    in_place = {c.call_id for c in st.counts
                if c.name == "entropy.scan_in_place"}
    return 100.0 * sum(c.root.call_id in in_place
                       for c in st.calls) / len(st.calls)
