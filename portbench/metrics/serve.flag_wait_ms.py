"""Median over the window's ``decode()`` calls of the program's
``entropy.flags`` span: the host blocked on K2's per-segment error flags
(``err.cpu()`` in ``ops.entropy_cuda.decode_scan_baseline``) until K2 is
done."""

from portbench import stages


def read(ctx):
    st = stages.of(ctx)
    return st.stage_ms("entropy.flags") if st else None
