"""Tracing / profiling utilities.

Counterpart of ``jpeg_decoder_tpu/utils/profiling.py``: (a) lightweight
per-stage wall-clock counters with MP/s reporting and (b) a
``torch.profiler`` trace context (host ops and, on a CUDA card, device
kernels), written as a Chrome trace (open it in chrome://tracing or
Perfetto), and named host annotations that show up in it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    >>> t = StageTimer()
    >>> with t.stage("entropy"): ...
    >>> t.report(megapixels=12.5)
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, megapixels: float | None = None) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            line = (f"{name:>16s}: {total * 1e3:8.1f} ms "
                    f"({self.counts[name]} calls)")
            if megapixels:
                line += f"  {megapixels / total:8.1f} MP/s"
            lines.append(line)
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the enclosed code: CPU ops and, when a CUDA
    card is present, its kernels; written to ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named host annotation that shows up in profiler traces."""
    from torch.profiler import record_function

    with record_function(name):
        yield
