"""Tracing / profiling utilities.

Counterpart of ``jpeg_decoder_tpu/utils/profiling.py``: (a) lightweight
per-stage wall-clock counters with MP/s reporting (:class:`StageTimer`),
(b) the program's own stage spans and cache counters (:func:`span`,
:func:`count`), and (c) a ``torch.profiler`` trace context (host ops and,
on a CUDA card, device kernels), written as a Chrome trace with the stage
spans on their threads (open it in chrome://tracing or Perfetto).

The span recorder is on while a ``torch.profiler`` profile is active in the
process, whichever thread started it, and off otherwise.  A span records
its name, its start and end on ``time.time_ns`` (the clock of the
profiler's events), the calling thread's CPU nanoseconds over it (some
hosts advance that clock in 10 ms ticks: only sums over many spans mean
much there), the thread's native id (the profiler's ``tid``), its own id,
the id of the span enclosing it on that thread, and the id of the call it
belongs to: a span opened with ``call=True`` and no call open on its
thread takes a new call id, which every span nested inside it on that
thread shares.  The records live in memory, at most :data:`MAX_RECORDS`
of each kind (the newest), and are cleared by the first record after the
recorder was found off (a span or count while no profile ran) and by
:func:`device_trace` as it starts.  Off, :func:`span` returns one shared
no-op context and :func:`count` returns at once.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch.autograd.profiler as _torch_profiler

#: Records kept of each kind (spans, counts): the newest.
MAX_RECORDS = 1_000_000


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    #: The thread's CPU time over the span (``time.thread_time_ns``).
    cpu_ns: int
    #: ``threading.get_native_id()``: the profiler's ``tid``.
    tid: int
    span_id: int
    #: The enclosing span on the same thread, or None.
    parent_id: int | None
    #: The call the span belongs to, or None outside any call.
    call_id: int | None


class CountRecord(NamedTuple):
    name: str
    n: int
    t_ns: int
    tid: int
    call_id: int | None


class _Thread(threading.local):
    def __init__(self):
        self.tid = threading.get_native_id()
        #: (span id, call id) of the open spans, innermost last.
        self.stack: list = []


class Recorder:
    """The process's span and counter buffers and their on/off state."""

    def __init__(self):
        self.spans: collections.deque = collections.deque(
            maxlen=MAX_RECORDS)
        self.counts: collections.deque = collections.deque(
            maxlen=MAX_RECORDS)
        #: Whether the buffers hold the current recording's records.
        self.live = False
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._calls = itertools.count(1)
        self._thread = _Thread()

    def start(self, clear: bool = False) -> None:
        """Clear the buffers at a recording's first record (or now)."""
        with self._lock:
            if clear or not self.live:
                self.spans.clear()
                self.counts.clear()
                self.live = True


_recorder = Recorder()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "call", "t0", "c0", "sid", "parent", "call_id",
                 "th")

    def __init__(self, name: str, call: bool):
        self.name = name
        self.call = call

    def __enter__(self):
        rec = _recorder
        if not rec.live:
            rec.start()
        th = rec._thread
        self.th = th
        if th.stack:
            self.parent, self.call_id = th.stack[-1]
        else:
            self.parent = self.call_id = None
        if self.call and self.call_id is None:
            self.call_id = next(rec._calls)
        self.sid = next(rec._ids)
        th.stack.append((self.sid, self.call_id))
        # The CPU clock reads inside the wall clock's interval.
        self.t0 = time.time_ns()
        self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        c1 = time.thread_time_ns()
        t1 = time.time_ns()
        th = self.th
        th.stack.pop()
        # A plain tuple here (the cheaper to make), a SpanRecord when read.
        _recorder.spans.append((
            self.name, self.t0, t1, c1 - self.c0, th.tid, self.sid,
            self.parent, self.call_id))
        return False


def span(name: str, call: bool = False):
    """Context manager recording one span ``name`` while recording is on
    (see the module docstring); ``call=True`` opens a call when none is
    open on the thread."""
    if recording():
        return _Span(name, call)
    _recorder.live = False
    return _NO_SPAN


def recording() -> bool:
    """Whether the recorder is on: a caller gathers what only a counter
    would read (a copy from the card, say) only then."""
    # torch sets this flag for the whole process while a profile runs.
    return _torch_profiler._is_profiler_enabled


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    rec = _recorder
    if not recording():
        rec.live = False
        return
    if not rec.live:
        rec.start()
    th = rec._thread
    rec.counts.append((name, n, time.time_ns(), th.tid,
                       th.stack[-1][1] if th.stack else None))


def spans() -> list[SpanRecord]:
    """The recorded spans, in the order they ended."""
    return [SpanRecord._make(r) for r in list(_recorder.spans)]


def counts() -> list[CountRecord]:
    """The recorded counter increments, in order."""
    return [CountRecord._make(r) for r in list(_recorder.counts)]


def counters() -> dict[str, int]:
    """Each counter's total over the recorded increments."""
    out: dict[str, int] = defaultdict(int)
    for c in counts():
        out[c.name] += c.n
    return dict(out)


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


#: The host annotation that ties :func:`device_trace`'s recorded spans to
#: the Chrome trace's time base.
TRACE_ANCHOR = "jpeg_decoder_tpu_torch.trace"


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the enclosed code: CPU ops and, when a CUDA
    card is present, its kernels, with the stage spans recorded meanwhile
    as complete events on their threads; written to
    ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        _recorder.start(clear=True)
        with record_function(TRACE_ANCHOR):
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    anchor = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == TRACE_ANCHOR]
    _add_spans(path, anchor[0], spans())


def _add_spans(path: str, anchor_ns: int, records: list) -> None:
    """Write ``records`` into the Chrome trace at ``path`` as complete
    events, shifted onto its time base by the anchor annotation, which
    started at ``anchor_ns`` on ``time.time_ns``."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    mark = next(e for e in events
                if e.get("name") == TRACE_ANCHOR and e.get("ph") == "X")
    shift_us = mark["ts"] - anchor_ns / 1e3
    pid = mark["pid"]
    for r in records:
        events.append({
            "ph": "X", "cat": "jd_span", "name": r.name, "pid": pid,
            "tid": r.tid, "ts": r.start_ns / 1e3 + shift_us,
            "dur": (r.end_ns - r.start_ns) / 1e3,
            "args": {"span": r.span_id, "parent": r.parent_id,
                     "call": r.call_id, "thread_cpu_us": r.cpu_ns / 1e3}})
    with open(path, "w") as f:
        json.dump(trace, f)
