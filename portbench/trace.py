"""The traced run's profiler window and its reduction.

``torch.profiler`` records the host (the harness's ``portbench.*`` spans
and the program's torch operations) and the card (kernels, copies and
sets, through CUPTI) over the window.  :func:`reduce` turns its raw events
into what the per-layer readers and the result line take: the device
operations inside the window, the time the device was busy (the union of
their intervals), the idle gaps with the harness span that covered each,
and the operations that took most time.
"""

from __future__ import annotations

import dataclasses
import re

import torch

WINDOW = "portbench.window"


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    #: (short name, start ns, end ns) of every device operation that ran
    #: inside the window, clipped to it.
    device_ops: list
    #: The ten longest idle gaps: [host span covering it, seconds].
    idle_gaps: list
    #: The ten device operations that took most time: [name, seconds].
    top_ops: list
    #: (name, start ns, end ns, thread) of every ``portbench.*`` span.
    spans: list
    #: (short name, start ns, end ns) of every device operation traced.
    all_ops: list


def short_name(name: str) -> str:
    """A kernel's name without its namespace noise and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:120]


def profiler():
    """A profiler of the host and the card, not yet started."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False)


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof, host_spans: list) -> Reduced:
    """Reduce a finished profiler's events (see the module docstring);
    ``host_spans`` are the load threads' (``traffic.Spans``)."""
    events = prof.profiler.kineto_results.events()
    spans, dev = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            name = e.name()
            if name.startswith("portbench."):
                spans.append((name, e.start_ns(), e.end_ns(),
                              e.start_thread_id()))
        elif not e.name().startswith("portbench."):
            # (the device-side copies of the harness's own annotations
            # are ranges, no operation)
            dev.append((e.name(), e.start_ns(), e.end_ns()))
    windows = [s for s in spans if s[0] == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = windows[0][1], windows[0][2]
    ops = [(short_name(n), max(a, w0), min(b, w1)) for n, a, b in dev
           if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in ops])
    busy_ns = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    inner = [s for s in spans if s[0] != WINDOW] + list(host_spans)
    idle = []
    for a, b in gaps[:10]:
        mid = (a + b) // 2
        # A call covering the gap says the host was busy with a request;
        # else the innermost span (a wait), else none.
        cover = sorted((s for s in inner if s[1] <= mid <= s[2]),
                       key=lambda s: (s[0] != "portbench.call", s[2] - s[1]))
        name = cover[0][0] if cover else "portbench.none"
        idle.append([name, (b - a) * 1e-9])
    by_name: dict = {}
    for n, a, b in ops:
        by_name[n] = by_name.get(n, 0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return Reduced(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                   device_ops=ops, idle_gaps=idle,
                   top_ops=[[n, ns * 1e-9] for n, ns in top], spans=spans,
                   all_ops=[(short_name(n), a, b) for n, a, b in dev])


def span_device_ns(red: Reduced, name: str) -> dict:
    """Device time by operation name of the operations that started inside
    any span called ``name``, in ns."""
    marks = [(s[1], s[2]) for s in red.spans if s[0] == name]
    out: dict = {}
    for n, a, b in red.all_ops:
        if any(s <= a <= e for s, e in marks):
            out[n] = out.get(n, 0) + (b - a)
    return out
