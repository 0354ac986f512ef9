"""The program's own stage spans and cache counters in a traced run.

While a profiler runs, ``jpeg_decoder_tpu_torch.utils.profiling`` records a
span for each stage of ``decode()`` (on ``time.time_ns``, the clock of
``traffic.Spans`` and of the profiler's events) and counts the misses of
its caches.  :func:`of` keeps the calls whose ``decode`` span lies inside
the window span (``portbench.window``), which leaves out the calibration
calls after it, groups their spans by call id, and logs once per run:

* the clock check: the share of calls whose K2 launch (``offsets_kernel``)
  starts after their ``entropy.enqueue`` span starts, and the share whose
  ``write_kernel`` ends before their ``entropy.flags`` span ends.  The
  k-th earliest kernel is held to the k-th earliest span: if each call's
  own kernel keeps to its span, so do these pairs, and a pair that does
  not shows that the two clocks parted there.  The least slack of each
  tenth of the window shows when;
* the window's device-idle seconds by the innermost recorded span over
  them ("between calls" where none is);
* the five slowest calls with each stage's time.

A program without the recorder, or a run in which it recorded no call,
gives None, and so does every reader of this module.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import statistics

from . import roofline, trace

ROOT = "decode"
#: The stages of a ``decode()`` call on the restart-stream route, in order.
STAGES = ("decode.parse", "entropy.prepare_scan", "entropy.enqueue",
          "entropy.flags", "pixel.enqueue")
#: The stages in which the host works, not waits for the card.
HOST_STAGES = ("decode.parse", "entropy.prepare_scan", "entropy.enqueue",
               "pixel.enqueue")
#: The program's cache-miss counters.
COUNTERS = ("tables.build", "layout.comp_src_upload", "kernels.load",
            "kernels.build")
K2_WRITE = re.compile(r"(?<![A-Za-z0-9_])write_kernel\b")
BETWEEN = "between calls"


@dataclasses.dataclass
class Call:
    root: object
    #: The call's other spans.
    spans: list

    @property
    def ns(self) -> int:
        return self.root.end_ns - self.root.start_ns

    def stage_ns(self, name: str) -> int | None:
        """Wall ns of the call's spans called ``name``, or None."""
        got = [s.end_ns - s.start_ns for s in self.spans if s.name == name]
        return sum(got) if got else None

    def offcpu_ns(self, names) -> int:
        """Wall minus thread CPU ns over the call's spans in ``names``."""
        return sum(s.end_ns - s.start_ns - s.cpu_ns for s in self.spans
                   if s.name in names)

    def covered_ns(self) -> int:
        """The part of the root span its direct children cover."""
        kids = [(s.start_ns, s.end_ns) for s in self.spans
                if s.parent_id == self.root.span_id]
        return sum(b - a for a, b in trace._union(kids))


@dataclasses.dataclass
class Stages:
    """The recorder's calls (by start), spans and counter increments
    inside the window, and the device's busy intervals there."""

    calls: list
    spans: list
    counts: list
    window: tuple
    busy: list

    def stage_ms(self, name: str) -> float | None:
        """Median over calls of the stage's wall ms."""
        return median_ms(c.stage_ns(name) for c in self.calls)

    def idle_ns(self, a: int, b: int) -> int:
        """The part of [a, b] in which no device operation ran."""
        return (b - a) - _overlap(self.busy, a, b)


def median_ms(values) -> float | None:
    """The median of the ns values that are not None, in ms."""
    v = [x for x in values if x is not None]
    return statistics.median(v) * 1e-6 if v else None


def recorded():
    """(spans, counter increments) of the program's recorder, or None if
    the program has none."""
    try:
        from jpeg_decoder_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    counts = getattr(profiling, "counts", None)
    if spans is None or counts is None:
        return None
    return spans(), counts()


_cache: dict = {}


def _print(line: str) -> None:
    print(line, flush=True)


def of(ctx) -> Stages | None:
    """The traced run's :class:`Stages` (computed and logged once per
    context), or None."""
    hit = _cache.get(id(ctx))
    if hit is not None and hit[0] is ctx:
        return hit[1]
    got = recorded()
    st = None if got is None else build(ctx.trace, *got)
    _cache.clear()
    _cache[id(ctx)] = (ctx, st)
    if st is not None:
        for line in report(st, ctx.trace):
            _print(line)
    return st


def build(red: trace.Reduced, spans: list, counts: list) -> Stages | None:
    """:class:`Stages` from a reduced trace and the recorder's records."""
    w0, w1 = next((a, b) for n, a, b, _ in red.spans if n == trace.WINDOW)
    inside = [s for s in spans if s.start_ns >= w0 and s.end_ns <= w1]
    by_call: dict = collections.defaultdict(list)
    for s in inside:
        if s.call_id is not None:
            by_call[s.call_id].append(s)
    calls = []
    for group in by_call.values():
        roots = [s for s in group if s.name == ROOT and s.parent_id is None]
        if len(roots) == 1:
            calls.append(Call(roots[0], [s for s in group
                                         if s is not roots[0]]))
    if not calls:
        return None
    calls.sort(key=lambda c: c.root.start_ns)
    return Stages(calls=calls, spans=inside,
                  counts=[c for c in counts if w0 <= c.t_ns <= w1],
                  window=(w0, w1),
                  busy=trace._union([(a, b) for _, a, b in red.device_ops]))


def _overlap(busy: list, a: int, b: int) -> int:
    """ns of [a, b] covered by ``busy`` (sorted, disjoint intervals)."""
    i = max(0, bisect.bisect_right(busy, [a, a]) - 1)
    out = 0
    while i < len(busy) and busy[i][0] < b:
        out += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return out


def clock_check(early: list, late: list) -> tuple[float, list]:
    """The k-th earliest of ``early`` against the k-th earliest of
    ``late``: the share of pairs in which early <= late, and (early,
    late - early) of each pair, in time order."""
    pairs = [(a, b - a) for a, b in zip(sorted(early), sorted(late))]
    ok = sum(d >= 0 for _, d in pairs)
    return (ok / len(pairs) if pairs else float("nan")), pairs


def _quartet_us(pairs: list) -> str:
    """The least, 1st percentile and median slack of ``pairs``, in us."""
    slack = sorted(d for _, d in pairs)
    if not slack:
        return "none"
    pick = [slack[0], slack[len(slack) // 100], slack[len(slack) // 2]]
    return "/".join(f"{v * 1e-3:.1f}" for v in pick)


def _tenths_us(pairs: list, window: tuple) -> str:
    """The least slack of ``pairs`` in each tenth of the window, in us: a
    drift between the two clocks shows as a trend."""
    w0, w1 = window
    least: dict = {}
    for t, d in pairs:
        k = min(9, max(0, (t - w0) * 10 // max(1, w1 - w0)))
        least[k] = min(d, least.get(k, d))
    return " ".join(f"{least[k] * 1e-3:.0f}" if k in least else "-"
                    for k in range(10))


def idle_by_span(st: Stages) -> dict:
    """The window's device-idle seconds by the innermost recorded span
    over them (the deepest, then the latest started), else
    :data:`BETWEEN`."""
    w0, w1 = st.window
    gaps, t = [], w0
    for a, b in st.busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    depth: dict = {}
    for s in sorted(st.spans, key=lambda s: s.start_ns):
        depth[s.span_id] = depth.get(s.parent_id, -1) + 1
    ev = []
    for s in st.spans:
        key = (depth[s.span_id], s.start_ns, s.span_id, s.name)
        ev.append((s.start_ns, 1, key))
        ev.append((s.end_ns, 0, key))
    for a, b in gaps:
        ev.append((a, 3, None))
        ev.append((b, 2, None))
    ev.sort(key=lambda e: (e[0], e[1]))
    active: set = set()
    in_gap = False
    out: dict = collections.defaultdict(int)
    prev = w0
    for t, kind, key in ev:
        if in_gap and t > prev:
            out[max(active)[3] if active else BETWEEN] += t - prev
        prev = t
        if kind == 1:
            active.add(key)
        elif kind == 0:
            active.discard(key)
        else:
            in_gap = kind == 3
    return {n: ns * 1e-9 for n, ns in sorted(out.items(),
                                              key=lambda kv: -kv[1])}


def report(st: Stages, red: trace.Reduced) -> list[str]:
    """The log lines of the module docstring."""
    calls = st.calls
    enq = [s.start_ns for s in st.spans if s.name == "entropy.enqueue"]
    flags = [s.end_ns for s in st.spans if s.name == "entropy.flags"]
    launch = [a for n, a, _ in red.device_ops
              if roofline.K2_LAUNCH.search(n)]
    write = [b for n, _, b in red.device_ops if K2_WRITE.search(n)]
    s_start, by_start = clock_check(enq, launch)
    s_end, by_end = clock_check(write, flags)
    self_share = statistics.median(1 - c.covered_ns() / c.ns if c.ns else 0
                                   for c in calls)
    lines = [
        f"stages: {len(calls)} decode() calls in the window, median "
        f"{median_ms(c.ns for c in calls):.4f} ms, the stage spans "
        f"leave {100 * self_share:.2f}% of the median call uncovered; "
        f"clock check: {100 * s_start:.2f}% of {len(by_start)} K2 "
        f"launches start after their entropy.enqueue starts ({len(enq)} "
        f"spans, {len(launch)} offsets_kernel; by {_quartet_us(by_start)} "
        f"us least/1%/median), {100 * s_end:.2f}% of {len(by_end)} "
        f"write_kernel end before their entropy.flags ends ({len(write)} "
        f"kernels, {len(flags)} spans; by {_quartet_us(by_end)} us)",
        f"stages: clock check's least slack by tenth of the window (us): "
        f"launch {_tenths_us(by_start, st.window)}; flags "
        f"{_tenths_us(by_end, st.window)}",
        "stages: device idle s by innermost span "
        + ", ".join(f"{n} {s:.6f}" for n, s in idle_by_span(st).items())]
    for c in sorted(calls, key=lambda c: -c.ns)[:5]:
        parts = [f"{n} {c.stage_ns(n) * 1e-6:.3f}" for n in STAGES
                 if c.stage_ns(n) is not None]
        at = (c.root.start_ns - st.window[0]) * 1e-9
        lines.append(f"stages: slow call at {at:.3f} s, thread "
                     f"{c.root.tid}: decode {c.ns * 1e-6:.3f} ms; "
                     + ", ".join(parts))
    return lines
