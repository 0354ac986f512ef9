"""The one traffic generator: it reads a mix's data file
(``portbench/traffic/<name>.json``) and offers its load to an entry.

Two kinds of mix:

* ``closed``: ``callers`` threads, each sending its next request of
  ``batch`` frames as soon as its last one returned (frames taken in turn
  from the configuration's distinct frames); the window counts what
  completed before it closed;
* ``open``: ``cameras`` sources at ``fps`` frames a second each, a phase
  per camera from the seed (``"phase": "even"``: the phases split a frame
  period evenly and the seed deals them to the cameras, so that every
  seed offers the same arrivals, from cameras in another order;
  ``"locked"``: every camera at phase 0, frame-locked), each frame sent
  ``jitter_ms`` early or late at most (uniform), served by the entry's
  ``workers`` threads in due order; a request's latency runs from its due
  time.  After the window closes no new request is due, and those already
  due are drained and timed in full.

Each worker or caller thread runs in the entry's per-thread context (its
own CUDA stream).  :class:`Spans` marks each call and each wait on the
host's clock (``time.time_ns``, the profiler's time base), so that a
traced run can tell what the host was doing in each idle gap of the card;
the profiler itself records only the thread that started it.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np


class Spans:
    """Host spans of the load threads: (name, start ns, end ns)."""

    def __init__(self):
        self.items: list = []

    def add(self, name: str, t0_ns: int) -> None:
        self.items.append((name, t0_ns, time.time_ns()))


@dataclasses.dataclass
class Request:
    """One request of a run: when it was due (open mixes; the start of the
    call in a closed one), taken by a thread, and done."""

    index: int
    frames: tuple
    due: float
    taken: float = 0.0
    done: float = 0.0
    error: Exception | None = None
    #: The call's RGB outputs, kept for the requests the check samples.
    outputs: list | None = None
    late: float | None = None


def schedule(mix: dict, seed: int, seconds: float) -> list[tuple]:
    """An open mix's requests due in [0, seconds): (due offset in s,
    camera), in due order."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x0A7E])
    n, fps = int(mix["cameras"]), float(mix["fps"])
    period = 1.0 / fps
    kind = mix.get("phase", "even")
    if kind == "even":
        phase = rng.permutation(n) / n * period
    elif kind == "locked":
        phase = np.zeros(n)
    else:
        raise ValueError(f"unknown phase {kind!r}")
    jitter = float(mix.get("jitter_ms", 0.0)) * 1e-3
    out = []
    frames = int(np.ceil(seconds * fps)) + 1
    for cam in range(n):
        t = phase[cam] + period * np.arange(frames)
        t = t + rng.uniform(-jitter, jitter, frames)
        out += [(float(d), cam) for d in t if 0.0 <= d < seconds]
    out.sort()
    return out


def sampled(index: int, seed: int, every: int) -> bool:
    """Whether the check keeps request ``index``'s outputs: one request in
    ``every``, from an offset drawn from the seed."""
    off = int(np.random.default_rng([int(seed) % (1 << 64), 0x5A]).integers(
        every))
    return index % every == off


def _threads(n: int, target) -> None:
    ts = [threading.Thread(target=target, args=(k,), daemon=True)
          for k in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=3600)
    if any(t.is_alive() for t in ts):
        raise RuntimeError("a load thread did not finish")


def run_closed(entry, mix: dict, n_frames: int, seconds: float, seed: int,
               every: int, spans: Spans) -> tuple[list, float, float]:
    """A closed mix for ``seconds``: returns (requests, window start, window
    end), the window's times from ``time.perf_counter``."""
    batch = int(mix["batch"])
    lock = threading.Lock()
    counter = iter(range(1 << 62))
    reqs: list = []
    t_begin = time.perf_counter()
    t_end = t_begin + seconds

    def caller(k):
        with entry.thread_context(k):
            while True:
                with lock:
                    i = next(counter)
                t0 = time.perf_counter()
                if t0 >= t_end:
                    return
                frames = tuple((i * batch + j) % n_frames
                               for j in range(batch))
                r = Request(i, frames, due=t0, taken=t0)
                s0 = time.time_ns()
                try:
                    out = entry.call(frames)
                except Exception as e:  # noqa: BLE001 — the request fails
                    out, r.error = None, e
                r.done = time.perf_counter()
                spans.add("portbench.call", s0)
                if out is not None and sampled(i, seed, every):
                    r.outputs = out
                with lock:
                    reqs.append(r)

    _threads(int(mix["callers"]), caller)
    return reqs, t_begin, t_end


def run_open(entry, mix: dict, workers: int, seconds: float, seed: int,
             every: int, spans: Spans) -> tuple[list, float, float]:
    """An open mix for ``seconds`` (see the module docstring): returns
    (requests, window start, window end)."""
    sched = schedule(mix, seed, seconds)
    lock = threading.Lock()
    nxt = [0]
    reqs: list = [None] * len(sched)
    t_begin = time.perf_counter()
    t_end = t_begin + seconds

    def worker(k):
        with entry.thread_context(k):
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= len(sched):
                    return
                off, cam = sched[i]
                r = Request(i, (cam,), due=t_begin + off)
                wait = r.due - time.perf_counter()
                if wait > 0:
                    s0 = time.time_ns()
                    time.sleep(wait)
                    spans.add("portbench.wait", s0)
                r.taken = time.perf_counter()
                if wait > 0:
                    r.late = r.taken - r.due
                s0 = time.time_ns()
                try:
                    out = entry.call((cam,))
                except Exception as e:  # noqa: BLE001 — the request fails
                    out, r.error = None, e
                r.done = time.perf_counter()
                spans.add("portbench.call", s0)
                if out is not None and sampled(i, seed, every):
                    r.outputs = out
                reqs[i] = r

    _threads(workers, worker)
    return reqs, t_begin, t_end


def warm(entry, n_threads: int, n_frames: int, calls: int,
         batch: int) -> None:
    """``calls`` requests on each of ``n_threads`` threads at once, so that
    every kernel, table set and stream the window uses exists before it."""
    def one(k):
        with entry.thread_context(k):
            for c in range(calls):
                entry.call(tuple((k * calls + c + j) % n_frames
                                 for j in range(batch)))

    _threads(n_threads, one)
