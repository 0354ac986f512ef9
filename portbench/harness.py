"""One run of one cell: set-up, the measured window, the check.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``: the frames, the entry and its
arguments, the pixel semantics the check holds it to, the limits), its
traffic mix (``traffic/<traffic>.json``, read by ``traffic.py``), the entry
adapter (``entries/<entry>.py``) and each per-layer metric's reader
(``metrics/<name>.py``, see :func:`reader`).  :func:`run` returns the
result line's object and the compared numbers; ``run.py`` prints them.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time

import torch

from . import corpus, reference, roofline, trace, traffic

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str, e2e_names: set | None) -> bool:
    """Whether a metric is reported in ``cell``: the cells its
    ``workloads`` lists, or without the key every cell (end to end) or
    every cell that reports the metric it moves (per layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(root: str, name: str, workload: dict | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files; given
    ``workload``, an entry of that file's form, that cell with the
    file's metrics."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload is None and name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = workload or cells[name]
    config = load_json(os.path.join(HERE, "configs", f"{w['config']}.json"))
    mix = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, None)]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"] if _applies(m, name, names)]
    return Cell(name, config, mix, int(w["chips"]), e2e, per)


def reader(name: str):
    """The per-layer metric ``name``'s reader module: ``metrics/<name>.py``,
    or for a quantity split by cell (``<quantity>.<part>``, such as
    ``k2_roofline.batch``) the one reader ``metrics/<quantity>.py`` its
    parts share.  Its layer, unit and cells are BENCHMARK.json's."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(HERE, "metrics", f"{name.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_class(name: str):
    return importlib.import_module(f"portbench.entries.{name}").Entry


def n_distinct(cell: Cell) -> int:
    n = cell.config.get("distinct_frames")
    return int(n if n is not None else cell.mix["cameras"])


def make_frames(cell: Cell, seed: int, device) -> list:
    return corpus.make_frames(cell.config["frame"], seed, n_distinct(cell),
                              device)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the cell, its frames, the requests
    completed inside the window, the window's length, the process's CPU
    seconds over it, and the reduced trace."""

    cell: Cell
    frames: list
    requests: list
    window_s: float
    cpu_s: float
    trace: trace.Reduced

    @property
    def megapixels(self) -> float:
        return sum(self.frames[i].pixels for r in self.requests
                   for i in r.frames) / 1e6


def _nearest_rank(values: list, q: float) -> float:
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def _latency_stats(reqs: list) -> tuple[list, list]:
    lat = [(r.done - r.due) if r is not None and r.error is None
           else math.inf for r in reqs]
    late = [r.late for r in reqs if r is not None and r.late is not None]
    return lat, late


def run(root: str, workload: str, seed: int, seconds: float, traced: bool,
        device, t_start: float, log=print, cell: Cell | None = None,
        observe=None) -> tuple[dict, list]:
    """Run one cell (see the module docstring).  ``t_start`` is the process
    start on ``time.perf_counter``'s clock, for ``setup_s``; ``observe``,
    if given, is called with (requests, window start, window end).
    Returns (the result line's object without ``check``, the compared
    numbers as (name, value, limit) triples)."""
    cell = cell or load_cell(root, workload)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, mix = cell.config, cell.mix
    t0 = time.perf_counter()
    frames = make_frames(cell, seed, dev)
    t1 = time.perf_counter()
    entry = entry_class(cfg["entry"])(cfg, frames, dev)
    kind = mix["kind"]
    n_threads = int(mix["callers"]) if kind == "closed" else int(
        cfg["workers"])
    batch = int(mix.get("batch", 1))
    traffic.warm(entry, n_threads, len(frames), 2, batch)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"set-up: {t0 - t_start:.3f} s to the first frame (interpreter, "
        f"torch, the card), {t1 - t0:.3f} s for {len(frames)} frames "
        f"({sum(len(f.blob) for f in frames)} B), "
        f"{time.perf_counter() - t1:.3f} s to import the program and warm "
        f"up {n_threads} x 2 calls")
    every = int(cfg["check"]["every"])
    prof = trace.profiler() if traced else None
    if prof is not None:
        prof.__enter__()
    spans = traffic.Spans()
    cpu0 = os.times()
    setup_s = time.perf_counter() - t_start
    with torch.profiler.record_function(trace.WINDOW):
        if kind == "closed":
            reqs, t_begin, t_end = traffic.run_closed(
                entry, mix, len(frames), seconds, seed, every, spans)
        elif kind == "open":
            reqs, t_begin, t_end = traffic.run_open(
                entry, mix, n_threads, seconds, seed, every, spans)
        else:
            raise ValueError(f"unknown traffic kind {kind!r}")
    cpu1 = os.times()
    cpu_s = (cpu1.user - cpu0.user) + (cpu1.system - cpu0.system)
    if observe is not None:
        observe(reqs, t_begin, t_end)
    calib = None
    if prof is not None:
        calib = _calibrate(entry, batch, len(frames)) if cuda else None
        prof.__exit__(None, None, None)
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    if kind == "closed":
        inside = [r for r in reqs if r.error is None and r.done <= t_end]
        attempted = sum(len(r.frames) for r in reqs)
    else:
        inside = [r for r in reqs if r is not None and r.error is None]
        attempted = len(reqs)
    failed = sum(len(r.frames) for r in reqs
                 if r is not None and r.error is not None)
    missing = sum(r is None for r in reqs)
    mp = sum(frames[i].pixels for r in inside for i in r.frames) / 1e6
    values = {"setup_s": setup_s}
    if kind == "closed":
        values["decoded_mps"] = mp / seconds
        log(f"window: {len(inside)} calls of {batch} frames completed in "
            f"{seconds} s ({mp:.1f} MP), {len(reqs)} started; callers "
            f"{n_threads}; failed images {failed}")
    else:
        lat, late = _latency_stats(reqs)
        values["request_p50_ms"] = _nearest_rank(lat, 0.50) * 1e3
        values["request_p95_ms"] = _nearest_rank(lat, 0.95) * 1e3
        svc = [r.done - r.taken for r in inside]
        log(f"window: {len(reqs)} requests due in {seconds} s from "
            f"{mix['cameras']} cameras at {mix['fps']} fps, {len(inside)} "
            f"done, {failed} failed, {missing} missing; latency p50 "
            f"{values['request_p50_ms']:.3f} ms, p95 "
            f"{values['request_p95_ms']:.3f} ms, p99 "
            f"{_nearest_rank(lat, 0.99) * 1e3:.3f} ms, max "
            f"{max(lat) * 1e3:.3f} ms; service median "
            f"{statistics.median(svc) * 1e3 if svc else 0:.3f} ms; "
            f"generator lateness (idle workers) p50 "
            f"{_nearest_rank(late, 0.5) * 1e3 if late else 0:.3f} ms, max "
            f"{max(late) * 1e3 if late else 0:.3f} ms over {len(late)}")
    log(f"setup {setup_s:.3f} s; window CPU {cpu_s:.3f} s; peak device "
        f"memory {peak} B")

    result = {"correct": None, "attempted": attempted, "failed": failed}
    if traced:
        red = trace.reduce(prof, spans.items)
        ctx = Context(cell, frames, inside, seconds, cpu_s, red)
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        _profiler_check(red, inside, calib, log)
        result["metrics"] = metrics
    else:
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = _device(dev, cell.chips, peak)
    if traced:
        result["device"]["busy_s"] = red.busy_s
        result["device"]["window_s"] = red.window_s
        result["breakdown"] = {"device_ops": red.top_ops,
                               "idle_gaps": red.idle_gaps}

    # The check, once the window has closed and the program's state is
    # freed: every sampled output against the plain reference.
    kept = [(r.frames, r.outputs) for r in reqs
            if r is not None and r.outputs is not None]
    del entry, reqs, inside
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    compared = check(cfg, frames, kept, failed, missing, log)
    result["correct"] = all(v <= lim for _, v, lim in compared)
    return result, compared


def reference_rgb(cfg: dict, frame, precision: str = "float64"):
    """The plain reference's RGB of ``frame`` under the configuration's
    pixel semantics."""
    px = cfg["pixels"]
    return reference.rgb(frame.planes, frame.qtables, frame.samplings,
                         frame.height, frame.width, idct=px["idct"],
                         upsample=px["upsample"], precision=precision)


def check(cfg: dict, frames: list, kept: list, failed: int, missing: int,
          log=print) -> list:
    """The compared numbers: the share of RGB samples of the sampled
    outputs that differ from the plain reference, the failed and the
    missing requests; each as (name, value, limit)."""
    refs: dict = {}
    off = tot = worst = 0
    images = 0
    for ids, outs in kept:
        for i, got in zip(ids, outs):
            if i not in refs:
                refs[i] = reference_rgb(cfg, frames[i])
            n, mx, t = reference.compare(got, refs[i])
            off, tot, worst = off + n, tot + t, max(worst, mx)
            images += 1
    lim = cfg["check"]["limits"]
    share = off / tot if tot else math.inf
    log(f"check: {images} images of {len(kept)} sampled requests against "
        f"the reference: {off} of {tot} samples differ, the "
        f"largest by {worst}")
    return [("share_off", share, float(lim["share_off"])),
            ("failed", failed, int(lim["failed"])),
            ("missing", missing, int(lim["missing"]))]


def _device(dev: torch.device, chips: int, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def _calibrate(entry, batch: int, n_frames: int) -> tuple[float, int]:
    """Three calls, each queued behind a spin on the caller's stream and
    timed by CUDA events around it (see ``_profiler_check``): (their
    milliseconds, calls)."""
    ms = 0.0
    with entry.thread_context(0):
        for k in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function("portbench.calibrate"):
                torch.cuda._sleep(200_000_000)
                e0.record()
                entry.call(tuple((k * batch + j) % n_frames
                                 for j in range(batch)))
                e1.record()
                e1.synchronize()
            ms += e0.elapsed_time(e1)
    return ms, 3


def _profiler_check(red, inside: list, calib, log) -> None:
    """Whether the profiler lost device records: K2's launches it saw in
    the window against the calls completed there, and its device time of
    the calibration calls against CUDA events around them."""
    _, k2_launches = roofline.kernel_time(red.device_ops, roofline.K2_LAUNCH)
    counts: dict = {}
    for n, _, _ in red.device_ops:
        counts[n] = counts.get(n, 0) + 1
    log(f"profiler: {len(red.device_ops)} device operations in the window, "
        f"busy {red.busy_s:.6f} s of {red.window_s:.6f}; K2 launches "
        f"{k2_launches} against {len(inside)} calls completed in the window; "
        f"operations by name {sorted(counts.items(), key=lambda kv: -kv[1])}")
    if calib is not None:
        by_name = trace.span_device_ns(red, "portbench.calibrate")
        prof_ms = sum(ns for n, ns in by_name.items()
                      if "spin_kernel" not in n) * 1e-6
        log(f"profiler check: {calib[1]} calls queued behind a spin, CUDA "
            f"events from before each call to after its return "
            f"{calib[0]:.4f} ms (the host's return path included), the "
            f"profiler's device operations of them {prof_ms:.4f} ms (ratio "
            f"{prof_ms / calib[0]:.4f}); by name (ms) "
            f"{[(n, ns * 1e-6) for n, ns in by_name.items()]}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``jpeg_decoder_tpu_torch`` is the port)."""
    bad = {"jax", "jaxlib", "flax", "jpeg_decoder_tpu"}
    return sorted({m for m in sys.modules if m.split(".")[0] in bad})
