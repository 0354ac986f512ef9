"""Device-entropy batch decode on one GPU: entropy, plane assembly and pixels
on the card per geometry group, from raw entropy words.

Counterpart of ``jpeg_decoder_tpu/parallel/sharded.py`` on one CUDA device:
one process, no mesh.  Where the JAX functions take ``mesh``, these take
``device`` (``"cuda"`` by default, which raises without a card; ``"cpu"``
runs the kernels' plain versions).  The mesh, ``torch.distributed`` and the
``('data', 'seg')`` split arrive with the multi-GPU port.

:func:`decode_batch_sharded` is the serving route for hosts whose CPUs
cannot feed the card: the host parses and, for the emit-lane kernel, walks
each stream's skeleton; the words go to the card, and per geometry group one
device pass runs entropy decode, plane assembly and pixels.  Its routing is
the JAX function's, line for line (jax sharded.py:1187-1257, its thresholds
and environment switches included); each route's device work:

* a *uniform* group (one exact key: size, sampling, colour space, DRI,
  Huffman and quantisation tables) of DRI-0 streams, or of restart streams
  with fewer than ``JD_RESTART_EMIT_MAX_LANES`` (512) segments in all: the
  host lane plan of every image (``entropy_spec.device_plan``), then one
  launch of K7 (``csrc/entropy_emit.cu``) over the whole group, the plane
  gather and the pixel pipeline (K1 under ``idct="pallas"``, K5 under
  ``"exact"``) — JAX's ``_hybrid_group_dispatch`` with its default
  ``emit`` kernel;
* a *bucketed* group (a power-of-two MCU-grid bucket whose images differ in
  size, tables or DRI): per-image plans padded to the group
  (``entropy_spec.plan_bucket_group``), one K7 launch with each image's
  table set (``lut_base``) and geometry, the bucket's plane gather and
  pixels with each image's true edge (``models.batch.rgb_from_blocks_dyn``)
  — JAX's ``_hybrid_group_dispatch_dyn``;
* restart streams of a uniform group with 512 segments or more in all, or
  any restart stream without the native library: ``scan_prep.prepare_scan``
  per image, then one K2 launch (``csrc/entropy.cu``) over the group's
  B * S segments (one table set, by the exact key), the padded-row gather
  and pixels — JAX's ``full_decode_step``;
* DRI-0 streams under ``JD_DEVICE_ENTROPY=spec`` or without the native
  library: K2 over each image's single segment, the same way.  K2 is the
  port's device speculation: JAX's ``_spec_full_step`` (speculative lanes
  and ``_device_splice``) is not ported;
* progressive 8-bit Huffman frames: one frame at a time on the device
  progressive lanes (``ops/entropy_prog.decode_progressive_lanes``: the
  kernels K8a-K8d fed the host's skeleton walks or the restart segments),
  then the pixel pipeline on the device planes — JAX's ``_prog_one``, on a
  pool of two threads (each on a CUDA stream of its own) after the groups
  are dispatched; a frame whose lanes flag or whose walk refuses the
  stream (:class:`JPEGError`) joins the host fallback, and any other
  failure there (a kernel that does not build or launch) is that image's
  error, never a quiet host decode;
* the host fallback (arithmetic, multi-scan, restart-mismatched frames,
  other precisions, and the progressive frames above whose lanes
  flagged): one ``models.batch.BatchDecoder(idct=..., upsample=...)``
  batch;
* rows whose walk or device decode flagged, on the emission and ``spec``
  routes: each image again through the host decoder
  (``decoder._decode_scan_robust``) and ``pixel_pipeline_from_scan``; a
  failure there stays that image's error.  On the K2 restart route a
  flagged image is an error, as in JAX.

As in JAX, every group is dispatched before any flag is read, from a pool
of two threads (each on a CUDA stream of its own; the caller's stream
waits on them and every returned tensor is recorded on it), and the flags
of all groups come back in one device-to-host copy.  The JAX package's
``JD_HYBRID_KERNEL=lockstep|flat`` kernels are not ported: the port always
runs the emit lanes.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..entropy import native
from ..io import parser
from ..layout import scan_layout
from ..models import decoder as decoder_mod
from ..models import routing
from ..models.batch import (BatchDecoder, BatchItem, _bucket_pow2,
                            rgb_from_blocks_dyn)
from ..ops import (entropy_cuda, entropy_emit_cuda, entropy_prog,
                   entropy_spec, scan_prep)
from ..ops import pixel as pixel_ops
from ..ops.staging import upload as _upload
from ..types import FrameHeader, JPEGError, ScanHeader

# K7's counters of a launch are read under this lock, so that the two
# dispatch threads do not read each other's.
_k7_lock = threading.Lock()


def decode_scan_sharded(hdr: FrameHeader, scan: ScanHeader,
                        device="cuda") -> np.ndarray:
    """Baseline scan decode with the restart segments as K2's lanes (on one
    GPU the JAX function's shard_map over 'seg' is one launch over every
    segment; ``entropy_cuda.decode_scan_baseline``).  Returns the
    (n_mcus*bpm, 64) int32 scan-order blocks on the host; a flagged segment
    raises :class:`JPEGError`."""
    return entropy_cuda.decode_scan_baseline(
        hdr, scan, routing.resolve_device(device)).cpu().numpy()


def decode_planes_sharded(hdr: FrameHeader, device="cuda") -> list:
    """Full-frame entropy decode (:func:`decode_scan_sharded`) to the
    per-component (rows, cols, 64) int32 planes."""
    scan_coefs = decode_scan_sharded(hdr, hdr.scans[0], device)
    lay = scan_layout(hdr)
    return [scan_coefs[lay.comp_src[ci]].reshape(*lay.comp_shapes[ci], 64)
            for ci in range(len(hdr.components))]


def _qtables(hdrs: list) -> np.ndarray:
    """(B, n_comps, 64) int32 quantisation tables of each image."""
    return np.stack([
        np.stack([h.quant_tables[c.tq].values for c in h.components])
        for h in hdrs]).astype(np.int32)


def _pixels(blocks, qt, srcs, hdr, *, idct, upsample):
    """(B, H, W, 3) RGB of same-geometry images: each component's plane
    gathered from the scan-order ``blocks`` (B, N, 64) by ``srcs`` (int64
    row indices), then the pixel pipeline with ``qt`` (B, n_comps, 64)."""
    lay = scan_layout(hdr)
    b = blocks.shape[0]
    planes = tuple(blocks.index_select(1, src).view(b, rows, cols, 64)
                   for src, (rows, cols) in zip(srcs, lay.comp_shapes))
    return pixel_ops.pixel_pipeline_impl(
        planes, tuple(qt[:, i].contiguous() for i in range(len(srcs))),
        height=hdr.height, width=hdr.width,
        samplings=tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                        for c in hdr.components),
        idct=idct, upsample=upsample, color=hdr.colorspace,
        precision=hdr.precision)


def _mark(rec: dict, name: str) -> None:
    """On the card, a CUDA event recorded on the current stream at the end
    of the group's stage ``name`` (read after the flags: the device times
    of the stages between two marks)."""
    if rec["cuda"]:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        rec["marks"].append((name, ev))


def _k7(args, rec, **kw):
    """One ``decode_lanes`` call; on the card the launch's counters go to
    ``rec["k7_stats"]`` (a device tensor, read after the flags)."""
    with _k7_lock:
        out = entropy_emit_cuda.decode_lanes(*args, **kw)
        if args[0].is_cuda:
            rec["k7_stats"] = entropy_emit_cuda.decode_lanes.last_stats
    return out


def _emit_group(hdr, scans, dev, rec, *, idct, upsample):
    """A uniform group through K7 (JAX's ``_hybrid_group_dispatch``, its
    ``emit`` kernel): the lane plans of every image (``device_plan``), one
    launch over the group, pixels.  Returns (rgb, bad)."""
    t0 = time.perf_counter()
    (pools, starts, nm, lane_off, t_sym, _, _, seg_first,
     skel_ok) = entropy_spec.device_plan(hdr, scans)
    rec["host_s"] += time.perf_counter() - t0
    _mark(rec, "plan")
    luts, l1 = entropy_cuda.device_tables(hdr, scans[0], dev)
    (pools, starts, nm, lane_off, seg_first, skel_bad, qt) = _upload(
        [pools, starts, nm, lane_off, seg_first, ~skel_ok,
         _qtables([hdr] * len(scans))], dev)
    blocks, err = _k7(
        (pools, starts, nm, lane_off, seg_first, luts), rec,
        block_comp=entropy_spec._block_comp(hdr),
        n_comps=len(hdr.components), n_mcus=scan_layout(hdr).n_mcus,
        trips=t_sym, precision=hdr.precision, l1=l1)
    _mark(rec, "entropy")
    rgb = _pixels(blocks, qt, decoder_mod._comp_srcs(hdr, dev), hdr,
                  idct=idct, upsample=upsample)
    return rgb, (err != 0) | skel_bad


def _k2_group(hdr, scans, dev, rec, *, idct, upsample):
    """A uniform group through K2 (JAX's ``full_decode_step``, and its
    ``spec`` route on one segment per image): every image's segments
    (``prepare_scan``), padded to the group's (B, S, W) and flattened to
    B * S lanes of one launch, then the padded-row gather (jax
    sharded.py:316-325: every segment but the last holds max_mcus MCUs, so
    the padded rows are the scan order and the scan layout's maps apply) and
    pixels.  Returns (rgb, bad)."""
    t0 = time.perf_counter()
    prepped = [scan_prep.prepare_scan(hdr, scan)[:2] for scan in scans]
    b = len(scans)
    s_max = max(len(nm) for _, nm in prepped)
    w_max = max(w.shape[1] for w, _ in prepped)
    words = np.zeros((b, s_max, w_max), np.uint32)
    nm_b = np.zeros((b, s_max), np.int32)
    for k, (w, nm) in enumerate(prepped):
        words[k, :w.shape[0], :w.shape[1]] = w
        nm_b[k, :len(nm)] = nm
    lay = scan_layout(hdr)
    ri = scans[0].restart_interval
    max_mcus = ri if ri else lay.n_mcus
    rec["host_s"] += time.perf_counter() - t0
    _mark(rec, "plan")
    luts, l1 = entropy_cuda.device_tables(hdr, scans[0], dev)
    words, nm_b, qt = _upload(
        [words.reshape(b * s_max, w_max), nm_b.reshape(-1),
         _qtables([hdr] * b)], dev)
    out, err = entropy_cuda.decode_segments(
        words, nm_b, luts, block_comp=entropy_spec._block_comp(hdr),
        n_comps=len(hdr.components), max_mcus=max_mcus, l1=l1,
        precision=hdr.precision)
    _mark(rec, "entropy")
    rgb = _pixels(out.view(b, -1, 64), qt, decoder_mod._comp_srcs(hdr, dev),
                  hdr, idct=idct, upsample=upsample)
    return rgb, err.view(b, s_max).any(1)


def _dyn_group(hdrs, scans, dev, rec, *, idct, upsample):
    """A geometry-bucketed group through K7 (JAX's
    ``_hybrid_group_dispatch_dyn``): the group plan, one launch with each
    image's table set and geometry (the kernel zeroes each image's rows
    past its blocks, and the fill row the plane gather reads), then the
    bucket's pixels.  Returns (rgb, bad, row of each group position)."""
    t0 = time.perf_counter()
    plan = entropy_spec.plan_bucket_group(hdrs, scans)
    rec["host_s"] += time.perf_counter() - t0
    _mark(rec, "plan")
    rec["table_sets"] = len(plan.sets)
    luts, l1 = entropy_cuda.device_table_stack(plan.sets, dev)
    hdr0 = hdrs[0]
    bpm = sum(h * v for h, v in plan.comp_hv)
    (pools, starts, nm, lane_off, lut_base, n_mcus_img, ri, geom, qt,
     skel_bad) = _upload(
        [plan.pools, plan.starts, plan.nm_lane, plan.lane_off,
         plan.lut_base, plan.n_mcus_img, plan.ri, plan.geom, plan.qtables,
         ~plan.skel_ok], dev)
    blocks, err = _k7(
        (pools, starts, nm, lane_off, None, luts), rec,
        block_comp=entropy_spec._block_comp(hdr0),
        n_comps=len(plan.comp_hv), n_mcus=plan.n_mcus, trips=plan.trips,
        precision=hdr0.precision, l1=l1, lut_base=lut_base,
        n_mcus_img=n_mcus_img, ri=ri, rows=plan.n_mcus * bpm + 1)
    _mark(rec, "entropy")
    rgb = rgb_from_blocks_dyn(
        blocks, qt, geom, comp_shapes=plan.comp_shapes,
        comp_hv=plan.comp_hv, height=plan.height, width=plan.width,
        samplings=plan.samplings, idct=idct, upsample=upsample,
        color=hdr0.colorspace, precision=hdr0.precision)
    row_of = [0] * len(hdrs)
    for row, k in enumerate(plan.order):
        row_of[k] = row
    return rgb, (err != 0) | skel_bad, row_of


def _prog_one(hdr, dev, *, idct, upsample) -> torch.Tensor:
    """A progressive frame's (1, H, W, 3) RGB: its planes from the device
    lanes (raises JPEGError when a lane is flagged), then the pixel
    pipeline."""
    planes = entropy_prog.decode_progressive_lanes(hdr, dev, as_device=True)
    return decoder_mod.pixels_from_planes(hdr, planes, idct=idct,
                                          upsample=upsample)


def _host_rgb_one(hdr, scan, dev, *, idct, upsample) -> torch.Tensor:
    """One image's (H, W, 3) RGB at its own geometry from the host decoder
    (``_decode_scan_robust`` with the native backend): the per-image
    fallback of a row whose walk or device decode flagged."""
    blocks = decoder_mod._decode_scan_robust(hdr, scan, "auto", dev)
    lay = scan_layout(hdr)
    blocks = torch.from_numpy(np.asarray(blocks)[
        :lay.n_mcus * lay.blocks_per_mcu].astype(np.int32)).to(dev)
    qts = tuple(torch.from_numpy(hdr.quant_tables[c.tq].values
                                 .astype(np.int32)).to(dev)
                for c in hdr.components)
    return pixel_ops.pixel_pipeline_from_scan(
        blocks, qts, decoder_mod._comp_srcs(hdr, dev),
        comp_shapes=tuple(lay.comp_shapes), height=hdr.height,
        width=hdr.width,
        samplings=tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                        for c in hdr.components),
        idct=idct, upsample=upsample, color=hdr.colorspace,
        precision=hdr.precision)


def _exact_key(hdr: FrameHeader, scan: ScanHeader) -> tuple:
    """The JAX function's exact group key: geometry, precision, sampling,
    colour space, DRI, Huffman and quantisation tables."""
    return (
        hdr.width, hdr.height, hdr.precision,
        tuple((c.h, c.v) for c in hdr.components), hdr.colorspace,
        scan.restart_interval,
        tuple(sorted((tid, spec.counts.tobytes(), spec.symbols.tobytes())
                     for tid, spec in scan.dc_specs.items())),
        tuple(sorted((tid, spec.counts.tobytes(), spec.symbols.tobytes())
                     for tid, spec in scan.ac_specs.items())),
        tuple(sorted((tid, t.values.tobytes())
                     for tid, t in hdr.quant_tables.items())))


def decode_batch_sharded(blobs, device="cuda", *, idct="kron",
                         upsample="fancy"):
    """Decode a list of JPEG blobs with entropy decode, plane assembly and
    pixels on the device, per geometry group (see the module docstring for
    the routes and the kernel each runs).

    Returns a list of ``models.batch.BatchItem`` in input order; failures
    stay per image.  ``idct="kron"`` is the JAX function's default (within
    +-1 of ``exact``); ``"pallas"`` runs K1 and ``"exact"`` K5 on the card.
    RGB stays on ``device``; on the card the caller's current stream waits
    for the decode and every returned tensor is recorded on it.

    After each call ``decode_batch_sharded.last_timing`` holds host-clock
    seconds of the parse (``parse_s``), the dispatch of every group
    (``dispatch_s``), the progressive frames (``progressive_s``, of
    ``progressive`` frames, ``progressive_fallback`` of them sent to the
    host fallback), the host fallback (``fallback_s``, of
    ``host_fallback`` images) and the flag fetch and per-row fallback
    (``finish_s``, of ``fallback_rows`` rows), and per group (``groups``)
    its route, images, host plan seconds (the walks or ``prepare_scan``)
    and, on the card, its device milliseconds from the end of the host plan
    (CUDA events on its stream): ``entropy_ms`` (copy, tables and the
    entropy kernel), ``pixels_ms`` (plane gather and the pixel pipeline)
    and their sum ``device_ms``; and K7's counters.
    """
    dev = routing.resolve_device(device)
    cuda = dev.type == "cuda"
    timing: dict = {"groups": []}
    t_start = time.perf_counter()
    results: list = [None] * len(blobs)
    groups: dict[tuple, list] = {}
    host_fallback: list[int] = []
    prog_frames: list = []
    native_ok = native.available()
    emit_max_lanes = int(os.environ.get("JD_RESTART_EMIT_MAX_LANES", "512"))
    spec = os.environ.get("JD_DEVICE_ENTROPY", "hybrid") == "spec"
    use_dyn = (native_ok and not spec
               and os.environ.get("JD_SHARDED_BUCKET", "pow2") == "pow2")
    for i, blob in enumerate(blobs):
        try:
            hdr = parser.parse(blob)
            if (hdr.progressive and not hdr.arithmetic
                    and hdr.precision == 8):
                prog_frames.append((i, hdr))
                continue
            scan = hdr.scans[0]
            if (hdr.progressive or hdr.arithmetic
                    or hdr.precision not in (8, 12)
                    or routing.needs_scan_loop(hdr)
                    or routing.segment_mismatch(hdr, scan)):
                host_fallback.append(i)
                continue
            exact_key = _exact_key(hdr, scan)
            n_seg = len(scan.seg_offsets) - 1
            if use_dyn and n_seg < emit_max_lanes:
                key = ("dyn", _bucket_pow2(hdr.mcus_x),
                       _bucket_pow2(hdr.mcus_y),
                       tuple((c.h, c.v) for c in hdr.components),
                       hdr.colorspace, hdr.precision)
            else:
                key = exact_key
            groups.setdefault(key, []).append((i, hdr, scan, exact_key))
        except Exception as e:  # noqa: BLE001 — per-image isolation
            results[i] = BatchItem(index=i, header=None, rgb_batch=None,
                                   batch_index=-1, error=e)
    timing["parse_s"] = time.perf_counter() - t_start

    caller = torch.cuda.current_stream(dev) if cuda else None
    streams: list = []
    tls = threading.local()
    dispatched: list = [None] * len(groups)

    def dispatch(slot, key, items):
        hdr0 = items[0][1]
        b = len(items)
        scans = [it[2] for it in items]
        n_seg0 = len(hdr0.scans[0].seg_offsets) - 1
        ri0 = hdr0.scans[0].restart_interval
        rec = {"slot": slot, "images": b, "host_s": 0.0, "cuda": cuda,
               "marks": []}
        t0 = time.perf_counter()
        if cuda and getattr(tls, "stream", None) is None:
            tls.stream = torch.cuda.Stream(dev)
            streams.append(tls.stream)
        stream = tls.stream if cuda else None
        try:
            with (torch.cuda.stream(stream) if cuda
                  else contextlib.nullcontext()):
                if cuda:
                    stream.wait_stream(caller)
                kw = dict(idct=idct, upsample=upsample)
                row_of = list(range(b))
                if key[0] == "dyn":
                    uniform = len({it[3] for it in items}) == 1
                    wide = ri0 and b * n_seg0 >= emit_max_lanes
                    if uniform and not wide:
                        rec["route"] = "emit"
                        rgb, bad = _emit_group(hdr0, scans, dev, rec, **kw)
                        fallback = True
                    elif uniform:
                        rec["route"] = "k2"
                        rgb, bad = _k2_group(hdr0, scans, dev, rec, **kw)
                        fallback = False
                    else:
                        rec["route"] = "dyn"
                        rgb, bad, row_of = _dyn_group(
                            [it[1] for it in items], scans, dev, rec, **kw)
                        fallback = "dyn"
                else:
                    use_emit_restart = (ri0 and native_ok
                                        and b * n_seg0 < emit_max_lanes
                                        and not spec)
                    if ri0 and not use_emit_restart:
                        rec["route"] = "k2"
                        rgb, bad = _k2_group(hdr0, scans, dev, rec, **kw)
                        fallback = False
                    elif use_emit_restart or (native_ok and not spec):
                        rec["route"] = "emit"
                        rgb, bad = _emit_group(hdr0, scans, dev, rec, **kw)
                        fallback = True
                    else:
                        rec["route"] = "spec"
                        rgb, bad = _k2_group(hdr0, scans, dev, rec, **kw)
                        fallback = True
                _mark(rec, "pixels")
            dispatched[slot] = (items, rgb, bad, fallback, row_of)
        except Exception as e:  # noqa: BLE001 — the group's images fail
            for it in items:
                results[it[0]] = BatchItem(index=it[0], header=it[1],
                                           rgb_batch=None, batch_index=-1,
                                           error=e)
        rec["dispatch_s"] = time.perf_counter() - t0
        timing["groups"].append(rec)

    t0 = time.perf_counter()
    group_list = list(groups.items())
    if len(group_list) > 1:
        with ThreadPoolExecutor(2) as ex:
            list(ex.map(lambda sk: dispatch(sk[0], *sk[1]),
                        enumerate(group_list)))
    else:
        for slot, (key, items) in enumerate(group_list):
            dispatch(slot, key, items)
    timing["dispatch_s"] = time.perf_counter() - t0

    # Progressive frames on the device lanes, while the groups run; a frame
    # whose lanes flag or whose walk refuses the stream (JPEGError) joins
    # the host fallback; any other failure (a kernel that does not build or
    # launch) is the image's error.
    t0 = time.perf_counter()
    prog_done: list = []
    prog_fallback: list = []

    def prog(arg):
        i, hdr = arg
        if cuda and getattr(tls, "stream", None) is None:
            tls.stream = torch.cuda.Stream(dev)
            streams.append(tls.stream)
        try:
            with (torch.cuda.stream(tls.stream) if cuda
                  else contextlib.nullcontext()):
                if cuda:
                    tls.stream.wait_stream(caller)
                rgb = _prog_one(hdr, dev, idct=idct, upsample=upsample)
            prog_done.append((i, hdr, rgb))
        except JPEGError:
            prog_fallback.append(i)
        except Exception as e:  # noqa: BLE001 — per-image isolation
            results[i] = BatchItem(index=i, header=hdr, rgb_batch=None,
                                   batch_index=-1, error=e)

    if len(prog_frames) > 1:
        with ThreadPoolExecutor(2) as ex:
            list(ex.map(prog, prog_frames))
    else:
        for pf in prog_frames:
            prog(pf)
    timing["progressive_s"] = time.perf_counter() - t0
    timing["progressive"] = len(prog_frames)
    timing["progressive_fallback"] = len(prog_fallback)
    host_fallback += sorted(prog_fallback)

    # Frames the device routes do not cover decode while the groups run.
    t0 = time.perf_counter()
    if host_fallback:
        with BatchDecoder(device=dev, idct=idct, upsample=upsample) as bd:
            host_items = bd.decode([blobs[i] for i in host_fallback])
        for i, it in zip(host_fallback, host_items):
            results[i] = BatchItem(index=i, header=it.header,
                                   rgb_batch=it.rgb_batch,
                                   batch_index=it.batch_index, error=it.error)
    timing["fallback_s"] = time.perf_counter() - t0
    timing["host_fallback"] = len(host_fallback)
    timing["fallback_rows"] = 0

    # Every group's flags in one device-to-host copy, after the caller's
    # stream has waited for the dispatch streams.
    t0 = time.perf_counter()
    for s in streams:
        caller.wait_stream(s)
    for i, hdr, rgb in prog_done:
        if cuda:
            rgb.record_stream(caller)
        results[i] = BatchItem(index=i, header=hdr, rgb_batch=rgb,
                               batch_index=0)
    dispatched = [d for d in dispatched if d is not None]
    flags = (torch.cat([d[2] for d in dispatched]).cpu().numpy()
             if dispatched else np.zeros(0, bool))
    o = 0
    for items, rgb, _, fallback, row_of in dispatched:
        bad = flags[o:o + len(items)]
        o += len(items)
        if cuda:
            rgb.record_stream(caller)
        for k, (i, hdr, scan, _) in enumerate(items):
            rgb_k, row, err = rgb, row_of[k], None
            if bad[row] and not fallback:
                err = JPEGError("device entropy decode failed")
            elif bad[row]:
                timing["fallback_rows"] += 1
                try:
                    one = _host_rgb_one(hdr, scan, dev, idct=idct,
                                        upsample=upsample)
                    if fallback == "dyn":
                        rgb_k, row = one[None], 0
                    else:
                        rgb[row] = one
                except Exception as e:  # noqa: BLE001 — per image
                    err = e
            results[i] = BatchItem(index=i, header=hdr, rgb_batch=rgb_k,
                                   batch_index=row, error=err)
    timing["groups"].sort(key=lambda r: r["slot"])
    for rec in timing["groups"]:
        marks = dict(rec.pop("marks"))
        del rec["cuda"]
        if len(marks) == 3:
            rec["entropy_ms"] = marks["plan"].elapsed_time(marks["entropy"])
            rec["pixels_ms"] = marks["entropy"].elapsed_time(marks["pixels"])
            rec["device_ms"] = rec["entropy_ms"] + rec["pixels_ms"]
        if rec.get("k7_stats") is not None:
            rec["k7_stats"] = dict(zip(entropy_emit_cuda.STATS,
                                       rec["k7_stats"].tolist()))
    timing["finish_s"] = time.perf_counter() - t0
    decode_batch_sharded.last_timing = timing
    return results


#: Timing of the last :func:`decode_batch_sharded` call (see there).
decode_batch_sharded.last_timing = {}
