"""Device-entropy batch decode: entropy, plane assembly and pixels on the
card per geometry group, from raw entropy words, on one GPU or over a
``('data', 'seg')`` mesh of ranks.

Counterpart of ``jpeg_decoder_tpu/parallel/sharded.py``.  Where the JAX
functions take ``mesh``, these take a ``device`` (``"cuda"`` by default,
which raises without a card; ``"cpu"`` runs the kernels' plain versions) or
a ``torch.distributed`` ``DeviceMesh`` (``parallel/mesh.py``; one process
per GPU).  On a mesh every rank of the mesh calls the function with the same
arguments and launches the same kernels as on one GPU, on its share:

* ``data`` splits a group's images, JAX's ``ceil(B / n_data)`` rows per
  coordinate (``multihost.local_data_rows``);
* ``seg`` splits each image's restart segments (K2) or lanes (K7), padded
  to a multiple of ``seg`` as JAX pads them; the ranks of a ``seg`` line
  all-gather the blocks each decoded (its own row ranges only: K7 leaves
  the rows of other ranks' lanes unwritten) and K7's DC carry crosses the
  ranks through ``ops/emit_carry_cuda.carry_pack``, which also packs the
  rows a rank sends; the pixels of a row run on every ``seg`` rank of its
  ``data`` coordinate, as JAX replicates them over ``seg``;
* a progressive frame's lanes split over the whole mesh
  (``ops/entropy_prog.py``), its RGB replicated on every rank, as is the
  host fallback's.

The output layout is the counterpart of a ``data``-sharded ``jax.Array``: a
group's ``BatchItem.rgb_batch`` holds on each rank only the rows
``local_data_rows`` gives it, ``BatchItem.rows`` says which, and
``batch_index`` stays the row in the whole batch; ``it.rgb`` of a row held
elsewhere raises IndexError.  :func:`allgather_items` (or
``multihost.process_allgather`` on one batch) rebuilds the whole batches.
Every rank returns the same items with the same errors.

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
  launch of K7 (``csrc/entropy_emit.cu``) over the whole group, then the
  pixels (one launch of K6b, ``ops/pixels_cuda.blocks_to_rgb``, with K1's
  arithmetic under ``idct="pallas"`` and ``"kron"``, K5's under ``"exact"``
  and its own separable form under ``"fast"``) — JAX's
  ``_hybrid_group_dispatch`` with its default ``emit`` kernel;
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
of all groups come back in one device-to-host copy; on a mesh of more than
one rank the groups and the progressive frames go one at a time, in the
same order on every rank (two threads issuing collectives on one group can
interleave them differently on different ranks), and the flags come back in
one all-gather over the mesh.  The JAX package's
``JD_HYBRID_KERNEL=lockstep|flat`` kernels are not ported: the port always
runs the emit lanes.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..entropy import native
from ..io import parser
from ..layout import scan_layout
from ..models import decoder as decoder_mod
from ..models import routing
from ..models.batch import (BatchDecoder, BatchItem, _bucket_pow2,
                            rgb_from_blocks_dyn)
from ..ops import (emit_carry_cuda, entropy_cuda, entropy_emit_cuda,
                   entropy_prog, entropy_spec, scan_prep)
from ..ops import pixel as pixel_ops
from ..ops.staging import upload as _upload
from ..types import FrameHeader, JPEGError, ScanHeader
from . import mesh as mesh_mod
from . import multihost

# K7's counters of a launch are read under this lock, so that the two
# dispatch threads do not read each other's.
_k7_lock = threading.Lock()


class _Place(NamedTuple):
    """Where this rank sits: the mesh (None on one GPU), the 'data' and
    'seg' sizes and this rank's coordinates on them (an axis the mesh lacks
    is one rank)."""

    mesh: object
    n_data: int
    d: int
    n_seg: int
    s: int

    @property
    def world(self) -> int:
        return self.n_data * self.n_seg


def _target(device) -> tuple[torch.device, _Place]:
    """The device and place of a ``device`` argument: a device (or its
    name) or a ``DeviceMesh`` whose axes are 'data' and/or 'seg'."""
    if not mesh_mod.is_mesh(device):
        return routing.resolve_device(device), _Place(None, 1, 0, 1, 0)
    mesh = device
    names = tuple(mesh.mesh_dim_names or ())
    if not names or any(a not in mesh_mod.AXES for a in names):
        raise ValueError(f"mesh axes must be 'data' and/or 'seg', got "
                         f"{names}")
    ax = {a: (mesh_mod.size(mesh, a), mesh_mod.coordinate(mesh, a))
          for a in names}
    nd, d = ax.get("data", (1, 0))
    ns, s = ax.get("seg", (1, 0))
    return mesh_mod.mesh_device(mesh), _Place(mesh, nd, d, ns, s)


def _ranges(lo, hi, stride: int, dev) -> torch.Tensor:
    """The int64 indices ``k * stride + r`` for every k and r in
    [lo[k], hi[k]) (``lo``/``hi`` host int arrays), on ``dev``."""
    lo = np.asarray(lo, np.int64)
    span = np.maximum(np.asarray(hi, np.int64) - lo, 0)
    first = np.arange(len(lo), dtype=np.int64) * stride + lo
    first, span = (torch.from_numpy(a).to(dev) for a in (first, span))
    n = int(span.sum())
    return (torch.repeat_interleave(first - (span.cumsum(0) - span), span)
            + torch.arange(n, device=dev))


def decode_scan_sharded(hdr: FrameHeader, scan: ScanHeader,
                        device="cuda") -> np.ndarray:
    """Baseline scan decode with the restart segments as K2's lanes
    (:func:`_k2_blocks`).  On one GPU one launch over every segment; on a
    mesh each 'seg' rank decodes its slice of the segments (padded to a
    multiple of 'seg', as JAX pads them) and the ranks all-gather the
    blocks, so every rank returns the whole scan.
    Returns the (n_mcus*bpm, 64) int32 scan-order blocks on the host; a
    flagged segment raises :class:`JPEGError` (on every rank)."""
    dev, place = _target(device)
    if hdr.precision not in (8, 12):
        raise JPEGError(f"device entropy decodes 8- and 12-bit frames, got "
                        f"{hdr.precision}-bit")
    words, nm, block_comp, max_mcus, lay = scan_prep.prepare_scan(hdr, scan)
    blocks, err = _k2_blocks(hdr, scan, words[None], nm[None], max_mcus,
                             dev, place, {"exchange_s": 0.0,
                                          "exchange_bytes": 0})
    err = _segment_flags(err, len(nm), place)
    bad = np.flatnonzero(err[0].cpu().numpy())
    if bad.size:
        raise JPEGError(f"sharded entropy decode failed in segments "
                        f"{bad[:8].tolist()} ({bad.size} of {len(nm)})")
    return blocks[0, :lay.n_mcus * len(block_comp)].cpu().numpy()


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


def _samplings(hdr: FrameHeader) -> tuple:
    return tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                 for c in hdr.components)


def header_geom(hdr: FrameHeader, b: int, device) -> torch.Tensor:
    """(B, 4) int32 rows of the header's geometry (mcus_x, mcus_y, height,
    width) on ``device``: K6b's closed-form plane geometry with the exact
    dims as the bucket, which is ``scan_layout``'s ``comp_src``
    (tests/test_torch_pixels.py)."""
    row = torch.tensor((hdr.mcus_x, hdr.mcus_y, hdr.height, hdr.width),
                       dtype=torch.int32)
    return row.repeat(b, 1).to(device)


def _pixels(blocks, qt, srcs, hdr, *, idct, upsample):
    """(B, H, W, 3) RGB of same-geometry images from the scan-order
    ``blocks`` (B, N, 64) and ``qt`` (B, n_comps, 64).  On the card one
    launch of K6b (``models.batch.rgb_from_blocks_dyn``) with the header's
    geometry (:func:`header_geom`); on the CPU :func:`_pixels_torch`."""
    if not blocks.is_cuda:
        return _pixels_torch(blocks, qt, srcs, hdr, idct=idct,
                             upsample=upsample)
    lay = scan_layout(hdr)
    return rgb_from_blocks_dyn(
        blocks, qt, header_geom(hdr, blocks.shape[0], blocks.device),
        comp_shapes=tuple(lay.comp_shapes),
        comp_hv=tuple((c.h, c.v) for c in hdr.components),
        height=hdr.height, width=hdr.width, samplings=_samplings(hdr),
        idct=idct, upsample=upsample, color=hdr.colorspace,
        precision=hdr.precision)


def _pixels_torch(blocks, qt, srcs, hdr, *, idct, upsample):
    """The plain route K6b replaces in :func:`_pixels`: each component's
    plane gathered from ``blocks`` by ``srcs`` (int64 row indices), then
    the pixel pipeline (K1 or K5 and torch ops on a CUDA tensor)."""
    lay = scan_layout(hdr)
    b = blocks.shape[0]
    planes = tuple(blocks.index_select(1, src).view(b, rows, cols, 64)
                   for src, (rows, cols) in zip(srcs, lay.comp_shapes))
    return pixel_ops.pixel_pipeline_impl(
        planes, tuple(qt[:, i].contiguous() for i in range(len(srcs))),
        height=hdr.height, width=hdr.width, samplings=_samplings(hdr),
        idct=idct, upsample=upsample, color=hdr.colorspace,
        precision=hdr.precision)


def batch_pixel_pipeline(planes_batch, qtables, hdr: FrameHeader,
                         mesh=None, *, idct="fast", upsample="fancy"):
    """The pixel pipeline on a batch of same-geometry images.

    ``planes_batch``: per component a (B, rows, cols, 64) int32 array or
    tensor; ``qtables``: per component its (64,) table.  ``mesh``: a
    ``DeviceMesh``, a device, or None (the card).  On a mesh the batch is
    split over 'data' x 'seg' flattened (pure image parallelism, as JAX
    shards it) and each rank returns only its rows, ``mesh_mod.split(B, ranks,
    coordinate)``: ``multihost.process_allgather(rgb, mesh, ("data",
    "seg"))`` rebuilds the batch.  ``idct="pallas"`` runs K1 and
    ``"exact"`` K5.  Returns (B_rank, H, W, 3) RGB on the rank's device."""
    dev, place = _target(mesh)
    b = int(planes_batch[0].shape[0])
    lo, hi = mesh_mod.split(b, place.world, place.d * place.n_seg + place.s)
    planes = tuple(torch.as_tensor(p)[lo:hi].to(dev, torch.int32)
                   for p in planes_batch)
    qts = tuple(torch.as_tensor(np.asarray(q, np.int32)).to(dev)
                .reshape(1, 64).expand(hi - lo, 64).contiguous()
                for q in qtables)
    return pixel_ops.pixel_pipeline_impl(
        planes, qts, height=hdr.height, width=hdr.width,
        samplings=_samplings(hdr), idct=idct, upsample=upsample,
        color=hdr.colorspace, precision=hdr.precision)


def _mark(rec: dict, name: str) -> None:
    """On the card, a CUDA event recorded on the current stream at the end
    of the group's stage ``name`` (read after the flags: the device times
    of the stages between two marks)."""
    if rec.get("cuda"):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        rec["marks"].append((name, ev))


def _exchange(rec: dict, fn, nbytes: int):
    """Run the collective ``fn()``, adding its host seconds and the bytes
    it gathers on this rank to the group's record."""
    t0 = time.perf_counter()
    out = fn()
    rec["exchange_s"] += time.perf_counter() - t0
    rec["exchange_bytes"] += nbytes
    return out


def _k7(args, rec, **kw):
    """One ``decode_lanes`` call; on the card the launch's counters go to
    ``rec["k7_stats"]`` (a device tensor, read after the flags)."""
    with _k7_lock:
        out = entropy_emit_cuda.decode_lanes(*args, **kw)
        if args[0].is_cuda:
            rec["k7_stats"] = entropy_emit_cuda.decode_lanes.last_stats
    return out


def share_mcus(nm_lane, lane_off, bpm: int, n_seg: int):
    """The MCUs each of ``n_seg`` ranks decodes of each image of a K7 plan
    (``nm_lane``/``lane_off`` (B, C), split ``ceil(C / n_seg)`` lanes a
    rank): (lane cuts, m_a, m_b), ``m_a``/``m_b`` (n_seg, B) int64, the
    rank's MCUs [m_a, m_b) of the image, 0/0 when it has none."""
    b, c = nm_lane.shape
    m_lo = lane_off // (64 * bpm)
    on = nm_lane > 0
    cuts = [mesh_mod.split(c, n_seg, q) for q in range(n_seg)]
    m_a = np.zeros((n_seg, b), np.int64)
    m_b = np.zeros((n_seg, b), np.int64)
    big = np.iinfo(np.int64).max
    for q, (j0, j1) in enumerate(cuts):
        mine = on[:, j0:j1]
        has = mine.any(1)
        # initial=: a rank past the last lane (C < n_seg) has no columns.
        lo = np.where(mine, m_lo[:, j0:j1], big).min(1, initial=big)
        hi = np.where(mine, m_lo[:, j0:j1] + nm_lane[:, j0:j1], 0).max(
            1, initial=0)
        m_a[q] = np.where(has, lo, 0)
        m_b[q] = np.where(has, hi, 0)
    return cuts, m_a, m_b


def carry_plan(m_a, m_b, s: int, intervals, img_mcus, bpm: int, rows: int,
               device=None) -> emit_carry_cuda.PackPlan:
    """Rank ``s``'s carry and pack (``emit_carry_cuda.carry_pack``'s plan),
    reckoned on the host from ``m_a``/``m_b`` (:func:`share_mcus`): w[q, b]
    = 1 for the ranks q < s whose last MCU of image b lies in the restart
    segment of rank s's first MCU; the carried rows [lo, hi) of rank s,
    from its first MCU to the end of that segment or of its share (empty
    where no rank carries in); its owned rows [m_a * bpm, m_b * bpm) of
    each image, their offsets in the send buffer, which holds the most rows
    any rank owns.  ``intervals``/``img_mcus`` (B,): each image's restart
    interval and MCUs; ``rows``: the blocks' rows an image.  On a CUDA
    ``device`` a plan too large for the kernel's parameters is copied to
    the card here (``emit_carry_cuda.pack_plan``)."""
    ri = np.asarray(intervals, np.int64)
    rs = np.maximum(ri, 1)

    def seg_start(m):
        return np.where(ri > 0, m // rs * rs, 0)

    head = seg_start(m_a[s])
    w = np.zeros(m_a.shape, np.int32)
    for q in range(s):
        w[q] = (m_b[q] > 0) & (m_b[s] > 0) & \
            (seg_start(np.maximum(m_b[q] - 1, 0)) == head)
    seg_end = np.where(ri > 0, head + rs, np.asarray(img_mcus, np.int64))
    lo = m_a[s] * bpm
    hi = np.where(w.any(0), np.minimum(seg_end, m_b[s]) * bpm, lo)
    return emit_carry_cuda.pack_plan(
        w, lo, hi, m_a[s] * bpm, m_b[s] * bpm, rows=rows, bpm=bpm,
        n_send=max(int(((m_b - m_a) * bpm).sum(1).max()), 1), device=device)


def _k7_shared(args, rec, place: _Place, nm_lane, lane_off, intervals,
               img_mcus, *, block_comp, rows, **kw):
    """K7 over a 'seg' line: this rank decodes its share of every image's
    lanes (``ceil(C / n_seg)`` of them, JAX's padded split), then the
    cross-rank DC carry and the exchange of the blocks.

    ``nm_lane``/``lane_off`` (B, C) are the host plan, ``intervals`` (B,)
    the images' restart intervals and ``img_mcus`` (B,) their MCUs.  Each
    rank owns the MCUs its lanes tile (:func:`share_mcus`).  The carry's
    plan (:func:`carry_plan`) is made before K7's launch.  The ranks
    all-gather, per (image, component), the DC total of the segment open at
    their last MCU; :func:`emit_carry_cuda.carry_pack` adds the totals of
    the ranks before this one in its first segment to that segment's blocks
    and packs the rows this rank owns into the send buffer, which the ranks
    all-gather as it is; each rank then writes the others' rows into its
    blocks, so every rank holds every image's blocks.  Returns (blocks,
    flags) as ``decode_lanes``, the flags of this rank's lanes only (the
    caller ORs them over 'seg')."""
    bpm = len(block_comp)
    n_comps = max(block_comp) + 1
    b = nm_lane.shape[0]
    dev = args[0].device
    cuts, m_a, m_b = share_mcus(nm_lane, lane_off, bpm, place.n_seg)
    plan = carry_plan(m_a, m_b, place.s, intervals, img_mcus, bpm, rows,
                      dev)
    j0, j1 = cuts[place.s]
    if j1 > j0:
        blocks, err = _k7(args, rec, block_comp=block_comp, rows=rows,
                          lanes=(j0, j1), **kw)
    else:   # no lanes here: zeros stand for K7's zero rows
        blocks = torch.zeros((b, rows, 64), dtype=torch.int32, device=dev)
        err = torch.zeros(b, dtype=torch.int32, device=dev)
    _mark(rec, "entropy")

    # This rank's DC totals: the last block of each component in its last
    # MCU, after K7's carry (which starts from 0 at its first lane).
    tot = dc_totals(blocks, m_b[place.s], block_comp)
    tot = torch.stack(_exchange(rec, lambda: mesh_mod.all_gather(
        tot, place.mesh, "seg"), 4 * b * n_comps * place.n_seg))
    send = emit_carry_cuda.carry_pack(blocks, tot, plan,
                                      block_comp=block_comp)
    _mark(rec, "pack")

    # The blocks: every rank's own row ranges.
    counts = [int(((m_b[q] - m_a[q]) * bpm).sum())
              for q in range(place.n_seg)]
    parts = _exchange(rec, lambda: mesh_mod.all_gather_rows(
        send, place.mesh, "seg", counts), 256 * plan.n_send * place.n_seg)
    flat = blocks.view(-1, 64)
    for q, part in enumerate(parts):
        if q != place.s and counts[q]:
            flat[_ranges(m_a[q] * bpm, m_b[q] * bpm, rows, dev)] = part
    _mark(rec, "exchange")
    return blocks, err


def dc_totals(blocks: torch.Tensor, m_b, block_comp) -> torch.Tensor:
    """(B, n_comps) int32: the DC of each component's last block in MCU
    ``m_b[b] - 1`` of image b (0 where ``m_b`` is 0), the DC total of the
    segment open at a rank's last MCU after its K7 launch."""
    b, rows = blocks.shape[:2]
    bpm = len(block_comp)
    n_comps = max(block_comp) + 1
    last_k = [max(k for k, c in enumerate(block_comp) if c == ci)
              for ci in range(n_comps)]
    m_b = np.asarray(m_b, np.int64)
    at = (np.arange(b)[:, None] * rows
          + np.maximum(m_b - 1, 0)[:, None] * bpm + np.array(last_k))
    dev = blocks.device
    tot = blocks.view(-1, 64)[torch.from_numpy(at.reshape(-1)).to(dev), 0]
    return torch.where(torch.from_numpy(m_b > 0).to(dev)[:, None],
                       tot.view(b, n_comps), 0)


def _emit_group(hdr, scans, dev, rec, place, *, idct, upsample):
    """A uniform group through K7 (JAX's ``_hybrid_group_dispatch``, its
    ``emit`` kernel): the lane plans of every image (``device_plan``), one
    launch over the group (on a mesh: this rank's share of the lanes,
    :func:`_k7_shared`), pixels.  Returns (rgb, bad)."""
    t0 = time.perf_counter()
    (pools, starts, nm, lane_off, t_sym, _, _, seg_first,
     skel_ok) = entropy_spec.device_plan(hdr, scans)
    rec["host_s"] += time.perf_counter() - t0
    _mark(rec, "plan")
    luts, l1 = entropy_cuda.device_tables(hdr, scans[0], dev)
    (pools_t, starts_t, nm_t, off_t, seg_t, skel_bad, qt) = _upload(
        [pools, starts, nm, lane_off, seg_first, ~skel_ok,
         _qtables([hdr] * len(scans))], dev)
    lay = scan_layout(hdr)
    kw = dict(block_comp=entropy_spec._block_comp(hdr),
              n_comps=len(hdr.components), n_mcus=lay.n_mcus, trips=t_sym,
              precision=hdr.precision, l1=l1)
    args = (pools_t, starts_t, nm_t, off_t, seg_t, luts)
    if place.n_seg == 1:
        blocks, err = _k7(args, rec, **kw)
        _mark(rec, "entropy")
    else:
        b = len(scans)
        blocks, err = _k7_shared(
            args, rec, place, nm, lane_off,
            [scans[0].restart_interval] * b, [lay.n_mcus] * b,
            rows=lay.n_mcus * lay.blocks_per_mcu, **kw)
    rgb = _pixels(blocks, qt, decoder_mod._comp_srcs(hdr, dev), hdr,
                  idct=idct, upsample=upsample)
    return rgb, (err != 0) | skel_bad


def _k2_blocks(hdr, scan, words, nm, max_mcus, dev, place: _Place, rec):
    """K2 over B same-geometry images' restart segments, ``words`` (B, S,
    W) uint32 and ``nm`` (B, S) MCUs: one launch over the B * S segments,
    or on a mesh over this 'seg' rank's slice of each image's segments
    (``ceil(S / n_seg)``, JAX's padded split) and an all-gather of the
    slices.  Returns ((B, S * max_mcus * bpm, 64) int32 scan-order rows
    with every segment's padding, (B, S_rank) int32 flags of this rank's
    segments, :func:`_segment_flags` gathers them) on ``dev``."""
    b, s_all, w = words.shape
    lo, hi = mesh_mod.split(s_all, place.n_seg, place.s)
    bpm = len(entropy_spec._block_comp(hdr))
    if b == 0:
        return (torch.zeros((0, s_all * max_mcus * bpm, 64),
                            dtype=torch.int32, device=dev),
                torch.zeros((0, s_all), dtype=torch.int32, device=dev))
    luts, l1 = entropy_cuda.device_tables(hdr, scan, dev)
    kw = dict(block_comp=entropy_spec._block_comp(hdr),
              n_comps=len(hdr.components), max_mcus=max_mcus, l1=l1,
              precision=hdr.precision)
    if hi > lo:
        words_t, nm_t = _upload(
            [np.ascontiguousarray(words[:, lo:hi]).reshape(-1, w),
             np.ascontiguousarray(nm[:, lo:hi], np.int32).reshape(-1)], dev)
        out, err = entropy_cuda.decode_segments(words_t, nm_t, luts, **kw)
    else:
        out = torch.zeros((0, max_mcus * bpm, 64), dtype=torch.int32,
                          device=dev)
        err = torch.zeros(0, dtype=torch.int32, device=dev)
    out = out.view(b, hi - lo, max_mcus * bpm, 64)
    err = err.view(b, hi - lo)
    _mark(rec, "entropy")
    if place.n_seg > 1:
        counts = _seg_counts(s_all, place)
        per = max(counts)
        out = torch.cat(_exchange(rec, lambda: mesh_mod.all_gather_rows(
            out, place.mesh, "seg", counts, dim=1),
            4 * b * per * max_mcus * bpm * 64 * place.n_seg), 1)
        _mark(rec, "exchange")
    return out.reshape(b, -1, 64), err


def _seg_counts(s_all: int, place: _Place) -> list:
    """The segments of each 'seg' rank's slice of ``s_all``."""
    return [hi - lo for lo, hi in (mesh_mod.split(s_all, place.n_seg, q)
                                   for q in range(place.n_seg))]


def _segment_flags(err: torch.Tensor, s_all: int,
                   place: _Place) -> torch.Tensor:
    """The (B, S) flags of all ``s_all`` segments, from :func:`_k2_blocks`'
    flags of this rank's slice: an all-gather over 'seg' on a mesh."""
    if place.n_seg == 1:
        return err
    return torch.cat(mesh_mod.all_gather_rows(
        err, place.mesh, "seg", _seg_counts(s_all, place), dim=1), 1)


def _k2_group(hdr, scans, dev, rec, place, *, idct, upsample):
    """A uniform group through K2 (JAX's ``full_decode_step``, and its
    ``spec`` route on one segment per image): every image's segments
    (``prepare_scan``), padded to the group's (B, S, W) and flattened to
    B * S lanes of one launch (on a mesh, :func:`_k2_blocks`' slice), then
    the padded-row gather (jax sharded.py:316-325: every segment but the
    last holds max_mcus MCUs, so the padded rows are the scan order and the
    scan layout's maps apply) and pixels.  Returns (rgb, bad), ``bad`` from
    this rank's segments (:func:`_gather_flags` ORs it over 'seg')."""
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
    blocks, err = _k2_blocks(hdr, scans[0], words, nm_b, max_mcus, dev,
                             place, rec)
    (qt,) = _upload([_qtables([hdr] * b)], dev)
    rgb = _pixels(blocks, qt, decoder_mod._comp_srcs(hdr, dev), hdr,
                  idct=idct, upsample=upsample)
    return rgb, err.any(1)


def full_decode_step(hdr: FrameHeader, words_b: np.ndarray,
                     nm_b: np.ndarray, device="cuda", *, idct="fast",
                     upsample="fancy"):
    """Decode a batch of same-geometry restart-segment images in one step:
    K2 over the segments, the padded-row plane gather and pixels (JAX's
    ``full_decode_step``, jax sharded.py:296).

    ``words_b``/``nm_b``: (B, S, W) uint32 / (B, S) per-segment packed
    streams and MCUs (``scan_prep.prepare_scan`` per image, padded).
    ``device``: a device or a ``DeviceMesh``; on a mesh the images split
    over 'data' and each image's segments over 'seg' (K2 on this rank's
    slice, then an all-gather of the slices over 'seg'), and each rank
    returns its 'data' rows (``multihost.local_data_rows``).  Returns (rgb
    (B_rank, H, W, 3), err (B_rank, S) bool per segment, err_img (B_rank,)
    bool) on the rank's device; ``multihost.process_allgather`` rebuilds
    each."""
    dev, place = _target(device)
    scan = hdr.scans[0]
    lay = scan_layout(hdr)
    ri = scan.restart_interval
    max_mcus = ri if ri else lay.n_mcus
    b0, b1 = mesh_mod.split(words_b.shape[0], place.n_data, place.d)
    if b1 == b0:    # no row here (and none on this rank's 'seg' line)
        return (torch.zeros((0, hdr.height, hdr.width, 3),
                            dtype=pixel_ops._sample_dtype(hdr.precision),
                            device=dev),
                torch.zeros((0, words_b.shape[1]), dtype=torch.bool,
                            device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    rec = {"exchange_s": 0.0, "exchange_bytes": 0}
    blocks, err = _k2_blocks(hdr, scan, np.asarray(words_b[b0:b1],
                                                   np.uint32),
                             np.asarray(nm_b[b0:b1]), max_mcus, dev, place,
                             rec)
    (qt,) = _upload([_qtables([hdr] * (b1 - b0))], dev)
    rgb = _pixels(blocks, qt, decoder_mod._comp_srcs(hdr, dev), hdr,
                  idct=idct, upsample=upsample)
    err = _segment_flags(err, words_b.shape[1], place) != 0
    return rgb, err, err.any(1)


def _dyn_group(hdrs, scans, dev, rec, place, bucket, *, idct, upsample):
    """A geometry-bucketed group through K7 (JAX's
    ``_hybrid_group_dispatch_dyn``): the group plan (at the whole group's
    ``bucket``), one launch with each image's table set and geometry (the
    kernel zeroes each image's rows past its blocks, and the fill row the
    plane gather reads; on a mesh this rank's share of the lanes,
    :func:`_k7_shared`), then the bucket's pixels.  Returns (rgb, bad,
    order), the rows in the plan's order (``order[k]``: the position of row
    k; :func:`_global_rows`)."""
    t0 = time.perf_counter()
    plan = entropy_spec.plan_bucket_group(hdrs, scans, bucket=bucket)
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
    kw = dict(block_comp=entropy_spec._block_comp(hdr0),
              n_comps=len(plan.comp_hv), n_mcus=plan.n_mcus,
              trips=plan.trips, precision=hdr0.precision, l1=l1,
              lut_base=lut_base, n_mcus_img=n_mcus_img, ri=ri)
    args = (pools, starts, nm, lane_off, None, luts)
    rows = plan.n_mcus * bpm + 1
    if place.n_seg == 1:
        blocks, err = _k7(args, rec, rows=rows, **kw)
        _mark(rec, "entropy")
    else:
        blocks, err = _k7_shared(args, rec, place, plan.nm_lane,
                                 plan.lane_off, plan.ri, plan.n_mcus_img,
                                 rows=rows, **kw)
    rgb = rgb_from_blocks_dyn(
        blocks, qt, geom, comp_shapes=plan.comp_shapes,
        comp_hv=plan.comp_hv, height=plan.height, width=plan.width,
        samplings=plan.samplings, idct=idct, upsample=upsample,
        color=hdr0.colorspace, precision=hdr0.precision)
    return rgb, (err != 0) | skel_bad, plan.order


def _rows_of(order: list) -> list:
    """The row of each group position in a plan whose row k is position
    ``order[k]``."""
    row_of = [0] * len(order)
    for row, k in enumerate(order):
        row_of[k] = row
    return row_of


def _prog_one(hdr, dev, *, idct, upsample) -> torch.Tensor:
    """A progressive frame's (1, H, W, 3) RGB: its planes from the device
    lanes (``dev`` a device or a mesh; raises JPEGError when a lane is
    flagged), then the pixel pipeline."""
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
        width=hdr.width, samplings=_samplings(hdr), idct=idct,
        upsample=upsample, color=hdr.colorspace, precision=hdr.precision)


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


def _global_rows(items: list, place: _Place, order) -> list:
    """The row of each position of a bucketed group in the group's whole
    batch: each 'data' share's plan sorts its rows by table set, ``order``
    on this rank's share (``entropy_spec.bucket_order`` again for the
    other 'data' coordinates' shares)."""
    b = len(items)
    out = [0] * b
    for d in range(place.n_data):
        lo, hi = mesh_mod.split(b, place.n_data, d)
        if hi > lo:
            share = items[lo:hi]
            share_order = order if d == place.d else entropy_spec.bucket_order(
                [it[1] for it in share], [it[2] for it in share])[0]
            for k, row in enumerate(_rows_of(share_order)):
                out[lo + k] = lo + row
    return out


def _route(key, items, native_ok: bool, spec: bool,
           emit_max_lanes: int) -> str:
    """The route of a group: "emit", "k2", "dyn" or "spec" (the JAX
    function's routing, jax sharded.py:1187-1257)."""
    hdr0 = items[0][1]
    b = len(items)
    n_seg0 = len(hdr0.scans[0].seg_offsets) - 1
    ri0 = hdr0.scans[0].restart_interval
    if key[0] == "dyn":
        uniform = len({it[3] for it in items}) == 1
        wide = ri0 and b * n_seg0 >= emit_max_lanes
        if uniform and not wide:
            return "emit"
        return "k2" if uniform else "dyn"
    use_emit_restart = (ri0 and native_ok and b * n_seg0 < emit_max_lanes
                        and not spec)
    if ri0 and not use_emit_restart:
        return "k2"
    if use_emit_restart or (native_ok and not spec):
        return "emit"
    return "spec"


def _empty_rgb(route: str, items: list, dev) -> torch.Tensor:
    """The (0, H, W, 3) batch of a rank that holds none of a group's rows
    (the dims and sample type the others' rows have)."""
    hdr0 = items[0][1]
    h, w = hdr0.height, hdr0.width
    if route == "dyn":
        mx, my = entropy_spec.bucket_dims([it[1] for it in items])
        h = my * 8 * hdr0.v_max
        w = mx * 8 * hdr0.h_max
    dtype = pixel_ops._sample_dtype(hdr0.precision)
    return torch.zeros((0, h, w, 3), dtype=dtype, device=dev)


def decode_batch_sharded(blobs, device="cuda", *, idct="kron",
                         upsample="fancy"):
    """Decode a list of JPEG blobs with entropy decode, plane assembly and
    pixels on the device, per geometry group (see the module docstring for
    the routes and the kernel each runs).

    ``device``: a device (``"cuda"`` by default) or a ``DeviceMesh``
    (``parallel/mesh.py``), which every rank of the mesh passes with the
    same blobs.  Returns a list of ``models.batch.BatchItem`` in input
    order; failures stay per image, and on a mesh every rank returns the
    same errors.  ``idct="kron"`` is the JAX function's default (within
    +-1 of ``exact``); ``"pallas"`` runs K1 and ``"exact"`` K5 on the card.
    RGB stays on the rank's device; on the card the caller's current stream
    waits for the decode and every returned tensor is recorded on it.

    The output layout on a mesh: a geometry group's ``rgb_batch`` holds
    this rank's 'data' rows of the group, ``BatchItem.rows`` = (lo, hi)
    (``multihost.local_data_rows``), replicated over 'seg';
    ``batch_index`` is the row in the whole group batch, and ``it.rgb``
    raises IndexError for a row another rank holds.  Progressive frames,
    host-fallback frames and rows the per-image fallback re-decoded are
    whole on every rank (``rows`` None).  :func:`allgather_items` rebuilds
    every batch on every rank.

    After each call ``decode_batch_sharded.last_timing`` holds host-clock
    seconds of the parse (``parse_s``), the dispatch of every group
    (``dispatch_s``), the progressive frames (``progressive_s``, of
    ``progressive`` frames, ``progressive_fallback`` of them sent to the
    host fallback), the host fallback (``fallback_s``, of
    ``host_fallback`` images) and the flag fetch and per-row fallback
    (``finish_s``, of ``fallback_rows`` rows), and per group (``groups``)
    its route, images (this rank's), host plan seconds (the walks or
    ``prepare_scan``) and, on the card, its device milliseconds from the
    end of the host plan (CUDA events on its stream): ``entropy_ms`` (copy,
    tables and the entropy kernel), on a mesh ``exchange_ms`` (the carry
    and the all-gathers of the blocks) and, for K7, ``pack_ms`` (its first
    part: the DC totals' all-gather and K7c's carry and pack, before the
    blocks' collective), ``pixels_ms`` (plane gather and
    the pixel pipeline) and their sum ``device_ms``; ``exchange_s`` and
    ``exchange_bytes``, the host seconds of its collectives and the bytes
    they gathered here; and K7's counters.
    """
    dev, place = _target(device)
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
    # Collectives go one group at a time, in order, on every rank.
    n_threads = 2 if place.world == 1 else 1

    def dispatch(slot, key, items):
        route = _route(key, items, native_ok, spec, emit_max_lanes)
        lo, hi = mesh_mod.split(len(items), place.n_data, place.d)
        mine = items[lo:hi]
        hdr0 = items[0][1]
        rec = {"slot": slot, "images": len(mine), "host_s": 0.0,
               "cuda": cuda, "marks": [], "route": route, "exchange_s": 0.0,
               "exchange_bytes": 0}
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
                scans = [it[2] for it in mine]
                order = None
                if not mine:
                    rgb = _empty_rgb(route, items, dev)
                    bad = torch.zeros(0, dtype=torch.bool, device=dev)
                elif route == "emit":
                    rgb, bad = _emit_group(hdr0, scans, dev, rec, place,
                                           **kw)
                elif route == "dyn":
                    bucket = entropy_spec.bucket_dims(
                        [it[1] for it in items])
                    rgb, bad, order = _dyn_group(
                        [it[1] for it in mine], scans, dev, rec, place,
                        bucket, **kw)
                else:
                    rgb, bad = _k2_group(hdr0, scans, dev, rec, place, **kw)
                _mark(rec, "pixels")
            grow = (list(range(len(items))) if route != "dyn"
                    else _global_rows(items, place, order))
            dispatched[slot] = (items, rgb, bad, route, lo, grow)
        except Exception as e:  # noqa: BLE001 — the group's images fail
            if place.world > 1:
                raise   # a rank that leaves the collectives stalls the rest
            for it in items:
                results[it[0]] = BatchItem(index=it[0], header=it[1],
                                           rgb_batch=None, batch_index=-1,
                                           error=e)
        rec["dispatch_s"] = time.perf_counter() - t0
        timing["groups"].append(rec)

    t0 = time.perf_counter()
    group_list = list(groups.items())
    if len(group_list) > 1 and n_threads > 1:
        with ThreadPoolExecutor(n_threads) as ex:
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
    target = dev if place.mesh is None else place.mesh

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
                rgb = _prog_one(hdr, target, idct=idct, upsample=upsample)
            prog_done.append((i, hdr, rgb))
        except JPEGError:
            prog_fallback.append(i)
        except Exception as e:  # noqa: BLE001 — per-image isolation
            if place.world > 1:
                raise
            results[i] = BatchItem(index=i, header=hdr, rgb_batch=None,
                                   batch_index=-1, error=e)

    if len(prog_frames) > 1 and n_threads > 1:
        with ThreadPoolExecutor(n_threads) as ex:
            list(ex.map(prog, prog_frames))
    else:
        for pf in prog_frames:
            prog(pf)
    timing["progressive_s"] = time.perf_counter() - t0
    timing["progressive"] = len(prog_frames)
    timing["progressive_fallback"] = len(prog_fallback)
    host_fallback += sorted(prog_fallback)

    # Frames the device routes do not cover decode while the groups run
    # (on every rank of a mesh).
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
    # stream has waited for the dispatch streams; on a mesh the flags of
    # this rank's rows, padded to each group's rows per 'data' coordinate,
    # in one all-gather over the mesh.
    t0 = time.perf_counter()
    for s in streams:
        caller.wait_stream(s)
    for i, hdr, rgb in prog_done:
        if cuda:
            rgb.record_stream(caller)
        results[i] = BatchItem(index=i, header=hdr, rgb_batch=rgb,
                               batch_index=0)
    dispatched = [d for d in dispatched if d is not None]
    flags = _gather_flags([(len(d[0]), d[2]) for d in dispatched], place,
                          dev)
    for (items, rgb, _, route, lo, grow), bad in zip(dispatched, flags):
        if cuda:
            rgb.record_stream(caller)
        fallback = {"emit": True, "dyn": "dyn", "spec": True}.get(route,
                                                                  False)
        held = None if place.n_data == 1 else (lo, lo + rgb.shape[0])
        for k, (i, hdr, scan, _) in enumerate(items):
            rgb_k, row, rows, err = rgb, grow[k], held, None
            if bad[row] and not fallback:
                err = JPEGError("device entropy decode failed")
            elif bad[row]:
                timing["fallback_rows"] += 1
                try:
                    one = _host_rgb_one(hdr, scan, dev, idct=idct,
                                        upsample=upsample)
                    if fallback == "dyn":
                        rgb_k, row, rows = one[None], 0, None
                    elif held is None or held[0] <= row < held[1]:
                        rgb[row - (0 if held is None else held[0])] = one
                except Exception as e:  # noqa: BLE001 — per image
                    err = e
            results[i] = BatchItem(index=i, header=hdr, rgb_batch=rgb_k,
                                   batch_index=row, error=err, rows=rows)
    timing["groups"].sort(key=lambda r: r["slot"])
    for rec in timing["groups"]:
        marks = dict(rec.pop("marks"))
        del rec["cuda"]
        if "pixels" in marks and "plan" in marks:
            stage = marks.get("exchange", marks.get("entropy"))
            rec["entropy_ms"] = marks["plan"].elapsed_time(
                marks.get("entropy", stage))
            if "exchange" in marks and "entropy" in marks:
                rec["exchange_ms"] = marks["entropy"].elapsed_time(
                    marks["exchange"])
            if "pack" in marks and "entropy" in marks:
                rec["pack_ms"] = marks["entropy"].elapsed_time(marks["pack"])
            rec["pixels_ms"] = stage.elapsed_time(marks["pixels"])
            rec["device_ms"] = marks["plan"].elapsed_time(marks["pixels"])
        if rec.get("k7_stats") is not None:
            rec["k7_stats"] = dict(zip(entropy_emit_cuda.STATS,
                                       rec["k7_stats"].tolist()))
    timing["finish_s"] = time.perf_counter() - t0
    decode_batch_sharded.last_timing = timing
    return results


#: Timing of the last :func:`decode_batch_sharded` call (see there).
decode_batch_sharded.last_timing = {}


def _gather_flags(groups: list, place: _Place, dev) -> list:
    """Each group's (B,) host bool flags of its whole batch, from this
    rank's flags of its rows: one device-to-host copy on one GPU; on a
    mesh one all-gather over the mesh of every group's rows padded to its
    rows per 'data' coordinate, each row's flag the OR over the 'seg'
    ranks."""
    if not groups:
        return []
    if place.mesh is None:
        flat = torch.cat([bad for _, bad in groups]).cpu().numpy()
        out, o = [], 0
        for b, _ in groups:
            out.append(flat[o:o + b])
            o += b
        return out
    pers = [-(-b // place.n_data) for b, _ in groups]
    mine = torch.cat([torch.cat([bad.to(torch.int32), torch.zeros(
        per - bad.shape[0], dtype=torch.int32, device=dev)])
        for per, (_, bad) in zip(pers, groups)])
    axes = tuple(a for a in place.mesh.mesh_dim_names)
    every = torch.stack(mesh_mod.all_gather(mine, place.mesh, axes))
    every = every.view(place.n_data, place.n_seg, -1).any(1).cpu().numpy()
    out, o = [], 0
    for per, (b, _) in zip(pers, groups):
        out.append(every[:, o:o + per].reshape(-1)[:b])
        o += per
    return out


def allgather_items(items: list, mesh) -> list:
    """The items of a mesh :func:`decode_batch_sharded` call with every
    'data'-sharded group batch gathered whole on every rank
    (``multihost.process_allgather``, one call per batch in item order, the
    same on every rank); items already whole come back as they are."""
    whole: dict[int, torch.Tensor] = {}
    out = []
    for it in items:
        if it.rows is None or it.rgb_batch is None:
            out.append(it)
            continue
        key = id(it.rgb_batch)
        if key not in whole:
            whole[key] = multihost.process_allgather(it.rgb_batch, mesh)
        out.append(BatchItem(index=it.index, header=it.header,
                             rgb_batch=whole[key],
                             batch_index=it.batch_index, error=it.error))
    return out
