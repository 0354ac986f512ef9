"""The ``jax`` and ``hybrid`` device entropy routes for a DRI=0 stream.

Counterpart of ``jpeg_decoder_tpu/ops/entropy_spec.py``; its host halves are
numpy functions of the port's own (the JAX module imports jax), its device
halves the port's kernels:

* **Hybrid** (:func:`decode_scan_hybrid`): the native host *skeleton walk*
  (``entropy/native.py:emit_prep``, full Huffman decode of positions only)
  plans lanes that start at TRUE MCU starts and hold about equal paired
  step counts (:func:`prepare_hybrid_batch_emit`, the JAX function's plan
  and defaults; :func:`device_plan`, the lane size the port's kernel
  wants); the emit-lane kernel K7 (``ops/entropy_emit_cuda.py``) decodes
  every lane from its true start and sums DC across lanes.  No speculation
  and no synchronisation: the host pays one position-only walk.
* **Speculative** (:func:`decode_scan_speculative`): no host walk; the
  chunk-parallel self-synchronising Huffman kernel K2 (``ops/entropy_cuda``)
  takes the stream as one restart segment.  K2 is the port's device
  speculation: the JAX package's ``_spec_pipeline`` / ``_device_splice``
  (speculative lanes, then a splice) are not ported.

Both return the (n_mcus*bpm, 64) int32 scan-order natural-order blocks on
the device, equal to ``python_ref.decode_scan_baseline``, and raise
:class:`JPEGError` on a corrupt stream.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..layout import scan_layout
from ..types import FrameHeader, JPEGError, ScanHeader
from . import entropy_cuda, entropy_emit_cuda


def _bucket_T(t: int) -> int:
    """Round a trip count up to quarter-pow2 granularity (at least 64), so
    that distinct corpora give a few trip bounds, not one per exact count."""
    t = max(64, int(t))
    step = max(64, 1 << (t.bit_length() - 3))
    return -(-t // step) * step


def prepare_hybrid_batch_emit(hdr: FrameHeader, scans: list, *,
                              max_chunks: int = 512,
                              threads: int | None = None,
                              cap_factor: int = 4,
                              target_steps: int = 1300):
    """Host plan of the emit-lane decode for same-geometry scans.

    Per image one native call (``emit_prep``, threaded across images):
    per-segment skeleton walks, lane boundaries that balance the paired
    step counts with every restart segment start a lane start (lane MCU
    counts capped at ``cap_factor`` times the mean), about one lane per
    ``target_steps`` paired steps and at most ``max_chunks`` (plus the
    segments).  Lanes cover contiguous MCU ranges, so a lane's output slot
    is its first MCU's.

    Returns (pools (B, W) uint32, starts_rel (B, C) int32 start bits,
    nm_lane (B, C) int32 MCUs per lane, lane_off (B, C) int64 first
    coefficient slot ``first_mcu * bpm * 64``, T (bucketed most symbols of
    any lane: the single-symbol trip count), T2 (bucketed most paired
    steps), C, seg_first_mcu (n_mcus,) int32, skel_ok (B,) bool).  An image
    whose walk fails (a corrupt stream) keeps no lanes and skel_ok False.
    The values are the JAX function's; lane_off is int64 here (int32 there).
    """
    from ..entropy import native

    b_n = len(scans)
    lay = scan_layout(hdr)
    n_mcus = lay.n_mcus
    bpm = lay.blocks_per_mcu
    ri = scans[0].restart_interval
    per_seg = ri if ri else n_mcus
    seg_lo = np.arange(0, n_mcus, per_seg, dtype=np.int64)
    seg_first_mcu = np.repeat(seg_lo, np.minimum(
        per_seg, n_mcus - seg_lo)).astype(np.int32)

    nbytes = [int(len(s.data)) for s in scans]
    w = (max(nbytes) + 3) // 4 + 2
    pools = np.zeros((b_n, w), np.uint32)
    lanes: list = [None] * b_n
    skel_ok = np.zeros(b_n, bool)

    def scan_one(b):
        pad = np.zeros(w * 4, np.uint8)
        pad[:nbytes[b]] = np.asarray(scans[b].data, np.uint8)
        pools[b] = pad.view(">u4")
        try:
            lanes[b] = native.emit_prep(
                hdr, scans[b], max_chunks=max_chunks, cap_factor=cap_factor,
                target_steps=target_steps,
                n_threads=1 if threads == 1 else None)
        except JPEGError:
            return
        skel_ok[b] = True

    if b_n > 1 and (threads is None or threads > 1):
        with ThreadPoolExecutor(threads or min(4, b_n)) as ex:
            list(ex.map(scan_one, range(b_n)))
    else:
        for b in range(b_n):
            scan_one(b)

    c = max((len(ln[0]) for ln in lanes if ln is not None), default=1)
    starts_rel = np.zeros((b_n, c), np.int32)
    nm_lane = np.zeros((b_n, c), np.int32)
    lane_off = np.zeros((b_n, c), np.int64)
    t_sym = t_pair = 64
    for b in range(b_n):
        if lanes[b] is None:
            continue
        m_lo, nm, starts, ts, tp = lanes[b]
        k = len(m_lo)
        nm_lane[b, :k] = nm
        starts_rel[b, :k] = starts
        lane_off[b, :k] = m_lo * (bpm * 64)
        t_sym = max(t_sym, ts)
        t_pair = max(t_pair, tp)
    return (pools, starts_rel, nm_lane, lane_off, _bucket_T(t_sym),
            _bucket_T(t_pair), c, seg_first_mcu, skel_ok)


#: Paired steps per lane of :func:`device_plan`.  The JAX defaults of
#: :func:`prepare_hybrid_batch_emit` (1,300 steps, at most 512 lanes) suit
#: the TPU's lockstep loop, whose cost per step grows with the lanes; K7
#: runs one thread per lane and is latency-bound, so it wants many short
#: lanes, enough to fill the card: chip_smoke.py's sweep on an H100
#: (PERF.md) puts its time lowest here.
LANE_STEPS = 32


def device_plan(hdr: FrameHeader, scans: list, *, threads: int | None = None):
    """:func:`prepare_hybrid_batch_emit` with the plan K7 runs best on:
    about one lane per :data:`LANE_STEPS` paired steps, no cap below one
    lane per MCU."""
    return prepare_hybrid_batch_emit(
        hdr, scans, threads=threads, max_chunks=scan_layout(hdr).n_mcus,
        target_steps=LANE_STEPS)


def _eighth(n: int) -> int:
    """``n`` rounded up to a multiple of an eighth of its power of two (at
    most 12.5% padding): the bucket dims of a geometry group, as in the JAX
    package's ``_hybrid_group_dispatch_dyn``."""
    step = 1 << max(n.bit_length() - 3, 0)
    return -(-n // step) * step


@dataclasses.dataclass
class GroupPlan:
    """Host plan of one geometry-bucketed group for one K7 launch: row k of
    every (B, ...) array is image ``order[k]`` of the group, the images
    sorted by table set (stable), so that a CTA of the kernel seldom stages
    another set."""

    order: list[int]            # group position of row k
    pools: np.ndarray           # (B, W) uint32
    starts: np.ndarray          # (B, C) int32
    nm_lane: np.ndarray         # (B, C) int32
    lane_off: np.ndarray        # (B, C) int64
    trips: int                  # bucketed most symbols of any lane
    skel_ok: np.ndarray         # (B,) bool: the image's walk succeeded
    lut_base: np.ndarray        # (B,) int32 first table of the image's set
    sets: list                  # (hdr, scan) of each distinct table set
    n_mcus_img: np.ndarray      # (B,) int32
    ri: np.ndarray              # (B,) int32 restart intervals
    geom: np.ndarray            # (B, 4) int32 mcus_x, mcus_y, height, width
    qtables: np.ndarray         # (B, n_comps, 64) int32
    comp_hv: tuple              # (h, v) of each component
    n_mcus: int                 # the bucket's MCUs
    comp_shapes: tuple          # the bucket's plane dims per component
    samplings: tuple
    height: int                 # the bucket's pixel dims
    width: int


def bucket_order(hdrs: list, scans: list) -> tuple[list, list, list]:
    """The table sets of a geometry-bucketed group and the order of its
    plan's rows: (order, each image's set index, (hdr, scan) of each set).
    Sets are de-duplicated by their bytes and numbered in order of first
    appearance; ``order`` sorts the images by set (stable).  Host work of
    the headers alone (a mesh's ranks use it to find another rank's rows)."""
    set_of: dict[tuple, int] = {}
    sets: list = []
    set_idx = []
    for hdr, scan in zip(hdrs, scans):
        key = entropy_cuda.table_key(hdr, scan)
        if key not in set_of:
            set_of[key] = len(sets)
            sets.append((hdr, scan))
        set_idx.append(set_of[key])
    return sorted(range(len(hdrs)), key=lambda k: set_idx[k]), set_idx, sets


def bucket_dims(hdrs: list) -> tuple[int, int]:
    """The MCU grid (mcus_x, mcus_y) of the bucket that holds ``hdrs``:
    each axis's maximum rounded up to an eighth of its power of two."""
    return (_eighth(max(h.mcus_x for h in hdrs)),
            _eighth(max(h.mcus_y for h in hdrs)))


def plan_bucket_group(hdrs: list, scans: list, *,
                      threads: int | None = None,
                      bucket: tuple[int, int] | None = None) -> GroupPlan:
    """Host plan of a geometry-bucketed group: frames of one sampling,
    colour space and precision whose sizes, restart intervals and Huffman
    tables may differ (the JAX package's ``_hybrid_group_dispatch_dyn``,
    jax sharded.py:863-975, with the port's :func:`device_plan` per image).

    The bucket is each MCU-grid axis's group maximum rounded up to an
    eighth of its power of two; the pool width the largest image's,
    bucketed as :func:`_bucket_T` (as JAX does); the lanes the most any
    image has.  Each image's walk runs on a pool of ``threads`` (min(4, B))
    threads; an image whose plan fails keeps no lanes and ``skel_ok``
    False.  Table sets and the rows' order are :func:`bucket_order`'s, and
    each image's ``lut_base`` is its set's first table, set * 2 * n_comps.
    ``bucket`` (mcus_x, mcus_y) overrides the bucket (a mesh's 'data' ranks
    plan their shares of one group at the whole group's
    :func:`bucket_dims`)."""
    b_n = len(hdrs)
    hdr0 = hdrs[0]
    comp_hv = tuple((c.h, c.v) for c in hdr0.components)
    h_max = max(h for h, _ in comp_hv)
    v_max = max(v for _, v in comp_hv)
    mxb, myb = bucket_dims(hdrs) if bucket is None else bucket

    preps: list = [None] * b_n

    def prep_one(k):
        # A failed plan must not sink the group: the image goes to the
        # per-image fallback through skel_ok.
        try:
            preps[k] = device_plan(hdrs[k], [scans[k]], threads=1)
        except Exception:  # noqa: BLE001 — per-image isolation
            preps[k] = None

    if b_n > 1 and (threads is None or threads > 1):
        with ThreadPoolExecutor(threads or min(4, b_n)) as ex:
            list(ex.map(prep_one, range(b_n)))
    else:
        for k in range(b_n):
            prep_one(k)

    order, set_idx, sets = bucket_order(hdrs, scans)

    live = [p for p in preps if p is not None]
    w = _bucket_T(max((p[0].shape[1] for p in live), default=64))
    c = max((p[6] for p in live), default=1)
    pools = np.zeros((b_n, w), np.uint32)
    starts = np.zeros((b_n, c), np.int32)
    nm_lane = np.zeros((b_n, c), np.int32)
    lane_off = np.zeros((b_n, c), np.int64)
    skel_ok = np.zeros(b_n, bool)
    for row, k in enumerate(order):
        p = preps[k]
        if p is None:
            continue
        pools[row, :p[0].shape[1]] = p[0][0]
        c_k = p[1].shape[1]
        starts[row, :c_k] = p[1][0]
        nm_lane[row, :c_k] = p[2][0]
        lane_off[row, :c_k] = p[3][0]
        skel_ok[row] = bool(p[8][0])
    rows = [(hdrs[k], scans[k]) for k in order]
    return GroupPlan(
        order=order, pools=pools, starts=starts, nm_lane=nm_lane,
        lane_off=lane_off, trips=max((p[4] for p in live), default=64),
        skel_ok=skel_ok,
        lut_base=np.array([set_idx[k] * 2 * len(comp_hv) for k in order],
                          np.int32),
        sets=sets,
        n_mcus_img=np.array([h.mcus_x * h.mcus_y for h, _ in rows],
                            np.int32),
        ri=np.array([s.restart_interval for _, s in rows], np.int32),
        geom=np.array([(h.mcus_x, h.mcus_y, h.height, h.width)
                       for h, _ in rows], np.int32).reshape(b_n, 4),
        qtables=np.stack([
            np.stack([h.quant_tables[cp.tq].values for cp in h.components])
            for h, _ in rows]).astype(np.int32),
        comp_hv=comp_hv, n_mcus=mxb * myb,
        comp_shapes=tuple((myb * v, mxb * h) for h, v in comp_hv),
        samplings=tuple((v_max // v, h_max // h) for h, v in comp_hv),
        height=myb * 8 * v_max, width=mxb * 8 * h_max)


def _block_comp(hdr: FrameHeader) -> tuple[int, ...]:
    return tuple(ci for ci, c in enumerate(hdr.components)
                 for _ in range(c.v * c.h))


def decode_scan_hybrid(hdr: FrameHeader, scan: ScanHeader,
                       device) -> torch.Tensor:
    """Single-image hybrid decode: the host skeleton walk plans the lanes
    (:func:`device_plan`), K7 decodes them on ``device`` (its plain version
    on the CPU).

    Returns (n_mcus*bpm, 64) int32 scan-order natural-order blocks on
    ``device``; only the error flag crosses back.  Raises JPEGError when
    the walk or the device decode fails (a corrupt stream)."""
    dev = torch.device(device)
    lay = scan_layout(hdr)
    (pools, starts, nm, lane_off, t_sym, _, _, seg_first,
     skel_ok) = device_plan(hdr, [scan], threads=1)
    if not skel_ok[0]:
        raise JPEGError("skeleton scan failed (corrupt stream)")
    luts, l1 = entropy_cuda.device_tables(hdr, scan, dev)
    blocks, err = entropy_emit_cuda.decode_lanes(
        *(torch.from_numpy(a).to(dev) for a in (pools, starts, nm, lane_off,
                                                seg_first)),
        luts, block_comp=_block_comp(hdr), n_comps=len(hdr.components),
        n_mcus=lay.n_mcus, trips=t_sym, precision=hdr.precision, l1=l1)
    if int(err[0]):
        raise JPEGError("hybrid device decode failed")
    return blocks[0]


def decode_scan_speculative(hdr: FrameHeader, scan: ScanHeader,
                            device) -> torch.Tensor:
    """Chunk-parallel device decode of a single-segment interleaved scan:
    K2 on ``device``, the stream as one segment cut into self-synchronising
    chunks.  The same contract as :func:`decode_scan_hybrid`."""
    if len(scan.seg_offsets) != 2:
        raise JPEGError("speculative decode expects a single segment "
                        "(DRI=0); use the segment path otherwise")
    return entropy_cuda.decode_scan_baseline(hdr, scan, device)
