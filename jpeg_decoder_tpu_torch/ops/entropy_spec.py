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
