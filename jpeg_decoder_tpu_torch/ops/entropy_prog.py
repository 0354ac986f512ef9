"""Device-lane progressive entropy decode (T.81 Annex G.2).

Counterpart of ``jpeg_decoder_tpu/ops/entropy_prog.py``: every scan of a
progressive Huffman frame decodes on the device as lanes, each lane a run of
consecutive MCUs (DC scans) or blocks (AC scans) of the scan started from a
known state, by the hand-written kernels of ``ops/entropy_prog_cuda.py``
(``csrc/entropy_prog.cu``): K8a DC first, K8b DC refinement, K8c AC first
and K8d AC refinement.

Lanes come from the restart segments (predictors and EOB runs reset at each
RSTn: no host work; :func:`decode_progressive_device`) or, for a frame whose
scans are all DRI 0, from the native library's position-only skeleton walks
(:func:`decode_progressive_hybrid`): a walk records the lane state (bit
position, DC predictors or pending EOB run) at chosen units, and keeps each
component's band bitmap across its AC scans so that refinement walks never
need the planes.  :func:`decode_progressive_lanes` picks the route as the
JAX function does.

Planes live on the device as ``(n_blocks_c + 1, 64)`` int32 in natural
order, the last row the drop row, as in the JAX package; the kernels update
them in place (JAX's functions return new arrays).  Per-scan lane flags go
to an ``err_sink`` and are fetched once per frame (:func:`check_errors`).

What differs from the JAX module, and why:

* JAX's ``_chain_step``/``_apply_chain`` trace a chain's scans into one
  jitted program, because each program dispatch paid a link round trip.
  Here a chain is a Python loop over its scans: the host walk of scan k+1
  runs while scan k's kernel runs (launches are asynchronous), so
  ``JD_PROG_FUSE`` and ``JD_PROG_CHAIN_SPLIT`` have no counterpart.
* The chains (all DC scans, and each component's AC scans) write disjoint
  coefficients (DC: coefficient 0; an AC chain: its component's 1..63) and
  no kernel writes a whole row, so they share one set of planes and run on
  two threads, each on its own CUDA stream; JAX's per-chain zero
  accumulators and their final add are not needed.
* Where JAX's functions take ``mesh``, these take ``device``: a device or
  a ``torch.distributed`` ``DeviceMesh`` (``parallel/mesh.py``).  On a mesh
  each scan's lanes split over all its ranks, as JAX shards them over all
  mesh axes (``ceil(S / ranks)`` lanes per rank, in order), and each rank
  launches the scan's kernel on its share only (:func:`rank_share`); where
  JAX psums per-rank partial planes into replicated ones (jax
  entropy_prog.py:1752-1832), the ranks all-gather the coefficients their
  units wrote (:func:`exchange_scan`), so every rank's planes are equal
  again before the next scan.  The kernels store in place, so a sum of
  whole planes would count every earlier scan's values once per rank.  A
  chained share keeps the next share's first lane as a lane of no units, so
  that its last lane is held to that lane's start state as every inner lane
  is; a DC refinement scan (K8b, one thread per block, no walk) splits by
  rows of units instead and runs as a scan of its own rows
  (:func:`share_units`).  The lane flags
  of every rank are summed over the mesh once per frame
  (:func:`check_errors`), so every rank raises alike.  The host skeleton
  walks run on every rank (each parses the frame anyway), and on a mesh of
  more than one rank the chains run one after another on one thread, in
  the same order everywhere.
* The lockstep refine (``JD_PROG_REFINE=lockstep``) is not ported: every
  AC scan runs K8c or K8d, fed skeleton or segment lanes.
* ``JD_PROG_LANES`` is the target lane count of a skeleton scan, as in JAX;
  the default is :data:`DEFAULT_LANES`, more lanes than JAX's 512 because
  a lane is one serial chain on the card: on an H100 (80GB HBM3, 700 W),
  on a 1920x1080 frame, K8a ran 5.5x faster at 4096 target lanes than at
  512, K8c 2.3x and K8d 1.7x (their first forms 4.2x and 6.7x;
  ``chip_smoke.py``'s progressive phase times both).
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .. import collectives as coll
from ..huffman import build_lut
from ..layout import comp_dims_unpadded
from ..models.routing import resolve_device
from ..types import ZIGZAG, FrameHeader, JPEGError, ScanHeader
from . import entropy_prog_cuda as k8

#: Target lanes of a skeleton-lane scan when ``JD_PROG_LANES`` is unset.
DEFAULT_LANES = 4096


def scan_words(scan: ScanHeader) -> np.ndarray:
    """Whole-scan big-endian uint32 word buffer with
    ``entropy_prog_cuda.PAD_WORDS`` zero words after the data (lanes index
    it by absolute bit position)."""
    data = np.asarray(scan.data, np.uint8)
    nw = (len(data) + 3) // 4 + k8.PAD_WORDS
    buf = np.zeros(nw * 4, np.uint8)
    buf[: len(data)] = data
    return buf.view(">u4").astype(np.uint32)


def segment_lanes(scan: ScanHeader, n_mcus: int):
    """Restart segments as lanes: (base_bits, n_per_lane, mcu_first), all
    (S,) int64/int32.  DRI=0 scans yield one lane."""
    offs = np.asarray(scan.seg_offsets, np.int64)
    n_seg = len(offs) - 1
    ri = scan.restart_interval
    expected = -(-n_mcus // ri) if ri else 1
    if n_seg != expected:
        raise JPEGError(
            f"progressive scan: segment count {n_seg} != expected "
            f"{expected} (DRI {ri}, {n_mcus} MCUs)")
    base_bits = (offs[:-1] * 8).astype(np.int64)
    per = ri if ri else n_mcus
    n_per = np.full(n_seg, per, np.int32)
    if ri:
        n_per[-1] = n_mcus - ri * (n_seg - 1)
    mcu_first = (np.arange(n_seg, dtype=np.int64) * per)
    return base_bits, n_per, mcu_first


def scan_units(hdr: FrameHeader, scan: ScanHeader) -> int:
    """Units of a scan: the frame's MCUs for an interleaved scan, the
    component's unpadded blocks for a single-component one."""
    if len(scan.comp_indices) > 1:
        if scan.ss != 0:
            raise JPEGError("progressive: AC scans must be single-component")
        return hdr.mcus_x * hdr.mcus_y
    r, c = comp_dims_unpadded(hdr, scan.comp_indices[0])
    return r * c


def scan_geometry(hdr: FrameHeader,
                  scan: ScanHeader) -> tuple[list, k8.Geometry]:
    """The frame components a scan writes (the kernels' planes, in order)
    and its :class:`~.entropy_prog_cuda.Geometry`: the closed forms of the
    JAX package's ``_dc_rows_device`` and ``_ac_rows_device``.  A
    single-component scan walks the UNPADDED grid (``comp_dims_unpadded``)
    and writes into the padded plane: row = (m // cols_u) * plane_cols +
    m % cols_u."""
    comps = hdr.components

    def plane_dims(ci):
        cols = hdr.mcus_x * comps[ci].h
        return cols, hdr.mcus_y * comps[ci].v * cols

    if len(scan.comp_indices) == 1:
        ci = scan.comp_indices[0]
        cols, n_rows = plane_dims(ci)
        return [ci], k8.Geometry(
            mx_div=comp_dims_unpadded(hdr, ci)[1],
            slots=((0, 1, 0, 1, 0, 0),), pcols=(cols,), n_rows=(n_rows,))
    cis = sorted(set(scan.comp_indices))
    slots = tuple(
        (cis.index(ci), comps[ci].v, v, comps[ci].h, h, k)
        for k, ci in enumerate(scan.comp_indices)
        for v in range(comps[ci].v) for h in range(comps[ci].h))
    dims = [plane_dims(ci) for ci in cis]
    return cis, k8.Geometry(mx_div=hdr.mcus_x, slots=slots,
                            pcols=tuple(d[0] for d in dims),
                            n_rows=tuple(d[1] for d in dims))


def _balanced_lane_edges(weights: np.ndarray, S: int) -> np.ndarray:
    """Lane boundaries (S + 1 edges over flat block space) equalising the
    per-lane sums of ``weights`` (per-block counts from the skeleton
    walk)."""
    n = len(weights)
    cum = np.cumsum(weights.astype(np.int64))
    total = int(cum[-1]) if n else 0
    tgt = (np.arange(1, S, dtype=np.int64) * total) // S
    inner = np.searchsorted(cum, tgt, side="left")
    edges = np.concatenate([[0], inner, [n]])
    return np.maximum.accumulate(edges)


def _stride_lanes(bits: np.ndarray, stride: int, n_mcus: int,
                  preds: np.ndarray):
    """Lane table of a DC first scan from per-stride skeleton records."""
    L = len(bits)
    n_per = np.full(L, stride, np.int32)
    if L:
        n_per[-1] = n_mcus - stride * (L - 1)
    mcu_first = np.arange(L, dtype=np.int64) * stride
    return bits, n_per, mcu_first, np.zeros(L, np.int32), preds


def target_lanes_default() -> int:
    return int(os.environ.get("JD_PROG_LANES", str(DEFAULT_LANES)))


def hybrid_scan_prep(hdr: FrameHeader, scan: ScanHeader, nzmaps: dict, *,
                     target_lanes: int):
    """Host half of one skeleton-lane (DRI-0) scan: the native skeleton walk
    and the lane table (base_bits, n_per, mcu_first, eobrun0, pred0), or
    None for a DC refinement scan (one segment lane: its bits lie at closed
    positions, K8b needs no walk).

    DC first: records every ``ceil(units / target_lanes)`` MCUs.  AC scans:
    the walk records every block (with per-block symbol or event counts)
    and the lanes are cut to balance those counts (at least 1 per block),
    as the JAX function does.  ``nzmaps`` keeps each component's band
    bitmap across its AC scans."""
    from ..entropy import native

    n = scan_units(hdr, scan)
    if scan.ss == 0:
        if scan.ah != 0:
            return None
        stride = max(1, -(-n // target_lanes))
        bits, preds = native.prog_skeleton_dc(hdr, scan, stride)
        return _stride_lanes(bits, stride, n, preds)
    ci = scan.comp_indices[0]
    nzmap = nzmaps.setdefault(ci, np.zeros(n, np.uint64))
    bits, eob, wts = native.prog_skeleton_ac(hdr, scan, 1, nzmap,
                                             want_syms=True)
    edges = _balanced_lane_edges(np.maximum(wts, 1), target_lanes)
    return (bits[edges[:-1]], np.diff(edges).astype(np.int32),
            edges[:-1].astype(np.int64), eob[edges[:-1]].astype(np.int32),
            np.zeros((len(edges) - 1, 1), np.int32))


class ScanInputs(NamedTuple):
    """One scan's kernel inputs on a device (:func:`scan_inputs`)."""

    words: torch.Tensor          # (W,) uint32 word pool
    lanes: k8.LaneTable
    luts: torch.Tensor           # (n, 65536) int32 tables (n = 0 for K8b)
    cis: list                    # the frame components the scan writes
    geom: k8.Geometry
    ac_table: k8.AcTable | None = None   # an AC scan's compact table
    dc_table: k8.DcTables | None = None  # a DC first scan's compact tables
    row_off: tuple = ()          # each plane's first row (a rank's share)


def lane_arrays(hdr: FrameHeader, scan: ScanHeader, lanes) -> dict:
    """A scan's whole lane table on the host: ``lanes`` (a (base_bits,
    n_per, mcu_first, eobrun0, pred0) skeleton lane table, chained) or the
    restart segments; the keyword arguments of ``k8.lane_table``."""
    n = scan_units(hdr, scan)
    nsc = len(scan.comp_indices)
    if lanes is None:
        base, n_per, first = segment_lanes(scan, n)
        return dict(base=base, n_per=n_per, first=first,
                    end=np.asarray(scan.seg_offsets, np.int64)[1:] * 8,
                    eob0=np.zeros(len(base), np.int32),
                    pred0=np.zeros((len(base), nsc), np.int32),
                    chained=False)
    base, n_per, first, eob0, pred0 = lanes
    base = np.asarray(base, np.int64)
    return dict(base=base, n_per=np.asarray(n_per, np.int32),
                first=np.asarray(first, np.int64),
                end=np.append(base[1:], len(scan.data) * 8),
                eob0=np.asarray(eob0, np.int32),
                pred0=np.asarray(pred0, np.int32), chained=True)


def share_units(scan: ScanHeader, arrays: dict, geom: k8.Geometry, n: int,
                ranks: int, r: int) -> tuple[int, int]:
    """The units [lo, hi) rank r of ``ranks`` decodes of a scan of ``n``
    units: those its share of the lanes tiles (``ceil(S / ranks)`` lanes
    each, in order, as JAX pads the lanes to a multiple of the ranks and
    shards them), or for a DC refinement scan whole rows of units
    (``geom.mx_div`` each, ``ceil(rows / ranks)`` rows a rank)."""
    if scan.ss == 0 and scan.ah != 0:
        lo, hi = coll.split(-(-n // geom.mx_div), ranks, r)
        return min(lo * geom.mx_div, n), min(hi * geom.mx_div, n)
    first, s = arrays["first"], len(arrays["first"])
    s0, s1 = coll.split(s, ranks, r)
    return (int(first[s0]) if s0 < s else n, int(first[s1]) if s1 < s else n)


def rank_share(scan: ScanHeader, arrays: dict, geom: k8.Geometry, n: int,
               ranks: int, r: int):
    """Rank r's share of a scan of ``n`` units over ``ranks`` ranks:
    (lane table arguments, units, geometry, each plane's first row), or
    None when it has no units.

    K8a, K8c and K8d take lanes ``s0 .. s1-1`` of the scan's (JAX's
    split), and a chained share that is not the last also the next share's
    first lane with no units, whose start state the share's last lane must
    end in.  K8b (a DC refinement scan: the bits of a block lie at closed
    positions, and the kernel walks every block of its scan) takes whole
    rows of units: its lanes are cut at the rows' ends, their units counted
    from the first row, and its planes start at that row (the geometry's
    rows then shift by ``rows * v * pcols`` in each plane)."""
    s = len(arrays["base"])
    u0, u1 = share_units(scan, arrays, geom, n, ranks, r)
    if u1 <= u0:
        return None
    if scan.ss == 0 and scan.ah != 0:
        bpm = geom.bpm
        first = arrays["first"]
        last = first + arrays["n_per"]
        keep = (last > u0) & (first < u1) & (arrays["n_per"] > 0)
        f0 = np.maximum(first[keep], u0)
        kw = dict(base=arrays["base"][keep] + (f0 - first[keep]) * bpm,
                  n_per=(np.minimum(last[keep], u1) - f0).astype(np.int32),
                  first=f0 - u0, end=arrays["end"][keep],
                  eob0=arrays["eob0"][keep], pred0=arrays["pred0"][keep],
                  chained=False)
        rows0 = u0 // geom.mx_div
        v = {sl[0]: sl[1] for sl in geom.slots}
        off = tuple(rows0 * v[p] * pc for p, pc in enumerate(geom.pcols))
        shifted = k8.Geometry(mx_div=geom.mx_div, slots=geom.slots,
                              pcols=geom.pcols,
                              n_rows=tuple(nr - o for nr, o in
                                           zip(geom.n_rows, off)))
        return kw, (0, u1 - u0), u1 - u0, shifted, off
    s0, s1 = coll.split(s, ranks, r)
    stop = s1 + 1 if arrays["chained"] and s1 < s else s1
    kw = {k: (v[s0:stop] if isinstance(v, np.ndarray) else v)
          for k, v in arrays.items()}
    if stop > s1:
        kw["n_per"] = kw["n_per"].copy()
        kw["n_per"][-1] = 0
    return kw, (u0, u1), n, geom, (0,) * len(geom.pcols)


def scan_inputs(hdr: FrameHeader, scan: ScanHeader, lanes, device,
                share: tuple[int, int] | None = None) -> ScanInputs | None:
    """A scan's word pool, lane table, Huffman tables and geometry on
    ``device``, in one host-to-device copy.  ``lanes``: a (base_bits, n_per,
    mcu_first, eobrun0, pred0) skeleton lane table (chained: each lane must
    end at the next one's start), or None for the restart segments.
    ``share`` = (ranks, r): only rank r's share (:func:`rank_share`; None
    when it has no units)."""
    n = scan_units(hdr, scan)
    nsc = len(scan.comp_indices)
    arrays = lane_arrays(hdr, scan, lanes)
    cis, geom = scan_geometry(hdr, scan)
    units, n_scan, row_off = None, n, (0,) * len(geom.pcols)
    if share is not None:
        got = rank_share(scan, arrays, geom, n, *share)
        if got is None:
            return None
        arrays, units, n_scan, geom, row_off = got
    base, n_per, first = (arrays.pop(k) for k in ("base", "n_per", "first"))
    kw = arrays
    compact = None
    if scan.ss == 0 and scan.ah == 0:
        dc = [build_lut(scan.dc_specs[scan.dc_table_ids[k]])
              for k in range(nsc)]
        tables = np.stack(dc)
        compact = k8.dc_tables(dc)
    elif scan.ss != 0:
        lut = build_lut(scan.ac_specs[scan.ac_table_ids[0]])
        tables = lut[None]
        compact = k8.compact_table(lut)
    else:
        tables = np.zeros((0, 1 << 16), np.int32)
    pool = scan_words(scan)
    # The pool padded to 16 bytes, so that the tables after it stay aligned
    # for the kernels' 16-byte copies.
    pool = np.concatenate([pool, np.zeros(-len(pool) % 4, np.uint32)])
    parts = [pool, tables.reshape(-1).view(np.uint32)]
    if compact is not None:
        parts.append(compact.tab.view(np.uint32))
    words, lt = k8.lane_table(
        base, n_per, first, n_units=n_scan, scan_bits=len(scan.data) * 8,
        device=device, words=np.concatenate(parts), units=units, **kw)
    n_lut = len(pool) + tables.size
    luts = words[len(pool):n_lut].view(torch.int32).view(tables.shape)
    if compact is not None:
        compact = compact._replace(tab=words[n_lut:].view(torch.int16))
    ac, dc = (None, compact) if scan.ss == 0 else (compact, None)
    return ScanInputs(words[:len(pool)], lt, luts, cis, geom, ac, dc,
                      row_off)


def launch_scan(scan: ScanHeader, inp: ScanInputs, planes: list,
                plain: bool = False) -> torch.Tensor:
    """The scan's kernel (K8a-K8d by its kind) on ``planes``, in place;
    ``plain`` calls the kernel's plain version instead, on any device (the
    card tests and chip_smoke.py hold the two against each other).
    Returns the (S,) int32 lane flags."""
    offs = inp.row_off or (0,) * len(inp.cis)
    mine = [planes[ci][off:] for ci, off in zip(inp.cis, offs)]
    kind = ("dc_first" if scan.ah == 0 else "dc_refine") if scan.ss == 0 \
        else ("ac_first" if scan.ah == 0 else "ac_refine")
    fn = getattr(k8, kind + ("_torch" if plain else ""))
    if scan.ss == 0 and scan.ah == 0:
        kw = {} if plain else {"table": inp.dc_table}
        return fn(inp.words, inp.lanes, inp.luts, mine, inp.geom, al=scan.al,
                  **kw)
    if scan.ss == 0:
        return fn(inp.words, inp.lanes, mine, inp.geom, al=scan.al)
    kw = {} if plain else {"table": inp.ac_table}
    return fn(inp.words, inp.lanes, inp.luts, mine[0], inp.geom, ss=scan.ss,
              se=scan.se, al=scan.al, **kw)


def _mesh_of(device):
    """(device, mesh): a ``DeviceMesh`` of more than one rank and its
    rank's device, else the resolved device and None."""
    if coll.is_mesh(device):
        dev = coll.mesh_device(device)
        return dev, device if coll.size(device) > 1 else None
    return resolve_device(device), None


def exchange_scan(scan: ScanHeader, cis: list, geom: k8.Geometry,
                  owned: list, planes: list, mesh) -> None:
    """After each rank of ``mesh`` applied its share of a scan: all-gather
    the coefficients each rank's units ``owned[q]`` = (lo, hi) wrote
    (coefficient 0 of every block of a DC scan's MCUs, the band of an AC
    scan's blocks) and store the other ranks' into ``planes``, so that
    every rank's planes are equal.  The units of the ranks are disjoint and
    tile the scan."""
    dev = planes[0].device
    cols = torch.from_numpy(
        (np.array([0]) if scan.ss == 0 else
         ZIGZAG[scan.ss:scan.se + 1]).astype(np.int64)).to(dev)
    per_unit = geom.bpm * len(cols)

    def rows(lo, hi):
        m = torch.arange(lo, hi, device=dev)
        return [geom.rows(m, j) for j in range(geom.bpm)]

    me = coll.coordinate(mesh)
    lo, hi = owned[me]
    mine = torch.cat([planes[cis[p]][r][:, cols].reshape(-1)
                      for p, r in rows(lo, hi)])
    counts = [(b - a) * per_unit for a, b in owned]
    parts = coll.all_gather_rows(mine, mesh, mesh.mesh_dim_names,
                                     counts)
    for q, part in enumerate(parts):
        if q == me or not counts[q]:
            continue
        vals = part.view(geom.bpm, -1, len(cols))
        for (p, r), v in zip(rows(*owned[q]), vals):
            planes[cis[p]][r[:, None], cols[None, :]] = v


def apply_scan_device(hdr: FrameHeader, scan: ScanHeader, planes: list,
                      lanes=None, err_sink: list | None = None,
                      mesh=None) -> list:
    """Apply ONE progressive scan to device-resident planes, in place.

    ``planes``: one (n_blocks_c + 1, 64) int32 tensor per component, natural
    order, on the device the kernels run on (a CPU tensor runs their plain
    versions).  ``lanes``: an optional skeleton lane table replacing the
    restart-segment lanes (see :func:`scan_inputs`).  ``err_sink``: when
    given, the scan's (S,) lane flags are appended to it instead of being
    fetched here (see :func:`check_errors`).  ``mesh``: a ``DeviceMesh``
    every rank of which applies the scan to equal planes: each launches its
    share of the lanes (:func:`rank_share`) and the ranks exchange what
    their units wrote (:func:`exchange_scan`); the flags are this rank's
    lanes' (a sink then goes to ``check_errors(sink, mesh)``).  Returns
    ``planes``; without a sink, raises JPEGError when any lane is
    flagged."""
    dev = planes[0].device
    if mesh is None or coll.size(mesh) == 1:
        err = launch_scan(scan, scan_inputs(hdr, scan, lanes, dev), planes)
    else:
        ranks, me = coll.size(mesh), coll.coordinate(mesh)
        inp = scan_inputs(hdr, scan, lanes, dev, share=(ranks, me))
        if inp is None:
            err = torch.zeros(1, dtype=torch.int32, device=dev)
        else:
            err = launch_scan(scan, inp, planes)
            lt = inp.lanes
            if lt.chained and lt.units[1] < lt.n_units:
                err = err[:-1]    # the next share's first lane
        n = scan_units(hdr, scan)
        cis, geom = scan_geometry(hdr, scan)
        arrays = lane_arrays(hdr, scan, lanes)
        exchange_scan(scan, cis, geom, [
            share_units(scan, arrays, geom, n, ranks, q)
            for q in range(ranks)], planes, mesh)
    if err_sink is not None:
        err_sink.append(err)
    elif err_sink is None and mesh is not None:
        check_errors([err], mesh)
    elif bool(err.any()):
        raise JPEGError(f"device progressive scan failed in lanes "
                        f"{torch.nonzero(err).flatten()[:8].tolist()}")
    return planes


def check_errors(err_sink: list, mesh=None) -> None:
    """Fetch all deferred per-scan lane flags with one device-to-host copy
    (on a ``mesh``, summed over its ranks first, so that every rank raises
    alike); raises JPEGError naming the first failing scans."""
    if not err_sink:
        return
    flags = torch.stack([e.any() for e in err_sink]).to(torch.int32)
    if mesh is not None:
        flags = coll.all_reduce_sum(flags, mesh, mesh.mesh_dim_names)
    flags = flags.cpu().numpy()
    if flags.any():
        raise JPEGError(
            f"device progressive decode failed in scan(s) "
            f"{np.flatnonzero(flags)[:8].tolist()}")


def _zero_planes(hdr: FrameHeader, dev: torch.device):
    shapes = [(hdr.mcus_y * c.v, hdr.mcus_x * c.h) for c in hdr.components]
    return shapes, [torch.zeros((r * c + 1, 64), dtype=torch.int32,
                                device=dev) for r, c in shapes]


def _finish(planes, shapes, as_device: bool):
    out = [p[:-1].view(r, c, 64) for p, (r, c) in zip(planes, shapes)]
    if as_device:
        return out
    return [p.cpu().numpy() for p in out]


def decode_progressive_device(hdr: FrameHeader, device=None,
                              as_device: bool = False,
                              err_sink: list | None = None):
    """Decode ALL scans of a progressive frame with restart segments as the
    lanes (a DRI-0 scan is one lane; frames with the native library take
    :func:`decode_progressive_hybrid` instead).  Returns per-component
    (rows_c, cols_c, 64) int32 planes on the padded grid, equal to
    entropy/progressive.decode_progressive's: numpy arrays, or tensors on
    ``device`` with ``as_device``.  ``device`` is resolved by
    ``models/routing.resolve_device``: None is the card (raising without
    one), "cpu" runs the kernels' plain versions; a ``DeviceMesh`` splits
    every scan's lanes over its ranks (see :func:`apply_scan_device`), each
    of which returns the whole planes.  Flags go to ``err_sink`` when
    given (a mesh's then go to ``check_errors(sink, mesh)``), else a
    flagged lane raises JPEGError (on every rank of a mesh)."""
    dev, mesh = _mesh_of(device)
    shapes, planes = _zero_planes(hdr, dev)
    errs: list = []
    for scan in hdr.scans:
        apply_scan_device(hdr, scan, planes, err_sink=errs, mesh=mesh)
    if err_sink is not None:
        err_sink.extend(errs)
    else:
        check_errors(errs, mesh)
    return _finish(planes, shapes, as_device)


def scan_chains(hdr: FrameHeader) -> list:
    """The frame's scans as independent chains, largest (by scan bytes)
    first: all DC scans (coefficient 0 of every component) and each
    component's AC scans (its coefficients 1..63).  A refinement depends
    only on earlier scans of its own chain."""
    chains: dict = {}
    for scan in hdr.scans:
        key = "dc" if scan.ss == 0 else ("ac", scan.comp_indices[0])
        chains.setdefault(key, []).append(scan)
    return sorted(chains.values(),
                  key=lambda sc: -sum(len(s.data) for s in sc))


def run_chain(hdr: FrameHeader, scans: list, planes: list, errs: list, *,
              target_lanes: int, mesh=None) -> None:
    """One chain on the current stream: per scan the host skeleton walk,
    then its kernel (which runs while the next scan's walk does; on a
    ``mesh``, this rank's share of it and the exchange)."""
    nzmaps: dict = {}
    for scan in scans:
        lanes = hybrid_scan_prep(hdr, scan, nzmaps, target_lanes=target_lanes)
        apply_scan_device(hdr, scan, planes, lanes=lanes, err_sink=errs,
                          mesh=mesh)


def decode_progressive_hybrid(hdr: FrameHeader, device=None,
                              as_device: bool = False,
                              target_lanes: int | None = None,
                              err_sink: list | None = None):
    """DRI-0 progressive decode with skeleton lanes: the host walks each
    scan position-only (``native.prog_skeleton_dc``/``_ac``) and the
    kernels decode ~``target_lanes`` lanes per scan from the recorded
    states; all coefficient stores happen on the device.  The chains of
    :func:`scan_chains` run on two threads, on a CUDA device each on its own
    stream, into one set of planes (on a mesh of more than one rank, one
    after another on one thread, in the same order on every rank).  8-bit
    frames with DRI-0 scans only (the caller routes the rest).  ``device``
    (a device or a ``DeviceMesh``), returns and flags as
    :func:`decode_progressive_device`."""
    if hdr.precision != 8:
        raise JPEGError("progressive hybrid path is 8-bit only")
    if any(len(s.seg_offsets) != 2 for s in hdr.scans):
        raise JPEGError(
            "progressive hybrid path requires DRI=0 scans "
            "(restart-segmented scans take segment lanes)")
    if target_lanes is None:
        target_lanes = target_lanes_default()
    if target_lanes < 1:
        raise ValueError(f"target_lanes must be >= 1, got {target_lanes}")
    dev, mesh = _mesh_of(device)
    cuda = dev.type == "cuda"
    shapes, planes = _zero_planes(hdr, dev)
    chains = scan_chains(hdr)
    caller = torch.cuda.current_stream(dev) if cuda else None
    streams = [torch.cuda.Stream(dev) if cuda else None for _ in chains]
    errs: list = [[] for _ in chains]

    def one(k):
        with (torch.cuda.stream(streams[k]) if cuda
              else contextlib.nullcontext()):
            if cuda:
                streams[k].wait_stream(caller)
            run_chain(hdr, chains[k], planes, errs[k],
                      target_lanes=target_lanes, mesh=mesh)

    if len(chains) > 1 and mesh is None:
        with ThreadPoolExecutor(2) as ex:
            list(ex.map(one, range(len(chains))))
    else:
        for k in range(len(chains)):
            one(k)
    flat = [e for es in errs for e in es]
    if cuda:
        for s in streams:
            caller.wait_stream(s)
        for e in flat:
            e.record_stream(caller)
    if err_sink is not None:
        err_sink.extend(flat)
    else:
        check_errors(flat, mesh)
    return _finish(planes, shapes, as_device)


def decode_progressive_lanes(hdr: FrameHeader, device=None,
                             as_device: bool = False,
                             err_sink: list | None = None):
    """Best available device-lane progressive decode (the JAX function's
    routing): frames of another precision than 8 decode on the host
    (``entropy/progressive.py``; the kernels take the 8-bit size
    categories), DRI-0 frames with the native library take skeleton lanes,
    the rest segment lanes.  ``device`` as :func:`decode_progressive_device`
    (a device or a ``DeviceMesh``; a host-decoded frame needs it too: its
    planes go there, on every rank of a mesh)."""
    if not coll.is_mesh(device):
        device = resolve_device(device)
    if hdr.precision != 8:
        from ..entropy import progressive

        planes = progressive.decode_progressive(hdr)
        if as_device:
            dev = _mesh_of(device)[0]
            return [torch.from_numpy(p).to(dev) for p in planes]
        return planes
    if all(len(s.seg_offsets) == 2 for s in hdr.scans):
        from ..entropy import native

        if native.available():
            return decode_progressive_hybrid(hdr, device, as_device=as_device,
                                             err_sink=err_sink)
    return decode_progressive_device(hdr, device, as_device=as_device,
                                     err_sink=err_sink)
