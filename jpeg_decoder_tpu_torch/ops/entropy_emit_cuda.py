"""Emit-lane Huffman decode from true MCU starts (K7): the CUDA kernel and
its plain version.

Counterpart of the device half of the JAX package's ``hybrid`` backend,
``jpeg_decoder_tpu/ops/entropy_spec.py:_hybrid_pipeline_batch_emit`` with
``ops/entropy_flat.py:decode_emit2`` and ``_dc_prefix_sum_seg``, and of the
emission step of ``parallel/sharded.py:_hybrid_full_step_emit_dyn``: a
geometry-bucketed group whose images differ in size, restart interval and
Huffman tables (``lut_base``, ``n_mcus_img``, ``ri``).  A host walk
(``entropy/native.py:emit_prep``, planned by ``ops/entropy_spec.py``) finds
the true start bit of every lane's first MCU, so the device decodes each
lane from a true state: no speculation, no synchronisation.

* :func:`decode_lanes` launches ``csrc/entropy_emit.cu`` (built with nvcc for
  sm_90a at first use into ``.cache/torch/kernels/``, bound with ctypes) on
  CUDA tensors and counts its launches in ``decode_lanes.launches``: one
  persistent grid that stages each lane group's stream words and the tables
  in shared memory, decodes the group's lanes one thread each, stores every
  block whole once, and carries DC across groups by a decoupled look-back
  (see the source).  :func:`schedule` picks the group size and the staging
  budget on the host.  A failed build or launch raises.  On CPU tensors it
  runs :func:`decode_lanes_torch`; that is the only way the plain version
  is reached.
* :func:`decode_lanes_torch` is the plain PyTorch version the kernel is held
  to: the lanes in lockstep, one symbol per step (as ``decode_emit``, with a
  Python loop over the steps), then the segmented carry.

The LUTs are ``entropy_cuda.device_tables``' (rows ``comp * 2 + is_ac``, as
the JAX package's ``entropy_flat.merged_luts``), cached per device, or a
stack of such sets (``entropy_cuda.device_table_stack``) that ``lut_base``
indexes.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .._build import CudaLib, launch_check
from . import entropy_cuda

_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,   # pools, starts
    ctypes.c_void_p, ctypes.c_void_p,   # nm, lane_off
    ctypes.c_void_p, ctypes.c_void_p,   # seg_first, lut_base
    ctypes.c_void_p, ctypes.c_void_p,   # n_mcus_img, ri
    ctypes.c_void_p, ctypes.c_void_p,   # luts, l1
    ctypes.c_void_p, ctypes.c_void_p,   # out, err
    ctypes.c_void_p,                    # scratch
    ctypes.c_int64, ctypes.c_int64,     # n_img, n_words
    ctypes.c_int64, ctypes.c_int64,     # lanes_per_img, n_mcus
    ctypes.c_int64, ctypes.c_int64,     # rows, trips
    ctypes.c_int, ctypes.c_int,         # n_tables, n_stack
    ctypes.c_int, ctypes.c_uint64,      # bpm, comp_code
    ctypes.c_int, ctypes.c_int,         # precision, group_lanes
    ctypes.c_int, ctypes.c_int,         # budget_words, grid
    ctypes.c_int64, ctypes.c_int64,     # lane_lo, lane_hi
    ctypes.c_void_p,                    # stream
]
LIB = CudaLib("entropy_emit.cu", "jd_entropy_emit", {
    "jd_emit_lanes": _ARGS,
    "jd_emit_ctas_per_sm": [ctypes.c_int, ctypes.c_int, ctypes.c_int]})

# Constants of csrc/entropy_emit.cu.
#: Lanes per group (threads per CTA), in order of preference.
GROUP_LANES = (128, 64, 32)
#: Words past a lane's last word that its reader may load.
LOOKAHEAD_WORDS = 3
_L1_BYTES = 2 << entropy_cuda.L1_BITS     # one first-level table
_L2_BYTES = 128 * 16 * 2                  # the second-level slots
_LANE_BYTES = 68 * 2 + 16 * 4            # a lane's block buffer, DC terms
_HEADER_WORDS = 8
_STATUS_WORDS = 16
#: Dynamic shared memory a CTA may ask for on sm_90 (227 KB), less room for
#: the kernel's static shared memory.
SMEM_LIMIT = 232448 - 1024
#: What ``decode_lanes.last_stats`` holds, in order: the lane groups whose
#: reads all came from shared memory, the groups that read stream words from
#: device memory (over the staging budget), the probes that read the full
#: tables in device memory, and the table sets the CTAs staged (at least one
#: per CTA; more when a CTA moves to an image of another set).
STATS = ("groups_staged", "groups_over_budget", "lut_misses", "table_stages")

_count_lock = threading.Lock()


def build():
    """Compile ``csrc/entropy_emit.cu`` (once per source and flag set) and
    load it."""
    return LIB.load()


def smem_bytes(group_lanes: int, budget_words: int, n_tables: int) -> int:
    """Dynamic shared memory of one CTA: the staged words (plus 4 for
    alignment), the first- and second-level tables, each lane's block
    buffer and lane-local DC terms."""
    return (4 * (budget_words + 4) + n_tables * _L1_BYTES + _L2_BYTES
            + group_lanes * _LANE_BYTES)


def staging_words(group_lanes: int, n_words: int, lanes_per_img: int) -> int:
    """Staging budget of a group of ``group_lanes`` lanes: twice its share
    of the pool row plus 64 words (lanes hold about equal symbol counts, not
    equal bits), rounded up to 64 words."""
    share = -(-group_lanes * n_words // max(1, lanes_per_img))
    return -(-(2 * share + 64) // 64) * 64


def schedule(n_img: int, n_words: int, lanes_per_img: int, n_tables: int,
             n_sms: int, lanes: int | None = None) -> tuple[int, int]:
    """(group_lanes, budget_words) of a launch of ``lanes`` of each
    image's ``lanes_per_img`` (all of them by default).

    The largest group in :data:`GROUP_LANES` that still gives half the SMs
    a group (``n_img * ceil(lanes / L) >= n_sms / 2``; the smallest
    otherwise), whose :func:`staging_words` fit the CTA's shared memory: a
    CTA pays for its table copy once, so a few large groups beat many
    one-warp ones (chip_smoke.py's group-size readings on an H100,
    PERF.md)."""
    c = max(1, lanes_per_img if lanes is None else lanes)
    need = cap = 0
    for group in GROUP_LANES:
        need = staging_words(group, n_words, max(1, lanes_per_img))
        cap = (SMEM_LIMIT - smem_bytes(group, 0, n_tables)) // 16 * 4
        fills = (2 * n_img * -(-c // group) >= n_sms
                 or group == GROUP_LANES[-1])
        if fills and need <= cap:
            return group, need
    return GROUP_LANES[-1], min(need, cap)


def _check(pools, starts, nm_lane, lane_off, seg_first, luts, block_comp,
           n_comps, n_mcus, trips, per_img=None, rows=None) -> None:
    """Raises unless the arguments of :func:`decode_lanes` are as it says:
    ``per_img`` the per-image tensors by name, ``rows`` the output's rows
    (n_mcus * bpm when None)."""
    per_img = per_img or {}
    rows = n_mcus * len(block_comp) if rows is None else rows
    dev = pools.device
    for name, t in (("starts", starts), ("nm_lane", nm_lane),
                    ("lane_off", lane_off), ("seg_first", seg_first),
                    ("luts", luts), *per_img.items()):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, pools on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pools.dtype != torch.uint32 or pools.dim() != 2 or 0 in pools.shape:
        raise TypeError(f"pools must be non-empty (B, W) uint32, got "
                        f"{pools.dtype} {tuple(pools.shape)}")
    if not pools.is_contiguous():
        raise ValueError("pools must be contiguous")
    b = pools.shape[0]
    for name, t, dt in (("starts", starts, torch.int32),
                        ("nm_lane", nm_lane, torch.int32),
                        ("lane_off", lane_off, torch.int64)):
        if t.dtype != dt or t.dim() != 2 or t.shape[0] != b or \
                t.shape[1] < 1 or t.shape != starts.shape:
            raise TypeError(f"{name} must be ({b}, C) {dt}, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if n_mcus < 1:
        raise ValueError(f"n_mcus must be >= 1, got {n_mcus}")
    if seg_first is not None and (seg_first.dtype != torch.int32 or tuple(
            seg_first.shape) != (n_mcus,)):
        raise TypeError(f"seg_first must be ({n_mcus},) int32, got "
                        f"{seg_first.dtype} {tuple(seg_first.shape)}")
    for name, t in per_img.items():
        if t is not None and (t.dtype != torch.int32
                              or tuple(t.shape) != (b,)):
            raise TypeError(f"{name} must be ({b},) int32, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if not 1 <= n_comps <= 4:
        raise ValueError(f"n_comps must be 1..4, got {n_comps}")
    one_set = per_img.get("lut_base") is None
    if (luts.dtype != torch.int32 or luts.dim() != 2
            or luts.shape[1] != 1 << 16 or luts.shape[0] < 2 * n_comps
            or luts.shape[0] % (2 * n_comps)
            or (one_set and luts.shape[0] != 2 * n_comps)):
        raise TypeError(f"luts must be ({2 * n_comps} * sets, 65536) int32 "
                        f"(one set without lut_base), got {luts.dtype} "
                        f"{tuple(luts.shape)}")
    if rows < n_mcus * len(block_comp):
        raise ValueError(f"rows {rows} < n_mcus * bpm")
    if not 1 <= len(block_comp) <= 16 or any(
            not 0 <= c < n_comps for c in block_comp):
        raise ValueError(f"bad block_comp {block_comp} for {n_comps} "
                         "components")
    if trips < 0:
        raise ValueError(f"trips must be >= 0, got {trips}")


def decode_lanes(pools: torch.Tensor, starts: torch.Tensor,
                 nm_lane: torch.Tensor, lane_off: torch.Tensor,
                 seg_first: torch.Tensor | None, luts: torch.Tensor, *,
                 block_comp: tuple[int, ...], n_comps: int, n_mcus: int,
                 trips: int, precision: int = 8,
                 l1: torch.Tensor | None = None,
                 lut_base: torch.Tensor | None = None,
                 n_mcus_img: torch.Tensor | None = None,
                 ri: torch.Tensor | None = None, rows: int | None = None,
                 lanes: tuple[int, int] | None = None):
    """Decode B images of C lanes each to scan-order natural-order blocks.

    pools: (B, W) uint32, each image's scan bytes as big-endian words (zero
    past its end); starts: (B, C) int32 start bit of each lane in its row;
    nm_lane: (B, C) int32 MCUs of each lane (0: no lane); lane_off: (B, C)
    int64 coefficient slot of each lane's first block, first MCU * bpm * 64;
    seg_first: (n_mcus,) int32 first MCU of each MCU's restart segment, or
    None (each image's segments from ``ri``); luts: (2*n_comps, 65536) int32,
    table 2c the DC and 2c+1 the AC LUT of component c, or with ``lut_base``
    a stack of such sets; block_comp: the component of each block of an MCU;
    trips: the symbols any lane may decode (the bucketed ``T`` of
    ``entropy_spec.prepare_hybrid_batch_emit``); precision: 8 or 12 (the
    size categories).  On the card ``l1`` is the first-level tables of
    ``luts`` (built here when not given, cached by
    ``entropy_cuda.device_tables``).

    A group of images of assorted geometry and tables (a geometry bucket)
    adds, each (B,) int32: ``lut_base``, the first table of each image's set
    in the stack; ``n_mcus_img``, each image's MCUs (``n_mcus`` is then the
    bucket's); ``ri``, each image's restart interval, whose segments start
    at multiples of it (with ``seg_first`` None).  ``rows`` (at least
    ``n_mcus * bpm``, the default) is the rows of each image's output.
    ``lanes`` = (lo, hi) decodes only lanes lo .. hi-1 of every image (a
    rank's share on a mesh; all C by default): the plan is still checked
    against the whole table, the DC carry starts from 0 at lane lo, and
    only those lanes' rows (and the zero rows past each image's blocks) are
    written.

    The lanes of an image must tile its MCUs in order, each inside one
    restart segment; a plan that does not is flagged, and so is an
    ``n_mcus_img`` outside [1, n_mcus] or a set outside the stack.  Returns
    ((B, rows, 64) int32 blocks, (B,) int32 error flags); the rows past an
    image's blocks are zeros, a flagged image's blocks are unspecified.  On
    CUDA tensors this launches the kernel or raises; on CPU tensors it runs
    :func:`decode_lanes_torch`.
    """
    per_img = dict(lut_base=lut_base, n_mcus_img=n_mcus_img, ri=ri)
    rows = n_mcus * len(block_comp) if rows is None else rows
    _check(pools, starts, nm_lane, lane_off, seg_first, luts, block_comp,
           n_comps, n_mcus, trips, per_img, rows)
    lanes = (0, starts.shape[1]) if lanes is None else tuple(lanes)
    if not 0 <= lanes[0] < lanes[1] <= starts.shape[1]:
        raise ValueError(f"lanes {lanes} outside the plan's "
                         f"{starts.shape[1]}")
    entropy_cuda.size_limits(precision)
    dev = pools.device
    kw = dict(block_comp=block_comp, n_comps=n_comps, n_mcus=n_mcus,
              trips=trips, precision=precision)
    if dev.type == "cpu":
        return decode_lanes_torch(pools, starts, nm_lane, lane_off,
                                  seg_first, luts, **kw, **per_img,
                                  rows=rows, lanes=lanes)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if l1 is None:
        l1 = entropy_cuda.first_level(luts)
    elif (l1.device != dev or l1.dtype != torch.int16
          or tuple(l1.shape) != (luts.shape[0], 1 << entropy_cuda.L1_BITS)
          or not l1.is_contiguous()):
        raise TypeError(f"l1 must be ({luts.shape[0]}, "
                        f"{1 << entropy_cuda.L1_BITS}) int16 on {dev}")
    sched = schedule(pools.shape[0], pools.shape[1], starts.shape[1],
                     2 * n_comps, _n_sms(dev), lanes=lanes[1] - lanes[0])
    out, scratch = buffers(pools, starts, n_mcus, len(block_comp), sched[0],
                           rows=rows, lanes=lanes[1] - lanes[0])
    launch((pools, starts, nm_lane, lane_off, seg_first, luts, l1), out,
           scratch, group_lanes=sched[0], budget_words=sched[1], **kw,
           **per_img, lanes=lanes)
    with _count_lock:
        decode_lanes.launches += 1
    n = pools.shape[0]
    decode_lanes.last_stats = scratch[n + 1:n + 1 + len(STATS)]
    return out, scratch[:n]


#: Launches of the CUDA kernel since the count was last set to 0.
decode_lanes.launches = 0
#: The :data:`STATS` counters of the last launch, a device tensor.
decode_lanes.last_stats = None


@functools.lru_cache(maxsize=None)
def _n_sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _n_sms(dev: torch.device) -> int:
    return _n_sms_of(torch.device(dev).index or 0)


def buffers(pools: torch.Tensor, starts: torch.Tensor, n_mcus: int,
            bpm: int, group_lanes: int, rows: int | None = None,
            lanes: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The (B, rows, 64) int32 blocks (``rows`` n_mcus*bpm by default), left
    uninitialised (the kernel writes every element of an unflagged image),
    and the zero-filled int32 scratch: the (B,) error flags, then the
    kernel's ticket, its :data:`STATS` counters and each lane group's carry
    status (``lanes`` lanes of each image launched, all by default)."""
    b, c = starts.shape
    c = c if lanes is None else lanes
    dev = pools.device
    n_groups = b * -(-c // group_lanes)
    rows = n_mcus * bpm if rows is None else rows
    return (torch.empty((b, rows, 64), dtype=torch.int32, device=dev),
            torch.zeros(b + _HEADER_WORDS + _STATUS_WORDS * n_groups,
                        dtype=torch.int32, device=dev))


@functools.lru_cache(maxsize=256)
def _ctas_per_sm(index: int, group_lanes: int, budget_words: int,
                 n_tables: int) -> int:
    with torch.cuda.device(index):
        n = build().jd_emit_ctas_per_sm(group_lanes, budget_words, n_tables)
    launch_check(max(0, -n), "jd_emit_ctas_per_sm")
    if n < 1:
        raise RuntimeError(f"K7 cannot run {group_lanes} lanes with "
                           f"{budget_words} staged words per CTA")
    return n


def ctas_per_sm(group_lanes: int, budget_words: int, n_tables: int,
                dev: torch.device | None = None) -> int:
    """CTAs of the kernel one SM of ``dev`` holds at this shape (the
    persistent grid is this times the SMs, or the groups if fewer); cached
    per device and shape."""
    index = torch.device(dev).index if dev is not None else None
    index = torch.cuda.current_device() if index is None else index
    return _ctas_per_sm(index, group_lanes, budget_words, n_tables)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch(args: tuple, out: torch.Tensor, scratch: torch.Tensor, *,
           block_comp: tuple[int, ...], n_comps: int, n_mcus: int,
           trips: int, precision: int, group_lanes: int, budget_words: int,
           lut_base: torch.Tensor | None = None,
           n_mcus_img: torch.Tensor | None = None,
           ri: torch.Tensor | None = None,
           lanes: tuple[int, int] | None = None) -> None:
    """One kernel launch on the current stream: ``args`` the tensors pools,
    starts, nm_lane, lane_off, seg_first (or None), luts and l1, and the
    per-image ``lut_base``, ``n_mcus_img`` and ``ri``, checked by
    :func:`decode_lanes`; ``out`` and ``scratch`` from :func:`buffers` (the
    scratch zero-filled, for the same ``lanes``).  Counts nothing (the
    phases' own timing and the tests that force a staging budget call
    it)."""
    lib = build()
    pools, starts, seg_first, luts, l1 = (args[0], args[1], args[4], args[5],
                                          args[6])
    comp_code = sum(c << (4 * k) for k, c in enumerate(block_comp))
    dev = pools.device
    n = pools.shape[0]
    lanes = (0, starts.shape[1]) if lanes is None else lanes
    grid = ctas_per_sm(group_lanes, budget_words, 2 * n_comps,
                       dev) * _n_sms(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jd_emit_lanes(
            *(t.data_ptr() for t in args[:4]), _ptr(seg_first),
            _ptr(lut_base), _ptr(n_mcus_img), _ptr(ri), luts.data_ptr(),
            l1.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * n, n, pools.shape[1], starts.shape[1],
            n_mcus, out.shape[1], trips, 2 * n_comps, luts.shape[0],
            len(block_comp), comp_code, precision, group_lanes,
            budget_words, grid, lanes[0], lanes[1], stream)
    launch_check(rc, "jd_emit_lanes")


def stats(scratch: torch.Tensor, n_img: int) -> dict:
    """The :data:`STATS` counters of a launch's scratch, as ints."""
    vals = scratch[n_img + 1:n_img + 1 + len(STATS)].tolist()
    return dict(zip(STATS, vals))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 range modulo 2^32 (two's
    complement wrap, as the kernel's uint32 sums and jnp.cumsum give)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def lane_carry(key: torch.Tensor, tot: torch.Tensor) -> torch.Tensor:
    """Each lane's DC carry-in: the exclusive sum of ``tot`` (S, 4) over the
    run of consecutive lanes with its ``key`` (S,) (keys of distinct runs
    differ), wrapped to int32."""
    lane = torch.arange(len(key), device=key.device)
    excl = tot.cumsum(0) - tot
    head = torch.ones(len(key), dtype=torch.bool, device=key.device)
    head[1:] = key[1:] != key[:-1]
    first = torch.where(head, lane, 0).cummax(0).values
    return _wrap32(excl - excl[first])


def decode_lanes_torch(pools: torch.Tensor, starts: torch.Tensor,
                       nm_lane: torch.Tensor, lane_off: torch.Tensor,
                       seg_first: torch.Tensor | None, luts: torch.Tensor, *,
                       block_comp: tuple[int, ...], n_comps: int,
                       n_mcus: int, trips: int, precision: int = 8,
                       lut_base: torch.Tensor | None = None,
                       n_mcus_img: torch.Tensor | None = None,
                       ri: torch.Tensor | None = None,
                       rows: int | None = None,
                       lanes: tuple[int, int] | None = None):
    """Plain PyTorch version of :func:`decode_lanes`, the same contract.

    Lanes in lockstep: each of at most ``trips`` steps decodes one symbol of
    every unfinished lane with ``torch`` gathers into the words and the
    LUTs (``entropy_cuda``'s lane step, from the lane's image's table set),
    storing each coefficient at its natural index and DC as the lane's
    running sum per component; then each lane's carry-in, the exclusive sum
    of the lane sums before it in its image and restart segment, is added to
    its blocks' DC terms.  Arithmetic is int64, wrapped to int32 where the
    kernel's sums wrap."""
    dev = pools.device
    b, c = starts.shape
    lo, hi = (0, c) if lanes is None else lanes
    s = b * c
    bpm = len(block_comp)
    rows = n_mcus * bpm if rows is None else rows
    lane = torch.arange(s, device=dev)
    img, j = lane // c, lane % c

    def per_img(t, default):
        return (torch.full((b,), default, dtype=torch.int64, device=dev)
                if t is None else t.to(torch.int64))

    set_base = per_img(lut_base, 0)
    bad_set = (set_base < 0) | (set_base + 2 * n_comps > luts.shape[0])
    set_base = torch.where(bad_set, 0, set_base)
    n_img = per_img(n_mcus_img, n_mcus)
    bad_img = bad_set | (n_img < 1) | (n_img > n_mcus)
    n_img = torch.where(bad_img, n_mcus, n_img)
    lanes = entropy_cuda._Lanes(pools, luts, block_comp, img, precision,
                                table_base=set_base[img])
    nm = nm_lane.reshape(-1).to(torch.int64)
    off = lane_off.reshape(-1).to(torch.int64)
    active = nm > 0
    mine = (j >= lo) & (j < hi)

    def seg(m):            # first MCU of the restart segment of lane MCU m
        if seg_first is not None:
            return seg_first.to(torch.int64)[m]
        r = per_img(ri, 0)[img]
        return torch.where(r > 0, m // r.clamp(min=1) * r, 0)

    # The plan: lanes tile each image's MCUs in order, each inside one
    # restart segment (see the kernel).
    n_lane = n_img[img]
    m_lo = off // (64 * bpm)
    end = m_lo + nm
    malformed = (off % (64 * bpm) != 0) | (off < 0) | (end > n_lane)
    m_lo = torch.where(malformed, 0, m_lo)
    nxt_on = torch.roll(active, -1) & (j + 1 < c)
    prv_on = torch.roll(active, 1) & (j > 0)
    last = torch.minimum((end - 1).clamp(min=0), n_lane - 1)
    bad_plan = active & (malformed | torch.where(j == 0, m_lo != 0, ~prv_on)
                         | torch.where(nxt_on, end != torch.roll(m_lo, -1),
                                       end != n_lane)
                         | (seg(last) != seg(m_lo)) | bad_img[img]) & mine
    nm = torch.where(bad_plan | ~mine, 0, nm)
    n_blk = nm * bpm
    nb = rows

    dump = b * nb * 64
    out = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    pos = starts.reshape(-1).to(torch.int64)
    k = torch.zeros_like(pos)
    i = torch.zeros_like(pos)
    blk = torch.zeros_like(pos)
    run = torch.zeros((s, 4), dtype=torch.int64, device=dev)
    err = bad_plan.clone()
    base = (img * nb + m_lo * bpm) * 64
    for t in range(trips):
        act = ~err & (blk < n_blk)
        if t % 16 == 0 and not bool(act.any()):
            break
        ci, is_dc, bad, val, ac_at, pos2, k2, i2 = lanes.step(pos, k, i)
        ok = act & ~bad
        err = err | (act & bad)
        dc_ok = ok & is_dc
        old = run.gather(1, ci.view(-1, 1)).view(-1)
        new = _wrap32(old + val)
        run.scatter_(1, ci.view(-1, 1),
                     torch.where(dc_ok, new, old).view(-1, 1))
        col = torch.where(dc_ok, 0, ac_at)
        dst = torch.where(ok & (col >= 0), base + blk * 64 + col, dump)
        out.index_put_((dst,), torch.where(dc_ok, new, val).to(torch.int32))
        blk = blk + (ok & ~is_dc & (i2 == 0))
        pos = torch.where(ok, pos2, pos)
        k = torch.where(ok, k2, k)
        i = torch.where(ok, i2, i)
    err = err | (blk < n_blk)

    # Carry: exclusive sums of the lane sums within (image, segment) runs.
    on = nm > 0
    key = torch.where(on, img * (n_mcus + 1) + seg(m_lo), -1 - lane)
    carry = lane_carry(key, torch.where(on.view(-1, 1), run, 0))
    owner = torch.repeat_interleave(lane, n_blk)
    within = torch.arange(len(owner), device=dev) - torch.repeat_interleave(
        n_blk.cumsum(0) - n_blk, n_blk)
    comp = torch.tensor(block_comp, dtype=torch.int64, device=dev)
    at = base[owner] + within * 64
    out[at] = _wrap32(out[at].to(torch.int64)
                      + carry[owner, comp[within % bpm]]).to(torch.int32)
    return (out[:dump].view(b, nb, 64),
            (err.view(b, c).any(1) | bad_set).to(torch.int32))
