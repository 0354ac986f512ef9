"""Emit-lane Huffman decode from true MCU starts (K7): the CUDA kernel and
its plain version.

Counterpart of the device half of the JAX package's ``hybrid`` backend,
``jpeg_decoder_tpu/ops/entropy_spec.py:_hybrid_pipeline_batch_emit`` with
``ops/entropy_flat.py:decode_emit2`` and ``_dc_prefix_sum_seg``.  A host walk
(``entropy/native.py:emit_prep``, planned by ``ops/entropy_spec.py``) finds
the true start bit of every lane's first MCU, so the device decodes each
lane from a true state: no speculation, no synchronisation.

* :func:`decode_lanes` launches ``csrc/entropy_emit.cu`` (built with nvcc for
  sm_90a at first use into ``.cache/torch/kernels/``, bound with ctypes) on
  CUDA tensors and counts its launches in ``decode_lanes.launches``: the
  emit kernel (one thread per lane, one symbol per iteration, coefficients
  stored at their natural index, DC as lane-local sums) and the carry kernel
  (each lane's DC carry-in within its restart segment).  A failed build or
  launch raises.  On CPU tensors it runs :func:`decode_lanes_torch`; that is
  the only way the plain version is reached.
* :func:`decode_lanes_torch` is the plain PyTorch version the kernel is held
  to: the lanes in lockstep, one symbol per step (as ``decode_emit``, with a
  Python loop over the steps), then the segmented carry.

The LUTs are ``entropy_cuda.device_tables``' (rows ``comp * 2 + is_ac``, as
the JAX package's ``entropy_flat.merged_luts``), cached per device.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .._build import CudaLib, launch_check
from . import entropy_cuda

_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,   # pools, starts
    ctypes.c_void_p, ctypes.c_void_p,   # nm, lane_off
    ctypes.c_void_p, ctypes.c_void_p,   # seg_first, luts
    ctypes.c_void_p, ctypes.c_void_p,   # l1, out
    ctypes.c_void_p, ctypes.c_void_p,   # err, tot
    ctypes.c_int64, ctypes.c_int64,     # n_img, n_words
    ctypes.c_int64, ctypes.c_int64,     # lanes_per_img, n_mcus
    ctypes.c_int64, ctypes.c_int,       # trips, n_tables
    ctypes.c_int, ctypes.c_uint64,      # bpm, comp_code
    ctypes.c_int, ctypes.c_void_p,      # precision, stream
]
LIB = CudaLib("entropy_emit.cu", "jd_entropy_emit",
              {"jd_emit_decode": _ARGS, "jd_emit_carry": _ARGS})

_count_lock = threading.Lock()


def build():
    """Compile ``csrc/entropy_emit.cu`` (once per source and flag set) and
    load it."""
    return LIB.load()


def _check(pools, starts, nm_lane, lane_off, seg_first, luts, block_comp,
           n_comps, n_mcus, trips) -> None:
    dev = pools.device
    for name, t in (("starts", starts), ("nm_lane", nm_lane),
                    ("lane_off", lane_off), ("seg_first", seg_first),
                    ("luts", luts)):
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
    if n_mcus < 1 or seg_first.dtype != torch.int32 or \
            tuple(seg_first.shape) != (n_mcus,):
        raise TypeError(f"seg_first must be ({n_mcus},) int32, got "
                        f"{seg_first.dtype} {tuple(seg_first.shape)}")
    if not 1 <= n_comps <= 4:
        raise ValueError(f"n_comps must be 1..4, got {n_comps}")
    if luts.dtype != torch.int32 or tuple(luts.shape) != (2 * n_comps,
                                                          1 << 16):
        raise TypeError(f"luts must be ({2 * n_comps}, 65536) int32, got "
                        f"{luts.dtype} {tuple(luts.shape)}")
    if not 1 <= len(block_comp) <= 16 or any(
            not 0 <= c < n_comps for c in block_comp):
        raise ValueError(f"bad block_comp {block_comp} for {n_comps} "
                         "components")
    if trips < 0:
        raise ValueError(f"trips must be >= 0, got {trips}")


def decode_lanes(pools: torch.Tensor, starts: torch.Tensor,
                 nm_lane: torch.Tensor, lane_off: torch.Tensor,
                 seg_first: torch.Tensor, luts: torch.Tensor, *,
                 block_comp: tuple[int, ...], n_comps: int, n_mcus: int,
                 trips: int, precision: int = 8,
                 l1: torch.Tensor | None = None):
    """Decode B images of C lanes each to scan-order natural-order blocks.

    pools: (B, W) uint32, each image's scan bytes as big-endian words (zero
    past its end); starts: (B, C) int32 start bit of each lane in its row;
    nm_lane: (B, C) int32 MCUs of each lane (0: no lane); lane_off: (B, C)
    int64 coefficient slot of each lane's first block, first MCU * bpm * 64;
    seg_first: (n_mcus,) int32 first MCU of each MCU's restart segment;
    luts: (2*n_comps, 65536) int32, table 2c the DC and 2c+1 the AC LUT of
    component c; block_comp: the component of each block of an MCU; trips:
    the symbols any lane may decode (the bucketed ``T`` of
    ``entropy_spec.prepare_hybrid_batch_emit``); precision: 8 or 12 (the
    size categories).  On the card ``l1`` is the first-level tables of
    ``luts`` (built here when not given, cached by
    ``entropy_cuda.device_tables``).

    The lanes of an image must tile its MCUs in order, each inside one
    restart segment; a plan that does not is flagged.  Returns ((B, n_mcus
    * bpm, 64) int32 blocks, (B,) int32 error flags); a flagged image's
    blocks are unspecified.  On CUDA tensors this launches the kernels or
    raises; on CPU tensors it runs :func:`decode_lanes_torch`.
    """
    _check(pools, starts, nm_lane, lane_off, seg_first, luts, block_comp,
           n_comps, n_mcus, trips)
    entropy_cuda.size_limits(precision)
    dev = pools.device
    kw = dict(block_comp=block_comp, n_comps=n_comps, n_mcus=n_mcus,
              trips=trips, precision=precision)
    if dev.type == "cpu":
        return decode_lanes_torch(pools, starts, nm_lane, lane_off,
                                  seg_first, luts, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if l1 is None:
        l1 = entropy_cuda.first_level(luts)
    elif (l1.device != dev or l1.dtype != torch.int16
          or tuple(l1.shape) != (luts.shape[0], 1 << entropy_cuda.L1_BITS)
          or not l1.is_contiguous()):
        raise TypeError(f"l1 must be ({luts.shape[0]}, "
                        f"{1 << entropy_cuda.L1_BITS}) int16 on {dev}")
    bufs = buffers(pools, starts, n_mcus, len(block_comp))
    args = (pools, starts, nm_lane, lane_off, seg_first, luts, l1, *bufs)
    launch(args, "jd_emit_decode", **kw)
    launch(args, "jd_emit_carry", **kw)
    with _count_lock:
        decode_lanes.launches += 1
    return bufs[0], bufs[1]


#: Launches of the CUDA kernels (emit, then carry) since the count was last
#: set to 0.
decode_lanes.launches = 0


def buffers(pools: torch.Tensor, starts: torch.Tensor, n_mcus: int,
            bpm: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The zero-filled (B, n_mcus*bpm, 64) int32 blocks, (B,) int32 flags
    and (B*C, 4) int32 lane DC sums the two kernels write."""
    b, c = starts.shape
    dev = pools.device
    return (torch.zeros((b, n_mcus * bpm, 64), dtype=torch.int32, device=dev),
            torch.zeros((b,), dtype=torch.int32, device=dev),
            torch.zeros((b * c, 4), dtype=torch.int32, device=dev))


def launch(args: tuple, entry: str, *, block_comp: tuple[int, ...],
           n_comps: int, n_mcus: int, trips: int, precision: int) -> None:
    """One kernel launch on the current stream: ``entry`` is
    ``jd_emit_decode`` or ``jd_emit_carry``; ``args`` the tensors pools,
    starts, nm_lane, lane_off, seg_first, luts, l1 and the
    :func:`buffers`, checked by :func:`decode_lanes`.  Counts nothing (the
    phases' own timing calls it)."""
    lib = build()
    pools, starts, luts = args[0], args[1], args[5]
    comp_code = sum(c << (4 * k) for k, c in enumerate(block_comp))
    dev = pools.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in args), pools.shape[0], pools.shape[1],
            starts.shape[1], n_mcus, trips, luts.shape[0], len(block_comp),
            comp_code, precision, stream)
    launch_check(rc, entry)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 range modulo 2^32 (two's
    complement wrap, as the kernel's uint32 sums and jnp.cumsum give)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def decode_lanes_torch(pools: torch.Tensor, starts: torch.Tensor,
                       nm_lane: torch.Tensor, lane_off: torch.Tensor,
                       seg_first: torch.Tensor, luts: torch.Tensor, *,
                       block_comp: tuple[int, ...], n_comps: int,
                       n_mcus: int, trips: int, precision: int = 8):
    """Plain PyTorch version of :func:`decode_lanes`, the same contract.

    Lanes in lockstep: each of at most ``trips`` steps decodes one symbol of
    every unfinished lane with ``torch`` gathers into the words and the
    LUTs (``entropy_cuda``'s lane step), storing each coefficient at its
    natural index and DC as the lane's running sum per component; then each
    lane's carry-in, the exclusive sum of the lane sums before it in its
    image and restart segment, is added to its blocks' DC terms.  Arithmetic
    is int64, wrapped to int32 where the kernel's sums wrap."""
    dev = pools.device
    b, c = starts.shape
    s = b * c
    bpm = len(block_comp)
    nb = n_mcus * bpm
    lane = torch.arange(s, device=dev)
    img, j = lane // c, lane % c
    lanes = entropy_cuda._Lanes(pools, luts, block_comp, img, precision)
    nm = nm_lane.reshape(-1).to(torch.int64)
    off = lane_off.reshape(-1).to(torch.int64)
    seg = seg_first.to(torch.int64)
    active = nm > 0

    # The plan: lanes tile each image's MCUs in order, each inside one
    # restart segment (see the kernel).
    m_lo = off // (64 * bpm)
    end = m_lo + nm
    malformed = (off % (64 * bpm) != 0) | (off < 0) | (end > n_mcus)
    m_lo = torch.where(malformed, 0, m_lo)
    nxt_on = torch.roll(active, -1) & (j + 1 < c)
    prv_on = torch.roll(active, 1) & (j > 0)
    last = (end - 1).clamp(0, n_mcus - 1)
    bad_plan = active & (malformed | torch.where(j == 0, m_lo != 0, ~prv_on)
                         | torch.where(nxt_on, end != torch.roll(m_lo, -1),
                                       end != n_mcus)
                         | (seg[last] != seg[m_lo]))
    nm = torch.where(bad_plan, 0, nm)
    n_blk = nm * bpm

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
    key = torch.where(on, img * (n_mcus + 1) + seg[m_lo], -1 - lane)
    tot = torch.where(on.view(-1, 1), run, 0)
    excl = tot.cumsum(0) - tot
    head = torch.ones(s, dtype=torch.bool, device=dev)
    head[1:] = key[1:] != key[:-1]
    first = torch.where(head, lane, 0).cummax(0).values
    carry = _wrap32(excl - excl[first])
    owner = torch.repeat_interleave(lane, n_blk)
    within = torch.arange(len(owner), device=dev) - torch.repeat_interleave(
        n_blk.cumsum(0) - n_blk, n_blk)
    comp = torch.tensor(block_comp, dtype=torch.int64, device=dev)
    at = base[owner] + within * 64
    out[at] = _wrap32(out[at].to(torch.int64)
                      + carry[owner, comp[within % bpm]]).to(torch.int32)
    return (out[:dump].view(b, nb, 64),
            err.view(b, c).any(1).to(torch.int32))
