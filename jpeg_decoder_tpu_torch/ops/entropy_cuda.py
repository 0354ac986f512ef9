"""Device Huffman decode of restart segments: the CUDA kernel and its twins.

Counterpart of ``jpeg_decoder_tpu/ops/entropy_pallas.py``.  Restart segments
are independent (DC predictors reset and the stream is byte-aligned at each
RSTn), and the device decodes all of them at once into scan-order 8x8 blocks
in natural coefficient order.  It reads segment s as big-endian uint32 words
from one of two forms, one kernel build each: a row of words the host packed
(``ops/scan_prep.prepare_scan``; the batch routes), or the unstuffed scan
bytes read in place at the segment's byte offsets, zero from the next
segment's first byte on (``scan_prep.segment_table``; ``decode()``).

* :func:`decode_segments` launches ``csrc/entropy.cu`` (built with nvcc for
  sm_90a at first use into ``.cache/torch/kernels/``, bound with ctypes) on
  CUDA tensors and counts its launches in ``decode_segments.launches``.  The
  kernel cuts every segment into chunks of :data:`CHUNK_BITS` bits, one
  thread each, that synchronise on the true symbol boundaries (see the
  source), so a DRI=0 stream is thousands of lanes, not one.  A failed build
  or launch raises.  On CPU tensors it runs :func:`decode_segments_torch`;
  that is the only way a plain version is reached.
* :func:`decode_scan_bytes` launches the same kernels on the in-place form;
  on CPU tensors it builds the rows with :func:`segment_words_torch`, the
  plain version of the kernel's byte reader, and runs
  :func:`decode_segments_torch`.
* :func:`decode_segments_torch` is the plain PyTorch twin the kernel is held
  to: the sequential decode, with the segments as lanes in lockstep.
* :func:`decode_segments_chunked_torch` is the plain model of the kernel's
  phases (chunks as lanes in lockstep), for the CPU tests of the
  synchronisation logic; no path runs it.
* :func:`device_tables` caches each table set's LUTs and first-level tables
  per device; :func:`decode_scan_baseline` is the ``entropy="pallas"`` and
  ``"jax"`` backend of ``models/decoder.py`` (and ``"hybrid"``'s on restart
  streams): on the card K2 reads the parser's scan bytes in place, blocks
  stay on the device, and only the per-segment error flags cross to the
  host.

Every version takes the frame's precision, 8 or 12 bits, for T.81's size
categories (:func:`size_limits`); the Pallas kernel flags 12-bit ones, and
``entropy="pallas"`` keeps refusing 12-bit frames as JAX's does.

The Pallas kernel writes zig-zag rows and its wrapper de-permutes them; here
every version stores each coefficient at its natural index directly.
Unlike the JAX wrapper, nothing falls back: a kernel that does not build or
launch raises.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict

import numpy as np
import torch

from .._build import CudaLib, launch_check
from ..types import FrameHeader, JPEGError, ScanHeader, ZIGZAG
from ..utils import profiling
from . import scan_prep

LIB = CudaLib("entropy.cu", "jd_entropy", {
    "jd_build_l1": [
        ctypes.c_void_p, ctypes.c_void_p,   # luts, l1
        ctypes.c_int, ctypes.c_void_p,      # n_tables, stream
    ],
    "jd_decode_segments": [
        ctypes.c_void_p, ctypes.c_void_p,   # words, seg_nmcus
        ctypes.c_void_p, ctypes.c_void_p,   # luts, l1
        ctypes.c_void_p, ctypes.c_void_p,   # out, err
        ctypes.c_void_p,                    # scratch
        ctypes.c_int64, ctypes.c_int64,     # n_seg, n_words
        ctypes.c_int64, ctypes.c_int,       # rows, n_tables
        ctypes.c_int, ctypes.c_uint64,      # bpm, comp_code
        ctypes.c_int64, ctypes.c_int,       # chunk_bits, global_rounds
        ctypes.c_int, ctypes.c_void_p,      # precision, stream
    ],
    "jd_decode_scan_bytes": [
        ctypes.c_void_p, ctypes.c_int64,    # bytes, n_bytes
        ctypes.c_void_p, ctypes.c_void_p,   # seg, luts
        ctypes.c_void_p, ctypes.c_void_p,   # l1, out
        ctypes.c_void_p, ctypes.c_void_p,   # err, scratch
        ctypes.c_int64, ctypes.c_int64,     # n_seg, n_words
        ctypes.c_int64, ctypes.c_int,       # rows, n_tables
        ctypes.c_int, ctypes.c_uint64,      # bpm, comp_code
        ctypes.c_int64, ctypes.c_int,       # chunk_bits, global_rounds
        ctypes.c_int, ctypes.c_void_p,      # precision, stream
    ]})

#: Lockstep steps of the twin between two checks for unfinished lanes.
_TWIN_CHECK_EVERY = 16
#: Bits per chunk, the kernel's unit of parallelism inside a segment.
CHUNK_BITS = 1024
#: Chunks (threads) per CTA of the sync and write kernels (kSyncLanes in
#: csrc/entropy.cu).
SYNC_LANES = 64
#: Rounds across CTA boundaries before the serial seal.
GLOBAL_ROUNDS = 2
#: Index bits of the first-level tables (kL1Bits in csrc/entropy.cu).
L1_BITS = 12
#: The statistics of a launch (``decode_segments``' ``tail``), in order:
#: the most iterations of a CTA in the first sync launch, the CTAs re-run
#: across CTA boundaries and their most iterations, the chunks the serial
#: seal re-decoded, and the chunk decodes of all sync launches.
STATS = ("round0_iterations", "global_round_ctas", "global_round_iterations",
         "seal_redecodes", "sync_decodes")
#: Table sets kept on each device by :func:`device_tables`.
TABLE_CACHE_SIZE = 16

_count_lock = threading.Lock()
_tables_lock = threading.Lock()
_tables: OrderedDict = OrderedDict()


def build():
    """Compile ``csrc/entropy.cu`` (once per source and flag set) and load
    it."""
    return LIB.load()


def size_limits(precision: int) -> tuple[int, int]:
    """The largest DC and AC size categories of a frame (T.81 F.1.2.1,
    B.2.2): 11 and 10 at 8 bits, 15 and 14 at 12."""
    if precision not in (8, 12):
        raise ValueError(f"precision must be 8 or 12, got {precision}")
    return (11, 10) if precision == 8 else (15, 14)


def _check_tables(dev, luts, block_comp, n_comps, max_mcus) -> None:
    if luts.device != dev:
        raise ValueError(f"luts on {luts.device}, the scan on {dev}")
    if not 1 <= n_comps <= 4:
        raise ValueError(f"n_comps must be 1..4, got {n_comps}")
    if luts.dtype != torch.int32 or tuple(luts.shape) != (2 * n_comps,
                                                          1 << 16):
        raise TypeError(f"luts must be ({2 * n_comps}, 65536) int32, got "
                        f"{luts.dtype} {tuple(luts.shape)}")
    if not luts.is_contiguous():
        raise ValueError("luts must be contiguous")
    if not 1 <= len(block_comp) <= 16 or any(
            not 0 <= c < n_comps for c in block_comp):
        raise ValueError(f"bad block_comp {block_comp} for {n_comps} "
                         "components")
    if max_mcus < 1:
        raise ValueError(f"max_mcus must be >= 1, got {max_mcus}")


def _check(words, seg_nmcus, luts, block_comp, n_comps, max_mcus) -> None:
    dev = words.device
    if seg_nmcus.device != dev:
        raise ValueError(f"seg_nmcus on {seg_nmcus.device}, words on {dev}")
    if words.dtype != torch.uint32 or words.dim() != 2:
        raise TypeError(f"words must be (S, W) uint32, got {words.dtype} "
                        f"{tuple(words.shape)}")
    s, w = words.shape
    if s < 1 or w < 1:
        raise ValueError(f"words must be non-empty, got {tuple(words.shape)}")
    if seg_nmcus.dtype != torch.int32 or tuple(seg_nmcus.shape) != (s,):
        raise TypeError(f"seg_nmcus must be ({s},) int32, got "
                        f"{seg_nmcus.dtype} {tuple(seg_nmcus.shape)}")
    for name, t in (("words", words), ("seg_nmcus", seg_nmcus)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_tables(dev, luts, block_comp, n_comps, max_mcus)


def _check_bytes(data, seg, n_words) -> None:
    if seg.device != data.device:
        raise ValueError(f"seg on {seg.device}, data on {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError(f"data must be (N,) uint8, got {data.dtype} "
                        f"{tuple(data.shape)}")
    if (seg.dtype != torch.int64 or seg.dim() != 1 or seg.numel() < 3
            or seg.numel() % 2 != 1):
        raise TypeError(f"seg must be (2S+1,) int64 with S >= 1, got "
                        f"{seg.dtype} {tuple(seg.shape)}")
    if n_words < 1:
        raise ValueError(f"n_words must be >= 1, got {n_words}")
    for name, t in (("data", data), ("seg", seg)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if data.device.type == "cuda" and data.data_ptr() % 4:
        raise ValueError("data must start on a 4-byte boundary")


def first_level_torch(luts: torch.Tensor) -> torch.Tensor:
    """Plain version of phase 0: (T, 4096) int16 first-level tables of
    (T, 65536) int32 LUTs; entry i is lut[i << 4] when that code is at most
    12 bits long (it then decides every window i<<4 .. +15), else 0."""
    e = luts[:, ::1 << (16 - L1_BITS)]
    ln = e & 31
    return torch.where((ln > 0) & (ln <= L1_BITS), e, 0).to(torch.int16)


def first_level(luts: torch.Tensor) -> torch.Tensor:
    """Phase 0: the first-level tables of ``luts`` (see
    :func:`first_level_torch`), built by a kernel on a CUDA tensor."""
    if luts.device.type == "cpu":
        return first_level_torch(luts)
    if luts.dtype != torch.int32 or luts.dim() != 2 or luts.shape[1] != 65536:
        raise TypeError(f"luts must be (T, 65536) int32, got {luts.dtype} "
                        f"{tuple(luts.shape)}")
    lib = build()
    l1 = torch.empty((luts.shape[0], 1 << L1_BITS), dtype=torch.int16,
                     device=luts.device)
    with torch.cuda.device(luts.device):
        stream = torch.cuda.current_stream(luts.device).cuda_stream
        rc = lib.jd_build_l1(luts.contiguous().data_ptr(), l1.data_ptr(),
                             luts.shape[0], stream)
    launch_check(rc, "first_level")
    return l1


def scratch_bytes(n_seg: int, n_words: int, chunk_bits: int) -> int:
    """Bytes of the kernel's scratch (the layout jd_decode_segments
    documents): 36 per chunk, 4 per segment, 4 per stat."""
    cps = -(-n_words * 32 // chunk_bits)
    return 36 * n_seg * cps + 4 * n_seg + 4 * len(STATS)


def decode_segments(words: torch.Tensor, seg_nmcus: torch.Tensor,
                    luts: torch.Tensor, *, block_comp: tuple[int, ...],
                    n_comps: int, max_mcus: int, chunk_bits: int | None = None,
                    l1: torch.Tensor | None = None, precision: int = 8,
                    tail: list | None = None):
    """Decode restart segments to natural-order blocks.

    words: (S, W) uint32, segment s's unstuffed bytes as big-endian words
    (zero past its end); seg_nmcus: (S,) int32 MCUs of each segment (at
    most ``max_mcus`` are decoded); luts: (2*n_comps, 65536) int32, table
    2c the DC and 2c+1 the AC LUT of component c (``huffman.build_lut``);
    block_comp: the component of each block of an MCU; precision: the
    frame's, 8 or 12 (its size categories, :func:`size_limits`).  On the
    card:
    ``chunk_bits`` (default :data:`CHUNK_BITS`, a multiple of 32) is the
    size of the kernel's chunks, and ``l1`` the first-level tables of
    ``luts`` (:func:`first_level`; built here when not given, cached by
    :func:`device_tables`).

    Returns ((S, max_mcus*bpm, 64) int32 blocks, (S,) int32 error flags).
    Rows past ``seg_nmcus[s]*bpm`` are 0; the rows of a flagged segment are
    unspecified.  On CUDA tensors this launches the kernel or raises; on
    CPU tensors it runs :func:`decode_segments_torch`.  Given a list
    ``tail``, a launch appends to it a (2S + len(STATS),) int32 device
    tensor: the chunks of each segment, the :data:`STATS`, then the error
    flags (the returned ``err`` is a view of its last S), so that one copy
    brings back both (:func:`launch_stats` reads it).
    """
    _check(words, seg_nmcus, luts, block_comp, n_comps, max_mcus)
    size_limits(precision)
    dev = words.device
    if dev.type == "cpu":
        return decode_segments_torch(words, seg_nmcus, luts,
                                     block_comp=block_comp, n_comps=n_comps,
                                     max_mcus=max_mcus, precision=precision)
    s, w = words.shape
    return _launch("jd_decode_segments",
                   (words.data_ptr(), seg_nmcus.data_ptr()), s, w, luts,
                   block_comp, max_mcus, chunk_bits, l1, precision, tail)


def decode_scan_bytes(data: torch.Tensor, seg: torch.Tensor,
                      luts: torch.Tensor, *, n_words: int,
                      block_comp: tuple[int, ...], n_comps: int,
                      max_mcus: int, l1: torch.Tensor | None = None,
                      precision: int = 8, tail: list | None = None):
    """:func:`decode_segments` with each segment read in place from the
    scan's bytes, nothing packed on the host.

    data: (N,) uint8, the unstuffed scan bytes (on the card starting on a
    4-byte boundary); seg: (2S+1,) int64, the S+1 byte offsets of the
    segments in ``data`` (segment s is ``data[off[s]:off[s+1]]``), then
    their S MCU counts (``scan_prep.segment_table``); n_words: the words a
    segment is read and cut into chunks over, at least the longest
    segment's ceil(bytes / 4) (``scan_prep.row_words`` gives
    ``prepare_scan``'s row width, so that both forms cut the same chunks).
    Word w of segment s is the big-endian bytes ``off[s] + 4w`` .. ``+ 3``,
    each byte at or past ``off[s+1]`` zero: row s of the words
    ``prepare_scan`` packs (:func:`segment_words_torch`).  The rest, the
    returns and ``tail`` as in :func:`decode_segments` (chunks of
    :data:`CHUNK_BITS`).  On CPU tensors it runs
    :func:`decode_segments_torch` on :func:`segment_words_torch`.
    """
    _check_bytes(data, seg, n_words)
    dev = data.device
    _check_tables(dev, luts, block_comp, n_comps, max_mcus)
    size_limits(precision)
    s = (seg.numel() - 1) // 2
    if dev.type == "cpu":
        return decode_segments_torch(
            segment_words_torch(data, seg[:s + 1], n_words),
            seg[s + 1:].to(torch.int32), luts, block_comp=block_comp,
            n_comps=n_comps, max_mcus=max_mcus, precision=precision)
    return _launch("jd_decode_scan_bytes",
                   (data.data_ptr(), data.numel(), seg.data_ptr()), s,
                   n_words, luts, block_comp, max_mcus, None, l1, precision,
                   tail)


def _launch(entry: str, head: tuple, s: int, w: int, luts, block_comp,
            max_mcus, chunk_bits, l1, precision, tail):
    """One launch of K2 through ``entry``, whose own arguments ``head``
    precede the ones both entries share; counted in
    ``decode_segments.launches``."""
    dev = luts.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    chunk_bits = CHUNK_BITS if chunk_bits is None else chunk_bits
    if chunk_bits < 32 or chunk_bits % 32:
        raise ValueError(f"chunk_bits must be a multiple of 32, got "
                         f"{chunk_bits}")
    if l1 is None:
        l1 = first_level(luts)
    elif (l1.device != dev or l1.dtype != torch.int16
          or tuple(l1.shape) != (luts.shape[0], 1 << L1_BITS)
          or not l1.is_contiguous()):
        raise TypeError(f"l1 must be ({luts.shape[0]}, {1 << L1_BITS}) "
                        f"int16 on {dev}")
    lib = build()
    bpm = len(block_comp)
    rows = max_mcus * bpm
    out = torch.zeros((s, rows, 64), dtype=torch.int32, device=dev)
    # The scratch ends in the chunks of each segment and the statistics;
    # the error flags follow them in the same buffer.
    n_scratch = (scratch_bytes(s, w, chunk_bits) + 3) // 4
    buf = torch.empty((n_scratch + s,), dtype=torch.int32, device=dev)
    scratch, err = buf[:n_scratch], buf[n_scratch:]
    comp_code = sum(c << (4 * k) for k, c in enumerate(block_comp))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            *head, luts.data_ptr(), l1.data_ptr(), out.data_ptr(),
            err.data_ptr(), scratch.data_ptr(), s, w, rows, luts.shape[0],
            bpm, comp_code, chunk_bits, GLOBAL_ROUNDS, precision, stream)
    launch_check(rc, "decode_segments")
    with _count_lock:
        decode_segments.launches += 1
    if tail is not None:
        tail.append(buf[-(2 * s + len(STATS)):])
    return out, err


#: Launches of the CUDA kernel, in either form, since the count was last
#: set to 0.
decode_segments.launches = 0


def segment_words_torch(data: torch.Tensor, off: torch.Tensor,
                        n_words: int) -> torch.Tensor:
    """(S, n_words) uint32: the words :func:`decode_scan_bytes`' kernel
    reads for each segment, by its rule.  Word w of segment s is the
    big-endian bytes ``off[s] + 4w`` .. ``+ 3`` of ``data``, each byte at or
    past ``off[s+1]`` zero; the offsets are clamped to ``[0, N]`` first, as
    the kernel clamps them.  ``off``: (S+1,) int64."""
    n = data.numel()
    end = off[1:].to(torch.int64).clamp(0, n)
    begin = torch.minimum(off[:-1].to(torch.int64).clamp(min=0), end)
    idx = begin[:, None] + torch.arange(4 * n_words, device=data.device)
    src = torch.cat([data.to(torch.int64),
                     torch.zeros(1, dtype=torch.int64, device=data.device)])
    b = torch.where(idx < end[:, None], src[idx.clamp(max=n)], 0)
    b = b.view(len(begin), n_words, 4)
    w = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return w.to(torch.uint32)


def decode_segments_torch(words: torch.Tensor, seg_nmcus: torch.Tensor,
                          luts: torch.Tensor, *, block_comp: tuple[int, ...],
                          n_comps: int, max_mcus: int, precision: int = 8):
    """Plain PyTorch twin of :func:`decode_segments`, the same contract.

    Segments are lanes in lockstep: each step decodes one symbol (a DC
    difference or one AC run/size pair) of every unfinished lane, with
    ``torch`` gathers into the words and the LUTs, until every lane has
    decoded its MCUs or met an error.  Arithmetic is int64 (the stream
    window is built from two words and masked), so no shift exceeds its
    width.  A lane stops at its first error, as the kernel's does.
    """
    dev = words.device
    s, w = words.shape
    bpm = len(block_comp)
    rows = max_mcus * bpm
    max_dc, max_ac = size_limits(precision)
    w64 = words.to(torch.int64)
    lut = luts.to(torch.int64).reshape(-1)
    comp = torch.tensor(block_comp, dtype=torch.int64, device=dev)
    zz = torch.from_numpy(ZIGZAG.astype(np.int64)).to(dev)
    lane = torch.arange(s, device=dev)
    dump = s * rows * 64
    out = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    nm = seg_nmcus.to(torch.int64).clamp(max=max_mcus)

    def word(idx):
        got = w64.gather(1, idx.clamp(0, w - 1).view(-1, 1)).view(-1)
        return torch.where(idx < w, got, 0)

    def peek16(pos):
        wi, off = pos >> 5, pos & 31
        window = (word(wi) << 32) | word(wi + 1)
        return (window >> (48 - off)) & 0xFFFF

    pos = torch.zeros(s, dtype=torch.int64, device=dev)
    m = torch.zeros_like(pos)            # MCU of the current block
    k = torch.zeros_like(pos)            # block within the MCU
    i = torch.zeros_like(pos)            # coefficient index; 0 = DC next
    pred = torch.zeros((s, n_comps), dtype=torch.int64, device=dev)
    err = torch.zeros(s, dtype=torch.bool, device=dev)
    done = nm <= 0

    def step():
        nonlocal pos, m, k, i, err, done
        act = ~done & ~err
        ci = comp[k]
        is_dc = i == 0
        e = lut[(2 * ci + (~is_dc).to(torch.int64)) * 65536 + peek16(pos)]
        sym = e >> 5
        eob = ~is_dc & (sym == 0)
        run = torch.where(sym == 0xF0, 16, sym >> 4)
        csize = sym & 0x0F
        i_new = i + run
        bad = torch.where(
            is_dc, (e == 0) | (sym > max_dc),
            (e == 0) | (~eob & ((i_new > 64) | ((csize > 0) & (i_new >= 64))
                                | (csize > max_ac))))
        ok = act & ~bad
        err = err | (act & bad)
        # Value bits: the DC size category, or the AC size (none at EOB).
        size = torch.where(ok, torch.where(is_dc, sym,
                                           torch.where(eob, 0, csize)), 0)
        pos1 = pos + (e & 31)
        raw = peek16(pos1) >> (16 - size)            # size <= 15 here
        half = torch.where(size > 0, 1 << (size - 1).clamp(min=0), 0)
        val = torch.where(raw < half, raw - ((1 << size) - 1), raw)
        pos = torch.where(ok, pos1 + size, pos)

        dc_ok = ok & is_dc
        old = pred.gather(1, ci.view(-1, 1)).view(-1)
        new_pred = torch.where(dc_ok, old + val, old)
        pred.scatter_(1, ci.view(-1, 1), new_pred.view(-1, 1))
        ac_write = ok & ~is_dc & ~eob & (csize > 0)
        base = (lane * rows + m * bpm + k) * 64
        col = torch.where(is_dc, 0, zz[i_new.clamp(0, 63)])
        dst = torch.where(dc_ok | ac_write, base + col, dump)
        out.index_put_((dst,), torch.where(dc_ok, new_pred, val)
                       .to(torch.int32))

        i = torch.where(ok, torch.where(
            is_dc, 1, torch.where(eob, 64, torch.where(
                csize > 0, i_new + 1, i_new))), i)
        end = ok & (i >= 64)
        i = torch.where(end, 0, i)
        k = torch.where(end, k + 1, k)
        wrap = k >= bpm
        k = torch.where(wrap, 0, k)
        m = torch.where(wrap, m + 1, m)
        done = done | (m >= nm)

    while bool((~done & ~err).any()):
        for _ in range(_TWIN_CHECK_EVERY):
            step()
    return (out[:dump].view(s, rows, 64),
            err.to(torch.int32))


def _pack(pos, k, i):
    """Decoder state (bit position, block in MCU, coefficient index) as one
    int64, the kernel's 64-bit state word."""
    return (pos << 10) | (k << 6) | i


def _unpack(st):
    return st >> 10, (st >> 6) & 15, st & 63


def seg_chunks(words: torch.Tensor, chunk_bits: int) -> torch.Tensor:
    """(S,) int64 chunks of each segment: its bits up to its last non-zero
    word, cut into ``chunk_bits`` pieces (at least one).  Zero words past
    that are still decoded, by the segment's last chunk."""
    s, w = words.shape
    nz = words.to(torch.int64) != 0
    idx = torch.arange(1, w + 1, device=words.device)
    n_words = torch.where(nz, idx, 0).amax(1).clamp(min=1)
    return (n_words * 32 + chunk_bits - 1) // chunk_bits


class _Lanes:
    """Plain-PyTorch lanes of the chunked decoder and of the emit-lane
    decoder (``ops/entropy_emit_cuda.py``): per-lane row of ``words`` and
    state, and one decode step (one symbol) for every lane at once."""

    def __init__(self, words, luts, block_comp, seg, precision=8,
                 table_base=None):
        dev = words.device
        self.max_dc, self.max_ac = size_limits(precision)
        self.w = words.shape[1]
        self.words = words.to(torch.int64).reshape(-1)
        self.lut = luts.to(torch.int64).reshape(-1)
        self.comp = torch.tensor(block_comp, dtype=torch.int64, device=dev)
        self.bpm = len(block_comp)
        self.row = seg * self.w
        # Each lane's first table in a stack of table sets (0: one set).
        self.table_base = 0 if table_base is None else table_base

    def _word(self, idx):
        got = self.words[self.row + idx.clamp(0, self.w - 1)]
        return torch.where(idx < self.w, got, 0)

    def _peek16(self, pos):
        wi, off = pos >> 5, pos & 31
        window = (self._word(wi) << 32) | self._word(wi + 1)
        return (window >> (48 - off)) & 0xFFFF

    def step(self, pos, k, i):
        """Decode one symbol at (pos, k, i) in every lane.  Returns the
        component, whether it was a DC symbol, the error flag, the value,
        the natural index an AC value goes to (-1: none) and the state
        after it (meaningless where the flag is set)."""
        ci = self.comp[k]
        is_dc = i == 0
        e = self.lut[(self.table_base + 2 * ci + (~is_dc).to(torch.int64))
                     * 65536 + self._peek16(pos)]
        sym = e >> 5
        eob = ~is_dc & (sym == 0)
        run = torch.where(sym == 0xF0, 16, sym >> 4)
        csize = sym & 0x0F
        i_new = i + run
        bad = torch.where(
            is_dc, (e == 0) | (sym > self.max_dc),
            (e == 0) | (~eob & ((i_new > 64) | ((csize > 0) & (i_new >= 64))
                                | (csize > self.max_ac))))
        size = torch.where(bad, 0, torch.where(
            is_dc, sym, torch.where(eob, 0, csize)))
        pos1 = pos + (e & 31)
        raw = self._peek16(pos1) >> (16 - size)
        half = torch.where(size > 0, 1 << (size - 1).clamp(min=0), 0)
        val = torch.where(raw < half, raw - ((1 << size) - 1), raw)
        ac_at = torch.where(~is_dc & ~eob & (csize > 0),
                            _ZZ.to(pos.device)[i_new.clamp(0, 63)], -1)
        i2 = torch.where(is_dc, 1, torch.where(eob, 64, torch.where(
            csize > 0, i_new + 1, i_new)))
        blk_end = i2 >= 64
        k2 = torch.where(blk_end, torch.where(k + 1 >= self.bpm, 0, k + 1), k)
        return (ci, is_dc, bad, val, ac_at, pos1 + size,
                k2, torch.where(blk_end, 0, i2))


_ZZ = torch.from_numpy(ZIGZAG.astype(np.int64))


def _sync_pass(lanes: _Lanes, entry, end, todo, n_comps):
    """Phase 1 for the lanes in ``todo``: decode speculatively from
    ``entry`` to the first symbol boundary at or past ``end``.  An error
    does not stop a lane: it re-aligns to the next byte boundary as an MCU
    start (entropy_spec's error-restart).  Returns the exit states, the DC
    symbols decoded and the per-component DC-difference sums (int64)."""
    pos, k, i = _unpack(entry)
    cnt = torch.zeros_like(pos)
    dcs = torch.zeros((len(pos), n_comps), dtype=torch.int64,
                      device=pos.device)
    act = todo & (pos < end)
    while bool(act.any()):
        ci, is_dc, bad, val, _, pos2, k2, i2 = lanes.step(pos, k, i)
        ok = act & ~bad
        redo = act & bad
        pos = torch.where(ok, pos2, torch.where(redo, (pos | 7) + 1, pos))
        k = torch.where(ok, k2, torch.where(redo, 0, k))
        i = torch.where(ok, i2, torch.where(redo, 0, i))
        dc_ok = ok & is_dc
        cnt += dc_ok
        dcs.scatter_add_(1, ci.view(-1, 1),
                         torch.where(dc_ok, val, 0).view(-1, 1))
        act = act & (pos < end)
    return _pack(pos, k, i), cnt, dcs


def decode_segments_chunked_torch(words: torch.Tensor,
                                  seg_nmcus: torch.Tensor,
                                  luts: torch.Tensor, *,
                                  block_comp: tuple[int, ...], n_comps: int,
                                  max_mcus: int, chunk_bits: int,
                                  lanes_per_cta: int | None = None,
                                  global_rounds: int | None = None,
                                  stats: dict | None = None,
                                  precision: int = 8):
    """Plain PyTorch model of the chunked kernel, the same contract as
    :func:`decode_segments`; chunks are lanes in lockstep.

    It runs the kernel's phases in the kernel's order, so that the CPU
    tests reach the synchronisation logic:

    1. every segment's bits, up to its last non-zero word, are cut into
       chunks of ``chunk_bits``; chunk ``c`` of segment ``s`` is lane
       ``s * cps + c`` (``cps`` chunks per row of ``words``), and lanes
       form CTAs of ``lanes_per_cta``;
    2. sync: every chunk but a segment's last decodes from an assumed
       entry (its first bit, block 0 of an MCU, coefficient 0; chunk 0's is
       the true one) to its exit, the first symbol boundary at or past its
       end; inside a CTA each chunk then takes its predecessor's exit as
       its entry and decodes again, until no entry changes; then
       ``global_rounds`` rounds do the same for each CTA's first chunk;
       then a seal walks each segment's CTA boundaries in order and
       re-decodes, one chunk after the other, wherever an entry still
       differs from its predecessor's exit.  The entries are then a fixed
       point, and chunk 0's is true, so every entry is the state the
       sequential decode has at that point;
    3. offsets: exclusive prefix sums, per segment, of the DC symbols
       (blocks begun) and the DC-difference sums per component;
    4. write: every chunk decodes from its entry to its exit (the last one
       until the segment's MCUs are done), storing DC (carry-in plus its
       running sum) and the non-zero AC terms; an error before the
       segment's last block flags it, as in the sequential decode.

    ``stats``, when given, receives the iteration counts of each step.
    """
    lanes_per_cta = lanes_per_cta or SYNC_LANES
    global_rounds = GLOBAL_ROUNDS if global_rounds is None else global_rounds
    if chunk_bits < 32 or chunk_bits % 32:
        raise ValueError(f"chunk_bits must be a multiple of 32, got "
                         f"{chunk_bits}")
    dev = words.device
    s, w = words.shape
    bpm = len(block_comp)
    rows = max_mcus * bpm
    cps = -(-w * 32 // chunk_bits)
    g = torch.arange(s * cps, device=dev)
    seg, c = g // cps, g % cps
    n = seg_chunks(words, chunk_bits)[seg]
    lanes = _Lanes(words, luts, block_comp, seg, precision)
    end = (c + 1) * chunk_bits
    spec = c < n - 1                      # phase-1 lanes
    has_prev = spec & (c > 0)
    head = g % lanes_per_cta == 0         # first lane of a CTA

    entry = _pack(c * chunk_bits, torch.zeros_like(c), torch.zeros_like(c))
    exit_, cnt, dcs = _sync_pass(lanes, entry, end, spec, n_comps)
    info = {"chunks": int((c < n).sum()), "round0_iterations": 1,
            "global_round_ctas": 0, "seal_redecodes": 0,
            "sync_decodes": int(spec.sum())}

    def take(mask):
        nonlocal entry, exit_, cnt, dcs
        prev = torch.roll(exit_, 1)
        changed = mask & (prev != entry)
        if bool(changed.any()):
            entry = torch.where(changed, prev, entry)
            x, n_dc, sums = _sync_pass(lanes, entry, end, changed, n_comps)
            exit_ = torch.where(changed, x, exit_)
            cnt = torch.where(changed, n_dc, cnt)
            dcs = torch.where(changed.view(-1, 1), sums, dcs)
            info["sync_decodes"] += int(changed.sum())
        return changed

    def settle_ctas():
        iters = 0
        while bool(take(has_prev & ~head).any()):
            iters += 1
        return iters

    info["round0_iterations"] += settle_ctas()
    for _ in range(global_rounds):
        info["global_round_ctas"] += int(take(has_prev & head).sum())
        settle_ctas()
    # Seal: per segment, serially from its first inconsistent chunk on.
    while True:
        prev = torch.roll(exit_, 1)
        bad = has_prev & (prev != entry)
        if not bool(bad.any()):
            break
        first = torch.full((s,), s * cps, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, seg[bad], g[bad], "amin")
        info["seal_redecodes"] += int((first < s * cps).sum())
        take(torch.zeros_like(bad).index_fill_(
            0, first[first < s * cps], True))

    # Offsets: exclusive per-segment prefix sums of the phase-1 counts.
    cnt = torch.where(spec, cnt, 0).view(s, cps)
    dcs = torch.where(spec.view(-1, 1), dcs, 0).view(s, cps, n_comps)
    base = (cnt.cumsum(1) - cnt).view(-1)
    carry = (dcs.cumsum(1) - dcs).view(-1, n_comps)

    # Write.
    out = torch.zeros(s * rows * 64 + 1, dtype=torch.int32, device=dev)
    dump = s * rows * 64
    err = torch.zeros(s, dtype=torch.int64, device=dev)
    limit = seg_nmcus.to(torch.int64).clamp(max=max_mcus)[seg] * bpm
    last = c == n - 1
    pos, k, i = _unpack(torch.where(c > 0, torch.roll(exit_, 1), 0))
    nb = base.clone()
    pred = carry.clone()

    def live(pos, i, nb):
        cur = torch.where(i == 0, nb, nb - 1)
        return (c < n) & (cur >= 0) & (cur < limit) & (last | (pos < end))

    act = live(pos, i, nb)
    while bool(act.any()):
        ci, is_dc, bad, val, ac_at, pos2, k2, i2 = lanes.step(pos, k, i)
        cur = torch.where(is_dc, nb, nb - 1)
        err.index_put_((seg,), (act & bad).to(torch.int64), accumulate=True)
        ok = act & ~bad
        dc_ok = ok & is_dc
        old = pred.gather(1, ci.view(-1, 1)).view(-1)
        new_pred = torch.where(dc_ok, old + val, old)
        pred.scatter_(1, ci.view(-1, 1), new_pred.view(-1, 1))
        at = torch.where(dc_ok, 0, ac_at)
        dst = torch.where(ok & (at >= 0), (seg * rows + cur) * 64 + at, dump)
        out.index_put_((dst,), torch.where(dc_ok, new_pred, val)
                       .to(torch.int32))
        nb = nb + dc_ok
        pos = torch.where(ok, pos2, pos)
        k = torch.where(ok, k2, k)
        i = torch.where(ok, i2, i)
        act = ok & live(pos, i, nb)
    if stats is not None:
        stats.update(info)
    return out[:dump].view(s, rows, 64), (err > 0).to(torch.int32)


def device_tables(hdr: FrameHeader, scan: ScanHeader,
                  dev: torch.device):
    """The scan's (2*n_comps, 65536) int32 LUTs on ``dev``, interleaved
    DC/AC per component as the kernel reads them, and on a CUDA device
    their first-level tables (phase 0; None on the CPU).

    Cached per device, keyed by the bytes of the scan's DC and AC tables
    (the :data:`TABLE_CACHE_SIZE` most recent sets), so ``decode()`` uploads
    and builds them once per table set."""
    dev = torch.device(dev)
    key = (str(dev),) + table_key(hdr, scan)
    with _tables_lock:
        hit = _tables.get(key)
        if hit is not None:
            _tables.move_to_end(key)
            return hit
    profiling.count("tables.build")
    dc, ac = scan_prep.luts_for_scan(hdr, scan)
    luts = np.empty((2 * len(hdr.components), 1 << 16), np.int32)
    luts[0::2] = dc
    luts[1::2] = ac
    t = torch.from_numpy(luts).to(dev)
    hit = (t, first_level(t) if dev.type == "cuda" else None)
    if dev.type == "cuda":
        # Callers on other streams (the batch path's host threads, the
        # decoder's own stream) read the cached set: finish building it
        # before publishing it.
        torch.cuda.current_stream(dev).synchronize()
    with _tables_lock:
        _tables[key] = hit
        while len(_tables) > TABLE_CACHE_SIZE:
            _tables.popitem(last=False)
    return hit


def table_key(hdr: FrameHeader, scan: ScanHeader) -> tuple:
    """The bytes of the scan's DC and AC tables, component by component:
    equal keys give equal LUT sets (``device_tables``' cache key)."""
    return tuple(b for c in hdr.components
                 for spec in (scan.dc_specs[c.td], scan.ac_specs[c.ta])
                 for b in (spec.counts.tobytes(), spec.symbols.tobytes()))


def device_table_stack(sets: list, dev: torch.device):
    """The LUTs of several table sets, one (hdr, scan) each, stacked on
    ``dev``: ((n_sets * 2*n_comps, 65536) int32, and on a CUDA device their
    first-level tables, else None).  Set k's tables start at row k *
    2*n_comps, the ``lut_base`` of ``entropy_emit_cuda.decode_lanes``.
    Each set comes from :func:`device_tables`' cache; one set is returned
    as it is, without a copy."""
    parts = [device_tables(hdr, scan, dev) for hdr, scan in sets]
    if len(parts) == 1:
        return parts[0]
    luts = torch.cat([p[0] for p in parts])
    l1 = (torch.cat([p[1] for p in parts])
          if torch.device(dev).type == "cuda" else None)
    return luts, l1


def clear_table_cache() -> None:
    """Forget every cached table set (a cold ``decode()``)."""
    with _tables_lock:
        _tables.clear()


#: The recorder's counters of one launch (:func:`count_stats`): its chunks
#: and three of its :data:`STATS`.
COUNTERS = ("k2.chunks", "k2.sync_decodes", "k2.seal_redecodes",
            "k2.global_round_ctas")


def launch_stats(tail: torch.Tensor) -> dict:
    """One launch's :data:`STATS` by name, and under ``chunks`` the chunks
    of all its segments, from its ``tail`` (see :func:`decode_segments`)."""
    vals = tail.tolist()
    s = (len(vals) - len(STATS)) // 2
    stats = dict(zip(STATS, vals[s:s + len(STATS)]))
    stats["chunks"] = sum(vals[:s])
    return stats


def count_stats(tail: torch.Tensor) -> None:
    """Record one launch's :data:`COUNTERS` from its ``tail`` on the host."""
    stats = launch_stats(tail)
    for name in COUNTERS:
        profiling.count(name, stats[name.removeprefix("k2.")])


def decode_scan_baseline(hdr: FrameHeader, scan: ScanHeader,
                         device) -> torch.Tensor:
    """Decode an 8- or 12-bit interleaved baseline scan on ``device``.

    Returns (n_mcus*bpm, 64) int32 scan-order natural-layout coefficients on
    ``device`` (equal to ``python_ref.decode_scan_baseline``).  On the card
    K2 reads the parser's scan bytes in place (:func:`decode_scan_bytes`:
    two copies up, the bytes and one array of offsets and MCU counts, and
    the counter ``entropy.scan_in_place``); on the CPU the twin decodes
    ``prepare_scan``'s rows.  Only the (S,) error flags cross to the host;
    any flag raises :class:`JPEGError` naming the failed segments.  While
    the recorder is on, the same copy brings back K2's statistics with
    them, which a span of their own (``entropy.stats``) counts as the
    :data:`COUNTERS`."""
    if hdr.precision not in (8, 12):
        raise JPEGError(f"device entropy decodes 8- and 12-bit frames, got "
                        f"{hdr.precision}-bit")
    dev = torch.device(device)
    in_place = dev.type == "cuda"
    with profiling.span("entropy.prepare_scan"):
        if in_place:
            seg, n_words, block_comp, max_mcus, lay = \
                scan_prep.segment_table(hdr, scan)
        else:
            words, nm, block_comp, max_mcus, lay = scan_prep.prepare_scan(
                hdr, scan)
    n_seg = len(scan.seg_offsets) - 1
    with profiling.span("entropy.enqueue"):
        luts, l1 = device_tables(hdr, scan, dev)
        # K2's statistics are gathered only for the recorder.
        tail = [] if profiling.recording() else None
        kw = dict(block_comp=block_comp, n_comps=len(hdr.components),
                  max_mcus=max_mcus, l1=l1, precision=hdr.precision,
                  tail=tail)
        if in_place:
            profiling.count("entropy.scan_in_place")
            data = np.asarray(scan.data, np.uint8)
            out, err = decode_scan_bytes(
                torch.from_numpy(data).to(dev), torch.from_numpy(seg).to(dev),
                luts, n_words=n_words, **kw)
        else:
            out, err = decode_segments(
                torch.from_numpy(words), torch.from_numpy(nm), luts, **kw)
    # The host waits here for K2 to finish.
    with profiling.span("entropy.flags"):
        host = (tail[0] if tail else err).cpu()
    if tail:
        with profiling.span("entropy.stats"):
            count_stats(host)
    bad = np.flatnonzero(host[-n_seg:].numpy())
    if bad.size:
        raise JPEGError(f"device entropy decode failed in segments "
                        f"{bad[:8].tolist()} ({bad.size} of {n_seg})")
    return out.view(-1, 64)[: lay.n_mcus * len(block_comp)]
