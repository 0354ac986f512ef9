"""Device Huffman decode of restart segments: the CUDA kernel and its twin.

Counterpart of ``jpeg_decoder_tpu/ops/entropy_pallas.py``.  Restart segments
are independent (DC predictors reset and the stream is byte-aligned at each
RSTn), so every segment is one decoder lane: the host packs each segment's
unstuffed bytes into a row of big-endian uint32 words (``ops/scan_prep``),
and the device decodes all rows at once into scan-order 8x8 blocks in
natural coefficient order.

* :func:`decode_segments` launches ``csrc/entropy.cu`` (one thread per
  segment; built with nvcc for sm_90a at first use into
  ``.cache/torch/kernels/``, bound with ctypes) on CUDA tensors and counts
  its launches in ``decode_segments.launches``.  A failed build or launch
  raises.  On CPU tensors it runs :func:`decode_segments_torch`; that is the
  only way the plain version is reached.
* :func:`decode_segments_torch` is the plain PyTorch twin: the same decode
  with the segments as lanes in lockstep, one symbol per lane per step.
* :func:`decode_scan_baseline` is the ``entropy="pallas"`` backend of
  ``models/decoder.py``: blocks stay on the device, only the per-segment
  error flags cross to the host.

The Pallas kernel writes zig-zag rows and its wrapper de-permutes them; here
both versions store each coefficient at its natural index directly.  Unlike
the JAX wrapper, nothing falls back: a DRI=0 stream is one lane (exact, and
slow), and a kernel that does not build or launch raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .._build import CudaLib, launch_check
from ..types import FrameHeader, JPEGError, ScanHeader, ZIGZAG
from . import scan_prep

LIB = CudaLib("entropy.cu", "jd_entropy", {"jd_decode_segments": [
    ctypes.c_void_p, ctypes.c_void_p,   # words, seg_nmcus
    ctypes.c_void_p,                    # luts
    ctypes.c_void_p, ctypes.c_void_p,   # out, err
    ctypes.c_int64, ctypes.c_int64,     # n_seg, n_words
    ctypes.c_int64, ctypes.c_int,       # rows, n_tables
    ctypes.c_int, ctypes.c_uint64,      # bpm, comp_code
    ctypes.c_void_p,                    # stream
]})

#: Lockstep steps of the twin between two checks for unfinished lanes.
_TWIN_CHECK_EVERY = 16

_count_lock = threading.Lock()


def build():
    """Compile ``csrc/entropy.cu`` (once per source and flag set) and load
    it."""
    return LIB.load()


def _check(words, seg_nmcus, luts, block_comp, n_comps, max_mcus) -> None:
    dev = words.device
    for name, t in (("seg_nmcus", seg_nmcus), ("luts", luts)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, words on {dev}")
    if words.dtype != torch.uint32 or words.dim() != 2:
        raise TypeError(f"words must be (S, W) uint32, got {words.dtype} "
                        f"{tuple(words.shape)}")
    s, w = words.shape
    if s < 1 or w < 1:
        raise ValueError(f"words must be non-empty, got {tuple(words.shape)}")
    if seg_nmcus.dtype != torch.int32 or tuple(seg_nmcus.shape) != (s,):
        raise TypeError(f"seg_nmcus must be ({s},) int32, got "
                        f"{seg_nmcus.dtype} {tuple(seg_nmcus.shape)}")
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
    if max_mcus < 1:
        raise ValueError(f"max_mcus must be >= 1, got {max_mcus}")
    for name, t in (("words", words), ("seg_nmcus", seg_nmcus),
                    ("luts", luts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def decode_segments(words: torch.Tensor, seg_nmcus: torch.Tensor,
                    luts: torch.Tensor, *, block_comp: tuple[int, ...],
                    n_comps: int, max_mcus: int):
    """Decode restart segments to natural-order blocks.

    words: (S, W) uint32, segment s's unstuffed bytes as big-endian words
    (zero past its end); seg_nmcus: (S,) int32 MCUs of each segment (at
    most ``max_mcus`` are decoded); luts: (2*n_comps, 65536) int32, table
    2c the DC and 2c+1 the AC LUT of component c (``huffman.build_lut``);
    block_comp: the component of each block of an MCU.

    Returns ((S, max_mcus*bpm, 64) int32 blocks, (S,) int32 error flags).
    Rows past ``seg_nmcus[s]*bpm`` are 0; the rows of a flagged segment are
    unspecified.  On CUDA tensors this launches the kernel or raises; on CPU
    tensors it runs :func:`decode_segments_torch`.
    """
    _check(words, seg_nmcus, luts, block_comp, n_comps, max_mcus)
    dev = words.device
    if dev.type == "cpu":
        return decode_segments_torch(words, seg_nmcus, luts,
                                     block_comp=block_comp, n_comps=n_comps,
                                     max_mcus=max_mcus)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = build()
    s, w = words.shape
    bpm = len(block_comp)
    rows = max_mcus * bpm
    out = torch.zeros((s, rows, 64), dtype=torch.int32, device=dev)
    err = torch.empty((s,), dtype=torch.int32, device=dev)
    comp_code = sum(c << (4 * k) for k, c in enumerate(block_comp))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jd_decode_segments(
            words.data_ptr(), seg_nmcus.data_ptr(), luts.data_ptr(),
            out.data_ptr(), err.data_ptr(), s, w, rows,
            luts.shape[0], bpm, comp_code, stream)
    launch_check(rc, "decode_segments")
    with _count_lock:
        decode_segments.launches += 1
    return out, err


#: Launches of the CUDA kernel since the count was last set to 0.
decode_segments.launches = 0


def decode_segments_torch(words: torch.Tensor, seg_nmcus: torch.Tensor,
                          luts: torch.Tensor, *, block_comp: tuple[int, ...],
                          n_comps: int, max_mcus: int):
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
            is_dc, (e == 0) | (sym > 11),
            (e == 0) | (~eob & ((i_new > 64) | ((csize > 0) & (i_new >= 64))
                                | (csize > 10))))
        ok = act & ~bad
        err = err | (act & bad)
        # Value bits: the DC size category, or the AC size (none at EOB).
        size = torch.where(ok, torch.where(is_dc, sym,
                                           torch.where(eob, 0, csize)), 0)
        pos1 = pos + (e & 31)
        raw = peek16(pos1) >> (16 - size)            # size <= 11 here
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


def _device_luts(hdr: FrameHeader, scan: ScanHeader,
                 dev: torch.device) -> torch.Tensor:
    """(2*n_comps, 65536) int32 LUTs of this scan on ``dev``, interleaved
    DC/AC per component as the kernel reads them."""
    dc, ac = scan_prep.luts_for_scan(hdr, scan)
    luts = np.empty((2 * len(hdr.components), 1 << 16), np.int32)
    luts[0::2] = dc
    luts[1::2] = ac
    return torch.from_numpy(luts).to(dev)


def decode_scan_baseline(hdr: FrameHeader, scan: ScanHeader,
                         device) -> torch.Tensor:
    """Decode an 8-bit interleaved baseline scan on ``device``.

    Returns (n_mcus*bpm, 64) int32 scan-order natural-layout coefficients on
    ``device`` (equal to ``python_ref.decode_scan_baseline``).  Only the
    (S,) error flags cross to the host; any flag raises :class:`JPEGError`
    naming the failed segments."""
    if hdr.precision != 8:
        raise JPEGError(f"device entropy decodes 8-bit frames only, got "
                        f"{hdr.precision}-bit")
    dev = torch.device(device)
    words, nm, block_comp, max_mcus, lay = scan_prep.prepare_scan(hdr, scan)
    out, err = decode_segments(
        torch.from_numpy(words).to(dev), torch.from_numpy(nm).to(dev),
        _device_luts(hdr, scan, dev), block_comp=block_comp,
        n_comps=len(hdr.components), max_mcus=max_mcus)
    bad = np.flatnonzero(err.cpu().numpy())
    if bad.size:
        raise JPEGError(f"device entropy decode failed in segments "
                        f"{bad[:8].tolist()} ({bad.size} of {len(nm)})")
    return out.view(-1, 64)[: lay.n_mcus * len(block_comp)]
