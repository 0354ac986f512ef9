"""ctypes wrapper for the native C++ entropy decoder (host side).

The port builds its own copy of the native decoder's source,
``csrc/jpeg_entropy.cpp`` (byte-identical to the JAX package's
``entropy/native_src/jpeg_entropy.cpp``, which the port never reads), into
``.cache/torch/native/`` at first use.  Bound: the unstuffer and the
nibble-wire emitter (the batched serving path), and the scan decoders
:func:`decode_scan_baseline` and
:func:`decode_scan_resilient` (the ``native``/``auto`` backends of
``models/decoder.py``, with the signatures of the JAX package's).  A failed
build raises :class:`BuildFailure`; nothing falls back silently.

The C calls release the GIL, so a Python thread pool gives image-level
parallelism on top of the in-call restart-segment parallelism.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._build import CSRC, shared_lib
from ..huffman import build_ac_lut32, build_lut
from ..layout import scan_layout
from ..types import FrameHeader, JPEGError, ScanHeader

_NCPU = os.cpu_count() or 1
_SRC = os.path.join(CSRC, "jpeg_entropy.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_ABI = 22

_lib = None
_lib_lock = threading.Lock()
_lut16_cache: dict[tuple, np.ndarray] = {}
_lut32_cache: dict[tuple, np.ndarray] = {}


class BuildFailure(RuntimeError):
    """The native entropy library could not be built or loaded."""


def _load():
    """Build (first use, into ``.cache/torch/native/``, keyed by a hash of
    the source and flags) and load the library; raises BuildFailure."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path, _ = shared_lib("g++", GXX_FLAGS, _SRC, "native",
                             "jpeg_entropy", BuildFailure)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise BuildFailure(f"cannot load {path}: {e}") from e
        lib.jd_abi_version.restype = ctypes.c_int32
        if lib.jd_abi_version() != _ABI:
            raise BuildFailure(
                f"jpeg_entropy ABI {lib.jd_abi_version()} != {_ABI}")
        lib.jd_unstuff.restype = ctypes.c_int64
        lib.jd_unstuff.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,    # data, len
            ctypes.c_void_p, ctypes.c_void_p,   # out, out_len
            ctypes.c_void_p, ctypes.c_int64,    # seg_offsets, seg_cap
            ctypes.c_void_p,                    # n_segs
        ]
        lib.jd_decode_scan_nibble.restype = ctypes.c_int64
        lib.jd_decode_scan_nibble.argtypes = [
            ctypes.c_void_p,                    # data
            ctypes.c_void_p, ctypes.c_int32,    # seg_offsets, n_segments
            ctypes.c_int32,                     # n_comps
            ctypes.c_void_p, ctypes.c_void_p,   # h, v
            ctypes.c_void_p, ctypes.c_void_p,   # dc_luts, ac_luts
            ctypes.c_int64, ctypes.c_int64,     # n_mcus, restart_interval
            ctypes.c_void_p,                    # dc_out
            ctypes.c_void_p, ctypes.c_int64,    # entry_out, entry_cap
            ctypes.c_void_p,                    # entry_count
            ctypes.c_void_p, ctypes.c_int64,    # ov_out, ov_cap
            ctypes.c_void_p,                    # ov_count
            ctypes.c_void_p, ctypes.c_void_p,   # esc_idx, esc_val
            ctypes.c_int64, ctypes.c_void_p,    # esc_cap, esc_count
            ctypes.c_int32,                     # n_threads
        ]
        lib.jd_decode_scan.restype = ctypes.c_int64
        lib.jd_decode_scan.argtypes = [
            ctypes.c_void_p,                    # data
            ctypes.c_void_p, ctypes.c_int32,    # seg_offsets, n_segments
            ctypes.c_int32,                     # n_comps
            ctypes.c_void_p, ctypes.c_void_p,   # h, v
            ctypes.c_void_p, ctypes.c_void_p,   # dc_luts, ac_luts
            ctypes.c_int64, ctypes.c_int64,     # n_mcus, restart_interval
            ctypes.c_void_p, ctypes.c_int32,    # out, n_threads
            ctypes.c_int32,                     # precision
        ]
        lib.jd_decode_scan_resilient.restype = ctypes.c_int64
        lib.jd_decode_scan_resilient.argtypes = [
            ctypes.c_void_p,                    # data
            ctypes.c_void_p, ctypes.c_int32,    # seg_offsets, n_segments
            ctypes.c_int32,                     # n_comps
            ctypes.c_void_p, ctypes.c_void_p,   # h, v
            ctypes.c_void_p, ctypes.c_void_p,   # dc_luts, ac_luts
            ctypes.c_int64, ctypes.c_int64,     # n_mcus, restart_interval
            ctypes.c_void_p, ctypes.c_void_p,   # out, seg_err
            ctypes.c_int32, ctypes.c_int32,     # n_threads, precision
        ]
        _lib = lib
    return _lib


def _lut16(spec) -> np.ndarray:
    """int16 LUT entry (sym<<5)|len: max (255<<5)|31 = 8191 < 2^15.

    Layout (ABI 21+): 65536 entries + a 4096-entry FIRST-LEVEL table
    (entry i resolves codes of <= 12 bits, 0 = fall back to the full
    probe)."""
    key = (spec.counts.tobytes(), spec.symbols.tobytes())
    lut = _lut16_cache.get(key)
    if lut is None:
        big = build_lut(spec).astype(np.int16)
        cand = big[::16].copy()                 # big[i << 4]
        lens = cand & 31
        small = np.where((lens > 0) & (lens <= 12), cand, 0)
        lut = np.ascontiguousarray(
            np.concatenate([big, small.astype(np.int16)]))
        _lut16_cache[key] = lut
    return lut


def _lut32ac(spec) -> np.ndarray:
    """Combined-value int32 AC LUT (huffman.build_ac_lut32), cached,
    with the same appended 4096-entry first level as :func:`_lut16`
    (fast entries need code+value <= 12 bits; slow entries need only the
    code to fit — the symbol is then already resolved)."""
    key = (spec.counts.tobytes(), spec.symbols.tobytes())
    lut = _lut32_cache.get(key)
    if lut is None:
        big = np.ascontiguousarray(build_ac_lut32(spec))
        cand = big[::16].copy()
        bits = cand & 31                        # total (fast) / len (slow)
        ok = (cand != 0) & (bits <= 12)
        small = np.where(ok, cand, 0)
        lut = np.ascontiguousarray(
            np.concatenate([big, small.astype(np.int32)]))
        _lut32_cache[key] = lut
    return lut


def available() -> bool:
    """True when the library builds and loads here (the ``auto`` backend's
    test)."""
    try:
        _load()
    except BuildFailure:
        return False
    return True


def _padded(scan) -> np.ndarray:
    """Entropy bytes with the 256-byte zero tail the decoders require.

    Uses the parser-provided pre-padded buffer only when it still aliases
    ``scan.data`` (callers may replace ``data`` without updating
    ``data_padded``)."""
    d = scan.data
    dp = getattr(scan, "data_padded", None)
    if (dp is not None and len(dp) == len(d) + 256
            and dp.__array_interface__["data"][0]
            == d.__array_interface__["data"][0]):
        return dp
    return np.concatenate([d, np.zeros(256, np.uint8)])


class _ScanCall:
    """Native-call setup for a full-frame 8-bit scan: padded data,
    validated segment table, sampling arrays, and LUT pointer arrays (the
    LUT ndarrays are kept alive on the instance for the ctypes call)."""

    def __init__(self, hdr: FrameHeader, scan: ScanHeader,
                 allow12: bool = False):
        # jd_decode_scan supports precision-12 frames (T.81 B.2.2 size
        # categories 15/14); the wire-format emitter stays 8-bit.
        if hdr.precision != 8 and not (allow12 and hdr.precision == 12):
            raise JPEGError(
                "this native entry point decodes 8-bit frames only")
        self.lay = scan_layout(hdr)
        comps = hdr.components
        self.data = _padded(scan)
        self.seg_offsets = np.ascontiguousarray(scan.seg_offsets,
                                                dtype=np.int64)
        self.n_segments = len(self.seg_offsets) - 1
        self.ri = scan.restart_interval
        expected = -(-self.lay.n_mcus // self.ri) if self.ri else 1
        if self.n_segments != expected:
            raise JPEGError(
                f"restart-segment count {self.n_segments} does not match "
                f"DRI {self.ri}")
        self.h = np.array([c.h for c in comps], np.int32)
        self.v = np.array([c.v for c in comps], np.int32)
        self.dc_luts = [_lut16(scan.dc_specs[c.td]) for c in comps]
        self.ac_luts = [_lut32ac(scan.ac_specs[c.ta]) for c in comps]
        PtrArray = ctypes.c_void_p * len(comps)
        self.dc_ptrs = PtrArray(*[a.ctypes.data for a in self.dc_luts])
        self.ac_ptrs = PtrArray(*[a.ctypes.data for a in self.ac_luts])
        self.n_comps = len(comps)

    def threads(self, n_threads):
        if n_threads is not None:
            return n_threads
        return min(_NCPU, max(1, self.n_segments))

    def head_args(self):
        """The common leading argument tuple of the jd_decode_scan_*
        C functions."""
        return (self.data.ctypes.data, self.seg_offsets.ctypes.data,
                self.n_segments, self.n_comps,
                self.h.ctypes.data, self.v.ctypes.data,
                self.dc_ptrs, self.ac_ptrs,
                self.lay.n_mcus, self.ri)


def decode_scan_baseline(hdr: FrameHeader, scan: ScanHeader,
                         n_threads: int | None = None) -> np.ndarray:
    """Decode a full baseline interleaved scan (native backend).

    Returns (total_blocks, 64) int32 scan-order natural-layout coefficients,
    identical to :func:`.python_ref.decode_scan_baseline`."""
    lib = _load()
    st = _ScanCall(hdr, scan, allow12=True)
    out = np.zeros((st.lay.total_blocks, 64), dtype=np.int32)
    rc = lib.jd_decode_scan(*st.head_args(), out.ctypes.data,
                            st.threads(n_threads), hdr.precision)
    if rc != 0:
        raise JPEGError(
            f"native entropy decode failed: segment {rc >> 8}, "
            f"error code {rc & 0xFF}")
    return out


def decode_scan_resilient(hdr: FrameHeader, scan: ScanHeader,
                          n_threads: int | None = None) -> np.ndarray:
    """Best-effort decode of a scan whose restart-segment count disagrees
    with DRI or whose segments are corrupt: the native mirror of
    :func:`.python_ref.decode_scan_resilient`, with identical output."""
    lib = _load()
    if hdr.precision not in (8, 12):
        raise JPEGError(f"unsupported precision {hdr.precision}")
    lay = scan_layout(hdr)
    comps = hdr.components
    # Big zero tail: garbage decoding near a segment end may overrun by up
    # to one MCU (~bpm * 209 bytes) before the per-MCU bound check fires;
    # the Python reader clamps reads to zeros, so the pad makes the native
    # reader see the same zero bits.
    data = np.concatenate([scan.data, np.zeros(16384, np.uint8)])
    seg_offsets = np.ascontiguousarray(scan.seg_offsets, dtype=np.int64)
    n_segments = len(seg_offsets) - 1
    h = np.array([c.h for c in comps], np.int32)
    v = np.array([c.v for c in comps], np.int32)
    dc_luts = [_lut16(scan.dc_specs[c.td]) for c in comps]
    ac_luts = [_lut32ac(scan.ac_specs[c.ta]) for c in comps]
    PtrArray = ctypes.c_void_p * len(comps)
    dc_ptrs = PtrArray(*[a.ctypes.data for a in dc_luts])
    ac_ptrs = PtrArray(*[a.ctypes.data for a in ac_luts])
    out = np.zeros((lay.total_blocks, 64), dtype=np.int32)
    seg_err = np.zeros(max(1, n_segments), np.uint8)
    if n_threads is None:
        n_threads = min(_NCPU, max(1, n_segments))
    rc = lib.jd_decode_scan_resilient(
        data.ctypes.data, seg_offsets.ctypes.data, n_segments,
        len(comps), h.ctypes.data, v.ctypes.data, dc_ptrs, ac_ptrs,
        lay.n_mcus, scan.restart_interval, out.ctypes.data,
        seg_err.ctypes.data, n_threads, hdr.precision)
    if rc != 0:
        raise JPEGError(f"native resilient decode failed (code {rc})")
    return out


def unstuff(data: np.ndarray, start: int):
    """Native entropy-region unstuffer; same contract as
    io.parser.unstuff_entropy_numpy (clean bytes, clean-stream segment
    offset table incl. 0 and total length, absolute end offset of the
    terminating marker FF)."""
    lib = _load()
    region = np.ascontiguousarray(data[start:])
    n = len(region)
    if n == 0:
        raise JPEGError("entropy data: no terminating marker found")
    out = np.empty(n + 256, np.uint8)
    out_len = np.zeros(1, np.int64)
    seg_cap = n // 2 + 2
    segs = np.empty(seg_cap, np.int64)
    n_segs = np.zeros(1, np.int64)
    end = lib.jd_unstuff(region.ctypes.data, n,
                         out.ctypes.data, out_len.ctypes.data,
                         segs.ctypes.data, seg_cap, n_segs.ctypes.data)
    if end == -1:
        raise JPEGError("entropy data: no terminating marker found")
    if end < 0:
        raise JPEGError(f"unstuffer failed (code {end})")
    k = int(out_len[0])
    out[k:k + 256] = 0  # native decoder padding contract, paid once here
    clean = out[:k]
    seg_offsets = np.unique(np.concatenate(
        [[0], segs[:int(n_segs[0])], [len(clean)]]).astype(np.int64))
    return clean, seg_offsets, start + int(end)


def decode_scan_nibble(hdr: FrameHeader, scan: ScanHeader,
                       n_threads: int | None = None):
    """Decode straight to the nibble wire format (int16 DC plane +
    (gap<<4)|val-code uint8 entry stream + int8 overflow stream + escape
    list); see models.batch.nibbleize_ac for the encoding.

    Returns (dc16 (N,), entries (K,) uint8, ov (O,) int8,
    esc_idx (E,) int32, esc_val (E,) int16)."""
    lib = _load()
    st = _ScanCall(hdr, scan)
    n_blocks = st.lay.total_blocks
    dc16 = np.empty((n_blocks,), np.int16)
    n_threads = st.threads(n_threads)

    entry_cap = max(4096, n_blocks * 12)
    ov_cap = max(1024, n_blocks * 3)
    esc_cap = max(4096, n_blocks // 2)
    while True:
        entries = np.empty((entry_cap,), np.uint8)
        ov = np.empty((ov_cap,), np.int8)
        esc_idx = np.empty((esc_cap,), np.int32)
        esc_val = np.empty((esc_cap,), np.int16)
        counts = np.zeros((3,), np.int64)
        rc = lib.jd_decode_scan_nibble(
            *st.head_args(),
            dc16.ctypes.data,
            entries.ctypes.data, entry_cap, counts[0:].ctypes.data,
            ov.ctypes.data, ov_cap, counts[1:].ctypes.data,
            esc_idx.ctypes.data, esc_val.ctypes.data,
            esc_cap, counts[2:].ctypes.data, n_threads,
        )
        if rc == -3:  # capacity exceeded
            entry_cap *= 4
            ov_cap *= 4
            esc_cap *= 4
            continue
        if rc != 0:
            raise JPEGError(
                f"native nibble entropy decode failed: segment {rc >> 8}, "
                f"error code {rc & 0xFF}")
        k, o, e = (int(x) for x in counts)
        return (dc16, entries[:k].copy(), ov[:o].copy(),
                esc_idx[:e].copy(), esc_val[:e].copy())
