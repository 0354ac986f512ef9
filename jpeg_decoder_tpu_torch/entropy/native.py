"""ctypes wrapper for the native C++ entropy decoder (host side).

The port builds its own copy of the native decoder's source,
``csrc/jpeg_entropy.cpp`` (byte-identical to the JAX package's
``entropy/native_src/jpeg_entropy.cpp``, which the port never reads), into
``.cache/torch/native/`` at first use.  Bound, with the signatures of the
JAX package's wrappers:

* the unstuffer :func:`unstuff`;
* the full-frame scan decoders :func:`decode_scan_baseline`,
  :func:`decode_scan_resilient` and :func:`decode_scan_speculative` (the
  ``native``/``auto``/``speculative`` backends of ``models/decoder.py``)
  and the component-subset decoder :func:`decode_scan_subset` (multi-scan
  and non-interleaved frames);
* the emit-lane plan of the ``hybrid`` backend, :func:`emit_prep`;
* the wire emitters of the batched path: :func:`decode_scan_nibble`,
  :func:`decode_scan_packed`, :func:`decode_scan_sparse` and
  :func:`decode_scan_slots`;
* the skeleton walks of the device progressive lanes
  (``ops/entropy_prog.py``), :func:`prog_skeleton_dc` and
  :func:`prog_skeleton_ac`;
* the progressive Huffman decoder :func:`decode_progressive` and the
  arithmetic decoders :func:`decode_scan_arith` (SOF9) and
  :func:`decode_progressive_arith` (SOF10).

Every wrapper checks the sizes, dtypes and layout of the buffers it hands
to C before the call.  A failed build raises :class:`BuildFailure`; nothing
falls back silently.

The C calls release the GIL, so a Python thread pool gives image-level
parallelism on top of the in-call restart-segment parallelism.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .._build import CSRC, shared_lib
from ..huffman import build_ac_lut32, build_lut
from ..layout import comp_dims_unpadded, scan_layout
from ..types import FrameHeader, JPEGError, ScanHeader

_NCPU = os.cpu_count() or 1
_SRC = os.path.join(CSRC, "jpeg_entropy.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_ABI = 22

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
#: Leading arguments of every jd_decode_scan_* entry: data, seg_offsets,
#: n_segments, n_comps, h, v, dc_luts, ac_luts, n_mcus, restart_interval.
_HEAD = [_P, _P, _I32, _I32, _P, _P, _P, _P, _I64, _I64]
_SIGNATURES = {
    "jd_unstuff": [_P, _I64, _P, _P, _P, _I64, _P],
    "jd_decode_scan": _HEAD + [_P, _I32, _I32],       # out, threads, prec
    "jd_decode_scan_resilient": _HEAD + [_P, _P, _I32, _I32],
    "jd_decode_scan_nibble": _HEAD + [
        _P,                     # dc_out
        _P, _I64, _P,           # entry_out, entry_cap, entry_count
        _P, _I64, _P,           # ov_out, ov_cap, ov_count
        _P, _P, _I64, _P,       # esc_idx, esc_val, esc_cap, esc_count
        _I32],                  # n_threads
    "jd_decode_scan_packed": _HEAD + [
        _P, _P,                 # dc_out, ac_out
        _P, _P, _I64, _P,       # esc_idx, esc_val, esc_cap, esc_count
        _I32],
    "jd_decode_scan_sparse": _HEAD + [
        _P,                     # dc_out
        _P, _P, _I64, _P,       # gap_out, val_out, sparse_cap, count
        _P, _P, _I64, _P,       # esc_idx, esc_val, esc_cap, esc_count
        _I32],
    "jd_decode_scan_slots": _HEAD + [
        _P,                     # dc_out
        _P, _P, _I32,           # pos_out, val_out, cap
        _P, _P, _I64, _P,       # ov_idx, ov_val, ov_cap, ov_count
        _P, _P, _I64, _P,       # esc_idx, esc_val, esc_cap, esc_count
        _I32],
    "jd_decode_scan_speculative": [
        _P, _I64,               # data, data_len
        _I32, _P, _P,           # n_comps, h, v
        _P, _P, _I64,           # dc_luts, ac_luts, n_mcus
        _P, _I32, _I32],        # out, n_threads, n_chunks
    "jd_emit_prep": [
        _P, _I64,               # data, data_len
        _P, _I32, _I32,         # seg_offsets, n_segments, n_comps
        _P, _P, _P, _P,         # h, v, dc_luts, ac_luts
        _I64, _I64,             # n_mcus, restart_interval
        _I32, _I32, _I32, _I32,  # precision, max_chunks, cap_factor, steps
        _P, _P, _P,             # scratch bits, syms, pairs
        _P, _P, _P,             # out_m_lo, out_nm, out_starts
        _P, _P, _P, _I32],      # out_T_sym, out_T_pair, out_L, n_threads
    "jd_prog_skeleton_dc": [
        _P, _I64, _I64,         # data, start_byte, data_len
        _I32, _P, _P,           # n_scan_comps, comp_h, comp_v
        _P, _I32,               # dc_luts, interleaved
        _I64, _I64,             # n_mcus, stride
        _P, _P],                # out_bits, out_preds
    "jd_prog_skeleton_ac": [
        _P, _I64, _I64,         # data, start_byte, data_len
        _I32, _I32, _I32,       # first, ss, se
        _P, _P,                 # ac_lut, nzmap
        _I64, _I64,             # n_blocks, stride
        _P, _P, _P],            # out_bits, out_eobrun, out_syms
    "jd_decode_scan_arith": [
        _P, _P, _I32, _I32,     # data, seg_offsets, n_segments, n_comps
        _P, _P,                 # h, v
        _P, _P, _P, _P, _P,     # dc_tid, ac_tid, dc_l, dc_u, ac_kx
        _I64, _I64, _P, _I32],  # n_mcus, restart_interval, out, threads
    "jd_prog_dc_scan": [
        _P, _P, _I32,           # data, seg_offsets, n_segments
        _I32, _I32, _I32, _I32,  # first, al, interleaved, n_scan_comps
        _P, _P, _P, _P, _P,     # comp_h, comp_v, planes, cols, dc_luts
        _I64, _I64, _I64, _I64,  # mcus_x, mcus_y, sc_rows, sc_cols
        _I64, _I32],            # restart_interval, n_threads
    "jd_prog_ac_scan": [
        _P, _P, _I32,           # data, seg_offsets, n_segments
        _I32, _I32, _I32, _I32,  # first, ss, se, al
        _P, _I32, _P,           # plane, plane_cols, ac_lut
        _I64, _I64, _I64, _I32],  # rows, cols, restart_interval, threads
    "jd_prog_dc_scan_arith": [
        _P, _P, _I32,           # data, seg_offsets, n_segments
        _I32, _I32, _I32, _I32,  # first, al, interleaved, n_scan_comps
        _P, _P, _P, _P,         # comp_h, comp_v, planes, plane_cols
        _P, _P, _P,             # dc_tid, dc_l, dc_u
        _I64, _I64, _I64, _I64,  # mcus_x, mcus_y, sc_rows, sc_cols
        _I64, _I32],            # restart_interval, n_threads
    "jd_prog_ac_scan_arith": [
        _P, _P, _I32,           # data, seg_offsets, n_segments
        _I32, _I32, _I32, _I32,  # ss, se, ah, al
        _P, _I32, _I32, _I32,   # plane, plane_cols, ac_tid, kx
        _I64, _I64, _I64, _I32],  # rows, cols, restart_interval, threads
}

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
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = argtypes
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


def _segment_table(scan) -> np.ndarray:
    """The scan's segment table as int64, after checking that its offsets
    ascend inside the entropy bytes."""
    seg = np.ascontiguousarray(scan.seg_offsets, dtype=np.int64)
    if len(seg) < 2 or seg[0] < 0 or seg[-1] > len(scan.data) or (
            np.diff(seg) < 0).any():
        raise JPEGError(f"bad segment table of {len(seg) - 1} segments "
                        f"over {len(scan.data)} bytes")
    return seg


def _segments(scan, n_units: int) -> tuple[np.ndarray, int, int]:
    """:func:`_segment_table`, its segment count and DRI, after checking
    that the count matches DRI over ``n_units`` MCUs."""
    seg = _segment_table(scan)
    n = len(seg) - 1
    ri = scan.restart_interval
    expected = -(-n_units // ri) if ri else 1
    if n != expected:
        raise JPEGError(f"restart-segment count {n} does not match DRI {ri}")
    return seg, n, ri


def _ptrs(arrays) -> ctypes.Array:
    """A C array of the data pointers of ``arrays`` (kept alive by the
    caller)."""
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def _check_plane(plane: np.ndarray, rows: int, cols: int) -> None:
    """A plane the progressive decoders write: C-contiguous int32, at
    least (rows, cols) blocks of 64."""
    if (plane.dtype != np.int32 or plane.ndim != 3 or plane.shape[2] != 64
            or not plane.flags.c_contiguous or plane.shape[0] < rows
            or plane.shape[1] < cols):
        raise ValueError(f"plane must be C-contiguous int32 of at least "
                         f"({rows}, {cols}, 64), got {plane.dtype} "
                         f"{plane.shape}")


def _check_band(scan) -> None:
    """Spectral band and point transform of a progressive scan (T.81
    G.1.1.1.1): DC scans are Ss = Se = 0, AC scans 1 <= Ss <= Se <= 63 over
    one component; Al <= 13."""
    if not 0 <= scan.al <= 13:
        raise JPEGError(f"progressive: Al {scan.al} out of range")
    if scan.ss == 0:
        if scan.se != 0:
            raise JPEGError("progressive: DC scan must have Se=0")
    elif not scan.ss <= scan.se <= 63:
        raise JPEGError(f"progressive: bad band {scan.ss}..{scan.se}")
    elif len(scan.comp_indices) != 1:
        raise JPEGError("progressive: AC scans must be single-component")


def _table_id(tid: int) -> int:
    """An arithmetic conditioning table id (T.81 B.2.4.3: 0..3)."""
    if not 0 <= tid <= 3:
        raise JPEGError(f"arithmetic table id {tid} out of range")
    return tid


def _arith_cond(scan) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dc_l, dc_u, ac_kx), four entries each: the scan's DAC
    conditioning per table id, T.81 defaults 0/1/5 elsewhere."""
    dc_l = np.zeros(4, np.int32)
    dc_u = np.ones(4, np.int32)
    ac_kx = np.full(4, 5, np.int32)
    for tid, (lp, up) in (getattr(scan, "dc_cond", None) or {}).items():
        dc_l[_table_id(tid)], dc_u[tid] = lp, up
    for tid, kx in (getattr(scan, "ac_cond", None) or {}).items():
        ac_kx[_table_id(tid)] = kx
    return dc_l, dc_u, ac_kx


class _ScanCall:
    """Native-call setup for a full-frame 8-bit scan: padded data,
    validated segment table, sampling arrays, and LUT pointer arrays (the
    LUT ndarrays are kept alive on the instance for the ctypes call)."""

    def __init__(self, hdr: FrameHeader, scan: ScanHeader,
                 allow12: bool = False):
        # jd_decode_scan supports precision-12 frames (T.81 B.2.2 size
        # categories 15/14); the wire-format emitters stay 8-bit.
        if hdr.precision != 8 and not (allow12 and hdr.precision == 12):
            raise JPEGError(
                "this native entry point decodes 8-bit frames only")
        self.lay = scan_layout(hdr)
        comps = hdr.components
        self.data = _padded(scan)
        self.seg_offsets, self.n_segments, self.ri = _segments(
            scan, self.lay.n_mcus)
        self.h = np.array([c.h for c in comps], np.int32)
        self.v = np.array([c.v for c in comps], np.int32)
        self.dc_luts = [_lut16(scan.dc_specs[c.td]) for c in comps]
        self.ac_luts = [_lut32ac(scan.ac_specs[c.ta]) for c in comps]
        self.dc_ptrs = _ptrs(self.dc_luts)
        self.ac_ptrs = _ptrs(self.ac_luts)
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


def _failed(what: str, rc: int) -> JPEGError:
    return JPEGError(f"native {what} decode failed: segment {rc >> 8}, "
                     f"error code {rc & 0xFF}")


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
        raise _failed("entropy", rc)
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
    seg_offsets = _segment_table(scan)
    n_segments = len(seg_offsets) - 1
    h = np.array([c.h for c in comps], np.int32)
    v = np.array([c.v for c in comps], np.int32)
    dc_luts = [_lut16(scan.dc_specs[c.td]) for c in comps]
    ac_luts = [_lut32ac(scan.ac_specs[c.ta]) for c in comps]
    out = np.zeros((lay.total_blocks, 64), dtype=np.int32)
    seg_err = np.zeros(max(1, n_segments), np.uint8)
    if n_threads is None:
        n_threads = min(_NCPU, max(1, n_segments))
    rc = lib.jd_decode_scan_resilient(
        data.ctypes.data, seg_offsets.ctypes.data, n_segments,
        len(comps), h.ctypes.data, v.ctypes.data, _ptrs(dc_luts),
        _ptrs(ac_luts), lay.n_mcus, scan.restart_interval, out.ctypes.data,
        seg_err.ctypes.data, n_threads, hdr.precision)
    if rc != 0:
        raise JPEGError(f"native resilient decode failed (code {rc})")
    return out


def decode_scan_speculative(hdr: FrameHeader, scan: ScanHeader,
                            n_threads: int | None = None,
                            n_chunks: int | None = None) -> np.ndarray:
    """Speculative self-synchronizing parallel decode of a DRI=0 stream
    (see jpeg_entropy.cpp for the algorithm).  Output identical to
    :func:`decode_scan_baseline`; raises JPEGError on malformed streams."""
    lib = _load()
    if hdr.precision != 8:
        raise JPEGError("speculative decode takes 8-bit frames only")
    lay = scan_layout(hdr)
    comps = hdr.components
    if len(scan.seg_offsets) != 2:
        raise JPEGError("speculative decode requires a single-segment scan")
    data = _padded(scan)
    h = np.array([c.h for c in comps], np.int32)
    v = np.array([c.v for c in comps], np.int32)
    dc_luts = [_lut16(scan.dc_specs[c.td]) for c in comps]
    ac_luts = [_lut32ac(scan.ac_specs[c.ta]) for c in comps]
    out = np.zeros((lay.total_blocks, 64), dtype=np.int32)
    if n_threads is None:
        n_threads = _NCPU
    if n_chunks is None:
        n_chunks = max(1, n_threads * 4)
    if n_threads < 1 or n_chunks < 1:
        raise ValueError("n_threads and n_chunks must be >= 1")
    rc = lib.jd_decode_scan_speculative(
        data.ctypes.data, len(scan.data),
        len(comps), h.ctypes.data, v.ctypes.data,
        _ptrs(dc_luts), _ptrs(ac_luts), lay.n_mcus,
        out.ctypes.data, n_threads, n_chunks)
    if rc != 0:
        raise JPEGError(f"speculative entropy decode failed (code {rc})")
    return out


def emit_prep(hdr: FrameHeader, scan: ScanHeader, *, max_chunks: int = 512,
              cap_factor: int = 4, target_steps: int = 1300,
              n_threads: int | None = None):
    """Lane plan of the emit-lane decode (jd_emit_prep): per-segment
    skeleton walks (threaded in C++), lane boundaries that balance the
    paired step counts with every segment start a lane start, and exact
    per-lane trip maxima.

    Returns (m_lo (L,) int64 first MCU of each lane, nm (L,) int32 MCUs,
    starts (L,) int32 start bits in ``scan.data``, T_sym, T_pair: the most
    Huffman symbols and paired steps of any lane).  Raises JPEGError on a
    malformed stream, a scan of 2^31 bits or more (the C function stores
    start bits as int32) and a lane count past the output capacity (the C
    function takes none; the capacity is the JAX wrapper's)."""
    lib = _load()
    if hdr.precision not in (8, 12):
        raise JPEGError(f"unsupported precision {hdr.precision}")
    if len(scan.data) * 8 >= 1 << 31:
        raise JPEGError(f"emit prep takes scans under 2^31 bits, got "
                        f"{len(scan.data)} bytes")
    if max_chunks < 1 or cap_factor < 1:
        raise ValueError("max_chunks and cap_factor must be >= 1")
    lay = scan_layout(hdr)
    n_mcus = lay.n_mcus
    comps = hdr.components
    data = _padded(scan)
    seg_offsets, n_segments, ri = _segments(scan, n_mcus)
    h = np.array([c.h for c in comps], np.int32)
    v = np.array([c.v for c in comps], np.int32)
    dc_luts = [_lut16(scan.dc_specs[c.td]) for c in comps]
    ac_luts = [_lut32ac(scan.ac_specs[c.ta]) for c in comps]
    scratch = (np.zeros(n_mcus, np.int64), np.zeros(n_mcus, np.int32),
               np.zeros(n_mcus, np.int32))
    cap = max_chunks + 2 * n_segments + 8
    m_lo = np.zeros(cap, np.int64)
    nm = np.zeros(cap, np.int32)
    starts = np.zeros(cap, np.int32)
    t_sym, t_pair = ctypes.c_int64(0), ctypes.c_int64(0)
    n_l = ctypes.c_int32(0)
    rc = lib.jd_emit_prep(
        data.ctypes.data, len(scan.data), seg_offsets.ctypes.data,
        n_segments, len(comps), h.ctypes.data, v.ctypes.data,
        _ptrs(dc_luts), _ptrs(ac_luts), n_mcus, ri, hdr.precision,
        max_chunks, cap_factor, target_steps,
        *(a.ctypes.data for a in scratch),
        m_lo.ctypes.data, nm.ctypes.data, starts.ctypes.data,
        ctypes.byref(t_sym), ctypes.byref(t_pair), ctypes.byref(n_l),
        n_threads if n_threads is not None else min(_NCPU, 4))
    if rc != 0:
        raise JPEGError(f"emit prep failed (code {rc})")
    n = int(n_l.value)
    if not 0 < n <= cap:
        raise JPEGError(f"emit prep returned {n} lanes, capacity {cap}")
    return m_lo[:n], nm[:n], starts[:n], int(t_sym.value), int(t_pair.value)


def _skeleton_scan(hdr: FrameHeader, scan: ScanHeader) -> int:
    """Checks shared by the skeleton walks: a DRI-0 scan of under 2^31
    bits.  Returns its units (MCUs of an interleaved scan, else the
    component's unpadded blocks)."""
    if len(scan.seg_offsets) != 2:
        raise JPEGError("progressive skeleton requires a DRI=0 scan")
    if len(scan.data) * 8 >= 1 << 31:
        raise JPEGError(f"progressive skeleton takes scans under 2^31 bits, "
                        f"got {len(scan.data)} bytes")
    if len(scan.comp_indices) > 1:
        return hdr.mcus_x * hdr.mcus_y
    r, c = comp_dims_unpadded(hdr, scan.comp_indices[0])
    return r * c


def _check_lane_bits(bits: np.ndarray, scan: ScanHeader, what: str) -> None:
    """The walk's lane start bits must ascend inside the scan."""
    if (bits < 0).any() or (np.diff(bits) < 0).any() or \
            (bits > len(scan.data) * 8).any():
        raise JPEGError(f"progressive {what} skeleton returned lane bits "
                        "out of order or outside the scan")


def prog_skeleton_dc(hdr: FrameHeader, scan: ScanHeader, stride: int):
    """Skeleton of a DRI-0 DC first scan (jd_prog_skeleton_dc): a walk that
    decodes every difference and stores nothing, recording at every
    ``stride``-th MCU the lane state.  Returns (bits (L,) int64 absolute
    start bits, preds (L, n_scan_comps) int32 predictors entering each
    lane), L = ceil(n_units / stride).

    JAX's guards (DRI 0, ``rc != 0`` -> JPEGError), and the lane arrays'
    guards of the emit-lane prep: outputs sized from ``stride``, scans of
    2^31 bits or more refused, lane bits checked to ascend inside the
    scan."""
    lib = _load()
    n_mcus = _skeleton_scan(hdr, scan)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    nsc = len(scan.comp_indices)
    h = np.array([hdr.components[ci].h for ci in scan.comp_indices],
                 np.int32)
    v = np.array([hdr.components[ci].v for ci in scan.comp_indices],
                 np.int32)
    dc_luts = [_lut16(scan.dc_specs[scan.dc_table_ids[k]])
               for k in range(nsc)]
    n_lanes = -(-n_mcus // stride)
    bits = np.zeros(n_lanes, np.int64)
    preds = np.zeros((n_lanes, nsc), np.int32)
    data = _padded(scan)   # alive across the call: it may be a new copy
    rc = lib.jd_prog_skeleton_dc(
        data.ctypes.data, int(scan.seg_offsets[0]), len(scan.data),
        nsc, h.ctypes.data, v.ctypes.data, _ptrs(dc_luts), int(nsc > 1),
        n_mcus, stride, bits.ctypes.data, preds.ctypes.data)
    if rc != 0:
        raise JPEGError(f"progressive DC skeleton failed (code {rc})")
    _check_lane_bits(bits, scan, "DC")
    return bits, preds


def prog_skeleton_ac(hdr: FrameHeader, scan: ScanHeader, stride: int,
                     nzmap: np.ndarray, want_syms: bool = False):
    """Skeleton of a DRI-0 AC scan, first or refinement
    (jd_prog_skeleton_ac).  Returns (bits (L,) int64, eobrun (L,) int32)
    lane states every ``stride`` blocks and UPDATES ``nzmap``, the
    component's (n_blocks,) uint64 band bitmap kept across its scans (bit k
    set: zigzag coefficient k nonzero), which decides refinement bit
    consumption.  With ``want_syms`` also a per-block (n_blocks,) int32
    count: Huffman symbols (first scans) or the JAX emission refine
    kernel's events (refinements), the lane-balancing weights.  The guards
    of :func:`prog_skeleton_dc`, and ``nzmap``'s shape and dtype."""
    lib = _load()
    n_blocks = _skeleton_scan(hdr, scan)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if nzmap.shape != (n_blocks,) or nzmap.dtype != np.uint64 or \
            not nzmap.flags.c_contiguous:
        raise ValueError("nzmap must be contiguous (n_blocks,) uint64")
    lut = _lut16(scan.ac_specs[scan.ac_table_ids[0]])
    n_lanes = -(-n_blocks // stride)
    bits = np.zeros(n_lanes, np.int64)
    eob = np.zeros(n_lanes, np.int32)
    syms = np.zeros(n_blocks, np.int32) if want_syms else None
    data = _padded(scan)   # alive across the call: it may be a new copy
    rc = lib.jd_prog_skeleton_ac(
        data.ctypes.data, int(scan.seg_offsets[0]), len(scan.data),
        int(scan.ah == 0), scan.ss, scan.se, lut.ctypes.data,
        nzmap.ctypes.data, n_blocks, stride, bits.ctypes.data,
        eob.ctypes.data, syms.ctypes.data if want_syms else None)
    if rc != 0:
        raise JPEGError(f"progressive AC skeleton failed (code {rc})")
    _check_lane_bits(bits, scan, "AC")
    return (bits, eob, syms) if want_syms else (bits, eob)


def decode_scan_subset(hdr: FrameHeader, scan: ScanHeader,
                       n_threads: int | None = None) -> np.ndarray:
    """Sequential subset scan (T.81 A.2): interleaved over the frame MCU
    grid when the scan lists several components, non-interleaved over the
    single component's unpadded block grid otherwise.

    Returns (n_units * blocks_per_unit, 64) int32 scan-order blocks, in
    the traversal order of python_ref.decode_scan_sequential_into."""
    lib = _load()
    if hdr.precision not in (8, 12):
        raise JPEGError(f"unsupported precision {hdr.precision}")
    sc = scan.comp_indices
    if not sc or any(not 0 <= ci < len(hdr.components) for ci in sc):
        raise JPEGError(f"scan components {sc} out of range")
    comps = [hdr.components[ci] for ci in sc]
    data = _padded(scan)
    if len(sc) == 1:
        # Non-interleaved: one data unit per MCU over the unpadded grid.
        rows_u, cols_u = comp_dims_unpadded(hdr, sc[0])
        n_units = rows_u * cols_u
        h = np.array([1], np.int32)
        v = np.array([1], np.int32)
        bpu = 1
    else:
        n_units = hdr.mcus_x * hdr.mcus_y
        h = np.array([c.h for c in comps], np.int32)
        v = np.array([c.v for c in comps], np.int32)
        bpu = int(sum(c.h * c.v for c in comps))
    seg_offsets, n_segments, ri = _segments(scan, n_units)
    dc_luts = [_lut16(scan.dc_specs[scan.dc_table_ids[k]])
               for k in range(len(sc))]
    ac_luts = [_lut32ac(scan.ac_specs[scan.ac_table_ids[k]])
               for k in range(len(sc))]
    out = np.zeros((n_units * bpu, 64), dtype=np.int32)
    if n_threads is None:
        n_threads = min(_NCPU, max(1, n_segments))
    rc = lib.jd_decode_scan(
        data.ctypes.data, seg_offsets.ctypes.data, n_segments,
        len(sc), h.ctypes.data, v.ctypes.data,
        _ptrs(dc_luts), _ptrs(ac_luts),
        n_units, ri, out.ctypes.data, n_threads, hdr.precision)
    if rc != 0:
        raise _failed("subset-scan", rc)
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
            raise _failed("nibble entropy", rc)
        k, o, e = (int(x) for x in counts)
        return (dc16, entries[:k].copy(), ov[:o].copy(),
                esc_idx[:e].copy(), esc_val[:e].copy())


def decode_scan_packed(hdr: FrameHeader, scan: ScanHeader,
                       n_threads: int | None = None):
    """Decode straight to the packed wire format (int16 DC plane, int8 AC
    plane, sparse escape list) — zero extra host passes.

    Returns (dc16 (N,), ac8 (N, 64) int8 with [:,0]=0, esc_idx (E,) int32,
    esc_val (E,) int16); the same as
    models.batch.pack_blocks(decode_scan_baseline(...)).
    """
    lib = _load()
    st = _ScanCall(hdr, scan)
    n_blocks = st.lay.total_blocks
    dc16 = np.empty((n_blocks,), np.int16)
    ac8 = np.empty((n_blocks, 64), np.int8)
    n_threads = st.threads(n_threads)

    esc_cap = max(4096, n_blocks // 2)
    while True:
        esc_idx = np.empty((esc_cap,), np.int32)
        esc_val = np.empty((esc_cap,), np.int16)
        esc_count = np.zeros((1,), np.int64)
        rc = lib.jd_decode_scan_packed(
            *st.head_args(),
            dc16.ctypes.data, ac8.ctypes.data,
            esc_idx.ctypes.data, esc_val.ctypes.data,
            esc_cap, esc_count.ctypes.data, n_threads,
        )
        if rc == -3:  # escape capacity exceeded (low-quality images)
            esc_cap *= 4
            continue
        if rc != 0:
            raise _failed("packed entropy", rc)
        e = int(esc_count[0])
        return dc16, ac8, esc_idx[:e].copy(), esc_val[:e].copy()


def decode_scan_sparse(hdr: FrameHeader, scan: ScanHeader,
                       n_threads: int | None = None):
    """Decode straight to the sparse wire format (int16 DC plane + (gap
    uint8, val int8) AC stream + escape list) — the run-length decode loop
    emits nonzeros directly, never materializing a dense AC plane.

    Returns (dc16 (N,), gaps (K,) uint8, vals (K,) int8, esc_idx (E,) int32,
    esc_val (E,) int16); the same as models.batch.sparsify_ac over the
    packed format.
    """
    lib = _load()
    st = _ScanCall(hdr, scan)
    n_blocks = st.lay.total_blocks
    dc16 = np.empty((n_blocks,), np.int16)
    n_threads = st.threads(n_threads)

    # Start at 16 entries per block and grow geometrically (the hard upper
    # bound is 64 per block, extenders included).
    sparse_cap = max(4096, n_blocks * 16)
    esc_cap = max(4096, n_blocks // 2)
    while True:
        gaps = np.empty((sparse_cap,), np.uint8)
        vals = np.empty((sparse_cap,), np.int8)
        sparse_count = np.zeros((1,), np.int64)
        esc_idx = np.empty((esc_cap,), np.int32)
        esc_val = np.empty((esc_cap,), np.int16)
        esc_count = np.zeros((1,), np.int64)
        rc = lib.jd_decode_scan_sparse(
            *st.head_args(),
            dc16.ctypes.data,
            gaps.ctypes.data, vals.ctypes.data,
            sparse_cap, sparse_count.ctypes.data,
            esc_idx.ctypes.data, esc_val.ctypes.data,
            esc_cap, esc_count.ctypes.data, n_threads,
        )
        if rc == -3:  # capacity exceeded
            sparse_cap *= 4
            esc_cap *= 4
            continue
        if rc != 0:
            raise _failed("sparse entropy", rc)
        k = int(sparse_count[0])
        e = int(esc_count[0])
        return (dc16, gaps[:k].copy(), vals[:k].copy(),
                esc_idx[:e].copy(), esc_val[:e].copy())


def decode_scan_slots(hdr: FrameHeader, scan: ScanHeader, cap: int = 16,
                      n_threads: int | None = None):
    """Decode straight to the slot wire format (int16 DC plane + (N, cap)
    position/value slot arrays + overflow and escape lists); see
    models.batch.slotify_ac for the format.

    Returns (dc16 (N,), pos (N, cap) uint8, val (N, cap) int8,
    ov_idx (O,) int32, ov_val (O,) int16, esc_idx (E,), esc_val (E,))."""
    if not 1 <= cap <= 63:
        raise ValueError(f"slot capacity must be 1..63, got {cap}")
    lib = _load()
    st = _ScanCall(hdr, scan)
    n_blocks = st.lay.total_blocks
    dc16 = np.empty((n_blocks,), np.int16)
    pos = np.zeros((n_blocks, cap), np.uint8)
    val = np.zeros((n_blocks, cap), np.int8)
    n_threads = st.threads(n_threads)

    ov_cap = max(4096, n_blocks * 8)
    esc_cap = max(4096, n_blocks // 2)
    while True:
        ov_idx = np.empty((ov_cap,), np.int32)
        ov_val = np.empty((ov_cap,), np.int16)
        esc_idx = np.empty((esc_cap,), np.int32)
        esc_val = np.empty((esc_cap,), np.int16)
        counts = np.zeros((2,), np.int64)
        rc = lib.jd_decode_scan_slots(
            *st.head_args(),
            dc16.ctypes.data,
            pos.ctypes.data, val.ctypes.data, cap,
            ov_idx.ctypes.data, ov_val.ctypes.data,
            ov_cap, counts[0:].ctypes.data,
            esc_idx.ctypes.data, esc_val.ctypes.data,
            esc_cap, counts[1:].ctypes.data, n_threads,
        )
        if rc == -3:
            ov_cap *= 4
            esc_cap *= 4
            continue
        if rc != 0:
            raise _failed("slots entropy", rc)
        o, e = (int(x) for x in counts)
        return (dc16, pos, val, ov_idx[:o].copy(), ov_val[:o].copy(),
                esc_idx[:e].copy(), esc_val[:e].copy())


def decode_scan_arith(hdr: FrameHeader, scan: ScanHeader,
                      n_threads: int | None = None) -> np.ndarray:
    """Decode a sequential arithmetic (SOF9) interleaved scan natively.

    Returns (total_blocks, 64) int32 scan-order natural-layout
    coefficients, identical to entropy.arith.decode_scan_baseline."""
    lib = _load()
    lay = scan_layout(hdr)
    comps = hdr.components
    data = _padded(scan)
    seg_offsets, n_segments, ri = _segments(scan, lay.n_mcus)
    if sorted(scan.comp_indices) != list(range(len(comps))):
        raise JPEGError("arithmetic scan must code every component")
    h = np.array([c.h for c in comps], np.int32)
    v = np.array([c.v for c in comps], np.int32)
    dc_tid = np.zeros(len(comps), np.int32)
    ac_tid = np.zeros(len(comps), np.int32)
    for k, ci in enumerate(scan.comp_indices):
        dc_tid[ci] = _table_id(scan.dc_table_ids[k])
        ac_tid[ci] = _table_id(scan.ac_table_ids[k])
    dc_l, dc_u, ac_kx = _arith_cond(scan)
    out = np.zeros((lay.total_blocks, 64), dtype=np.int32)
    if n_threads is None:
        n_threads = min(_NCPU, max(1, n_segments))
    rc = lib.jd_decode_scan_arith(
        data.ctypes.data, seg_offsets.ctypes.data, n_segments, len(comps),
        h.ctypes.data, v.ctypes.data,
        dc_tid.ctypes.data, ac_tid.ctypes.data,
        dc_l.ctypes.data, dc_u.ctypes.data, ac_kx.ctypes.data,
        lay.n_mcus, ri, out.ctypes.data, n_threads)
    if rc != 0:
        raise _failed("arithmetic", rc)
    return out


def _empty_planes(hdr: FrameHeader) -> list[np.ndarray]:
    """Zero (mcus_y*v, mcus_x*h, 64) int32 planes, one per component."""
    return [np.zeros((hdr.mcus_y * c.v, hdr.mcus_x * c.h, 64), np.int32)
            for c in hdr.components]


def _scan_geometry(hdr: FrameHeader, planes: list, scan):
    """Checks one progressive scan against the frame and its planes.

    Returns (padded data, segment table, n_segments, interleaved,
    sc_rows, sc_cols): sc_* are the unpadded block grid of a
    non-interleaved scan's component (0, 0 when interleaved).  The C
    decoders themselves refuse missing segments and skip surplus ones."""
    _check_band(scan)
    sc = scan.comp_indices
    if not sc or any(not 0 <= ci < len(planes) for ci in sc):
        raise JPEGError(f"scan components {sc} out of range")
    interleaved = len(sc) > 1
    sc_rows, sc_cols = (0, 0) if interleaved else comp_dims_unpadded(
        hdr, sc[0])
    for ci in sc:
        c = hdr.components[ci]
        _check_plane(planes[ci], max(hdr.mcus_y * c.v, sc_rows),
                     max(hdr.mcus_x * c.h, sc_cols))
    seg = _segment_table(scan)
    return _padded(scan), seg, len(seg) - 1, interleaved, sc_rows, sc_cols


def _run_prog_scan(lib, hdr: FrameHeader, planes: list, scan) -> None:
    """One progressive Huffman scan into caller-owned planes (segment-
    threaded in the C call; restart segments are independent, T.81 G.2)."""
    data, seg, n_segments, interleaved, sc_rows, sc_cols = _scan_geometry(
        hdr, planes, scan)
    ri = scan.restart_interval
    first = 1 if scan.ah == 0 else 0
    n_threads = min(_NCPU, max(1, n_segments))
    sc = scan.comp_indices
    if scan.ss == 0:
        nsc = len(sc)
        comps = [hdr.components[ci] for ci in sc]
        comp_h = np.array([c.h for c in comps], np.int32)
        comp_v = np.array([c.v for c in comps], np.int32)
        plane_cols = np.array([planes[ci].shape[1] for ci in sc], np.int32)
        if first:
            luts = [_lut16(scan.dc_specs[scan.dc_table_ids[k]])
                    for k in range(nsc)]
        else:
            luts = [np.zeros(1, np.int16)] * nsc  # unused
        rc = lib.jd_prog_dc_scan(
            data.ctypes.data, seg.ctypes.data, n_segments,
            first, scan.al, int(interleaved), nsc,
            comp_h.ctypes.data, comp_v.ctypes.data,
            _ptrs([planes[ci] for ci in sc]), plane_cols.ctypes.data,
            _ptrs(luts), hdr.mcus_x, hdr.mcus_y, sc_rows, sc_cols, ri,
            n_threads)
    else:
        ci = sc[0]
        lut = _lut16(scan.ac_specs[scan.ac_table_ids[0]])
        rc = lib.jd_prog_ac_scan(
            data.ctypes.data, seg.ctypes.data, n_segments,
            first, scan.ss, scan.se, scan.al,
            planes[ci].ctypes.data, planes[ci].shape[1],
            lut.ctypes.data, sc_rows, sc_cols, ri, n_threads)
    if rc != 0:
        raise JPEGError(f"native progressive scan failed (code {rc})")


def _run_prog_scan_arith(lib, hdr: FrameHeader, planes: list, scan) -> None:
    """One progressive arithmetic scan into caller-owned planes."""
    data, seg, n_segments, interleaved, sc_rows, sc_cols = _scan_geometry(
        hdr, planes, scan)
    ri = scan.restart_interval
    n_threads = min(_NCPU, max(1, n_segments))
    dc_l, dc_u, ac_kx = _arith_cond(scan)
    sc = scan.comp_indices
    if scan.ss == 0:
        nsc = len(sc)
        comps = [hdr.components[ci] for ci in sc]
        comp_h = np.array([c.h for c in comps], np.int32)
        comp_v = np.array([c.v for c in comps], np.int32)
        plane_cols = np.array([planes[ci].shape[1] for ci in sc], np.int32)
        dc_tid = np.array([_table_id(t) for t in scan.dc_table_ids[:nsc]],
                          np.int32)
        rc = lib.jd_prog_dc_scan_arith(
            data.ctypes.data, seg.ctypes.data, n_segments,
            1 if scan.ah == 0 else 0, scan.al, int(interleaved), nsc,
            comp_h.ctypes.data, comp_v.ctypes.data,
            _ptrs([planes[ci] for ci in sc]), plane_cols.ctypes.data,
            dc_tid.ctypes.data, dc_l.ctypes.data, dc_u.ctypes.data,
            hdr.mcus_x, hdr.mcus_y, sc_rows, sc_cols, ri, n_threads)
    else:
        ci = sc[0]
        tid = _table_id(scan.ac_table_ids[0])
        rc = lib.jd_prog_ac_scan_arith(
            data.ctypes.data, seg.ctypes.data, n_segments,
            scan.ss, scan.se, scan.ah, scan.al,
            planes[ci].ctypes.data, planes[ci].shape[1],
            tid, int(ac_kx[tid]), sc_rows, sc_cols, ri, n_threads)
    if rc != 0:
        raise JPEGError(
            f"native arithmetic progressive scan failed (code {rc})")


def _scan_chains(hdr: FrameHeader) -> list:
    """Partition a progressive frame's scans into independent chains.

    Scans write disjoint coefficient sets: DC scans touch only k=0, AC
    scans a single component's k>=1 band; refinements depend only on
    earlier scans of the SAME component/band.  So (all DC scans, in file
    order) and (each component's AC scans, in file order) are mutually
    independent chains — they run on parallel host threads, recovering
    scan-level parallelism even for DRI=0 progressive streams (where
    segment sharding has nothing to shard).  Order within a chain is
    preserved, so output is identical to the sequential loop."""
    chains: dict = {}
    for scan in hdr.scans:
        key = "dc" if scan.ss == 0 else ("ac", scan.comp_indices[0])
        chains.setdefault(key, []).append(scan)
    return list(chains.values())


def _run_chains(hdr: FrameHeader, run_scan) -> list[np.ndarray]:
    """Zero planes, then every scan chain of ``hdr`` through
    ``run_scan(lib, hdr, planes, scan)``, chains on parallel threads."""
    lib = _load()
    planes = _empty_planes(hdr)
    chains = _scan_chains(hdr)

    def run_chain(scans):
        for scan in scans:
            run_scan(lib, hdr, planes, scan)

    if len(chains) > 1 and _NCPU > 1:
        with ThreadPoolExecutor(min(_NCPU * 2, len(chains))) as ex:
            list(ex.map(run_chain, chains))
    else:
        for scans in chains:
            run_chain(scans)
    return planes


def decode_progressive(hdr: FrameHeader) -> list[np.ndarray]:
    """Native fast path for progressive Huffman frames (T.81 G.2): per-scan
    C++ decoders mutate caller-owned per-component planes; independent
    scan chains (DC / per-component AC) run on parallel threads and each
    scan is additionally segment-threaded.

    Output identical to entropy.progressive.decode_progressive."""
    if hdr.precision != 8:
        raise JPEGError("native progressive decode takes 8-bit frames only")
    return _run_chains(hdr, _run_prog_scan)


def decode_progressive_arith(hdr: FrameHeader) -> list[np.ndarray]:
    """Native fast path for progressive ARITHMETIC frames (SOF10, T.81
    G.3): per-scan C++ decoders mutate caller-owned planes.  Output
    identical to entropy.arith._decode_progressive."""
    return _run_chains(hdr, _run_prog_scan_arith)
