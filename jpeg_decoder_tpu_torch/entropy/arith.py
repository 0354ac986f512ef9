"""Arithmetic-coded JPEG entropy decode (T.81 Annexes D and F).

A numpy-only copy of ``jpeg_decoder_tpu/entropy/arith.py`` (see types.py
for why the port keeps copies), held to it by tests/test_torch_fallback.py:
SOF9 (extended sequential, arithmetic) and SOF10 (progressive, arithmetic)
streams.

The coder is the QM adaptive binary arithmetic coder of T.81 Annex D:
a 114-state probability estimation automaton (Table D.3; index 113 is
the non-adapting "fixed" ~0.5 bin used for AC sign decisions) driving
interval subdivision with conditional MPS/LPS exchange.  The JPEG layer
(Annex F) maps DCT coefficients onto binary decisions through per-
component conditioning contexts: DC uses a 5-category classification of
the previous diff controlled by the DAC (L, U) parameters; AC uses
per-index (k) EOB/zero contexts and a low/high spectral split at Kx.

Statistics reset at restart markers (F.1.4.1.1), so restart segments
remain the independently decodable parallel unit, exactly like the
Huffman path — ``decode_scan_baseline`` emits the same scan-order
``(total_blocks, 64)`` int32 natural-order coefficient array as every
other entropy backend.  :func:`decode_to_planes` takes the native decoders
(``native.decode_scan_arith``, ``native.decode_progressive_arith``) when
the library builds, else the pure-Python ones here.

A matching QM *encoder* lives here too, used by ``testing/encoder.py`` to
build test fixtures.
"""

from __future__ import annotations

import numpy as np

from .. import layout as layout_mod
from ..types import FrameHeader, JPEGError, ScanHeader, ZIGZAG

# T.81 Table D.3 — (Qe, NMPS, NLPS, SWITCH) per estimation state.
# Standard-defined constants; row 113 is the fixed-probability bin
# (self-transitioning, never adapts).
QM_TABLE = (
    (0x5A1D,1,1,1), (0x2586,2,14,0), (0x1114,3,16,0), (0x080B,4,18,0),
    (0x03D8,5,20,0), (0x01DA,6,23,0), (0x00E5,7,25,0), (0x006F,8,28,0),
    (0x0036,9,30,0), (0x001A,10,33,0), (0x000D,11,35,0), (0x0006,12,9,0),
    (0x0003,13,10,0), (0x0001,13,12,0), (0x5A7F,15,15,1), (0x3F25,16,36,0),
    (0x2CF2,17,38,0), (0x207C,18,39,0), (0x17B9,19,40,0), (0x1182,20,42,0),
    (0x0CEF,21,43,0), (0x09A1,22,45,0), (0x072F,23,46,0), (0x055C,24,48,0),
    (0x0406,25,49,0), (0x0303,26,51,0), (0x0240,27,52,0), (0x01B1,28,54,0),
    (0x0144,29,56,0), (0x00F5,30,57,0), (0x00B7,31,59,0), (0x008A,32,60,0),
    (0x0068,33,62,0), (0x004E,34,63,0), (0x003B,35,32,0), (0x002C,9,33,0),
    (0x5AE1,37,37,1), (0x484C,38,64,0), (0x3A0D,39,65,0), (0x2EF1,40,67,0),
    (0x261F,41,68,0), (0x1F33,42,69,0), (0x19A8,43,70,0), (0x1518,44,72,0),
    (0x1177,45,73,0), (0x0E74,46,74,0), (0x0BFB,47,75,0), (0x09F8,48,77,0),
    (0x0861,49,78,0), (0x0706,50,79,0), (0x05CD,51,48,0), (0x04DE,52,50,0),
    (0x040F,53,50,0), (0x0363,54,51,0), (0x02D4,55,52,0), (0x025C,56,53,0),
    (0x01F8,57,54,0), (0x01A4,58,55,0), (0x0160,59,56,0), (0x0125,60,57,0),
    (0x00F6,61,58,0), (0x00CB,62,59,0), (0x00AB,63,61,0), (0x008F,32,61,0),
    (0x5B12,65,65,1), (0x4D04,66,80,0), (0x412C,67,81,0), (0x37D8,68,82,0),
    (0x2FE8,69,83,0), (0x293C,70,84,0), (0x2379,71,86,0), (0x1EDF,72,87,0),
    (0x1AA9,73,87,0), (0x174E,74,72,0), (0x1424,75,72,0), (0x119C,76,74,0),
    (0x0F6B,77,74,0), (0x0D51,78,75,0), (0x0BB6,79,77,0), (0x0A40,48,77,0),
    (0x5832,81,80,1), (0x4D1C,82,88,0), (0x438E,83,89,0), (0x3BDD,84,90,0),
    (0x34EE,85,91,0), (0x2EAE,86,92,0), (0x299A,87,93,0), (0x2516,71,86,0),
    (0x5570,89,88,1), (0x4CA9,90,95,0), (0x44D9,91,96,0), (0x3E22,92,97,0),
    (0x3824,93,99,0), (0x32B4,94,99,0), (0x2E17,86,93,0), (0x56A8,96,95,1),
    (0x4F46,97,101,0), (0x47E5,98,102,0), (0x41CF,99,103,0), (0x3C3D,100,104,0),
    (0x375E,93,99,0), (0x5231,102,105,0), (0x4C0F,103,106,0), (0x4639,104,107,0),
    (0x415E,99,103,0), (0x5627,106,105,1), (0x50E7,107,108,0), (0x4B85,103,109,0),
    (0x5597,109,110,0), (0x504F,107,111,0), (0x5A10,111,110,1), (0x5522,109,112,0),
    (0x59EB,111,112,1), (0x5A1D,113,113,0),
)

#: Fixed ~0.5-probability state (AC sign / DC-refinement decisions).
FIXED_BIN = 113

DC_STAT_BINS = 64
AC_STAT_BINS = 256


class QMDecoder:
    """T.81 Annex D.2 arithmetic decoder over an unstuffed byte segment.

    Interval registers kept in the natural fixed-point form: ``a`` is the
    current interval size (renormalized into [0x8000, 0x10000)); ``c`` is
    the offset of the code value within the interval, bit-fed from the
    stream (zero bits after segment end, per the marker-detection rule of
    D.2.2 — the unstuffer has already removed FF00 stuffing and stopped
    at the terminating marker)."""

    __slots__ = ("data", "n", "byte_pos", "bit_pos", "a", "c")

    def __init__(self, data, start: int, end: int):
        self.data = data
        self.n = end
        self.byte_pos = start
        self.bit_pos = 0
        self.a = 0x10000
        c = 0
        for _ in range(16):
            c = (c << 1) | self._next_bit()
        self.c = c

    def _next_bit(self) -> int:
        if self.byte_pos >= self.n:
            return 0
        b = (int(self.data[self.byte_pos]) >> (7 - self.bit_pos)) & 1
        self.bit_pos += 1
        if self.bit_pos == 8:
            self.bit_pos = 0
            self.byte_pos += 1
        return b

    def decode(self, stats: bytearray, i: int) -> int:
        sv = stats[i]
        qe, nmps, nlps, sw = QM_TABLE[sv & 0x7F]
        mps = sv >> 7
        amq = self.a - qe
        if self.c < amq:
            if amq >= 0x8000:          # MPS, no renorm, no adaptation
                self.a = amq
                return mps
            # Renormalizing MPS path: conditional exchange (D.2.3).
            if amq < qe:
                d = 1 - mps
                if sw:
                    mps ^= 1
                stats[i] = nlps | (mps << 7)
            else:
                d = mps
                stats[i] = nmps | (mps << 7)
            a = amq
        else:
            self.c -= amq
            if amq < qe:               # conditional exchange
                d = mps
                stats[i] = nmps | (mps << 7)
            else:
                d = 1 - mps
                if sw:
                    mps ^= 1
                stats[i] = nlps | (mps << 7)
            a = qe
        c = self.c
        while a < 0x8000:
            a <<= 1
            c = (c << 1) | self._next_bit()
        self.a = a
        self.c = c
        return d


class QMEncoder:
    """T.81 Annex D.1 arithmetic encoder (fixture generation / tests).

    The code value accumulates in an arbitrary-precision integer, so
    carry propagation is exact by construction and BYTEOUT's carry/
    stacked-0xFF machinery is unnecessary; FF00 byte stuffing (D.1.6) is
    applied as a post-pass on the final byte string."""

    __slots__ = ("a", "c", "nbits")

    def __init__(self):
        self.a = 0x10000
        self.c = 0
        self.nbits = 16

    def encode(self, bit: int, stats: bytearray, i: int):
        sv = stats[i]
        qe, nmps, nlps, sw = QM_TABLE[sv & 0x7F]
        mps = sv >> 7
        amq = self.a - qe
        if bit == mps:
            if amq >= 0x8000:
                self.a = amq
                return
            if amq < qe:               # conditional exchange: MPS on top
                self.c += amq
                self.a = qe
            else:
                self.a = amq
            stats[i] = nmps | (mps << 7)
        else:
            if amq < qe:               # conditional exchange: LPS at base
                self.a = amq
            else:
                self.c += amq
                self.a = qe
            if sw:
                mps ^= 1
            stats[i] = nlps | (mps << 7)
        while self.a < 0x8000:
            self.a <<= 1
            self.c <<= 1
            self.nbits += 1

    def flush(self) -> bytes:
        """Terminate and return the entropy bytes (unstuffed -> stuffed)."""
        # Any value in [c, c + a) decodes correctly; clear as many low
        # bits as the interval allows so trailing bytes become 0x00 and
        # can be trimmed (decoders feed zeros past the end).
        c, a = self.c, self.a
        nb = self.nbits
        t = c + a - 1
        keep = t
        for k in range(nb):
            cand = (t >> k) << k
            if cand >= c:
                keep = cand
            else:
                break
        pad = (-nb) % 8
        raw = (keep << pad).to_bytes((nb + pad) // 8, "big")
        raw = raw.rstrip(b"\x00")
        return raw.replace(b"\xff", b"\xff\x00")


# ---------------------------------------------------------------------------
# JPEG decision layer (T.81 Annex F) — shared context arithmetic
# ---------------------------------------------------------------------------


def _cond_params(scan: ScanHeader, hdr: FrameHeader):
    """Per-scan-component (L, U, Kx) conditioning, DAC defaults 0/1/5."""
    dc_cond = getattr(scan, "dc_cond", None) or {}
    ac_cond = getattr(scan, "ac_cond", None) or {}
    lu = []
    kx = []
    for k, _ci in enumerate(scan.comp_indices):
        lu.append(dc_cond.get(scan.dc_table_ids[k], (0, 1)))
        kx.append(ac_cond.get(scan.ac_table_ids[k], 5))
    return lu, kx


class _ScanState:
    """Adaptive statistics + predictors for one restart segment."""

    def __init__(self, n_dc_tables: int = 4, n_ac_tables: int = 4,
                 n_comps: int = 4):
        self.dc_stats = [bytearray(DC_STAT_BINS) for _ in range(n_dc_tables)]
        self.ac_stats = [bytearray(AC_STAT_BINS) for _ in range(n_ac_tables)]
        self.fixed = bytearray([FIXED_BIN])
        self.last_dc = [0] * n_comps
        self.dc_context = [0] * n_comps


def _decode_dc(dec: QMDecoder, st8: _ScanState, tbl: int, ci: int,
               l_param: int, u_param: int) -> int:
    """Decode one DC diff (F.1.4.1, figures F.19-F.24); returns new DC."""
    stats = st8.dc_stats[tbl]
    base = st8.dc_context[ci]
    if dec.decode(stats, base) == 0:
        st8.dc_context[ci] = 0
        return st8.last_dc[ci]
    sign = dec.decode(stats, base + 1)
    st = base + 2 + sign
    m = dec.decode(stats, st)
    if m:
        st = 20                       # X1 (Table F.4)
        while dec.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                raise JPEGError("arith: DC magnitude category overflow")
            st += 1
    # Conditioning category for the NEXT block (F.1.4.4.1.2).
    if m < (1 << l_param) >> 1:
        st8.dc_context[ci] = 0
    elif m > (1 << u_param) >> 1:
        st8.dc_context[ci] = 12 + sign * 4
    else:
        st8.dc_context[ci] = 4 + sign * 4
    v = m
    st += 14                          # M bins (Table F.4)
    while m := m >> 1:
        if dec.decode(stats, st):
            v |= m
    v += 1
    if sign:
        v = -v
    st8.last_dc[ci] += v
    return st8.last_dc[ci]


def _decode_ac_block(dec: QMDecoder, st8: _ScanState, tbl: int, kx: int,
                     out: np.ndarray, ss: int = 1, se: int = 63,
                     al: int = 0):
    """Decode AC coefficients k in [ss, se] into natural-order ``out``."""
    stats = st8.ac_stats[tbl]
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if dec.decode(stats, st):     # EOB
            return
        while dec.decode(stats, st + 1) == 0:
            k += 1
            st += 3
            if k > se:
                raise JPEGError("arith: AC run past spectral end")
        sign = dec.decode(st8.fixed, 0)
        st += 2
        m = dec.decode(stats, st)
        if m:
            if dec.decode(stats, st):
                m = 2
                st = 189 if k <= kx else 217
                while dec.decode(stats, st):
                    m <<= 1
                    if m == 0x8000:
                        raise JPEGError(
                            "arith: AC magnitude category overflow")
                    st += 1
        v = m
        st += 14
        while m := m >> 1:
            if dec.decode(stats, st):
                v |= m
        v += 1
        if sign:
            v = -v
        out[ZIGZAG[k]] = v << al
        k += 1


def decode_scan_baseline(hdr: FrameHeader, scan: ScanHeader) -> np.ndarray:
    """Sequential arithmetic scan -> scan-order (total_blocks, 64) int32.

    Emits blocks in exactly the interleaved MCU order of the Huffman
    backends (layout.scan_layout distributes them to component planes),
    so arithmetic streams flow through the identical device pipeline.
    Statistics, DC predictors and conditioning contexts reset at every
    restart segment (F.1.4.1.1) — segments stay independently decodable.
    """
    lay = layout_mod.scan_layout(hdr)
    lu, kx = _cond_params(scan, hdr)
    n_comps = len(hdr.components)
    bpm = lay.blocks_per_mcu
    n_mcus = lay.n_mcus
    # Per within-MCU block: (scan position k, component index ci).  T.81
    # B.2.3 requires scan components in frame-header order, so the layout's
    # scan order and scan.comp_indices agree; .index maps ci -> k.
    per_mcu = [(scan.comp_indices.index(int(ci)), int(ci))
               for ci in lay.comp_of_block[:bpm]]
    out = np.zeros((n_mcus * bpm, 64), np.int32)

    mcu = 0
    for dec, seg_mcus in _iter_segments(scan, n_mcus):
        st8 = _ScanState(n_comps=n_comps)
        for _ in range(seg_mcus):
            base = mcu * bpm
            for b, (k, ci) in enumerate(per_mcu):
                blk = out[base + b]
                blk[0] = _decode_dc(dec, st8, scan.dc_table_ids[k], ci,
                                    *lu[k])
                _decode_ac_block(dec, st8, scan.ac_table_ids[k], kx[k], blk)
            mcu += 1
    if mcu != n_mcus:
        raise JPEGError(
            f"arith: stream ended after {mcu}/{n_mcus} MCUs")
    return out


def decode_scan_sequential_into(hdr: FrameHeader, scan: ScanHeader,
                                planes: list) -> None:
    """Decode one sequential arithmetic scan over a component subset into
    caller-owned padded per-component planes (mirror of
    python_ref.decode_scan_sequential_into: multi-component scans
    interleave MCUs over the frame grid, single-component scans traverse
    the component's unpadded block grid non-interleaved, T.81 A.2)."""
    lu, kx = _cond_params(scan, hdr)
    comps = hdr.components
    sc = scan.comp_indices
    interleaved = len(sc) > 1
    if interleaved:
        n_units = hdr.mcus_x * hdr.mcus_y
        per_mcu = []
        for k, ci in enumerate(sc):
            c = comps[ci]
            for bv in range(c.v):
                for bh in range(c.h):
                    per_mcu.append((k, ci, bv, bh))
    else:
        ci0 = sc[0]
        rows_u, cols_u = layout_mod.comp_dims_unpadded(hdr, ci0)
        n_units = rows_u * cols_u
    unit = 0
    for dec, seg_units in _iter_segments(scan, n_units):
        st8 = _ScanState(n_comps=len(comps))
        for _ in range(seg_units):
            if interleaved:
                my, mx = divmod(unit, hdr.mcus_x)
                for k, ci, bv, bh in per_mcu:
                    c = comps[ci]
                    blk = planes[ci][my * c.v + bv, mx * c.h + bh]
                    blk[:] = 0
                    blk[0] = _decode_dc(dec, st8, scan.dc_table_ids[k], ci,
                                        *lu[k])
                    _decode_ac_block(dec, st8, scan.ac_table_ids[k], kx[k],
                                     blk)
            else:
                r, c_ = divmod(unit, cols_u)
                blk = planes[ci0][r, c_]
                blk[:] = 0
                blk[0] = _decode_dc(dec, st8, scan.dc_table_ids[0], ci0,
                                    *lu[0])
                _decode_ac_block(dec, st8, scan.ac_table_ids[0], kx[0], blk)
            unit += 1
    if unit != n_units:
        raise JPEGError("arith: scan ended before all blocks decoded")


def decode_to_planes(hdr: FrameHeader):
    """Entropy-decode an arithmetic-coded frame (SOF9/SOF10) into
    per-component quantized coefficient planes (rows, cols, 64) int32."""
    from . import native

    # As in the JAX package, a stream the native decoder refuses is handed
    # to the pure-Python decoder, whose answer (or error) is the result.
    if hdr.progressive:
        if native.available():
            try:
                return native.decode_progressive_arith(hdr)
            except JPEGError:
                pass
        return _decode_progressive(hdr)
    lay = layout_mod.scan_layout(hdr)
    single_full = (
        len(hdr.scans) == 1
        and len(hdr.scans[0].comp_indices) == len(hdr.components)
        and not (len(hdr.components) == 1
                 and (hdr.components[0].h, hdr.components[0].v) != (1, 1)))
    if single_full:
        blocks = None
        if native.available():
            try:
                blocks = native.decode_scan_arith(hdr, hdr.scans[0])
            except JPEGError:
                blocks = None
        if blocks is None:
            blocks = decode_scan_baseline(hdr, hdr.scans[0])
        planes = []
        for ci in range(len(hdr.components)):
            rows, cols = lay.comp_shapes[ci]
            planes.append(blocks[lay.comp_src[ci]].reshape(rows, cols, 64))
        return planes
    # General sequential case: multiple scans over component subsets and/or
    # a non-interleaved subsampled single-component frame (T.81 A.2) —
    # legal streams the Huffman path already accepts; keep parity here.
    planes = [np.zeros((*lay.comp_shapes[ci], 64), np.int32)
              for ci in range(len(hdr.components))]
    seen: set[int] = set()
    for scan in hdr.scans:
        dup = seen.intersection(scan.comp_indices)
        if dup:
            raise JPEGError(
                f"arith: sequential frame codes components {sorted(dup)} "
                "twice")
        decode_scan_sequential_into(hdr, scan, planes)
        seen.update(scan.comp_indices)
    missing = set(range(len(hdr.components))) - seen
    if missing:
        raise JPEGError(
            f"arith: sequential frame never codes components "
            f"{sorted(missing)}")
    return planes


# ---------------------------------------------------------------------------
# Progressive arithmetic (SOF10) — T.81 G.3
# ---------------------------------------------------------------------------

_ZZ = ZIGZAG.tolist()


def _iter_segments(scan: ScanHeader, n_units: int):
    """Yield (QMDecoder, unit_count) per restart segment (mirrors the
    Huffman progressive path's _iter_segments)."""
    offs = scan.seg_offsets
    n_segments = len(offs) - 1
    ri = scan.restart_interval
    expected = -(-n_units // ri) if ri else 1
    if n_segments != expected:
        raise JPEGError(
            f"arith scan: segment count {n_segments} != expected "
            f"{expected} (DRI {ri}, {n_units} units)")
    done = 0
    for s in range(n_segments):
        dec = QMDecoder(scan.data, int(offs[s]), int(offs[s + 1]))
        n = min(ri, n_units - done) if ri else n_units
        yield dec, n
        done += n


def _decode_progressive(hdr: FrameHeader):
    planes = []
    for ci in range(len(hdr.components)):
        rows, cols = (hdr.mcus_y * hdr.components[ci].v,
                      hdr.mcus_x * hdr.components[ci].h)
        planes.append(np.zeros((rows, cols, 64), np.int32))

    for scan in hdr.scans:
        if scan.ss == 0:
            if scan.se != 0:
                raise JPEGError("arith progressive: DC scan must have Se=0")
            _dc_scan_arith(hdr, scan, planes)
        else:
            if len(scan.comp_indices) != 1:
                raise JPEGError(
                    "arith progressive: AC scans must be single-component")
            if scan.ah == 0:
                _ac_first_scan_arith(hdr, scan,
                                     planes[scan.comp_indices[0]])
            else:
                _ac_refine_scan_arith(hdr, scan,
                                      planes[scan.comp_indices[0]])
    return planes


def _dc_scan_arith(hdr: FrameHeader, scan: ScanHeader, planes):
    """Progressive DC scan (G.3.2): first pass is the sequential DC
    procedure with the value scaled by 2^Al; refinement is one fixed-bin
    decision per block setting bit Al."""
    lu, _ = _cond_params(scan, hdr)
    first = scan.ah == 0
    comps = hdr.components
    n_comps = len(comps)
    interleaved = len(scan.comp_indices) > 1

    if interleaved:
        mcus_x, mcus_y = hdr.mcus_x, hdr.mcus_y
        n_units = mcus_x * mcus_y
        blocks = []
        for k, ci in enumerate(scan.comp_indices):
            c = comps[ci]
            for v in range(c.v):
                for h in range(c.h):
                    blocks.append((k, ci, v, h))
        mcu = 0
        for dec, seg_units in _iter_segments(scan, n_units):
            st8 = _ScanState(n_comps=n_comps)
            for _ in range(seg_units):
                my, mx = divmod(mcu, mcus_x)
                for k, ci, v, h in blocks:
                    c = comps[ci]
                    row, col = my * c.v + v, mx * c.h + h
                    if first:
                        dc = _decode_dc(dec, st8, scan.dc_table_ids[k],
                                        ci, *lu[k])
                        planes[ci][row, col, 0] = dc << scan.al
                    else:
                        if dec.decode(st8.fixed, 0):
                            planes[ci][row, col, 0] |= 1 << scan.al
                mcu += 1
    else:
        ci = scan.comp_indices[0]
        rows_u, cols_u = layout_mod.comp_dims_unpadded(hdr, ci)
        n_units = rows_u * cols_u
        blk = 0
        for dec, seg_units in _iter_segments(scan, n_units):
            st8 = _ScanState(n_comps=n_comps)
            for _ in range(seg_units):
                row, col = divmod(blk, cols_u)
                if first:
                    dc = _decode_dc(dec, st8, scan.dc_table_ids[0], ci,
                                    *lu[0])
                    planes[ci][row, col, 0] = dc << scan.al
                else:
                    if dec.decode(st8.fixed, 0):
                        planes[ci][row, col, 0] |= 1 << scan.al
                blk += 1


def _ac_first_scan_arith(hdr, scan, plane):
    """Progressive AC first pass (G.3.3): the sequential AC procedure over
    the [Ss, Se] band with values scaled by 2^Al.  No EOB runs — the
    per-k EOB decision is coded directly."""
    _, kx = _cond_params(scan, hdr)
    ci = scan.comp_indices[0]
    rows_u, cols_u = layout_mod.comp_dims_unpadded(hdr, ci)
    n_units = rows_u * cols_u
    blk = 0
    for dec, seg_units in _iter_segments(scan, n_units):
        st8 = _ScanState()
        for _ in range(seg_units):
            row, col = divmod(blk, cols_u)
            _decode_ac_block(dec, st8, scan.ac_table_ids[0], kx[0],
                             plane[row, col], ss=scan.ss, se=scan.se,
                             al=scan.al)
            blk += 1


def _ac_refine_scan_arith(hdr, scan, plane):
    """Progressive AC refinement (G.3.4): per-coefficient correction bits
    (context st+2) and newly-nonzero decisions (st+1, sign via the fixed
    bin); the EOB decision is only coded past EOBx, the previous stage's
    last nonzero index."""
    ci = scan.comp_indices[0]
    tbl = scan.ac_table_ids[0]
    ss, se, al = scan.ss, scan.se, scan.al
    p1 = 1 << al
    m1 = -1 << al
    rows_u, cols_u = layout_mod.comp_dims_unpadded(hdr, ci)
    n_units = rows_u * cols_u
    blk = 0
    for dec, seg_units in _iter_segments(scan, n_units):
        st8 = _ScanState()
        stats = st8.ac_stats[tbl]
        for _ in range(seg_units):
            row, col = divmod(blk, cols_u)
            block = plane[row, col]
            kex = se
            while kex > 0 and block[_ZZ[kex]] == 0:
                kex -= 1
            k = ss
            while k <= se:
                st = 3 * (k - 1)
                if k > kex:
                    if dec.decode(stats, st):
                        break          # EOB
                while True:
                    coef = block[_ZZ[k]]
                    if coef:
                        if dec.decode(stats, st + 2):
                            block[_ZZ[k]] = (coef + m1 if coef < 0
                                             else coef + p1)
                        break
                    if dec.decode(stats, st + 1):
                        block[_ZZ[k]] = m1 if dec.decode(st8.fixed, 0) \
                            else p1
                        break
                    st += 3
                    k += 1
                    if k > se:
                        raise JPEGError(
                            "arith: AC refinement run past spectral end")
                k += 1
            blk += 1


# ---------------------------------------------------------------------------
# Encoder decision layer (fixture generation; mirrors the decode contexts)
# ---------------------------------------------------------------------------


def _pt(v: int, al: int) -> int:
    """AC point transform (T.81 A.4): magnitude shift, sign preserved."""
    if al == 0:
        return v
    a = (-v if v < 0 else v) >> al
    return -a if v < 0 else a


def _encode_dc(enc: QMEncoder, st8: _ScanState, tbl: int, ci: int,
               l_param: int, u_param: int, dc: int):
    """Encode one DC value (diff vs predictor), mirror of _decode_dc."""
    stats = st8.dc_stats[tbl]
    base = st8.dc_context[ci]
    diff = dc - st8.last_dc[ci]
    st8.last_dc[ci] = dc
    if diff == 0:
        enc.encode(0, stats, base)
        st8.dc_context[ci] = 0
        return
    enc.encode(1, stats, base)
    sign = 1 if diff < 0 else 0
    enc.encode(sign, stats, base + 1)
    vm1 = (abs(diff)) - 1
    # Category chain: first decision at base+2+sign, X chain at 20.
    st = base + 2 + sign
    if vm1 == 0:
        enc.encode(0, stats, st)
        m = 0
    else:
        enc.encode(1, stats, st)
        m = 1
        st = 20
        while (m << 1) <= vm1:
            enc.encode(1, stats, st)
            m <<= 1
            st += 1
        enc.encode(0, stats, st)
    if m < (1 << l_param) >> 1:
        st8.dc_context[ci] = 0
    elif m > (1 << u_param) >> 1:
        st8.dc_context[ci] = 12 + sign * 4
    else:
        st8.dc_context[ci] = 4 + sign * 4
    st += 14
    mm = m >> 1
    while mm:
        enc.encode(1 if vm1 & mm else 0, stats, st)
        mm >>= 1


def _encode_ac_block(enc: QMEncoder, st8: _ScanState, tbl: int, kx: int,
                     block: np.ndarray, ss: int = 1, se: int = 63,
                     al: int = 0):
    """Encode AC coefficients (natural-order block), mirror of
    _decode_ac_block.  The AC point transform (T.81 A.4) divides by 2^al
    truncating toward zero — i.e. shift the magnitude, keep the sign."""
    stats = st8.ac_stats[tbl]
    vals = [_pt(int(block[_ZZ[k]]), al) for k in range(64)]
    ke = 0
    for k in range(ss, se + 1):
        if vals[k]:
            ke = k
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if ke < k:
            enc.encode(1, stats, st)   # EOB
            return
        enc.encode(0, stats, st)
        while vals[k] == 0:
            enc.encode(0, stats, st + 1)
            st += 3
            k += 1
        enc.encode(1, stats, st + 1)
        v = vals[k]
        sign = 1 if v < 0 else 0
        enc.encode(sign, st8.fixed, 0)
        st += 2
        vm1 = abs(v) - 1
        if vm1 == 0:
            enc.encode(0, stats, st)
            mst = st + 14
            m = 0
        else:
            enc.encode(1, stats, st)
            if vm1 == 1:
                enc.encode(0, stats, st)
                mst = st + 14
                m = 1
            else:
                enc.encode(1, stats, st)
                m = 2
                st = 189 if k <= kx else 217
                while (m << 1) <= vm1:
                    enc.encode(1, stats, st)
                    m <<= 1
                    st += 1
                enc.encode(0, stats, st)
                mst = st + 14
        mm = m >> 1
        while mm:
            enc.encode(1 if vm1 & mm else 0, stats, mst)
            mm >>= 1
        k += 1
    # ke == se: band ends exactly at the last index — no EOB decision
    # (the decoder's loop exits at k > se).


def _encode_ac_refine_block(enc: QMEncoder, st8: _ScanState, tbl: int,
                            target: np.ndarray, ss: int, se: int, al: int):
    """Encoder mirror of the AC refinement decode loop (G.3.4).

    The approximation the decoder holds before this scan is derivable
    from the target alone — every previous scan coded exactly the bits
    above ``al``, so approx(k) = pt(v, al+1) << (al+1); no cross-scan
    state threading is needed."""
    stats = st8.ac_stats[tbl]
    t = [_pt(int(target[_ZZ[k]]), al) for k in range(64)]
    prev = [_pt(int(target[_ZZ[k]]), al + 1) for k in range(64)]
    kex = se
    while kex > 0 and prev[kex] == 0:
        kex -= 1
    kend = 0
    for k in range(ss, se + 1):
        if t[k]:
            kend = k
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if k > kex:
            if k > kend:
                enc.encode(1, stats, st)   # EOB
                return
            enc.encode(0, stats, st)
        while True:
            if prev[k]:
                enc.encode(abs(t[k]) & 1, stats, st + 2)
                break
            if t[k]:
                enc.encode(1, stats, st + 1)
                enc.encode(1 if t[k] < 0 else 0, st8.fixed, 0)
                break
            enc.encode(0, stats, st + 1)
            st += 3
            k += 1
        k += 1
    # Band ends exactly at se — no EOB decision (decoder exits at k > se).
