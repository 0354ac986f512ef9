"""Minimal JPEG encoder (pure NumPy) for tests and the smoke run.

A copy of ``tools/encoder.py`` that imports the port's own ``huffman``,
``types`` and ``entropy.arith``, so that it runs where neither jax nor PIL
is installed.  For the same arguments it writes the same bytes as
``tools/encoder.encode`` (tests/test_torch_host.py): baseline Huffman with
any sampling and restart interval, grayscale, 12-bit (SOF1), multi-scan and
non-interleaved scripts (``scans=``), 4-component (CMYK/YCCK) planes,
arithmetic (SOF9) and progressive arithmetic (SOF10).

``encode(quantized coefficients C) |> decode == C`` exactly for every legal
geometry: the entropy coding layer is lossless, so a decoder's coefficient
planes must equal the ``planes`` this returns.

Not a product surface — deliberately simple (float64 matrix FDCT, standard
Annex K tables only).
"""

from __future__ import annotations

import io
import struct

import numpy as np

from ..huffman import (
    STD_AC_CHROMA, STD_AC_LUMA, STD_DC_CHROMA, STD_DC_LUMA,
    canonical_codes)
from ..types import HuffmanSpec, ZIGZAG

# Extended-precision Huffman tables (12-bit frames need DC size
# categories up to 15 and AC sizes up to 14, beyond the Annex K tables):
# flat-length canonical tables — 16 DC symbols at 5 bits, 226 AC symbols
# (EOB + ZRL + run 0-15 x size 1-14) at 8 bits — trivially prefix-free.
EXT_DC = HuffmanSpec(
    0, 0,
    np.array([0, 0, 0, 0, 16, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.uint8),
    np.arange(16, dtype=np.uint8),
)
_EXT_AC_SYMS = [0x00, 0xF0] + [
    (r << 4) | s for r in range(16) for s in range(1, 15)]
EXT_AC = HuffmanSpec(
    1, 0,
    np.array([0, 0, 0, 0, 0, 0, 0, 226, 0, 0, 0, 0, 0, 0, 0, 0], np.uint8),
    np.array(sorted(_EXT_AC_SYMS), np.uint8),
)

# Annex K.1 luminance / K.2 chrominance base quantization tables (natural
# order after de-zigzag).
_K1_LUMA_ZZ = np.array([
    16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101,
    103, 99], np.int64)
_K2_CHROMA_ZZ = np.array([
    17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    np.int64)


def _qtable(base_zz: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg quality scaling; returns NATURAL-order (64,) int array."""
    quality = max(1, min(100, quality))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = np.clip((base_zz * scale + 50) // 100, 1, 255)
    nat = np.empty(64, np.int64)
    nat[ZIGZAG] = q  # de-zigzag, parser convention (natural-order storage)
    return nat


def qtable(quality: int, chroma: bool = False) -> np.ndarray:
    """The Annex K luma (or chroma) table at ``quality``; NATURAL-order
    (64,), as :func:`encode` writes it."""
    return _qtable(_K2_CHROMA_ZZ if chroma else _K1_LUMA_ZZ, quality)


# Orthonormal DCT-II matrix (rows = frequencies), float64.
_C = np.zeros((8, 8))
for _k in range(8):
    for _n in range(8):
        _C[_k, _n] = np.cos((2 * _n + 1) * _k * np.pi / 16) * (
            np.sqrt(1 / 8) if _k == 0 else np.sqrt(2 / 8))


def _fdct_quantize(plane: np.ndarray, qtable_nat: np.ndarray,
                   center: int = 128) -> np.ndarray:
    """(rows*8, cols*8) samples -> (rows, cols, 64) quantized coefficients.

    T.81 A.3.3's 1/4 c(u)c(v) double-sum equals the orthonormal 2-D DCT
    for N=8, so F = C (X - center) C^T with the orthonormal matrix
    directly (center = 2^(P-1): 128 for 8-bit, 2048 for 12-bit)."""
    r8, c8 = plane.shape
    x = plane.astype(np.float64) - float(center)
    blocks = x.reshape(r8 // 8, 8, c8 // 8, 8).transpose(0, 2, 1, 3)
    f = np.einsum("pu,rcuv,qv->rcpq", _C, blocks, _C)
    q = np.rint(f / qtable_nat.reshape(8, 8)).astype(np.int32)
    return q.reshape(r8 // 8, c8 // 8, 64)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, nbits: int):
        if nbits == 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            b = (self.acc >> self.nbits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing
        # Drop emitted high bits or acc grows into an ever-larger bigint
        # and encoding goes quadratic in the stream length.
        self.acc &= (1 << self.nbits) - 1

    def align(self):
        """Pad to byte boundary with 1-bits (T.81 F.1.2.3)."""
        if self.nbits:
            self.put((1 << (8 - self.nbits)) - 1, 8 - self.nbits)

    def raw(self, data: bytes):
        if self.nbits:
            raise ValueError("raw bytes need a byte-aligned writer")
        self.out += data


def _huff_maps(spec):
    codes, lengths = canonical_codes(spec)
    return {int(s): (int(c), int(l))
            for s, c, l in zip(spec.symbols, codes, lengths)}


def _magnitude(v: int) -> tuple[int, int]:
    """JPEG magnitude category: (size, value-bits)."""
    if v == 0:
        return 0, 0
    size = int(abs(v)).bit_length()
    bits = v if v > 0 else v + (1 << size) - 1
    return size, bits


def _encode_block(bw: _BitWriter, coef64: np.ndarray, pred: int,
                  dc_map, ac_map) -> int:
    """Encode one natural-order (64,) block; returns the new DC predictor."""
    dc = int(coef64[0])
    size, bits = _magnitude(dc - pred)
    code, length = dc_map[size]
    bw.put(code, length)
    bw.put(bits, size)
    zz = coef64[ZIGZAG]  # natural -> zigzag order
    run = 0
    last_nz = int(np.max(np.nonzero(zz)[0])) if np.any(zz[1:]) else 0
    for k in range(1, last_nz + 1):
        v = int(zz[k])
        if v == 0:
            run += 1
            continue
        while run >= 16:
            code, length = ac_map[0xF0]  # ZRL
            bw.put(code, length)
            run -= 16
        size, bits = _magnitude(v)
        code, length = ac_map[(run << 4) | size]
        bw.put(code, length)
        bw.put(bits, size)
        run = 0
    if last_nz < 63:
        code, length = ac_map[0x00]  # EOB
        bw.put(code, length)
    return dc


def encode(rgb: np.ndarray, *, samplings=((2, 2), (1, 1), (1, 1)),
           quality: int = 85, restart_interval: int = 0,
           grayscale: bool = False, zero_based_ids: bool = False,
           scans=None, raw_planes=None, app14_transform=None,
           arithmetic=False, dac=None, progressive=False, precision=8):
    """Encode an (H, W, 3) uint8 RGB array (or (H, W) when grayscale).

    samplings: per-component (h, v), h/v in 1..4, sum(h*v) <= 10.
    scans: None for the usual single interleaved scan, or a partition of
      component indices into scan groups, e.g. ``[(0,), (1, 2)]`` —
      single-component groups are coded non-interleaved over the
      component's unpadded block grid (T.81 A.2).
    raw_planes: list of full-resolution (H, W) float sample planes coded
      verbatim (pre level-shift-removal, 0..255) instead of RGB->YCbCr —
      enables 4-component (CMYK / YCCK) streams.
    app14_transform: when not None, emit an Adobe APP14 marker with this
      color-transform flag (0 = as-is, 1 = YCbCr, 2 = YCCK).
    arithmetic: emit a SOF9 frame entropy-coded with the T.81 Annex D QM
      arithmetic coder (no DHT segments) instead of baseline Huffman.
    dac: optional non-default arithmetic conditioning, a dict like
      ``{"dc": {0: (L, U)}, "ac": {0: Kx}}`` — emitted as a DAC segment.
    progressive: with ``arithmetic=True``, emit a SOF10 progressive-
      arithmetic frame with a fixed spectral-selection + successive-
      approximation scan script exercising all four scan kinds (DC
      first/refine, AC first/refine).  Huffman progressive is not
      emitted here (PIL generates those fixtures).
    precision: 8 (baseline SOF0) or 12 (extended sequential SOF1, T.81
      B.2.2: 2048 level shift, size categories to 15/14, flat extended
      Huffman tables).  12-bit input samples are ``rgb``/``raw_planes``
      scaled to 0..4095 (8-bit input is shifted left by 4).

    Returns (jpeg_bytes, planes) where planes[i] is the (rows_i, cols_i, 64)
    int32 quantized coefficient array actually entropy-coded (padded to the
    MCU grid; cells a non-interleaved scan never codes are zeroed) — the
    exact round-trip expectation for the decoder.
    """
    if precision not in (8, 12):
        raise ValueError("precision must be 8 or 12")
    if raw_planes is not None:
        ycc = [np.asarray(p, np.float64) for p in raw_planes]
        samplings = samplings[:len(ycc)]
    elif grayscale:
        samplings = samplings[:1]
        ycc = [np.asarray(rgb, np.float64)]
    else:
        rgbf = np.asarray(rgb, np.float64)
        r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
        ycc = [y, cb, cr]
    if precision == 12 and max(float(np.max(p)) for p in ycc) < 256:
        ycc = [p * 16.0 for p in ycc]  # 8-bit input -> 12-bit range
    ncomp = len(ycc)
    hs = [s[0] for s in samplings]
    vs = [s[1] for s in samplings]
    if any(not 1 <= x <= 4 for x in hs + vs):
        raise ValueError("sampling factors must be in 1..4")
    if sum(h * v for h, v in samplings) > 10:
        raise ValueError("more than 10 blocks per MCU (T.81 B.2.2)")
    h_max, v_max = max(hs), max(vs)
    H, W = ycc[0].shape
    mcus_x = -(-W // (8 * h_max))
    mcus_y = -(-H // (8 * v_max))

    qt_luma = _qtable(_K1_LUMA_ZZ, quality)
    qt_chroma = _qtable(_K2_CHROMA_ZZ, quality)

    planes = []
    for ci in range(ncomp):
        h, v = hs[ci], vs[ci]
        # Component resolution per T.81 A.1.1: ceil(dim * f / f_max),
        # box-average downsample then edge-pad to the padded MCU grid.
        cw = -(-W * h // h_max)
        ch = -(-H * v // v_max)
        fx, fy = h_max // h, v_max // v
        if h_max % h or v_max % v:
            raise ValueError("non-integer sampling ratio")
        src = ycc[ci]
        # pad source so it divides by (fy, fx), edge mode
        py, px = -(-src.shape[0] // fy) * fy, -(-src.shape[1] // fx) * fx
        src = np.pad(src, ((0, py - src.shape[0]), (0, px - src.shape[1])),
                     mode="edge")
        sub = src.reshape(py // fy, fy, px // fx, fx).mean(axis=(1, 3))
        sub = sub[:ch, :cw]
        # pad to the padded block grid (mcus * factor blocks)
        rows, cols = mcus_y * v, mcus_x * h
        sub = np.pad(sub, ((0, rows * 8 - ch), (0, cols * 8 - cw)),
                     mode="edge")
        qt = qt_luma if ci == 0 else qt_chroma
        planes.append(_fdct_quantize(sub, qt, center=1 << (precision - 1)))

    # ---- entropy-code the scan(s) ----
    specs = []
    for ci in range(ncomp):
        if precision == 12:
            specs.append((_huff_maps(EXT_DC), _huff_maps(EXT_AC)))
        elif ci == 0:
            specs.append((_huff_maps(STD_DC_LUMA), _huff_maps(STD_AC_LUMA)))
        else:
            specs.append((_huff_maps(STD_DC_CHROMA),
                          _huff_maps(STD_AC_CHROMA)))
    n_mcus = mcus_x * mcus_y

    # Arithmetic conditioning per table id (T.81 defaults L=0, U=1, Kx=5).
    dac = dac or {}
    dc_cond = dict(dac.get("dc", {}))
    ac_cond = dict(dac.get("ac", {}))

    def encode_scan_group_arith(group):
        """QM-arithmetic entropy bytes (with RSTn markers) for one scan.

        Mirror of the Huffman path below, driving the Annex D encoder in
        the port's entropy.arith; statistics/predictors reset and the
        coder flushes at every restart boundary (F.1.4.1.1), so segments
        stay independently decodable."""
        from ..entropy.arith import (
            QMEncoder, _ScanState, _encode_ac_block, _encode_dc)

        if len(group) > 1:
            units = n_mcus
        else:
            ci = group[0]
            cw = -(-W * hs[ci] // h_max)
            ch = -(-H * vs[ci] // v_max)
            rows_u, cols_u = -(-ch // 8), -(-cw // 8)
            units = rows_u * cols_u
            p = planes[ci]
            p[rows_u:, :] = 0
            p[:, cols_u:] = 0
        out = bytearray()
        enc = QMEncoder()
        st8 = _ScanState(n_comps=ncomp)
        rst = 0
        for m in range(units):
            if restart_interval and m and m % restart_interval == 0:
                out += enc.flush()
                out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) % 8
                enc = QMEncoder()
                st8 = _ScanState(n_comps=ncomp)
            if len(group) > 1:
                my, mx = divmod(m, mcus_x)
                for ci in group:
                    h, v = hs[ci], vs[ci]
                    tid = 0 if ci == 0 else 1
                    l_param, u_param = dc_cond.get(tid, (0, 1))
                    kx = ac_cond.get(tid, 5)
                    for bv in range(v):
                        for bh in range(h):
                            blk = planes[ci][my * v + bv, mx * h + bh]
                            _encode_dc(enc, st8, tid, ci, l_param, u_param,
                                       int(blk[0]))
                            _encode_ac_block(enc, st8, tid, kx, blk)
            else:
                ci = group[0]
                tid = 0 if ci == 0 else 1
                l_param, u_param = dc_cond.get(tid, (0, 1))
                kx = ac_cond.get(tid, 5)
                r, c_ = divmod(m, cols_u)
                blk = planes[ci][r, c_]
                _encode_dc(enc, st8, tid, ci, l_param, u_param, int(blk[0]))
                _encode_ac_block(enc, st8, tid, kx, blk)
        out += enc.flush()
        return bytes(out)

    def encode_scan_group(group):
        """Returns the entropy bytes (with RSTn markers) for one scan."""
        bw = _BitWriter()
        rst = 0
        preds = [0] * len(group)
        if len(group) > 1:
            units = n_mcus
        else:
            ci = group[0]
            cw = -(-W * hs[ci] // h_max)
            ch = -(-H * vs[ci] // v_max)
            rows_u, cols_u = -(-ch // 8), -(-cw // 8)
            units = rows_u * cols_u
            # zero never-coded padded cells so planes == decode output
            p = planes[ci]
            p[rows_u:, :] = 0
            p[:, cols_u:] = 0
        for m in range(units):
            if restart_interval and m and m % restart_interval == 0:
                bw.align()
                bw.raw(bytes([0xFF, 0xD0 + rst]))
                rst = (rst + 1) % 8
                preds = [0] * len(group)
            if len(group) > 1:
                my, mx = divmod(m, mcus_x)
                for k, ci in enumerate(group):
                    h, v = hs[ci], vs[ci]
                    dc_map, ac_map = specs[ci]
                    for bv in range(v):
                        for bh in range(h):
                            blk = planes[ci][my * v + bv, mx * h + bh]
                            preds[k] = _encode_block(bw, blk, preds[k],
                                                     dc_map, ac_map)
            else:
                ci = group[0]
                dc_map, ac_map = specs[ci]
                r, c_ = divmod(m, cols_u)
                blk = planes[ci][r, c_]
                preds[0] = _encode_block(bw, blk, preds[0], dc_map, ac_map)
        bw.align()
        return bytes(bw.out)

    def encode_prog_scan_arith(group, ss, se, ah, al):
        """One progressive-arithmetic scan payload (DC first/refine
        interleaved over the MCU grid; AC first/refine single-component
        over the unpadded block grid, T.81 G.3)."""
        from ..entropy.arith import (
            QMEncoder, _ScanState, _encode_ac_block, _encode_ac_refine_block,
            _encode_dc)

        dc_scan = ss == 0
        if dc_scan:
            units = n_mcus
        else:
            ci = group[0]
            cw = -(-W * hs[ci] // h_max)
            ch = -(-H * vs[ci] // v_max)
            rows_u, cols_u = -(-ch // 8), -(-cw // 8)
            units = rows_u * cols_u
            # Non-interleaved AC scans never code padded cells: zero their
            # AC so `planes` matches what a decoder reconstructs.
            p = planes[ci]
            p[rows_u:, :, 1:] = 0
            p[:, cols_u:, 1:] = 0
        out = bytearray()
        enc = QMEncoder()
        st8 = _ScanState(n_comps=ncomp)
        rst = 0
        for m in range(units):
            if restart_interval and m and m % restart_interval == 0:
                out += enc.flush()
                out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) % 8
                enc = QMEncoder()
                st8 = _ScanState(n_comps=ncomp)
            if dc_scan:
                my, mx = divmod(m, mcus_x)
                for ci in group:
                    h, v = hs[ci], vs[ci]
                    tid = 0 if ci == 0 else 1
                    l_param, u_param = dc_cond.get(tid, (0, 1))
                    for bv in range(v):
                        for bh in range(h):
                            dc = int(planes[ci][my * v + bv, mx * h + bh, 0])
                            if ah == 0:
                                _encode_dc(enc, st8, tid, ci, l_param,
                                           u_param, dc >> al)
                            else:
                                enc.encode((dc >> al) & 1, st8.fixed, 0)
            else:
                ci = group[0]
                tid = 0 if ci == 0 else 1
                kx = ac_cond.get(tid, 5)
                r, c_ = divmod(m, cols_u)
                blk = planes[ci][r, c_]
                if ah == 0:
                    _encode_ac_block(enc, st8, tid, kx, blk, ss=ss, se=se,
                                     al=al)
                else:
                    _encode_ac_refine_block(enc, st8, tid, blk, ss, se, al)
        out += enc.flush()
        return bytes(out)

    if progressive:
        if not arithmetic:
            raise ValueError(
                "progressive emission is arithmetic-only here (use PIL for "
                "progressive Huffman fixtures)")
        if scans is not None:
            raise ValueError("progressive uses its own scan script")
        # Scan script: DC first (Al=1), per-component AC first (Al=1),
        # DC refine, per-component AC refine — all four scan kinds.
        script = [(tuple(range(ncomp)), 0, 0, 0, 1)]
        script += [((ci,), 1, 63, 0, 1) for ci in range(ncomp)]
        script += [(tuple(range(ncomp)), 0, 0, 1, 0)]
        script += [((ci,), 1, 63, 1, 0) for ci in range(ncomp)]
        scan_descs = [(g, ss, se, ah, al,
                       encode_prog_scan_arith(g, ss, se, ah, al))
                      for (g, ss, se, ah, al) in script]
    else:
        scan_groups = [tuple(range(ncomp))] if scans is None \
            else [tuple(g) for g in scans]
        scan_encoder = (encode_scan_group_arith if arithmetic
                        else encode_scan_group)
        scan_descs = [(g, 0, 63, 0, 0, scan_encoder(g))
                      for g in scan_groups]

    # ---- markers ----
    out = io.BytesIO()
    out.write(b"\xff\xd8")  # SOI
    if app14_transform is not None:
        # Adobe streams carry APP14, not JFIF (JFIF would force the
        # 3-component case back to YCbCr in libjpeg's heuristics).
        out.write(b"\xff\xee" + struct.pack(">H", 14) + b"Adobe"
                  + struct.pack(">HHHB", 100, 0, 0, app14_transform))
    else:
        out.write(b"\xff\xe0" + struct.pack(">H", 16)
                  + b"JFIF\x00\x01\x01\x00" + struct.pack(">HH", 1, 1)
                  + b"\x00\x00")

    def dqt(tid, nat):
        # wire order is zigzag: raw[i] = nat[ZIGZAG[i]]
        raw = nat[ZIGZAG].astype(np.uint8)
        out.write(b"\xff\xdb" + struct.pack(">H", 67) + bytes([tid])
                  + raw.tobytes())

    dqt(0, qt_luma)
    if ncomp > 1:
        dqt(1, qt_chroma)

    sof = struct.pack(">BHHB", precision, H, W, ncomp)
    for ci in range(ncomp):
        cid = ci if zero_based_ids else ci + 1
        sof += bytes([cid, (hs[ci] << 4) | vs[ci], 0 if ci == 0 else 1])
    sof_marker = (b"\xff\xca" if progressive
                  else b"\xff\xc9" if arithmetic
                  else b"\xff\xc1" if precision == 12 else b"\xff\xc0")
    out.write(sof_marker + struct.pack(">H", 2 + len(sof)) + sof)

    if arithmetic:
        # DAC (B.2.4.3): only needed for non-default conditioning.
        pairs = bytearray()
        for tid, (l_param, u_param) in sorted(dc_cond.items()):
            pairs += bytes([tid, (u_param << 4) | l_param])
        for tid, kx in sorted(ac_cond.items()):
            pairs += bytes([0x10 | tid, kx])
        if pairs:
            out.write(b"\xff\xcc" + struct.pack(">H", 2 + len(pairs))
                      + bytes(pairs))
    else:
        def dht(tc, tid, spec):
            payload = bytes([(tc << 4) | tid]) + spec.counts.tobytes() \
                + spec.symbols.tobytes()
            out.write(b"\xff\xc4" + struct.pack(">H", 2 + len(payload))
                      + payload)

        if precision == 12:
            dht(0, 0, EXT_DC)
            dht(1, 0, EXT_AC)
            if ncomp > 1:
                dht(0, 1, EXT_DC)
                dht(1, 1, EXT_AC)
        else:
            dht(0, 0, STD_DC_LUMA)
            dht(1, 0, STD_AC_LUMA)
            if ncomp > 1:
                dht(0, 1, STD_DC_CHROMA)
                dht(1, 1, STD_AC_CHROMA)

    if restart_interval:
        out.write(b"\xff\xdd" + struct.pack(">HH", 4, restart_interval))

    for group, ss, se, ah, al, payload in scan_descs:
        sos = bytes([len(group)])
        for ci in group:
            cid = ci if zero_based_ids else ci + 1
            t = 0 if ci == 0 else 0x11
            sos += bytes([cid, t])
        sos += bytes([ss, se, (ah << 4) | al])
        out.write(b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos)
        out.write(payload)
    out.write(b"\xff\xd9")  # EOI
    return out.getvalue(), planes


def encode_swapped_tables(*args, **kw):
    """:func:`encode` with the luma and chroma Huffman tables exchanged (8-bit
    frames): a valid stream whose table set differs from :func:`encode`'s,
    for tests of decoders that take several table sets at once.  It swaps
    this module's tables while it runs: do not call it from two threads."""
    global STD_DC_LUMA, STD_AC_LUMA, STD_DC_CHROMA, STD_AC_CHROMA
    std = (STD_DC_LUMA, STD_AC_LUMA, STD_DC_CHROMA, STD_AC_CHROMA)
    STD_DC_LUMA, STD_AC_LUMA, STD_DC_CHROMA, STD_AC_CHROMA = (
        std[2], std[3], std[0], std[1])
    try:
        return encode(*args, **kw)
    finally:
        STD_DC_LUMA, STD_AC_LUMA, STD_DC_CHROMA, STD_AC_CHROMA = std
