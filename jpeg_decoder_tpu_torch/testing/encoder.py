"""Minimal baseline JPEG encoder (pure NumPy) for tests and the smoke run.

The baseline-Huffman path of ``tools/encoder.py`` (``encode`` with
``samplings``, ``quality`` and ``restart_interval``), importing the port's
own ``huffman``/``types`` so that it runs where neither jax nor PIL is
installed.  For the same arguments it writes the same bytes as
``tools/encoder.encode`` (tests/test_torch_host.py).

Not a product surface — deliberately simple (float64 matrix FDCT, standard
Annex K tables only, one interleaved scan, JFIF marker).
"""

from __future__ import annotations

import io
import struct

import numpy as np

from ..huffman import (
    STD_AC_CHROMA, STD_AC_LUMA, STD_DC_CHROMA, STD_DC_LUMA, canonical_codes)
from ..types import ZIGZAG

# Annex K.1 luminance / K.2 chrominance base quantization tables (zig-zag
# order).
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


def qtable(quality: int, chroma: bool = False) -> np.ndarray:
    """libjpeg quality scaling of the Annex K table; NATURAL-order (64,)."""
    base_zz = _K2_CHROMA_ZZ if chroma else _K1_LUMA_ZZ
    quality = max(1, min(100, quality))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = np.clip((base_zz * scale + 50) // 100, 1, 255)
    nat = np.empty(64, np.int64)
    nat[ZIGZAG] = q  # de-zigzag, parser convention (natural-order storage)
    return nat


# Orthonormal DCT-II matrix (rows = frequencies), float64.
_C = np.zeros((8, 8))
for _k in range(8):
    for _n in range(8):
        _C[_k, _n] = np.cos((2 * _n + 1) * _k * np.pi / 16) * (
            np.sqrt(1 / 8) if _k == 0 else np.sqrt(2 / 8))


def _fdct_quantize(plane: np.ndarray, qtable_nat: np.ndarray) -> np.ndarray:
    """(rows*8, cols*8) samples -> (rows, cols, 64) quantized coefficients:
    F = C (X - 128) C^T with the orthonormal DCT matrix."""
    r8, c8 = plane.shape
    x = plane.astype(np.float64) - 128.0
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
        # Drop emitted high bits or acc grows into an ever-larger bigint.
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
           quality: int = 85, restart_interval: int = 0):
    """Encode an (H, W, 3) uint8 RGB array as a baseline JFIF JPEG.

    samplings: per-component (h, v), h/v in 1..4, sum(h*v) <= 10.

    Returns (jpeg_bytes, planes) where planes[i] is the (rows_i, cols_i, 64)
    int32 quantized coefficient array actually entropy-coded (padded to the
    MCU grid) — the exact round-trip expectation for the decoder.
    """
    rgbf = np.asarray(rgb, np.float64)
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    ycc = [y, cb, cr]
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

    qt_luma = qtable(quality)
    qt_chroma = qtable(quality, chroma=True)

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
        py, px = -(-src.shape[0] // fy) * fy, -(-src.shape[1] // fx) * fx
        src = np.pad(src, ((0, py - src.shape[0]), (0, px - src.shape[1])),
                     mode="edge")
        sub = src.reshape(py // fy, fy, px // fx, fx).mean(axis=(1, 3))
        sub = sub[:ch, :cw]
        rows, cols = mcus_y * v, mcus_x * h
        sub = np.pad(sub, ((0, rows * 8 - ch), (0, cols * 8 - cw)),
                     mode="edge")
        qt = qt_luma if ci == 0 else qt_chroma
        planes.append(_fdct_quantize(sub, qt))

    specs = [(_huff_maps(STD_DC_LUMA), _huff_maps(STD_AC_LUMA))] + [
        (_huff_maps(STD_DC_CHROMA), _huff_maps(STD_AC_CHROMA))] * (ncomp - 1)

    # ---- entropy-code the single interleaved scan ----
    bw = _BitWriter()
    rst = 0
    preds = [0] * ncomp
    for m in range(mcus_x * mcus_y):
        if restart_interval and m and m % restart_interval == 0:
            bw.align()
            bw.raw(bytes([0xFF, 0xD0 + rst]))
            rst = (rst + 1) % 8
            preds = [0] * ncomp
        my, mx = divmod(m, mcus_x)
        for ci in range(ncomp):
            h, v = hs[ci], vs[ci]
            dc_map, ac_map = specs[ci]
            for bv in range(v):
                for bh in range(h):
                    blk = planes[ci][my * v + bv, mx * h + bh]
                    preds[ci] = _encode_block(bw, blk, preds[ci],
                                              dc_map, ac_map)
    bw.align()
    payload = bytes(bw.out)

    # ---- markers ----
    out = io.BytesIO()
    out.write(b"\xff\xd8")  # SOI
    out.write(b"\xff\xe0" + struct.pack(">H", 16)
              + b"JFIF\x00\x01\x01\x00" + struct.pack(">HH", 1, 1)
              + b"\x00\x00")

    def dqt(tid, nat):
        # wire order is zigzag: raw[i] = nat[ZIGZAG[i]]
        raw = nat[ZIGZAG].astype(np.uint8)
        out.write(b"\xff\xdb" + struct.pack(">H", 67) + bytes([tid])
                  + raw.tobytes())

    dqt(0, qt_luma)
    dqt(1, qt_chroma)

    sof = struct.pack(">BHHB", 8, H, W, ncomp)
    for ci in range(ncomp):
        sof += bytes([ci + 1, (hs[ci] << 4) | vs[ci], 0 if ci == 0 else 1])
    out.write(b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof)

    def dht(tc, tid, spec):
        payload = bytes([(tc << 4) | tid]) + spec.counts.tobytes() \
            + spec.symbols.tobytes()
        out.write(b"\xff\xc4" + struct.pack(">H", 2 + len(payload))
                  + payload)

    dht(0, 0, STD_DC_LUMA)
    dht(1, 0, STD_AC_LUMA)
    dht(0, 1, STD_DC_CHROMA)
    dht(1, 1, STD_AC_CHROMA)

    if restart_interval:
        out.write(b"\xff\xdd" + struct.pack(">HH", 4, restart_interval))

    sos = bytes([ncomp])
    for ci in range(ncomp):
        sos += bytes([ci + 1, 0 if ci == 0 else 0x11])
    sos += bytes([0, 63, 0])
    out.write(b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos)
    out.write(payload)
    out.write(b"\xff\xd9")  # EOI
    return out.getvalue(), planes
