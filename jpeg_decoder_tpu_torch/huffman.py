"""Canonical Huffman code generation and flat decode-LUT construction.

A numpy-only copy of ``jpeg_decoder_tpu/huffman.py`` (see types.py for why
the port keeps copies).  The native entropy decoder takes these LUTs.

The reference decodes one bit at a time and linearly scans all codes of the
current length (jpeg.cpp:300-320 — the innermost hot loop).  The LUT
replaces that with an O(1) probe: peek the next 16 bits, index a flat 2^16
lookup table, obtain ``(symbol, code_length)`` in one load.

LUT encoding: ``lut[idx] = (symbol << 5) | length`` as int32 (actually uint16
fits: symbol is 8 bits, length <= 16 needs 5 bits).  ``length == 0`` marks an
invalid prefix (no code matches), which a well-formed stream never hits.
"""

from __future__ import annotations

import numpy as np

from .types import HuffmanSpec, JPEGError

LUT_BITS = 16
LUT_SIZE = 1 << LUT_BITS


def canonical_codes(spec: HuffmanSpec) -> tuple[np.ndarray, np.ndarray]:
    """Assign canonical codes exactly as the reference does.

    Parity: HuffmanTable::generateCodes (reference huffman.hpp:17-28) —
    counting upward within each length, ``code <<= 1`` between lengths.

    Returns ``(codes, lengths)`` parallel to ``spec.symbols``.
    """
    counts = spec.counts.astype(np.int64)
    lengths = np.repeat(np.arange(1, 17, dtype=np.int32), counts)
    if len(lengths) != len(spec.symbols):
        raise JPEGError("DHT: counts/symbols mismatch")
    codes = np.zeros(len(lengths), dtype=np.uint32)
    code = 0
    k = 0
    for bitlen in range(1, 17):
        n = int(counts[bitlen - 1])
        for _ in range(n):
            codes[k] = code
            code += 1
            k += 1
        code <<= 1
    # Canonical-validity check: codes of length L must fit in L bits.
    if np.any(codes >> lengths.astype(np.uint32) != 0):
        raise JPEGError("DHT: over-subscribed Huffman table")
    return codes, lengths


_LUT16_CACHE: dict = {}
_LUT32AC_CACHE: dict = {}


def build_lut(spec: HuffmanSpec) -> np.ndarray:
    """Build the flat 2^16 decode LUT: ``lut[next16bits] = (symbol<<5)|len``.

    Every 16-bit window whose prefix equals a code maps to that code's
    (symbol, length).  Unreachable prefixes stay 0 (invalid).
    Returns an int32 array (int32 rather than uint16 for cheap device math).

    Tables repeat across scans, images and serving batches, so builds are
    memoized on the table bytes; the cached array is read-only (copy
    before mutating).
    """
    key = (spec.counts.tobytes(), spec.symbols.tobytes())
    lut = _LUT16_CACHE.get(key)
    if lut is None:
        codes, lengths = canonical_codes(spec)
        lut = np.zeros(LUT_SIZE, dtype=np.int32)
        for code, length, symbol in zip(codes, lengths, spec.symbols):
            shift = LUT_BITS - int(length)
            lo = int(code) << shift
            hi = lo + (1 << shift)
            lut[lo:hi] = (int(symbol) << 5) | int(length)
        lut.flags.writeable = False
        if len(_LUT16_CACHE) > 256:
            _LUT16_CACHE.clear()
        _LUT16_CACHE[key] = lut
    return lut


def build_ac_lut32(spec: HuffmanSpec) -> np.ndarray:
    """Combined-value AC decode LUT: one probe yields the fully decoded
    coefficient.

    For a 16-bit window ``w``: ``e = lut[w]`` packs
    ``(value << 13) | (run << 7) | (slow << 5) | total_bits`` where
    ``value`` is the sign-extended coefficient (the value bits are part of
    the same 16-bit window whenever ``code_len + size <= 16``, which is
    the overwhelmingly common case), ``run`` is the zero run (16 for ZRL,
    63 for EOB so the block loop exits), and ``total_bits`` is
    ``code_len + size`` — the decoder consumes code and value in one
    step, with no separate sign-extension.

    Slow entries (``slow`` bit set: ``code_len + size > 16`` or an
    invalid ``size > 10``) instead pack ``(symbol << 13) | 32 | code_len``
    and the decoder falls back to the two-step path.  ``e == 0`` marks an
    invalid prefix.

    Memoized like :func:`build_lut`; the cached array is read-only.
    """
    key = (spec.counts.tobytes(), spec.symbols.tobytes())
    out = _LUT32AC_CACHE.get(key)
    if out is not None:
        return out
    lut16 = build_lut(spec)
    lens = (lut16 & 31).astype(np.int64)
    syms = ((lut16 >> 5) & 0xFF).astype(np.int64)
    csize = syms & 15
    run = np.where(syms == 0, 63, np.where(syms == 0xF0, 16, syms >> 4))
    idx = np.arange(LUT_SIZE, dtype=np.int64)
    shift = np.maximum(16 - lens - csize, 0)
    vbits = (idx >> shift) & ((1 << csize) - 1)
    half = 1 << np.maximum(csize - 1, 0)
    value = np.where((csize > 0) & (vbits < half),
                     vbits - ((1 << csize) - 1), vbits)
    value = np.where(csize == 0, 0, value)
    total = lens + np.where((syms == 0) | (syms == 0xF0), 0, csize)
    fast = (lens + csize <= 16) & (csize <= 10)
    e_fast = (value << 13) | (run << 7) | total
    e_slow = (syms << 13) | 32 | lens
    out = np.where(lens == 0, 0, np.where(fast, e_fast, e_slow))
    out = out.astype(np.int32)
    out.flags.writeable = False
    if len(_LUT32AC_CACHE) > 256:
        _LUT32AC_CACHE.clear()
    _LUT32AC_CACHE[key] = out
    return out


# Standard tables from ITU-T T.81 Annex K.3 — used by the synthetic encoder
# (testing/encoder.py).
STD_DC_LUMA = HuffmanSpec(
    0, 0,
    np.array([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], np.uint8),
    np.arange(12, dtype=np.uint8),
)
STD_DC_CHROMA = HuffmanSpec(
    0, 1,
    np.array([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], np.uint8),
    np.arange(12, dtype=np.uint8),
)
_STD_AC_LUMA_SYMS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
STD_AC_LUMA = HuffmanSpec(
    1, 0,
    np.array([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], np.uint8),
    np.array(_STD_AC_LUMA_SYMS, np.uint8),
)
_STD_AC_CHROMA_SYMS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
STD_AC_CHROMA = HuffmanSpec(
    1, 1,
    np.array([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], np.uint8),
    np.array(_STD_AC_CHROMA_SYMS, np.uint8),
)
