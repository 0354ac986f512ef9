"""Test-only writer of progressive DC first scans with a chosen Huffman
table (numpy only).

PIL's DC tables have no code longer than 11 bits, so a real file never
reaches K8a's second-level tables.  :func:`rewrite_dc_first` writes a DC
first scan (T.81 G.1.2.1) anew from the planes it must leave, with one of
the tables of :func:`dc_spec`: ``"long"`` gives the sizes a decoder meets
most codes of 12 to 16 bits, ``"wide"`` adds filler symbols whose 12-bit
codes use more 11-bit prefixes than the compact tables keep, so that some
probes read the LUT in device memory.  The scan's bytes are the clean
entropy-coded data (no stuffing, no markers), padded with 1 bits, in one
segment.
"""

from __future__ import annotations

import copy

import numpy as np

from ..huffman import canonical_codes
from ..types import HuffmanSpec

#: DC size categories by code length (1..16) of the "long" table: the sizes
#: of smooth images' differences get the long codes.
_LONG = {2: [0], 3: [1, 2], 12: [3], 13: [4], 14: [5], 15: [6], 16: [7, 8, 9,
                                                                    10, 11]}


def dc_spec(kind: str) -> HuffmanSpec:
    """The ``"long"`` or ``"wide"`` DC table (see the module docstring)."""
    by_len = {k: list(v) for k, v in _LONG.items()}
    if kind == "wide":
        # 130 codes of 12 bits before size 3's: 65 prefixes of 11 bits.
        by_len[12] = list(range(16, 146)) + by_len[12]
    elif kind != "long":
        raise ValueError(f"no {kind!r} DC table")
    counts = np.zeros(16, np.uint8)
    symbols = []
    for length in sorted(by_len):
        counts[length - 1] = len(by_len[length])
        symbols += by_len[length]
    return HuffmanSpec(0, 0, counts, np.asarray(symbols, np.uint8))


def rewrite_dc_first(hdr, scan, after: list, spec: HuffmanSpec):
    """A copy of DC first ``scan`` of frame ``hdr`` written anew with
    ``spec`` for every component, so that it leaves ``after``: the frame's
    (rows + 1, 64) planes, one per component, after the scan."""
    from ..ops import entropy_prog as ep

    cis, geom = ep.scan_geometry(hdr, scan)
    codes, lengths = canonical_codes(spec)
    code_of = {int(s): (int(c), int(n))
               for s, c, n in zip(spec.symbols, codes, lengths)}
    bits: list = []
    prev = [0] * 4
    for m in range(ep.scan_units(hdr, scan)):
        my, mx = divmod(m, geom.mx_div)
        for p, v, jv, h, jh, c in geom.slots:
            row = (my * v + jv) * geom.pcols[p] + mx * h + jh
            pred = int(after[cis[p]][row, 0]) >> scan.al
            diff, prev[c] = pred - prev[c], pred
            size = abs(diff).bit_length()
            bits.append(code_of[size])
            if size:
                bits.append((diff if diff >= 0 else diff + (1 << size) - 1,
                             size))
    stream = "".join(format(value, f"0{n}b") for value, n in bits)
    stream += "1" * (-len(stream) % 8)
    data = np.packbits(np.frombuffer(stream.encode(), np.uint8) - ord("0"))
    out = copy.copy(scan)
    out.data = data
    out.data_padded = None
    out.seg_offsets = np.array([0, len(data)], np.int64)
    out.restart_interval = 0
    out.dc_specs = {t: spec for t in set(scan.dc_table_ids)}
    return out
