"""Test-only writer of single progressive AC scans over any band (numpy only).

PIL's progressive script refines only the band 1..63, so a real file never
reaches a partial-band refinement.  This module writes one AC first scan
(T.81 G.1.2.2) or one AC refinement scan (G.1.2.3) of one component from
chosen coefficients, with a Huffman table made for it, in the order libjpeg's
``encode_mcu_AC_first``/``encode_mcu_AC_refine`` emit: EOB runs held until
the next symbol, up to 0x7FFF blocks, and a refinement's correction bits
buffered behind the next symbol, ZRL or EOB run.  The scan's bytes are the
clean entropy-coded data (no stuffing, no markers), padded with 1 bits.

It also records, for every block, the decoder state at its start (the bit
position and the pending EOB run, as the progressive lanes take them), so
that a test can cut chained lanes anywhere, inside EOB runs too
(:func:`lanes_at`).

Coefficients are given per block in zigzag index order, (n_blocks, 64).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np

from ..huffman import canonical_codes
from ..types import HuffmanSpec

EOBRUN_MAX = 0x7FFF
#: Correction bits a refinement scan buffers before it flushes its EOB run
#: (libjpeg's MAX_CORR_BITS - DCTSIZE2 + 1).
MAX_BUFFERED = 1000 - 64 + 1


class AcScan(NamedTuple):
    data: np.ndarray      # (n,) uint8 scan bytes
    spec: HuffmanSpec     # the scan's AC table
    starts: np.ndarray    # (n_blocks,) int64 bit position at each block
    eobs: np.ndarray      # (n_blocks,) int32 pending EOB run at each block
    n_bits: int           # bits before the padding


def _size(v: int) -> int:
    return int(abs(v)).bit_length()


class _Tokens:
    """The scan as tokens: ("sym", s), ("bits", value, n), ("start", b,
    eob); written to bits once the table is known."""

    def __init__(self):
        self.out: list = []
        self.eobrun = 0
        self.run_blocks: list = []    # (block, started, correction bits)
        self.buffered: list = []      # correction bits behind the EOB run

    def sym(self, s: int) -> None:
        self.out.append(("sym", s))

    def bits(self, value: int, n: int) -> None:
        if n:
            self.out.append(("bits", int(value) & ((1 << n) - 1), n))

    def start(self, b: int, eob: int) -> None:
        self.out.append(("start", b, eob))

    def join_run(self, b: int, started: bool, corr: list) -> None:
        self.eobrun += 1
        self.run_blocks.append((b, started, list(corr)))
        self.buffered += corr

    def flush(self) -> None:
        """Emit the pending EOB run: its symbol and bits, then each block's
        buffered correction bits, with the start state of every block of
        the run that had none yet."""
        if not self.eobrun:
            return
        n = self.eobrun
        r = n.bit_length() - 1
        b1, started1, _ = self.run_blocks[0]
        if not started1:
            self.start(b1, 0)
        self.sym(r << 4)
        self.bits(n - (1 << r), r)
        for i, (b, started, corr) in enumerate(self.run_blocks):
            if i and not started:
                self.start(b, n - i)
            for c in corr:
                self.bits(c, 1)
        self.eobrun = 0
        self.run_blocks = []
        self.buffered = []


def _first_tokens(amps: np.ndarray, ss: int, se: int) -> _Tokens:
    tk = _Tokens()
    for b in range(amps.shape[0]):
        started = False
        r = 0
        for k in range(ss, se + 1):
            v = int(amps[b, k])
            if v == 0:
                r += 1
                continue
            tk.flush()
            if not started:
                tk.start(b, 0)
                started = True
            while r > 15:
                tk.sym(0xF0)
                r -= 16
            n = _size(v)
            tk.sym((r << 4) | n)
            tk.bits(v if v > 0 else v - 1, n)
            r = 0
        if r > 0:
            tk.join_run(b, started, [])
            if tk.eobrun == EOBRUN_MAX:
                tk.flush()
    tk.flush()
    return tk


def _refine_tokens(history: np.ndarray, corr: np.ndarray, new: np.ndarray,
                   ss: int, se: int) -> _Tokens:
    tk = _Tokens()
    for b in range(history.shape[0]):
        news = [k for k in range(ss, se + 1) if new[b, k]]
        last_new = news[-1] if news else -1
        started = False
        r = 0
        br: list = []

        def begin():
            nonlocal started
            tk.flush()
            if not started:
                tk.start(b, 0)
                started = True

        for k in range(ss, se + 1):
            if history[b, k] == 0 and new[b, k] == 0:
                r += 1
                continue
            while r > 15 and k <= last_new:
                begin()
                tk.sym(0xF0)
                r -= 16
                for c in br:
                    tk.bits(c, 1)
                br = []
            if history[b, k] != 0:
                br.append(int(corr[b, k]) & 1)
                continue
            begin()
            tk.sym((r << 4) | 1)
            tk.bits(1 if new[b, k] > 0 else 0, 1)
            for c in br:
                tk.bits(c, 1)
            br = []
            r = 0
        if r > 0 or br:
            tk.join_run(b, started, br)
            if tk.eobrun == EOBRUN_MAX or len(tk.buffered) > MAX_BUFFERED:
                tk.flush()
    tk.flush()
    return tk


def _table(tokens: list, table: str) -> HuffmanSpec:
    """A table for the symbols used: ``flat``, every code of one length;
    ``long``, the three most used symbols 2 bits, the fourth 3 and the rest
    16 (codes longer than 11 bits, whose decode needs a second level);
    ``wide``, the most used symbol 2 bits and every other byte value 12
    (128 prefixes of 11 bits with longer codes: more second levels than
    K8c/K8d keep, so some probes read the full table)."""
    freq = Counter(t[1] for t in tokens if t[0] == "sym")
    syms = sorted(freq, key=lambda s: (-freq[s], s)) or [0]
    counts = np.zeros(16, np.uint8)
    if table == "wide":
        # The unused values take the first 12-bit codes, so the used ones
        # lie past the kept second levels.
        syms = syms[:1] + [v for v in range(256) if v not in freq] + syms[1:]
        counts[1], counts[11] = 1, 255
    elif table == "flat":
        counts[max(1, int(np.ceil(np.log2(len(syms) + 1)))) - 1] = len(syms)
    elif table == "long":
        counts[1] = min(3, len(syms))
        counts[2] = 1 if len(syms) > 3 else 0
        counts[15] = max(0, len(syms) - 4)
    else:
        raise ValueError(f"unknown table kind {table!r}")
    return HuffmanSpec(table_class=1, table_id=0, counts=counts,
                       symbols=np.array(syms, np.uint8))


def _write(tk: _Tokens, n_blocks: int, table: str) -> AcScan:
    spec = _table(tk.out, table)
    codes, lengths = canonical_codes(spec)
    code = {int(s): (int(c), int(n))
            for s, c, n in zip(spec.symbols, codes, lengths)}
    bits: list = []
    starts = np.full(n_blocks, -1, np.int64)
    eobs = np.zeros(n_blocks, np.int32)
    for t in tk.out:
        if t[0] == "start":
            starts[t[1]], eobs[t[1]] = len(bits), t[2]
            continue
        value, n = code[t[1]] if t[0] == "sym" else (t[1], t[2])
        bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]
    if (starts < 0).any():
        raise AssertionError("a block got no start state")
    n_bits = len(bits)
    bits += [1] * (-len(bits) % 8)
    data = np.packbits(np.array(bits, np.uint8)) if bits else \
        np.zeros(0, np.uint8)
    return AcScan(data, spec, starts, eobs, n_bits)


def ac_first_scan(amps: np.ndarray, *, ss: int, se: int,
                  table: str = "flat") -> AcScan:
    """An AC first scan of ``amps`` (n_blocks, 64) int, zigzag order: the
    coefficients before the point transform (the decoder stores
    ``amp << al``); positions outside ss..se are ignored."""
    amps = np.asarray(amps)
    return _write(_first_tokens(amps, ss, se), amps.shape[0], table)


def ac_refine_scan(history: np.ndarray, corr: np.ndarray, new: np.ndarray,
                   *, ss: int, se: int, table: str = "flat") -> AcScan:
    """An AC refinement scan over ``history`` (n_blocks, 64), zigzag order
    (nonzero: the position has history): ``corr`` the correction bit of
    each nonzero-history band position (0 or 1), ``new`` the sign of each
    new coefficient at a zero-history band position (+1, -1; 0 for none)."""
    history = np.asarray(history)
    return _write(_refine_tokens(history, np.asarray(corr), np.asarray(new),
                                 ss, se), history.shape[0], table)


def lanes_at(scan: AcScan, edges) -> tuple:
    """Chained lanes cut at blocks ``edges`` (increasing, first 0, last
    n_blocks): the (base_bits, n_per, first, eob0, pred0) table of
    ``ops/entropy_prog.scan_inputs``."""
    edges = np.asarray(edges, np.int64)
    first = edges[:-1]
    n = len(scan.starts)
    base = np.where(first < n, scan.starts[np.minimum(first, n - 1)],
                    scan.n_bits)
    eob0 = np.where(first < n, scan.eobs[np.minimum(first, n - 1)], 0)
    return (base.astype(np.int64), np.diff(edges).astype(np.int32),
            first, eob0.astype(np.int32),
            np.zeros((len(first), 1), np.int32))


class BandCase(NamedTuple):
    hdr: object           # a gray frame's FrameHeader
    scan: object          # its scan, made the written AC scan
    prior: np.ndarray     # (n, 64) int32 natural order, before the scan
    post: np.ndarray      # after it, as written
    lanes: tuple          # chained lanes cut at random blocks
    written: AcScan


def band_case(kind: str, ss: int, se: int, al: int, table: str, seed: int,
              rows: int = 9, cols: int = 11) -> BandCase:
    """A gray frame of rows x cols blocks with one seeded AC scan of
    ``kind`` ("first" or "refine") over band ss..se at point transform
    ``al``: random new coefficients (about 45% of the blocks join EOB
    runs), and for a refinement a random prior history (multiples of
    2^(al+1)) with random correction bits.  Positions outside the band
    hold random values the scan must leave alone.  Lanes are cut at 7
    random blocks, inside EOB runs too."""
    from ..io import parser
    from ..testing.encoder import encode
    from ..types import ZIGZAG

    rng = np.random.default_rng(seed)
    n = rows * cols
    band = np.zeros(64, bool)
    band[ss:se + 1] = True
    empty = rng.random(n) < 0.45
    sign = rng.choice([-1, 1], (n, 64))
    prior = np.where(band, 0, rng.integers(-50, 50, (n, 64)))
    if kind == "first":
        amps = np.where(band & (rng.random((n, 64)) < 0.3),
                        rng.integers(1, 200, (n, 64)) * sign, 0)
        amps[empty] = 0
        written = ac_first_scan(amps, ss=ss, se=se, table=table)
        post = prior + (amps << al)
    else:
        hist = np.where(band & (rng.random((n, 64)) < 0.35),
                        rng.integers(1, 6, (n, 64)) * sign << (al + 1), 0)
        hist[rng.random(n) < 0.3] = 0
        corr = ((rng.random((n, 64)) < 0.5) & (hist != 0)).astype(np.int32)
        new = np.where(band & (hist == 0) & (rng.random((n, 64)) < 0.12),
                       rng.choice([-1, 1], (n, 64)), 0)
        new[empty] = 0
        written = ac_refine_scan(hist, corr, new, ss=ss, se=se, table=table)
        prior = prior + hist
        post = prior.copy()
        fix = (corr == 1) & ((prior & (1 << al)) == 0)
        post[fix] += np.sign(prior[fix]) << al
        post[new != 0] = new[new != 0] << al

    def natural(zz):
        out = np.zeros((n, 64), np.int32)
        out[:, ZIGZAG] = zz
        return out

    hdr = parser.parse(encode(np.full((8 * rows, 8 * cols), 128, np.uint8),
                              grayscale=True, samplings=((1, 1),))[0])
    set_scan(hdr.scans[0], written, kind, ss, se, al)
    edges = np.unique(np.concatenate([[0, n], rng.integers(1, n, 7)]))
    return BandCase(hdr, hdr.scans[0], natural(prior), natural(post),
                    lanes_at(written, edges), written)


def set_scan(scan, written: AcScan, kind: str, ss: int, se: int, al: int,
             spec=None) -> None:
    """Make a parsed frame's one-component scan the written one (one
    segment, table id 0; ``spec``: the table as another package's
    HuffmanSpec, default the written one)."""
    scan.ss, scan.se, scan.al = ss, se, al
    scan.ah = al + 1 if kind == "refine" else 0
    scan.data = written.data
    scan.data_padded = np.concatenate([written.data, np.zeros(256, np.uint8)])
    scan.seg_offsets = np.array([0, len(written.data)], np.int64)
    scan.restart_interval = 0
    scan.ac_table_ids = [0]
    scan.ac_specs = {0: written.spec if spec is None else spec}
