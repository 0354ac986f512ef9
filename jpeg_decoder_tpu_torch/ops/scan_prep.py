"""Host-side scan preparation shared by the on-device entropy backends.

Packs unstuffed entropy bytes into per-segment big-endian uint32 word rows
(the layout both the block-lockstep decoder in :mod:`ops.entropy_flat` and
the Pallas kernel consume) and builds the per-component decode LUTs.
Restart segments are independent (DC predictors reset + byte alignment at
RSTn, jpeg.cpp:419-425), so each segment becomes one decoder lane.

A numpy-only copy of ``jpeg_decoder_tpu/ops/scan_prep.py`` (see types.py for
why the port keeps copies); here it feeds the CUDA entropy kernel
(``ops/entropy_cuda.py``).
"""

from __future__ import annotations

import numpy as np

from ..huffman import build_lut
from ..layout import scan_layout
from ..types import FrameHeader, JPEGError, ScanHeader


def pack_words(data: np.ndarray) -> np.ndarray:
    """Pack unstuffed bytes into big-endian uint32 words (host side)."""
    n = len(data)
    padded = np.zeros((n + 3 + 8) // 4 * 4, dtype=np.uint8)
    padded[:n] = data
    return padded.view(">u4").astype(np.uint32)


def _segment_rows(data: np.ndarray, off: np.ndarray, row_bytes: int,
                  padded: np.ndarray | None = None) -> np.ndarray:
    """(S, row_bytes) uint8: row s holds bytes ``data[off[s]:off[s+1]]``
    (a row no longer than ``row_bytes``), zero past them.  ``padded``,
    where given, is ``data`` followed by zeros (the parser's
    ``data_padded``); where its zeros reach past the last row, the rows are
    read from it, and a single segment's row is a view of it.  Otherwise
    the bytes are copied into a zero buffer first.  Many segments take one
    gather of ``row_bytes`` windows at their offsets, then a mask over
    every row but the last (the zeros already end that one)."""
    lo, hi = int(off[0]), int(off[-1])
    start = off[:-1] - lo
    end = int(start[-1]) + row_bytes
    if padded is not None and hi == len(data) and lo + end <= len(padded):
        src = padded[lo:lo + end]
    else:
        src = np.zeros(end, np.uint8)
        src[:hi - lo] = data[lo:hi]
    if len(start) == 1:
        return src[None, :row_bytes]
    rows = np.lib.stride_tricks.sliding_window_view(src, row_bytes)[start]
    rows[:-1][np.arange(row_bytes) >= np.diff(off)[:-1, None]] = 0
    return rows


def _zero_tail(scan: ScanHeader, data: np.ndarray) -> np.ndarray | None:
    """The scan's ``data_padded`` where it still begins at ``data`` (a
    caller may replace ``data`` alone), else None."""
    dp = getattr(scan, "data_padded", None)
    if (dp is None or len(dp) < len(data) or dp.__array_interface__["data"][0]
            != data.__array_interface__["data"][0]):
        return None
    return dp


def prepare_scan(hdr: FrameHeader, scan: ScanHeader):
    """Host prep: per-segment packed words + geometry (NumPy, cheap).

    Returns (words (S, W) uint32, nm (S,) int32 MCUs per segment,
    block_comp, max_mcus, layout)."""
    lay = scan_layout(hdr)
    ri = scan.restart_interval
    n_mcus = lay.n_mcus
    seg_offsets = scan.seg_offsets
    n_segments = len(seg_offsets) - 1
    expected = -(-n_mcus // ri) if ri else 1
    if n_segments != expected:
        raise JPEGError(
            f"restart-segment count {n_segments} does not match DRI {ri}")
    max_mcus = ri if ri else n_mcus
    off = np.asarray(seg_offsets, np.int64)
    seg_lens = np.diff(off)
    seg_words = int(max(1, -(-int(seg_lens.max()) // 4) + 2))
    data = np.asarray(scan.data, np.uint8)
    words = _segment_rows(data, off, 4 * seg_words,
                          _zero_tail(scan, data)).view(">u4").astype(np.uint32)
    nm = np.full((n_segments,), max_mcus, np.int32)
    if ri:
        nm[-1] = n_mcus - ri * (n_segments - 1)
    block_comp = tuple(
        ci for ci, c in enumerate(hdr.components) for _ in range(c.v * c.h))
    return words, nm, block_comp, max_mcus, lay


def luts_for_scan(hdr: FrameHeader, scan: ScanHeader):
    """Per-component (n_comps, 65536) DC/AC decode LUTs."""
    dc = np.stack([build_lut(scan.dc_specs[c.td]) for c in hdr.components])
    ac = np.stack([build_lut(scan.ac_specs[c.ta]) for c in hdr.components])
    return dc, ac
