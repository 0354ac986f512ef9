"""Progressive JPEG entropy decoding (spectral selection + successive
approximation), ITU-T T.81 Annex G.2.

A numpy-only copy of ``jpeg_decoder_tpu/entropy/progressive.py`` (see
types.py for why the port keeps copies), held to it by
tests/test_torch_fallback.py: DC first/refinement scans (interleaved or
single-component), AC first/refinement scans (always single-component) with
EOB-run handling, restart-interval support in every scan type.

Output: per-component quantized coefficient planes on the padded dense block
grid — the same stage boundary as the baseline backends, so the device pixel
pipeline is shared unchanged.  This pure-Python decoder is the oracle and
the ``python`` backend for progressive frames; the native fast path is
``native.decode_progressive``.
"""

from __future__ import annotations

import numpy as np

from ..huffman import build_lut
from ..layout import comp_dims_unpadded
from ..types import FrameHeader, JPEGError, ScanHeader, ZIGZAG
from .python_ref import BitReader, receive_extend

_ZZ = ZIGZAG.tolist()


def _iter_segments(scan: ScanHeader, n_mcus: int):
    """Yield (BitReader, mcu_count) per restart segment."""
    data = scan.data.tobytes()
    offs = scan.seg_offsets
    n_segments = len(offs) - 1
    ri = scan.restart_interval
    expected = -(-n_mcus // ri) if ri else 1
    if n_segments != expected:
        raise JPEGError(
            f"scan: segment count {n_segments} != expected {expected} "
            f"(DRI {ri}, {n_mcus} MCUs)")
    done = 0
    for s in range(n_segments):
        reader = BitReader(data, int(offs[s]), int(offs[s + 1]))
        n = min(ri, n_mcus - done) if ri else n_mcus
        yield reader, n
        done += n


def _dc_scan(hdr: FrameHeader, scan: ScanHeader, planes: list[np.ndarray]):
    """DC scan (ss=0, se=0).  First pass (ah=0): differential size/extend
    coding like baseline, value << al.  Refinement (ah>0): one raw bit per
    block sets bit ``al``."""
    if scan.se != 0:
        raise JPEGError("progressive: DC scan must have Se=0")
    first = scan.ah == 0
    interleaved = len(scan.comp_indices) > 1
    comps = hdr.components

    if first:
        dc_luts = {ci: build_lut(scan.dc_specs[scan.dc_table_ids[k]]).tolist()
                   for k, ci in enumerate(scan.comp_indices)}

    if interleaved:
        # Full-MCU geometry (parity with the baseline scan loop,
        # jpeg.cpp:415-443).
        mcus_x, mcus_y = hdr.mcus_x, hdr.mcus_y
        n_mcus = mcus_x * mcus_y
        blocks = []  # (ci, v, h) per within-MCU block, scan order
        for k, ci in enumerate(scan.comp_indices):
            c = comps[ci]
            for v in range(c.v):
                for h in range(c.h):
                    blocks.append((ci, v, h))

        mcu = 0
        for reader, seg_mcus in _iter_segments(scan, n_mcus):
            preds = {ci: 0 for ci in scan.comp_indices}
            for _ in range(seg_mcus):
                my, mx = divmod(mcu, mcus_x)
                for ci, v, h in blocks:
                    c = comps[ci]
                    row, col = my * c.v + v, mx * c.h + h
                    if first:
                        preds[ci] = _decode_dc_first(
                            reader, dc_luts[ci], planes[ci], row, col,
                            preds[ci], scan.al)
                    else:
                        if reader.getbits(1):
                            planes[ci][row, col, 0] |= 1 << scan.al
                mcu += 1
    else:
        ci = scan.comp_indices[0]
        rows, cols = comp_dims_unpadded(hdr, ci)
        n_mcus = rows * cols
        blk = 0
        for reader, seg_mcus in _iter_segments(scan, n_mcus):
            pred = 0
            for _ in range(seg_mcus):
                row, col = divmod(blk, cols)
                if first:
                    pred = _decode_dc_first(reader, dc_luts[ci], planes[ci],
                                            row, col, pred, scan.al)
                else:
                    if reader.getbits(1):
                        planes[ci][row, col, 0] |= 1 << scan.al
                blk += 1


def _decode_dc_first(reader, dc_lut, plane, row, col, pred, al) -> int:
    t = dc_lut[reader.peek16()]
    length = t & 31
    if length == 0:
        raise JPEGError("progressive: invalid DC code")
    reader.pos += length
    size = t >> 5
    if size > 11:
        raise JPEGError("progressive: invalid DC size")
    diff = receive_extend(reader.getbits(size), size) if size else 0
    pred += diff
    plane[row, col, 0] = pred << al
    return pred


def _ac_first_scan(hdr, scan, plane):
    """AC first pass (T.81 G.2.2): run/size symbols with EOB runs."""
    ci = scan.comp_indices[0]
    rows, cols = comp_dims_unpadded(hdr, ci)
    ac_lut = build_lut(scan.ac_specs[scan.ac_table_ids[0]]).tolist()
    ss, se, al = scan.ss, scan.se, scan.al
    n_mcus = rows * cols
    blk = 0
    for reader, seg_mcus in _iter_segments(scan, n_mcus):
        eobrun = 0
        for _ in range(seg_mcus):
            row, col = divmod(blk, cols)
            block = plane[row, col]
            if eobrun > 0:
                eobrun -= 1
            else:
                k = ss
                while k <= se:
                    t = ac_lut[reader.peek16()]
                    length = t & 31
                    if length == 0:
                        raise JPEGError("progressive: invalid AC code")
                    reader.pos += length
                    sym = t >> 5
                    r, s = sym >> 4, sym & 0x0F
                    if s == 0:
                        if r < 15:
                            eobrun = (1 << r) - 1
                            if r:
                                eobrun += reader.getbits(r)
                            break
                        k += 16  # ZRL
                    else:
                        k += r
                        if k > se:
                            raise JPEGError("progressive: AC run overflow")
                        block[_ZZ[k]] = receive_extend(
                            reader.getbits(s), s) << al
                        k += 1
            blk += 1


def _ac_refine_scan(hdr, scan, plane):
    """AC refinement pass (T.81 G.2.3): correction bits along the band."""
    ci = scan.comp_indices[0]
    rows, cols = comp_dims_unpadded(hdr, ci)
    ac_lut = build_lut(scan.ac_specs[scan.ac_table_ids[0]]).tolist()
    ss, se, al = scan.ss, scan.se, scan.al
    p1 = 1 << al
    n_mcus = rows * cols

    def correct(block, k):
        """Apply a pending correction bit to the nonzero coef at zigzag k."""
        nz = block[_ZZ[k]]
        if nz > 0:
            if (nz & p1) == 0:
                block[_ZZ[k]] = nz + p1
        else:
            if (nz & p1) == 0:
                block[_ZZ[k]] = nz - p1

    blk = 0
    for reader, seg_mcus in _iter_segments(scan, n_mcus):
        eobrun = 0
        for _ in range(seg_mcus):
            row, col = divmod(blk, cols)
            block = plane[row, col]
            k = ss
            if eobrun == 0:
                while k <= se:
                    t = ac_lut[reader.peek16()]
                    length = t & 31
                    if length == 0:
                        raise JPEGError("progressive: invalid AC code")
                    reader.pos += length
                    sym = t >> 5
                    r, s = sym >> 4, sym & 0x0F
                    newval = 0
                    if s == 0:
                        if r < 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += reader.getbits(r)
                            break
                        # r == 15: ZRL — skip 16 zero-history coefficients
                    else:
                        if s != 1:
                            raise JPEGError(
                                "progressive: refinement size must be 1")
                        newval = p1 if reader.getbits(1) else -p1
                    # Advance past r zero-history coefficients, emitting
                    # correction bits for nonzero-history ones on the way.
                    while k <= se:
                        if block[_ZZ[k]] != 0:
                            if reader.getbits(1):
                                correct(block, k)
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if newval and k <= se:
                        block[_ZZ[k]] = newval
                    k += 1
            if eobrun > 0:
                # Correction bits for the remainder of the band.
                while k <= se:
                    if block[_ZZ[k]] != 0:
                        if reader.getbits(1):
                            correct(block, k)
                    k += 1
                eobrun -= 1
            blk += 1


def decode_progressive(hdr: FrameHeader) -> list[np.ndarray]:
    """Decode all scans of a progressive frame.

    Returns per-component quantized coefficient planes
    ``(rows_c, cols_c, 64)`` int32 on the padded dense grid (same layout as
    the baseline path's scan_to_comp_planes output).
    """
    planes = []
    for ci in range(len(hdr.components)):
        rows, cols = (hdr.mcus_y * hdr.components[ci].v,
                      hdr.mcus_x * hdr.components[ci].h)
        planes.append(np.zeros((rows, cols, 64), np.int64))

    for scan in hdr.scans:
        if scan.ss == 0:
            _dc_scan(hdr, scan, planes)
        else:
            if len(scan.comp_indices) != 1:
                raise JPEGError(
                    "progressive: AC scans must be single-component")
            if scan.ah == 0:
                _ac_first_scan(hdr, scan, planes[scan.comp_indices[0]])
            else:
                _ac_refine_scan(hdr, scan, planes[scan.comp_indices[0]])

    return [p.astype(np.int32) for p in planes]
