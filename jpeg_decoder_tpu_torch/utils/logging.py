"""Logging & verbose header narration.

Counterpart of ``jpeg_decoder_tpu/utils/logging.py``, on the logger
``jpeg_decoder_tpu_torch``.

Python-logging replacement for the reference's stream-DSL ``Logger``
(logger.hpp:13-102) and its header dumps: JFIF info (jpeg.cpp:62-64), SOF
narration (jpeg.cpp:138-145), quant-table print (types.hpp:98-109), Huffman
table dump (huffman.hpp:31-48), SOS narration (jpeg.cpp:265-281), and the
pre-decode summary (jpeg.cpp:775-783).  Useful when debugging conformance
failures: ``python -m jpeg_decoder_tpu_torch -vv image.jpg``.
"""

from __future__ import annotations

import logging

from ..types import FrameHeader

log = logging.getLogger("jpeg_decoder_tpu_torch")


def describe(hdr: FrameHeader) -> str:
    """Multi-line human-readable frame description."""
    lines = []
    kind = "progressive" if hdr.progressive else "baseline"
    lines.append(f"{kind} JPEG {hdr.width}x{hdr.height}, "
                 f"{hdr.precision}-bit, {len(hdr.components)} component(s)")
    lines.append(f"  MCU grid: {hdr.mcus_x}x{hdr.mcus_y} "
                 f"(block grid {hdr.mcu_width}x{hdr.mcu_height}, "
                 f"padded {hdr.mcu_width_real}x{hdr.mcu_height_real})")
    if hdr.restart_interval:
        lines.append(f"  restart interval: {hdr.restart_interval} MCUs")
    for i, c in enumerate(hdr.components):
        lines.append(
            f"  component {i}: id={c.comp_id} sampling={c.h}x{c.v} "
            f"qtable={c.tq} dc_table={c.td} ac_table={c.ta}")
    for tid, qt in sorted(hdr.quant_tables.items()):
        lines.append(f"  quantization table {tid} (natural order):")
        for r in range(8):
            row = " ".join(f"{int(v):4d}" for v in qt.values[r * 8:(r + 1) * 8])
            lines.append(f"    {row}")
    for kind_name, tables in (("DC", hdr.dc_tables), ("AC", hdr.ac_tables)):
        for tid, spec in sorted(tables.items()):
            lines.append(
                f"  {kind_name} huffman table {tid}: "
                f"counts={spec.counts.tolist()} "
                f"({len(spec.symbols)} symbols)")
    for si, scan in enumerate(hdr.scans):
        n_seg = len(scan.seg_offsets) - 1 if scan.seg_offsets is not None else 0
        lines.append(
            f"  scan {si}: comps={scan.comp_indices} "
            f"Ss={scan.ss} Se={scan.se} Ah={scan.ah} Al={scan.al} "
            f"{len(scan.data) if scan.data is not None else 0} bytes, "
            f"{n_seg} segment(s)")
    return "\n".join(lines)


def log_header(hdr: FrameHeader) -> None:
    if log.isEnabledFor(logging.DEBUG):
        log.debug("%s", describe(hdr))
    elif log.isEnabledFor(logging.INFO):
        log.info("%s", describe(hdr).split("\n", 1)[0])
