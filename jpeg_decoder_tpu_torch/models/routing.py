"""Routing of a decode: which frames take the fast path, on which device.

``needs_scan_loop`` and ``segment_mismatch`` are the counterparts of those
in ``jpeg_decoder_tpu/models/decoder.py``, shared by ``decode()`` and the
batch router; :func:`resolve_device` is the port's one rule for the
``device`` argument of both entry points.
"""

from __future__ import annotations

import torch

from .. import layout as layout_mod
from ..types import FrameHeader


def resolve_device(device) -> torch.device:
    """The device an entry point decodes on: ``None`` or "cuda" is the
    card, and a machine without one raises (it never falls back to the
    CPU); "cpu" runs the kernels' plain twins."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to decode on the CPU")
    return dev


def segment_mismatch(hdr: FrameHeader, scan) -> bool:
    """True when the stream's restart-segment count disagrees with DRI —
    a corrupted/nonconforming stream the strict backends reject."""
    ri = scan.restart_interval
    n_mcus = layout_mod.scan_layout(hdr).n_mcus
    expected = -(-n_mcus // ri) if ri else 1
    return len(scan.seg_offsets) - 1 != expected


def needs_scan_loop(hdr: FrameHeader) -> bool:
    """True when the frame cannot use the fast single-interleaved-scan
    path: multiple scans, a partial-component scan, or a single-component
    frame with sampling factors > 1 — T.81 A.2.2 makes ANY
    single-component scan non-interleaved (one data unit per MCU over the
    component's unpadded block grid), which changes both block order and
    restart-interval accounting whenever h*v > 1."""
    if len(hdr.scans) != 1:
        return True
    s0 = hdr.scans[0]
    if len(s0.comp_indices) != len(hdr.components):
        return True
    if len(hdr.components) == 1:
        c = hdr.components[0]
        if (c.h, c.v) != (1, 1):
            return True
    return False
