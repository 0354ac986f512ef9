"""The native decoder's coefficient planes scan by scan, in the layout of
the progressive lanes: the prior planes the kernels K8a-K8d are held to."""

from __future__ import annotations

import numpy as np

from ..entropy import native
from ..types import FrameHeader


def native_prog_states(hdr: FrameHeader) -> list:
    """The native decoder's planes before each scan and after the last: one
    list per state of (rows*cols + 1, 64) int32 host arrays, the last row
    the lanes' drop row."""
    lib = native._load()
    planes = native._empty_planes(hdr)
    out = []
    for scan in [None, *hdr.scans]:
        if scan is not None:
            native._run_prog_scan(lib, hdr, planes, scan)
        out.append([np.concatenate([p.reshape(-1, 64),
                                    np.zeros((1, 64), np.int32)])
                    for p in planes])
    return out
