"""Host-to-device staging shared by the kernel routes."""

from __future__ import annotations

import numpy as np
import torch


def upload(arrays: list, dev: torch.device) -> list:
    """The numpy ``arrays`` on ``dev``: on a CUDA device one non-blocking
    copy of a pinned staging buffer on the current stream, then views."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += -(-a.nbytes // 64) * 64
    buf = torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=True)
    raw = buf.numpy()
    for a, off in zip(arrays, offs):
        raw[off:off + a.nbytes] = np.ascontiguousarray(a).view(np.uint8) \
            .reshape(-1)
    dbuf = buf.to(dev, non_blocking=True)
    return [dbuf[off:off + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, off in zip(arrays, offs)]
