"""Host-to-device staging shared by the kernel routes."""

from __future__ import annotations

import threading

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


class PinnedStage:
    """One pinned staging buffer reused across uploads (grown as needed).
    An upload waits until the copy before it has left the buffer, then
    fills it and issues one non-blocking copy on the current stream."""

    def __init__(self):
        self._buf = None
        self._done = None
        self._lock = threading.Lock()

    def upload(self, a: np.ndarray, dev: torch.device) -> torch.Tensor:
        """``a`` as raw bytes on the CUDA device ``dev`` (a uint8 tensor)."""
        raw = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        with self._lock, torch.cuda.device(dev):
            if self._done is not None:
                self._done.synchronize()
            if self._buf is None or self._buf.numel() < raw.size:
                self._buf = torch.empty(max(raw.size, 4096),
                                        dtype=torch.uint8, pin_memory=True)
            self._buf.numpy()[:raw.size] = raw
            out = self._buf[:raw.size].to(dev, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(dev))
        return out
