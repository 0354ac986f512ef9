"""What every entry adapter shares: a CUDA stream per load thread."""

from __future__ import annotations

import contextlib
import threading

import torch


class Streams:
    """One CUDA stream per load thread, made on first use (none on the
    CPU)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._streams: dict = {}
        self._lock = threading.Lock()

    def context(self, k: int):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        with self._lock:
            s = self._streams.get(k)
            if s is None:
                s = self._streams[k] = torch.cuda.Stream(self.device)
        return torch.cuda.stream(s)

    def finish(self) -> None:
        """Wait for the calling thread's current stream (the RGB ready)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
