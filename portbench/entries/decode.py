"""``decode()``, the single-image entry: one call per request, with the
configuration's keyword arguments."""

from __future__ import annotations

from .common import Streams


class Entry:
    def __init__(self, config: dict, frames: list, device):
        from jpeg_decoder_tpu_torch import decode

        self._fn = decode
        self._kw = dict(config.get("kwargs", {}))
        self._blobs = [f.blob for f in frames]
        self._streams = Streams(device)
        self._device = self._streams.device

    def thread_context(self, k: int):
        return self._streams.context(k)

    def call(self, ids) -> list:
        out = [self._fn(self._blobs[i], device=self._device, **self._kw).rgb
               for i in ids]
        self._streams.finish()
        return out
