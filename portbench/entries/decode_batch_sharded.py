"""``parallel.sharded.decode_batch_sharded``: one call per request, on the
request's frames, with the configuration's keyword arguments."""

from __future__ import annotations

from .common import Streams


class Entry:
    def __init__(self, config: dict, frames: list, device):
        from jpeg_decoder_tpu_torch.parallel.sharded import (
            decode_batch_sharded)

        self._fn = decode_batch_sharded
        self._kw = dict(config.get("kwargs", {}))
        self._blobs = [f.blob for f in frames]
        self._streams = Streams(device)
        self._device = self._streams.device

    def thread_context(self, k: int):
        return self._streams.context(k)

    def call(self, ids) -> list:
        items = self._fn([self._blobs[i] for i in ids], device=self._device,
                         **self._kw)
        for it in items:
            if it.error is not None:
                raise it.error
        out = [it.rgb for it in items]
        self._streams.finish()
        return out
