"""Decode configuration.

Counterpart of ``jpeg_decoder_tpu/utils/config.py``: the same fields, checks
and keyword sets.  ``mesh_shape`` is kept for the signature; the port has no
sharded decode yet.

Replaces the reference's ``argv[1]``-only configuration (jpeg.cpp:918-922)
and its compile-time ``t_count`` knob (display.hpp:74) with a dataclass
shared by the CLI, the single-image decoder, and the batch/sharded paths.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Knobs for a decode pipeline instance."""

    entropy: str = "auto"   # auto | python | native | speculative | hybrid | jax | pallas
    idct: str = "fast"         # exact | fast | kron | pallas
    upsample: str = "fancy"    # nn | fancy
    strict: bool = False       # eager pixel pipeline (bit-exact vs reference)
    orientation: str = "ignore"  # ignore | respect (EXIF auto-rotate)
    wire: str = "nibble"   # batch wire: nibble|sparse|packed|slots
    host_threads: int | None = None
    # Mesh geometry for sharded decode: (data, seg) axis sizes; None = no
    # sharding (single device).
    mesh_shape: tuple[int, int] | None = None

    def validate(self) -> "DecodeConfig":
        if self.entropy not in ("auto", "python", "native", "speculative", "hybrid",
                                "jax", "pallas"):
            raise ValueError(f"bad entropy backend {self.entropy!r}")
        if self.idct not in ("exact", "fast", "kron", "pallas"):
            raise ValueError(f"bad idct mode {self.idct!r}")
        if self.upsample not in ("nn", "fancy"):
            raise ValueError(f"bad upsample mode {self.upsample!r}")
        if self.wire not in ("nibble", "sparse", "packed", "slots"):
            raise ValueError(f"bad wire format {self.wire!r}")
        if self.orientation not in ("ignore", "respect"):
            raise ValueError(f"bad orientation mode {self.orientation!r}")
        return self

    def decode_kwargs(self) -> dict:
        """Keyword arguments for models.decoder.decode()."""
        return dict(entropy=self.entropy, idct=self.idct,
                    upsample=self.upsample, strict=self.strict,
                    orientation=self.orientation)

    def batch_kwargs(self) -> dict:
        """Keyword arguments for models.batch.BatchDecoder()."""
        return dict(entropy=self.entropy, idct=self.idct,
                    upsample=self.upsample, wire=self.wire,
                    host_threads=self.host_threads)
