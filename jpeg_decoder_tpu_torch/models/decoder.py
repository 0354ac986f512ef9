"""Single-image decode: the port's counterpart of ``decode()``.

Counterpart of ``jpeg_decoder_tpu/models/decoder.py``.  Host parse, entropy
decode by the chosen backend, then the device pixel pipeline: one gather per
component from the scan-order blocks, dequant+IDCT, upsample, colour.

Entropy backends:

* ``pallas`` — the device path: host scan prep, then the CUDA Huffman
  kernel (``ops/entropy_cuda.py``) writes the scan-order blocks on the card;
  only the per-segment error flags cross back.  On ``device="cpu"`` the
  kernel's plain twin runs.
* ``native`` — the C++ host decoder; ``python`` — the pure-Python oracle;
  ``auto`` — native when it builds here, else python.  Their blocks are
  copied to the device.

What the JAX function offers beyond this is not ported yet and raises
rather than run something else: ``idct="exact"`` (its default) and
``strict=True``, ``colorspace="cmyk"``, CMYK/YCCK/RGB sources, progressive,
arithmetic, 12-bit and multi-scan frames, and the ``jax``, ``hybrid`` and
``speculative`` backends.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from .. import layout as layout_mod
from ..io import parser
from ..ops import pixel as pixel_ops
from ..types import FrameHeader, JPEGError
from .routing import needs_scan_loop, resolve_device, segment_mismatch

_log = logging.getLogger(__name__)

#: Backends of the JAX package that the port does not have yet.
_NOT_PORTED_BACKENDS = ("jax", "hybrid", "speculative")
_comp_src_cache: dict[tuple, tuple] = {}


class NotPortedError(JPEGError):
    """A frame kind or an option of the JAX ``decode()`` that the port does
    not have yet."""


@dataclasses.dataclass
class DecodeResult:
    """Everything a caller (or a conformance test) may want."""

    header: FrameHeader
    rgb: torch.Tensor  # (H, W, 3) uint8 on the decode device
    # Dequantized per-component coefficient planes (rows, cols, 64) int32 —
    # the bit-exactness conformance surface.
    dequantized_planes: Optional[list[np.ndarray]] = None
    # Quantized (raw decoded) planes, pre-dequantization.
    quantized_planes: Optional[list[np.ndarray]] = None


def _entropy_backend(name: str, device: torch.device):
    """Resolve an entropy backend by name to ``fn(hdr, scan)``, which
    returns (n_blocks, 64) int32 scan-order blocks: a numpy array for the
    host backends, a tensor on ``device`` for ``pallas``."""
    if name == "python":
        from ..entropy import python_ref
        return python_ref.decode_scan_baseline
    if name == "native":
        from ..entropy import native
        return native.decode_scan_baseline
    if name == "pallas":
        from ..ops import entropy_cuda

        def on_device(hdr, scan):
            return entropy_cuda.decode_scan_baseline(hdr, scan, device)
        return on_device
    if name == "auto":
        from ..entropy import native, python_ref

        nat = native.decode_scan_baseline if native.available() else None

        def auto(hdr, scan):
            if nat is not None and hdr.precision in (8, 12):
                return nat(hdr, scan)
            return python_ref.decode_scan_baseline(hdr, scan)
        return auto
    if name in _NOT_PORTED_BACKENDS:
        raise NotPortedError(f"entropy backend {name!r} is not ported")
    raise ValueError(f"unknown entropy backend {name!r}")


def _decode_scan_robust(hdr: FrameHeader, scan, entropy: str,
                        device: torch.device):
    """Backend dispatch with libjpeg-style restart resynchronization: a
    restart-count/DRI mismatch decodes best-effort (marker positions are
    ground truth) instead of raising.  That route is the native resilient
    decoder for ``native``/``auto`` (``auto`` only when it builds here) and
    python_ref's otherwise, as in the JAX package."""
    backend = _entropy_backend(entropy, device)
    if segment_mismatch(hdr, scan):
        _log.warning(
            "restart-segment count %d disagrees with DRI %d; "
            "resynchronizing on marker positions (best-effort decode)",
            len(scan.seg_offsets) - 1, scan.restart_interval)
        from ..entropy import native, python_ref

        if entropy == "native" or (entropy == "auto" and native.available()):
            return native.decode_scan_resilient(hdr, scan)
        return python_ref.decode_scan_resilient(hdr, scan)
    return backend(hdr, scan)


def _not_ported(hdr: FrameHeader) -> str | None:
    """Why ``decode()`` cannot take this frame yet, or None."""
    if hdr.progressive:
        return "progressive"
    if hdr.arithmetic:
        return "arithmetic-coded"
    if hdr.precision != 8:
        return f"{hdr.precision}-bit"
    if needs_scan_loop(hdr):
        return "multi-scan or non-interleaved"
    if hdr.colorspace not in ("gray", "ycbcr"):
        return f"{hdr.colorspace} colour"
    return None


def decode_to_planes(hdr: FrameHeader, entropy: str = "auto",
                     device="cpu") -> list[np.ndarray]:
    """Entropy-decode the frame's single interleaved scan to per-component
    quantized coefficient planes (rows, cols, 64) int32, on the host.
    ``device`` is where the ``pallas`` backend runs."""
    why = _not_ported(hdr)
    if why is not None:
        raise NotPortedError(f"{why} frames are not ported yet")
    scan_coefs = _decode_scan_robust(hdr, hdr.scans[0], entropy,
                                     torch.device(device))
    if isinstance(scan_coefs, torch.Tensor):
        scan_coefs = scan_coefs.cpu().numpy()
    lay = layout_mod.scan_layout(hdr)
    return [scan_coefs[lay.comp_src[ci]].reshape(*lay.comp_shapes[ci], 64)
            for ci in range(len(hdr.components))]


def apply_exif_orientation(rgb: torch.Tensor,
                           orientation: int | None) -> torch.Tensor:
    """Apply an EXIF orientation (1-8) to an (H, W, C) tensor, matching
    ``PIL.ImageOps.exif_transpose`` (as the JAX package's does)."""
    if orientation == 2:
        return rgb.flip(1)
    if orientation == 3:
        return rgb.flip(0, 1)
    if orientation == 4:
        return rgb.flip(0)
    if orientation == 5:
        return rgb.transpose(0, 1)
    if orientation == 6:
        return torch.rot90(rgb, k=3, dims=(0, 1))
    if orientation == 7:
        return rgb.transpose(0, 1).flip(0, 1)
    if orientation == 8:
        return torch.rot90(rgb, k=1, dims=(0, 1))
    return rgb


def _comp_srcs(hdr: FrameHeader, device: torch.device) -> tuple:
    """The scan layout's gather maps as int64 tensors on ``device``,
    uploaded once per geometry and device."""
    key = (hdr.mcus_x, hdr.mcus_y,
           tuple((c.h, c.v) for c in hdr.components), device)
    hit = _comp_src_cache.get(key)
    if hit is None:
        hit = tuple(torch.from_numpy(src.astype(np.int64)).to(device)
                    for src in layout_mod.scan_layout(hdr).comp_src)
        if len(_comp_src_cache) > 256:  # bound memory, like scan_layout
            _comp_src_cache.clear()
        _comp_src_cache[key] = hit
    return hit


def decode(source, *, entropy: str = "auto", idct: str = "exact",
           upsample: str = "nn", keep_planes: bool = False, device=None,
           strict: bool = False, colorspace: str = "rgb",
           orientation: str = "ignore") -> DecodeResult:
    """Decode a JPEG from a path or bytes to device-resident RGB.

    Args:
      source: file path or bytes-like JPEG stream.
      entropy: "auto" | "python" | "native" | "pallas" (device kernel).
      idct: "pallas" (the CUDA kernel; its plain twin on the CPU), "kron"
        (that twin) or "fast".  "exact", the JAX default, is not ported.
      upsample: "nn" (reference nearest-neighbour parity) or "fancy"
        (libjpeg triangular filter).
      keep_planes: also return the coefficient planes (numpy).
      device: where the pixel pipeline (and ``pallas`` entropy) runs; None
        means the CUDA card, and raises without one; "cpu" runs the
        kernels' plain twins.
      strict: not ported (raises when True).
      colorspace: "rgb"; "cmyk" is not ported.
      orientation: "ignore" (sensor order) or "respect" (apply the EXIF
        orientation tag, like PIL.ImageOps.exif_transpose).
    """
    dev = resolve_device(device)
    if idct == "exact" or strict:
        raise NotPortedError(
            "idct='exact' and strict=True are not ported: use idct='pallas'"
            ", 'kron' or 'fast'")
    if colorspace != "rgb":
        raise NotPortedError(f"colorspace={colorspace!r} is not ported")
    if orientation not in ("ignore", "respect"):
        raise ValueError(f"unknown orientation {orientation!r}")
    if not isinstance(source, (bytes, bytearray, np.ndarray)):
        with open(source, "rb") as f:
            source = f.read()
    hdr = parser.parse(source)
    why = _not_ported(hdr)
    if why is not None:
        raise NotPortedError(f"{why} frames are not ported yet")

    qtables = tuple(
        torch.from_numpy(hdr.quant_tables[c.tq].values.astype(np.int32))
        .to(dev) for c in hdr.components)
    samplings = tuple(
        (hdr.v_max // c.v, hdr.h_max // c.h) for c in hdr.components)
    lay = layout_mod.scan_layout(hdr)
    planes = None
    if keep_planes:
        planes = decode_to_planes(hdr, entropy=entropy, device=dev)
        rgb = pixel_ops.pixel_pipeline_impl(
            tuple(torch.from_numpy(p).to(dev)[None] for p in planes),
            tuple(q[None] for q in qtables),
            height=hdr.height, width=hdr.width, samplings=samplings,
            idct=idct, upsample=upsample, color=hdr.colorspace)[0]
    else:
        # Production path: scan-order blocks go (or stay) on the device and
        # plane assembly is a device gather inside the pipeline.
        blocks = _decode_scan_robust(hdr, hdr.scans[0], entropy, dev)
        if not isinstance(blocks, torch.Tensor):
            blocks = torch.from_numpy(blocks).to(dev)
        rgb = pixel_ops.pixel_pipeline_from_scan(
            blocks, qtables, _comp_srcs(hdr, dev),
            comp_shapes=tuple(lay.comp_shapes), height=hdr.height,
            width=hdr.width, samplings=samplings, idct=idct,
            upsample=upsample, color=hdr.colorspace)
    if orientation == "respect":
        rgb = apply_exif_orientation(rgb, hdr.exif_orientation).contiguous()
    result = DecodeResult(header=hdr, rgb=rgb)
    if keep_planes:
        result.quantized_planes = planes
        result.dequantized_planes = [
            p * hdr.quant_tables[c.tq].values
            for p, c in zip(planes, hdr.components)]
    return result
