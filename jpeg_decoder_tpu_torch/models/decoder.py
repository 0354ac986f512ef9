"""Single-image decode: the port's counterpart of ``decode()``.

Counterpart of ``jpeg_decoder_tpu/models/decoder.py``.  Host parse, entropy
decode by the chosen backend, then the device pixel stage.  On the card,
under ``idct="exact"`` or ``"pallas"`` to RGB, that is one launch of K6b
(``ops/pixels_cuda.blocks_to_rgb``: gather, dequant+IDCT, upsample, colour)
straight from the scan-order blocks, with the quantisation tables and the
geometry already on the card (:func:`k6b_route`); else the torch pixel
pipeline: one gather per component, dequant+IDCT, upsample, colour.

Entropy backends:

* ``pallas`` — the device path: host scan prep, then the CUDA Huffman
  kernel K2 (``ops/entropy_cuda.py``) writes the scan-order blocks on the
  card; only the per-segment error flags cross back.  8-bit frames, as the
  JAX package's Pallas kernel.  On ``device="cpu"`` the kernel's plain twin
  runs.
* ``jax`` — K2 on every stream, 8- and 12-bit (the JAX package's lockstep
  and speculative lanes; K2 is the port's device speculation for DRI=0).
* ``hybrid`` — on a DRI=0 stream the host skeleton walk plans lanes from
  true MCU starts and the emit-lane kernel K7 (``ops/entropy_spec.py``,
  ``ops/entropy_emit_cuda.py``) decodes them; restart streams take K2.
* ``native`` — the C++ host decoder; ``speculative`` — the same library's
  chunk-parallel self-synchronising decoder for DRI=0 streams (segment-
  threaded otherwise); ``python`` — the pure-Python oracle; ``auto`` —
  native when it builds here, else python.  Their blocks are copied to the
  device.

Progressive Huffman frames under ``pallas``, ``jax`` and ``hybrid`` decode
on the device progressive lanes (``ops/entropy_prog.py``: the kernels
K8a-K8d fed restart segments or the host's skeleton walks; 8-bit frames,
others on the host as in JAX), and the device planes go straight to the
pixel pipeline.  Under the host backends progressive frames, and under every
backend arithmetic (sequential or progressive), multi-scan and
non-interleaved frames, decode to host planes (:func:`decode_to_planes`,
the JAX function's routing) and go through the same pixel pipeline; a
restart-count mismatch takes the resilient decoder.

The pixel stage takes gray, YCbCr, Adobe RGB, CMYK and YCCK sources and
12-bit frames (uint16 output); ``idct="exact"``, the default, is the strict
AAN IDCT kernel K5, byte-identical to the JAX package's eager strict path.
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
from ..ops import pixels_cuda
from ..types import FrameHeader, JPEGError
from ..utils import profiling
from .routing import needs_scan_loop, resolve_device, segment_mismatch

_log = logging.getLogger(__name__)

_comp_src_cache: dict[tuple, tuple] = {}
_k6b_plans: dict[tuple, object] = {}
_k6b_const_cache: dict[tuple, tuple] = {}

#: The IDCTs under which K6b gives the torch pixel route's bytes.
K6B_IDCTS = ("exact", "pallas")


#: The entropy backends that decode on the device.
DEVICE_BACKENDS = ("pallas", "jax", "hybrid")


@dataclasses.dataclass
class DecodeResult:
    """Everything a caller (or a conformance test) may want."""

    header: FrameHeader
    # (H, W, 3) uint8 on the decode device (uint16 for 12-bit frames;
    # (H, W, 4) uint8 for colorspace="cmyk").
    rgb: torch.Tensor
    # Dequantized per-component coefficient planes (rows, cols, 64) int32 —
    # the bit-exactness conformance surface.
    dequantized_planes: Optional[list[np.ndarray]] = None
    # Quantized (raw decoded) planes, pre-dequantization.
    quantized_planes: Optional[list[np.ndarray]] = None


def _entropy_backend(name: str, device: torch.device):
    """Resolve an entropy backend by name to ``fn(hdr, scan)``, which
    returns (n_blocks, 64) int32 scan-order blocks: a numpy array for the
    host backends, a tensor on ``device`` for ``pallas``, ``jax`` and
    ``hybrid`` (the JAX function's routing, jax models/decoder.py:72-94)."""
    if name == "python":
        from ..entropy import python_ref
        return python_ref.decode_scan_baseline
    if name == "native":
        from ..entropy import native
        return native.decode_scan_baseline
    if name == "speculative":
        from ..entropy import native

        def spec(hdr, scan):
            if len(scan.seg_offsets) == 2:
                return native.decode_scan_speculative(hdr, scan)
            return native.decode_scan_baseline(hdr, scan)
        return spec
    if name == "pallas":
        from ..ops import entropy_cuda

        def on_device(hdr, scan):
            if hdr.precision != 8:
                # The JAX Pallas kernel flags 12-bit size categories.
                raise JPEGError(f"entropy='pallas' decodes 8-bit frames "
                                f"only, got {hdr.precision}-bit")
            return entropy_cuda.decode_scan_baseline(hdr, scan, device)
        return on_device
    if name in ("jax", "hybrid"):
        from ..ops import entropy_cuda, entropy_spec

        def lanes(hdr, scan):
            if len(scan.seg_offsets) == 2 and not scan.restart_interval:
                if name == "hybrid":
                    return entropy_spec.decode_scan_hybrid(hdr, scan, device)
                return entropy_spec.decode_scan_speculative(hdr, scan,
                                                            device)
            return entropy_cuda.decode_scan_baseline(hdr, scan, device)
        return lanes
    if name == "auto":
        from ..entropy import native, python_ref

        nat = native.decode_scan_baseline if native.available() else None

        def auto(hdr, scan):
            if nat is not None and hdr.precision in (8, 12):
                return nat(hdr, scan)
            return python_ref.decode_scan_baseline(hdr, scan)
        return auto
    raise ValueError(f"unknown entropy backend {name!r}")


def _decode_scan_robust(hdr: FrameHeader, scan, entropy: str,
                        device: torch.device):
    """Backend dispatch with libjpeg-style restart resynchronization: a
    restart-count/DRI mismatch decodes best-effort (marker positions are
    ground truth) instead of raising.  As in the JAX package, that route is
    the native resilient decoder for ``auto``/``native``/``speculative``
    8- and 12-bit frames when the library builds here, and python_ref's
    otherwise (the device backends included)."""
    if segment_mismatch(hdr, scan):
        _log.warning(
            "restart-segment count %d disagrees with DRI %d; "
            "resynchronizing on marker positions (best-effort decode)",
            len(scan.seg_offsets) - 1, scan.restart_interval)
        from ..entropy import native, python_ref

        if (entropy in ("auto", "native", "speculative")
                and hdr.precision in (8, 12) and native.available()):
            return native.decode_scan_resilient(hdr, scan)
        return python_ref.decode_scan_resilient(hdr, scan)
    return _entropy_backend(entropy, device)(hdr, scan)


def _decode_scan_loop(hdr: FrameHeader, entropy: str) -> list[np.ndarray]:
    """T.81 sequential multi-scan / partial-scan frames (one scan per
    component subset, non-interleaved when single-component): the native
    subset decoder for ``auto``/``native``/``speculative`` 8-bit frames when
    the library builds here, python_ref's otherwise."""
    from ..entropy import native, python_ref

    use_native = (entropy in ("auto", "native", "speculative")
                  and hdr.precision == 8 and native.available())
    lay = layout_mod.scan_layout(hdr)
    planes = [np.zeros((*lay.comp_shapes[ci], 64), np.int32)
              for ci in range(len(hdr.components))]
    seen: set[int] = set()
    for scan in hdr.scans:
        dup = seen.intersection(scan.comp_indices)
        if dup:
            raise JPEGError(
                f"sequential frame codes components {sorted(dup)} twice")
        if use_native:
            sc = scan.comp_indices
            blocks = native.decode_scan_subset(hdr, scan)
            if len(sc) == 1:
                rows_u, cols_u = layout_mod.comp_dims_unpadded(hdr, sc[0])
                planes[sc[0]][:rows_u, :cols_u] = blocks.reshape(
                    rows_u, cols_u, 64)
            else:
                slay = layout_mod.scan_layout(hdr, comp_indices=tuple(sc))
                for k_c, ci in enumerate(sc):
                    rows, cols = slay.comp_shapes[k_c]
                    planes[ci][:] = blocks[slay.comp_src[k_c]].reshape(
                        rows, cols, 64)
        else:
            python_ref.decode_scan_sequential_into(hdr, scan, planes)
        seen.update(scan.comp_indices)
    missing = set(range(len(hdr.components))) - seen
    if missing:
        raise JPEGError(
            f"sequential frame never codes components {sorted(missing)}")
    return planes


def decode_to_planes(hdr: FrameHeader, entropy: str = "auto",
                     device=None) -> list[np.ndarray]:
    """Run entropy decode for all scans, returning per-component quantized
    coefficient planes (rows, cols, 64) int32 on the host — for every frame
    the parser takes (12-bit and CMYK/YCCK included: planes do not depend
    on colour).  The JAX function's routing: arithmetic frames by
    ``entropy.arith``; progressive ones by the native decoder
    (``auto``/``native``, 8-bit) or ``entropy.progressive``; multi-scan and
    non-interleaved ones scan by scan; the rest through the chosen backend
    (``device`` is where the device backends run) with restart
    resynchronization.  Under ``pallas``, ``jax`` and ``hybrid`` progressive
    Huffman frames take the device lanes
    (``entropy_prog.decode_progressive_lanes`` on ``device``), whose planes
    are copied back.  ``device`` is resolved by ``routing.resolve_device``
    (None: the card, raising without one) for the device backends only; the
    host backends need no card."""
    if hdr.arithmetic:
        from ..entropy import arith
        return arith.decode_to_planes(hdr)
    if hdr.progressive:
        if entropy in DEVICE_BACKENDS:
            from ..ops import entropy_prog

            return entropy_prog.decode_progressive_lanes(
                hdr, resolve_device(device))
        from ..entropy import native, progressive

        if (entropy in ("auto", "native") and hdr.precision == 8
                and native.available()):
            # As in the JAX package, a stream the native decoder refuses is
            # handed to the pure-Python decoder.
            try:
                return native.decode_progressive(hdr)
            except JPEGError:
                pass
        return progressive.decode_progressive(hdr)
    if needs_scan_loop(hdr):
        return _decode_scan_loop(hdr, entropy)
    dev = (resolve_device(device) if entropy in DEVICE_BACKENDS
           else torch.device("cpu"))
    scan_coefs = _decode_scan_robust(hdr, hdr.scans[0], entropy, dev)
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
        profiling.count("layout.comp_src_upload")
        hit = tuple(torch.from_numpy(src.astype(np.int64)).to(device)
                    for src in layout_mod.scan_layout(hdr).comp_src)
        if len(_comp_src_cache) > 256:  # bound memory, like scan_layout
            _comp_src_cache.clear()
        _comp_src_cache[key] = hit
    return hit


def k6b_route(idct: str, out_cmyk: bool, device_type: str, plan) -> bool:
    """Whether :func:`decode`'s scan-order branch makes its pixels with one
    launch of K6b: on a CUDA device, under an IDCT whose bytes K6b keeps
    (:data:`K6B_IDCTS`), to RGB (K6b writes three channels), for a frame
    whose :func:`_k6b_plan` (None where K6b refuses it) fits the kernel's
    shared memory.  Every other call takes
    ``pixel_ops.pixel_pipeline_from_scan``."""
    if (device_type != "cuda" or idct not in K6B_IDCTS or out_cmyk
            or plan is None):
        return False
    out_bytes = 1 if plan.maxv < 256 else 2
    return plan.layout(idct, out_bytes)["smem"] <= pixels_cuda.SMEM_MAX


def _k6b_plan(hdr: FrameHeader, upsample: str):
    """K6b's launch plan (``pixels_cuda.kernel_plan``) for the frame's
    geometry and ``upsample``, or None where the kernel refuses the frame;
    made once per geometry."""
    key = (hdr.height, hdr.width, tuple((c.h, c.v) for c in hdr.components),
           hdr.precision, hdr.colorspace, upsample)
    if key in _k6b_plans:
        return _k6b_plans[key]
    try:
        plan = pixels_cuda.kernel_plan(
            comp_shapes=tuple(layout_mod.scan_layout(hdr).comp_shapes),
            comp_hv=tuple((c.h, c.v) for c in hdr.components),
            height=hdr.height, width=hdr.width,
            samplings=tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                            for c in hdr.components),
            upsample=upsample, color=hdr.colorspace,
            precision=hdr.precision)
    except ValueError:
        # The torch route takes the frame (and raises where it cannot).
        plan = None
    if len(_k6b_plans) > 256:  # bound memory, like _comp_srcs
        _k6b_plans.clear()
    _k6b_plans[key] = plan
    return plan


def _k6b_consts(hdr: FrameHeader, device: torch.device) -> tuple:
    """K6b's (1, n_comps, 64) int32 quantisation tables and (1, 4) int32
    geometry row (mcus_x, mcus_y, height, width) on ``device``: views of
    one buffer, uploaded once per geometry, table set and device, the
    upload finished before another stream can find it here."""
    tables = [hdr.quant_tables[c.tq].values.astype(np.int32, copy=False)
              for c in hdr.components]
    geom = (hdr.mcus_x, hdr.mcus_y, hdr.height, hdr.width)
    key = (*geom, b"".join(t.tobytes() for t in tables), device)
    hit = _k6b_const_cache.get(key)
    if hit is None:
        profiling.count("pixel.consts_upload")
        host = np.concatenate([*tables, np.array(geom, np.int32)])
        buf = torch.from_numpy(host).to(device)
        if buf.is_cuda:
            torch.cuda.current_stream(device).synchronize()
        n = len(tables) * 64
        hit = (buf, buf[:n].view(1, len(tables), 64), buf[n:].view(1, 4))
        if len(_k6b_const_cache) > 256:  # bound memory, like _comp_srcs
            _k6b_const_cache.clear()
        _k6b_const_cache[key] = hit
    return hit


def _k6b_pixels(hdr: FrameHeader, blocks: torch.Tensor, plan, *,
                comp_shapes: tuple, samplings: tuple, idct: str,
                upsample: str) -> torch.Tensor:
    """(H, W, 3) RGB of the frame's (N, 64) scan-order ``blocks``: one
    launch of K6b on the current stream, from the device-resident
    :func:`_k6b_consts` and the cached ``plan`` (on a CPU tensor, K6b's
    plain version)."""
    buf, qt, geom = _k6b_consts(hdr, blocks.device)
    if blocks.is_cuda:
        # The buffer may be freed (by the cache's bound) while this stream
        # still reads it.
        buf.record_stream(torch.cuda.current_stream(blocks.device))
    profiling.count("pixel.k6b")
    return pixels_cuda.blocks_to_rgb(
        blocks[None], qt, geom, comp_shapes=comp_shapes,
        comp_hv=tuple((c.h, c.v) for c in hdr.components),
        height=hdr.height, width=hdr.width, samplings=samplings, idct=idct,
        upsample=upsample, color=hdr.colorspace, precision=hdr.precision,
        plan=plan)[0]


def pixels_from_planes(hdr: FrameHeader, planes, *, idct: str,
                       upsample: str, out_cmyk: bool = False) -> torch.Tensor:
    """The frame's (1, H, W, C) pixels from its coefficient planes (one
    (rows*cols[+1], 64) int32 tensor per component, on the device the
    pixels go to): its quantisation tables and samplings, then the pixel
    pipeline."""
    dev = planes[0].device
    qts = tuple(torch.from_numpy(hdr.quant_tables[c.tq].values
                                 .astype(np.int32)).to(dev)[None]
                for c in hdr.components)
    return pixel_ops.pixel_pipeline_impl(
        tuple(p[None] for p in planes), qts, height=hdr.height,
        width=hdr.width,
        samplings=tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                        for c in hdr.components),
        idct=idct, upsample=upsample, color=hdr.colorspace,
        out_cmyk=out_cmyk, precision=hdr.precision)


def decode(source, *, entropy: str = "auto", idct: str = "exact",
           upsample: str = "nn", keep_planes: bool = False, device=None,
           strict: bool = False, colorspace: str = "rgb",
           orientation: str = "ignore") -> DecodeResult:
    """Decode a JPEG from a path or bytes to device-resident RGB.

    Args:
      source: file path or bytes-like JPEG stream.
      entropy: "auto" | "python" | "native" | "speculative" | "pallas"
        (device kernel K2, 8-bit frames) | "jax" (K2, 8- and 12-bit) |
        "hybrid" (K7 on DRI=0 streams, K2 on restart streams); under
        these three, progressive frames decode on the device lanes
        (K8a-K8d, ``ops/entropy_prog.py``).
      idct: "exact" (the reference's AAN float semantics: K5's arithmetic
        inside K6b on the card, its op-by-op twin on the CPU), "pallas"
        (the Kronecker arithmetic of K1: inside K6b on the card, its plain
        twin on the CPU), "kron" (that twin) or "fast".  CMYK output,
        ``keep_planes`` and frames decoded to planes take K5 or K1 and
        torch ops on the card.
      upsample: "nn" (reference nearest-neighbour parity) or "fancy"
        (libjpeg triangular filter).
      keep_planes: also return the coefficient planes (numpy).
      device: where the pixel pipeline (and device entropy) runs; None
        means the CUDA card, and raises without one; "cpu" runs the
        kernels' plain twins.
      strict: accepted for the JAX signature.  The port compiles no fused
        pixel program: every float32 operation of ``exact`` rounds on its
        own on the card (K5 contracts nothing) and on the CPU, so
        ``strict=True`` and ``strict=False`` give the same bytes, equal to
        the JAX package's eager strict output.
      colorspace: "rgb" (CMYK/YCCK sources are converted with Pillow's
        exact cmyk2rgb arithmetic) or "cmyk" (4-component sources only:
        the (H, W, 4) CMYK plane, PIL-inverted convention).
      orientation: "ignore" (sensor order) or "respect" (apply the EXIF
        orientation tag, like PIL.ImageOps.exif_transpose).
    """
    with profiling.span("decode", call=True):
        dev = resolve_device(device)
        if colorspace not in ("rgb", "cmyk"):
            raise ValueError(f"unknown colorspace {colorspace!r}")
        if orientation not in ("ignore", "respect"):
            raise ValueError(f"unknown orientation {orientation!r}")
        with profiling.span("decode.parse"):
            if isinstance(source, (bytes, bytearray, np.ndarray)):
                hdr = parser.parse(source)
            else:
                hdr = parser.parse_file(source)
        color = hdr.colorspace
        out_cmyk = colorspace == "cmyk"
        if out_cmyk and color not in ("ycck", "cmyk"):
            raise JPEGError(f"colorspace='cmyk' requires a 4-component "
                            f"source, got {color}")

        scan_branch = not (hdr.progressive or hdr.arithmetic
                           or needs_scan_loop(hdr) or keep_planes)
        plan = (_k6b_plan(hdr, upsample)
                if scan_branch and dev.type == "cuda" else None)
        fused = scan_branch and k6b_route(idct, out_cmyk, dev.type, plan)
        if not fused:
            with profiling.span("pixel.enqueue"):
                qtables = tuple(
                    torch.from_numpy(hdr.quant_tables[c.tq].values
                                     .astype(np.int32)).to(dev)
                    for c in hdr.components)
        samplings = tuple(
            (hdr.v_max // c.v, hdr.h_max // c.h) for c in hdr.components)
        pixel_kw = dict(height=hdr.height, width=hdr.width,
                        samplings=samplings, idct=idct, upsample=upsample,
                        color=color, out_cmyk=out_cmyk,
                        precision=hdr.precision)
        lay = layout_mod.scan_layout(hdr)
        planes = None
        if (hdr.progressive and not hdr.arithmetic
                and entropy in DEVICE_BACKENDS):
            # Device progressive lanes: the planes stay on the device for
            # the pixel pipeline; the lane flags are read once, after it is
            # queued.
            from ..ops import entropy_prog

            errs: list = []
            dplanes = entropy_prog.decode_progressive_lanes(
                hdr, dev, as_device=True, err_sink=errs)
            rgb = pixels_from_planes(hdr, dplanes, idct=idct,
                                     upsample=upsample, out_cmyk=out_cmyk)[0]
            entropy_prog.check_errors(errs)
            if keep_planes:
                planes = [p.cpu().numpy() for p in dplanes]
        elif not scan_branch:
            # Host planes: every scan of the frame decoded on the host (or
            # by K2 for ``keep_planes`` under pallas), then the pixel
            # pipeline.
            planes = decode_to_planes(hdr, entropy=entropy, device=dev)
            rgb = pixels_from_planes(
                hdr, [torch.from_numpy(p).to(dev) for p in planes],
                idct=idct, upsample=upsample, out_cmyk=out_cmyk)[0]
        else:
            # Production path: scan-order blocks go (or stay) on the device
            # and plane assembly is a device gather inside the pipeline.
            blocks = _decode_scan_robust(hdr, hdr.scans[0], entropy, dev)
            if not isinstance(blocks, torch.Tensor):
                blocks = torch.from_numpy(blocks).to(dev)
            with profiling.span("pixel.enqueue"):
                if fused:
                    rgb = _k6b_pixels(
                        hdr, blocks, plan, comp_shapes=tuple(lay.comp_shapes),
                        samplings=samplings, idct=idct, upsample=upsample)
                else:
                    rgb = pixel_ops.pixel_pipeline_from_scan(
                        blocks, qtables, _comp_srcs(hdr, dev),
                        comp_shapes=tuple(lay.comp_shapes), **pixel_kw)
        if orientation == "respect":
            # uint16 tensors lack flip: orient 12-bit samples as int32.
            wide = (rgb.to(torch.int32) if rgb.dtype == torch.uint16
                    else rgb)
            rgb = apply_exif_orientation(
                wide, hdr.exif_orientation).contiguous().to(rgb.dtype)
        result = DecodeResult(header=hdr, rgb=rgb)
        if keep_planes:
            result.quantized_planes = planes
            result.dequantized_planes = [
                p * hdr.quant_tables[c.tq].values
                for p, c in zip(planes, hdr.components)]
        return result


def decode_to_file(source, out_path, **kw) -> DecodeResult:
    """:func:`decode`, then write the image to ``out_path`` (format by
    extension: .bmp, .ppm, .npy, else PNG; see ``io.writers``)."""
    from ..io import writers

    res = decode(source, **kw)
    writers.write_image(out_path, res.rgb.cpu().numpy())
    return res
