"""K6a's and K6b's first forms, kept as the same-card baselines.

``jd_unpack_nibble_v1`` in ``csrc/pixels.cu`` is K6a as it was first
ported: zeros and DC written over the whole (B, n_blk + 1, 64) output,
chunk totals, each chunk's adds as 32-bit atomics in device memory, then
the escapes; its plain model is ``ops/pixels_cuda.unpack_nibble_chunked``.
``jd_blocks_to_rgb_v1`` is K6b as it was first
ported: one CTA per 64 x 64 output tile, each tile computing its halo
blocks again, K1's or K5's arithmetic, under ``kron`` and ``fast`` the torch
product ``ops/pixels_cuda.scan_samples`` before the launch, three 1-byte
stores a pixel; its plain model is ``ops/pixels_cuda.rgb_tiles_torch``.
``chip_smoke.py`` and ``testing/pixel_variants.py`` time each in turns with
``ops/pixels_cuda.unpack_nibble`` and ``blocks_to_rgb`` on the same inputs.
Nothing in ``decode()``, ``BatchDecoder`` or ``decode_batch_sharded``
reaches this module.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import launch_check
from ..ops import idct_cuda, pixel
from ..ops import pixels_cuda as k6


def unpack_nibble_v1(dc16, e, ov, esc_idx, esc_val, lib=None) -> torch.Tensor:
    """K6a's first form on CUDA tensors: the whole (B, n_blk + 1, 64) int32
    blocks of ``pixels_cuda.unpack_nibble`` without a trim.  ``lib``: a
    build of ``csrc/pixels.cu`` (``pixels_cuda.build()`` by default).
    Counts ``unpack_nibble_v1.launches``."""
    if dc16.device.type != "cuda":
        raise ValueError(f"the first form runs on the card, not "
                         f"{dc16.device}")
    k6.check_wire(dc16, e, ov, esc_idx, esc_val, dc16.shape[0])
    dev = dc16.device
    b, n_blk = dc16.shape
    k = e.shape[1]
    n_chunks = -(-k // (k6.UNPACK_THREADS * k6.PER_THREAD))
    out = torch.empty((b, n_blk + 1, 64), dtype=torch.int32, device=dev)
    agg = torch.empty((b, max(n_chunks, 1), 2), dtype=torch.int32,
                      device=dev)
    lib = lib or k6.build()
    with torch.cuda.device(dev):
        rc = lib.jd_unpack_nibble_v1(
            dc16.data_ptr(), e.data_ptr(), ov.data_ptr(), esc_idx.data_ptr(),
            esc_val.data_ptr(), out.data_ptr(), agg.data_ptr(), b, n_blk, k,
            ov.shape[1], esc_idx.shape[1], k6._stream(dc16))
    launch_check(rc, "unpack_nibble_v1")
    unpack_nibble_v1.launches += 1
    return out


#: Launches of K6a's first form since the count was last set to 0.
unpack_nibble_v1.launches = 0


def blocks_to_rgb_v1(blocks, qtables, geom, *, comp_shapes, comp_hv, height,
                     width, samplings, idct, upsample, color, precision,
                     lib=None, staged: bool = False,
                     tile=None) -> torch.Tensor:
    """K6b's first form on CUDA tensors: the arguments and result of
    ``pixels_cuda.blocks_to_rgb``.  ``lib``: a build of ``csrc/pixels.cu``
    (``pixels_cuda.build()`` by default; ``testing/pixel_variants.py``
    passes builds of its variants); ``staged``: room for the staged RGB rows
    of the variant that stores them 16 bytes at a time.  Counts
    ``blocks_to_rgb_v1.launches``."""
    if blocks.device.type != "cuda":
        raise ValueError(f"the first form runs on the card, not "
                         f"{blocks.device}")
    k6.check_rgb_args(blocks, qtables, geom, len(comp_shapes), idct)
    if blocks.shape[0] != geom.shape[0]:
        raise ValueError("the first form takes blocks of every image")
    dev = blocks.device
    plan = k6.rgb_plan(comp_shapes=comp_shapes, comp_hv=comp_hv,
                       height=height, width=width, samplings=samplings,
                       upsample=upsample, color=color, precision=precision,
                       tile=tile)
    if idct in ("kron", "fast"):
        src, mode = k6.scan_samples(blocks, qtables, comp_hv, idct), \
            "samples"
    else:
        src, mode = blocks, idct
    if src.data_ptr() % 16:
        raise ValueError("samples must be 16-byte aligned")
    out = torch.empty((blocks.shape[0], plan.out_h, plan.out_w, 3),
                      dtype=pixel._sample_dtype(precision), device=dev)
    win = -(-plan.window_ints // 4) * 4
    pitch = -(-(plan.tile_w * 3 * out.element_size() + 15) // 16) * 16
    smem = k6.SCRATCH[mode] + 4 * win + (plan.tile_h * pitch if staged
                                         else 0)
    n_comps = len(comp_shapes)
    dims = (ctypes.c_int32 * 14)(
        n_comps, plan.bpm, plan.out_h, plan.out_w, plan.tile_h, plan.tile_w,
        plan.tiles_x, plan.colour, plan.center, plan.maxv, k6.MODES[mode],
        out.element_size(), win, pitch)
    geo = (ctypes.c_int32 * (10 * n_comps))(
        *(x for c in plan.comps for x in c))
    lib = lib or k6.build()
    kron = idct_cuda._basis(dev, False)
    with torch.cuda.device(dev):
        rc = lib.jd_blocks_to_rgb_v1(
            src.data_ptr(), qtables.data_ptr(), geom.data_ptr(),
            kron.data_ptr(), out.data_ptr(), blocks.shape[0], src.shape[1],
            dims, geo, plan.n_tiles, smem, k6._stream(blocks))
    launch_check(rc, "blocks_to_rgb_v1")
    blocks_to_rgb_v1.launches += 1
    return out


#: Launches of the first form since the count was last set to 0.
blocks_to_rgb_v1.launches = 0
