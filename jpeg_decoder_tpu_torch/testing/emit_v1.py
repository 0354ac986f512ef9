"""K7's first form, kept as the same-card baseline of the current kernel.

``csrc/entropy_emit_v1.cu`` is the emit-lane kernel as it was first ported:
one thread per lane refilling every word from device memory, the output
zero-filled before the launch, and the DC carry in two more launches (a
segmented scan with one CTA per image, then one CTA per lane adding the
carry-ins).  ``chip_smoke.py`` times it in turns with
``ops/entropy_emit_cuda.decode_lanes`` on the same inputs.  Nothing in
``decode()`` or ``BatchDecoder`` reaches this module.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import CudaLib, launch_check
from ..ops import entropy_cuda, entropy_emit_cuda

_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,   # pools, starts
    ctypes.c_void_p, ctypes.c_void_p,   # nm, lane_off
    ctypes.c_void_p, ctypes.c_void_p,   # seg_first, luts
    ctypes.c_void_p, ctypes.c_void_p,   # l1, out
    ctypes.c_void_p, ctypes.c_void_p,   # err, tot
    ctypes.c_int64, ctypes.c_int64,     # n_img, n_words
    ctypes.c_int64, ctypes.c_int64,     # lanes_per_img, n_mcus
    ctypes.c_int64, ctypes.c_int,       # trips, n_tables
    ctypes.c_int, ctypes.c_uint64,      # bpm, comp_code
    ctypes.c_int, ctypes.c_void_p,      # precision, stream
]
LIB = CudaLib("entropy_emit_v1.cu", "jd_entropy_emit_v1",
              {"jd_emit_decode": _ARGS, "jd_emit_carry": _ARGS})
#: The C entry points, in launch order: the emit kernel, then the carry
#: (scan and apply).
PHASES = ("jd_emit_decode", "jd_emit_carry")


def build():
    """Compile ``csrc/entropy_emit_v1.cu`` (once per source and flag set)
    and load it."""
    return LIB.load()


def buffers(pools: torch.Tensor, starts: torch.Tensor, n_mcus: int,
            bpm: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The zero-filled (B, n_mcus*bpm, 64) int32 blocks, (B,) int32 flags
    and (B*C, 4) int32 lane DC sums the two launches write."""
    b, c = starts.shape
    dev = pools.device
    return (torch.zeros((b, n_mcus * bpm, 64), dtype=torch.int32, device=dev),
            torch.zeros((b,), dtype=torch.int32, device=dev),
            torch.zeros((b * c, 4), dtype=torch.int32, device=dev))


def launch(args: tuple, entry: str, *, block_comp: tuple[int, ...],
           n_comps: int, n_mcus: int, trips: int, precision: int) -> None:
    """One launch of ``entry`` (one of :data:`PHASES`) on the current stream:
    ``args`` the tensors pools, starts, nm_lane, lane_off, seg_first, luts,
    l1 and the :func:`buffers`."""
    lib = build()
    pools, starts, luts = args[0], args[1], args[5]
    comp_code = sum(c << (4 * k) for k, c in enumerate(block_comp))
    dev = pools.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            *(t.data_ptr() for t in args), pools.shape[0], pools.shape[1],
            starts.shape[1], n_mcus, trips, luts.shape[0], len(block_comp),
            comp_code, precision, stream)
    launch_check(rc, entry)


def decode_lanes_v1(pools: torch.Tensor, starts: torch.Tensor,
                    nm_lane: torch.Tensor, lane_off: torch.Tensor,
                    seg_first: torch.Tensor, luts: torch.Tensor, *,
                    block_comp: tuple[int, ...], n_comps: int, n_mcus: int,
                    trips: int, precision: int = 8,
                    l1: torch.Tensor | None = None):
    """``entropy_emit_cuda.decode_lanes``'s contract on CUDA tensors
    through the first-form kernel: the zero-fill, the emit launch and the
    carry launch."""
    entropy_emit_cuda._check(pools, starts, nm_lane, lane_off, seg_first,
                             luts, block_comp, n_comps, n_mcus, trips)
    entropy_cuda.size_limits(precision)
    if pools.device.type != "cuda":
        raise ValueError("the first-form kernel runs on CUDA tensors only")
    if l1 is None:
        l1 = entropy_cuda.first_level(luts)
    kw = dict(block_comp=block_comp, n_comps=n_comps, n_mcus=n_mcus,
              trips=trips, precision=precision)
    bufs = buffers(pools, starts, n_mcus, len(block_comp))
    args = (pools, starts, nm_lane, lane_off, seg_first, luts, l1, *bufs)
    for entry in PHASES:
        launch(args, entry, **kw)
    return bufs[0], bufs[1]
