"""Cross-rank DC carry of the emit-lane decode (K7c): the CUDA kernel and its
plain version.

On a mesh each rank runs K7 (``ops/entropy_emit_cuda.decode_lanes`` with
``lanes=``) on its share of every image's lanes; K7's DC carry starts from
0 at the share's first lane, so the blocks of the restart segment open at
the share's start lack the DC sums of the ranks before it (a DRI-0 image is
one segment: every block of every rank but the first).  ``parallel/
sharded.py`` all-gathers each rank's per-(image, component) DC total of the
segment open at its last MCU, and :func:`add_carry` adds to each rank's
first segment the totals of the ranks before it in that segment (see
``csrc/emit_carry.cu``): the cross-device half of JAX's psum and segmented
prefix sum (jax sharded.py:630, :641-646).

* :func:`add_carry` launches ``csrc/emit_carry.cu`` (built with nvcc for
  sm_90a at first use, bound with ctypes) on CUDA tensors, on the current
  stream, after one copy of the host plan (rank mask and row ranges) to the
  card, and counts its launches in ``add_carry.launches``; a failed build
  or launch raises.  On CPU tensors it runs :func:`add_carry_torch`, the
  plain version it is held to; that is the only way the plain version is
  reached.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .._build import CudaLib, launch_check
from .staging import upload

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
LIB = CudaLib("emit_carry.cu", "jd_emit_carry", {
    "jd_emit_carry": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                      ctypes.c_uint64, _I64, _P]})
_count_lock = threading.Lock()


def build():
    """Compile ``csrc/emit_carry.cu`` (once per source and flag set) and
    load it."""
    return LIB.load()


def _check(out, tot, w, lo, hi, block_comp) -> None:
    if tot.device != out.device or not tot.is_contiguous():
        raise ValueError(f"tot must be contiguous on {out.device}")
    if out.dtype != torch.int32 or out.dim() != 3 or out.shape[2] != 64 \
            or not out.is_contiguous():
        raise TypeError(f"out must be contiguous (B, rows, 64) int32, got "
                        f"{out.dtype} {tuple(out.shape)}")
    b = out.shape[0]
    n_comps = max(block_comp) + 1
    if tot.dtype != torch.int32 or tot.dim() != 3 or tot.shape[1] != b \
            or tot.shape[2] != n_comps or w.shape != tuple(tot.shape[:2]):
        raise TypeError(f"tot must be (R, {b}, {n_comps}) int32 and w "
                        f"(R, {b}), got {tuple(tot.shape)} {w.shape}")
    if lo.shape != (b,) or hi.shape != (b,) or (lo < 0).any():
        raise ValueError(f"lo and hi must be ({b},) with 0 <= lo")
    if not 1 <= len(block_comp) <= 16 or not 1 <= n_comps <= 4:
        raise ValueError(f"bad block_comp {block_comp}")


def add_carry(out: torch.Tensor, tot: torch.Tensor, w, lo, hi, *,
              block_comp: tuple[int, ...]) -> torch.Tensor:
    """Add to coefficient 0 of image b's rows ``lo[b] .. hi[b]-1`` of
    ``out`` (B, rows, 64) int32, in place, ``sum_q w[q, b] * tot[q, b, c]``
    for the block's component c (``block_comp[row % bpm]``), wrapping as
    int32.  ``tot``: (R, B, n_comps) int32 DC totals of R ranks on
    ``out``'s device; ``w`` (R, B) 0/1 and ``lo``/``hi`` (B,) with 0 <= lo:
    the host plan (``parallel/sharded.carry_plan``'s numpy arrays), which
    goes to the device with the launch.  Where no range holds a row,
    nothing is launched.  Returns ``out``."""
    w, lo, hi = (np.asarray(a, np.int64) for a in (w, lo, hi))
    _check(out, tot, w, lo, hi, block_comp)
    dev = out.device
    max_span = int(np.maximum(hi - lo, 0).max(initial=0))
    if max_span == 0:
        return out
    if dev.type == "cpu":
        return add_carry_torch(out, tot, w, lo, hi, block_comp=block_comp)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    comp_code = sum(c << (4 * k) for k, c in enumerate(block_comp))
    with torch.cuda.device(dev):
        w_t, lo_t, hi_t = upload([w.astype(np.int32), lo, hi], dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = build().jd_emit_carry(
            out.data_ptr(), tot.data_ptr(), w_t.data_ptr(), lo_t.data_ptr(),
            hi_t.data_ptr(), out.shape[0], out.shape[1], tot.shape[0],
            tot.shape[2], len(block_comp), comp_code, max_span, stream)
    launch_check(rc, "jd_emit_carry")
    with _count_lock:
        add_carry.launches += 1
    return out


#: Launches of the CUDA kernel since the count was last set to 0.
add_carry.launches = 0


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def add_carry_torch(out: torch.Tensor, tot: torch.Tensor, w, lo, hi, *,
                    block_comp: tuple[int, ...]) -> torch.Tensor:
    """Plain PyTorch version of :func:`add_carry`, the same contract: the
    carry by a masked sum over ranks, then one indexed add per row range."""
    dev = out.device
    b, rows, _ = out.shape
    w, lo, hi = (torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                 for a in (w, lo, hi))
    carry = _wrap32((w[:, :, None] * tot.to(torch.int64)).sum(0))
    hi = hi.clamp(max=rows)
    span = (hi - lo).clamp(min=0)
    img = torch.repeat_interleave(torch.arange(b, device=dev), span)
    row = torch.arange(int(span.sum()), device=dev) - torch.repeat_interleave(
        span.cumsum(0) - span, span) + lo[img]
    comp = torch.tensor(block_comp, dtype=torch.int64, device=dev)
    flat = out.view(-1, 64)
    at = img * rows + row
    flat[at, 0] = _wrap32(flat[at, 0].to(torch.int64)
                          + carry[img, comp[row % len(block_comp)]]
                          ).to(torch.int32)
    return out
