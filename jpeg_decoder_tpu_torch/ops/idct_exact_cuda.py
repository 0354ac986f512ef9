"""Strict ``exact`` dequantize + AAN IDCT: the hand-written CUDA kernel (K5)
and its twin.

Counterpart of the XLA code of ``jpeg_decoder_tpu/ops/pixel.py``:
``dequantize`` followed by ``idct_exact`` (the reference's AAN butterfly
with truncating int32 stores between the column and row passes,
jpeg.cpp:594-753), which the JAX package's strict mode runs op by op.

* :func:`dequant_idct_exact` launches ``csrc/idct_exact.cu`` on a CUDA
  tensor (built with nvcc for sm_90a at first use into
  ``.cache/torch/kernels/``, bound with ctypes) and counts its launches in
  ``dequant_idct_exact.launches``.  Every float operation of the kernel is
  an uncontracted ``__fmul_rn``/``__fadd_rn``/``__fsub_rn``, so it gives the
  twin's bytes.  A failed build or launch raises.  On a CPU tensor it runs
  :func:`exact_twin`; that is the only way the twin is reached.
* :func:`exact_twin` is the plain PyTorch version, op by op
  (``pixel.dequantize`` then ``pixel.idct_exact``), the reference the
  kernel is held to.

Same interface as K1 (``ops/idct_cuda.py``): (B, N, 64) int32 blocks and
(B, 64) int32 qtables, one launch per component for a whole batch.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .._build import CudaLib, launch_check
from . import pixel
from .idct_cuda import _check

__all__ = ["build", "dequant_idct_exact", "exact_twin"]

LIB = CudaLib("idct_exact.cu", "jd_idct_exact", {"jd_dequant_idct_exact": [
    ctypes.c_void_p, ctypes.c_void_p,   # blocks, qtable
    ctypes.c_void_p,                    # out
    ctypes.c_int64, ctypes.c_int64,     # n_img, n_blk
    ctypes.c_void_p,                    # stream
]})

_count_lock = threading.Lock()


def build():
    """Compile ``csrc/idct_exact.cu`` (once per source and flag set, into
    ``.cache/torch/kernels/``) and load it."""
    return LIB.load()


def exact_twin(blocks: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: (B, N, 64) int32 blocks and (B, 64) int32
    qtables -> (B, N, 64) int32 samples, by ``pixel.dequantize`` and
    ``pixel.idct_exact`` one op at a time."""
    b, n = blocks.shape[:2]
    deq = pixel.dequantize(blocks, qtable)
    return pixel.idct_exact(deq.reshape(b, n, 8, 8)).reshape(b, n, 64)


def dequant_idct_exact(blocks: torch.Tensor,
                       qtable: torch.Tensor) -> torch.Tensor:
    """(B, N, 64) int32 blocks + (B, 64) int32 qtables -> (B, N, 64) int32.

    On a CUDA tensor this launches the CUDA kernel or raises; on a CPU
    tensor it runs the plain twin :func:`exact_twin`.
    """
    if blocks.device.type == "cpu":
        _check(blocks, qtable)
        return exact_twin(blocks, qtable)
    if blocks.device.type != "cuda":
        raise ValueError(f"no kernel for device {blocks.device}")
    _check(blocks, qtable)
    lib = build()
    out = torch.empty_like(blocks)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        rc = lib.jd_dequant_idct_exact(
            blocks.data_ptr(), qtable.data_ptr(), out.data_ptr(),
            blocks.shape[0], blocks.shape[1], stream)
    launch_check(rc, "dequant_idct_exact")
    with _count_lock:
        dequant_idct_exact.launches += 1
    return out


#: Launches of the CUDA kernel since the count was last set to 0.
dequant_idct_exact.launches = 0
