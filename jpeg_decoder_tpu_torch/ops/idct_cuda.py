"""Fused dequantize + 8x8 IDCT: the hand-written CUDA kernel and its twin.

Counterpart of ``jpeg_decoder_tpu/ops/idct_pallas.py``.  The separable 2-D
IDCT ``out = M @ X @ M^T`` is rewritten via the Kronecker identity
``vec(M X M^T) = (M (x) M) vec(X)``, so every 8x8 block is a 64-vector and
the whole transform is one ``(N, 64) @ (64, 64)`` product, with the
dequantising multiply fused in front of it.

* :func:`fused_dequant_idct` launches ``csrc/idct.cu`` on a CUDA tensor
  (built with nvcc for sm_90a at first use into ``.cache/torch/kernels/``,
  bound with ctypes) and counts its launches in
  ``fused_dequant_idct.launches``.  A failed build or launch raises.  On a
  CPU tensor it runs :func:`idct_kron`; that is the only way the plain
  version is reached.
* :func:`idct_kron` is the plain PyTorch twin, the reference the kernel is
  held to.

The JAX kernel takes one image's (N, 64) blocks and a (64,) qtable under a
``vmap``; here the batch is written out: (B, N, 64) blocks and (B, 64)
qtables, one launch per component for a whole geometry group.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np
import torch

from .._build import shared_lib
from .pixel import IDCT_M

#: (64, 64) Kronecker IDCT basis: KRON[p*8+q, u*8+v] = M[p,u] * M[q,v].
IDCT_KRON = np.kron(IDCT_M, IDCT_M).astype(np.float32)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "idct.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
_basis_cache: dict[torch.device, torch.Tensor] = {}
#: nvcc's output of the last build (register and shared-memory use).
build_log = ""


class KernelBuildFailure(RuntimeError):
    """nvcc is missing or refused ``csrc/idct.cu``."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildFailure("nvcc not found (set CUDA_HOME)")


def build():
    """Compile ``csrc/idct.cu`` (once per source and flag set, into
    ``.cache/torch/kernels/``) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path, log = shared_lib(_nvcc(), NVCC_FLAGS, _SRC, "kernels",
                               "jd_idct", KernelBuildFailure)
        if log is not None:
            build_log = log
        lib = ctypes.CDLL(path)
        lib.jd_fused_dequant_idct.restype = ctypes.c_int
        lib.jd_fused_dequant_idct.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,   # blocks, qtable
            ctypes.c_void_p, ctypes.c_void_p,   # kron_t, out
            ctypes.c_int64, ctypes.c_int64,     # n_img, n_blk
            ctypes.c_void_p,                    # stream
        ]
        _lib = lib
    return _lib


def _basis_t(device: torch.device) -> torch.Tensor:
    """IDCT_KRON^T as a float32 tensor on ``device`` (cached per device)."""
    t = _basis_cache.get(device)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(IDCT_KRON.T)).to(device)
        _basis_cache[device] = t
    return t


def idct_kron(blocks: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: dequant + IDCT via the (64, 64) Kronecker matmul.

    blocks: (B, N, 64) int32 quantized coefficients (natural order).
    qtable: (B, 64) int32.  Returns (B, N, 64) int32 pixel-domain samples.

    The product must run in full float32: on a CUDA tensor this needs
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default),
    and the twin raises rather than compute a TF32 reference.
    """
    if blocks.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "idct_kron needs full float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    deq = (blocks * qtable[:, None, :].to(torch.int32)).to(torch.float32)
    out = torch.matmul(deq, _basis_t(blocks.device))
    return torch.round(out).to(torch.int32)


def _check(blocks: torch.Tensor, qtable: torch.Tensor) -> None:
    if qtable.device != blocks.device:
        raise ValueError(f"qtable on {qtable.device}, blocks on "
                         f"{blocks.device}")
    if blocks.dtype != torch.int32 or qtable.dtype != torch.int32:
        raise TypeError(f"need int32 blocks and qtable, got {blocks.dtype} "
                        f"and {qtable.dtype}")
    if blocks.dim() != 3 or blocks.shape[2] != 64:
        raise ValueError(f"blocks must be (B, N, 64), got "
                         f"{tuple(blocks.shape)}")
    if tuple(qtable.shape) != (blocks.shape[0], 64):
        raise ValueError(f"qtable must be ({blocks.shape[0]}, 64), got "
                         f"{tuple(qtable.shape)}")
    if blocks.shape[0] > 65535:
        raise ValueError("at most 65535 images per launch")
    for name, t in (("blocks", blocks), ("qtable", qtable)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def fused_dequant_idct(blocks: torch.Tensor,
                       qtable: torch.Tensor) -> torch.Tensor:
    """(B, N, 64) int32 blocks + (B, 64) int32 qtables -> (B, N, 64) int32.

    On a CUDA tensor this launches the CUDA kernel or raises; on a CPU
    tensor it runs the plain twin :func:`idct_kron`.
    """
    if blocks.device.type == "cpu":
        _check(blocks, qtable)
        return idct_kron(blocks, qtable)
    if blocks.device.type != "cuda":
        raise ValueError(f"no kernel for device {blocks.device}")
    _check(blocks, qtable)
    lib = build()
    out = torch.empty_like(blocks)
    basis = _basis_t(blocks.device)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        rc = lib.jd_fused_dequant_idct(
            blocks.data_ptr(), qtable.data_ptr(), basis.data_ptr(),
            out.data_ptr(), blocks.shape[0], blocks.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"fused_dequant_idct launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        fused_dequant_idct.launches += 1
    return out


#: Launches of the CUDA kernel since the count was last set to 0.
fused_dequant_idct.launches = 0
