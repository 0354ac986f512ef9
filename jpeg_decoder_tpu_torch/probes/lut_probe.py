"""LUT-probe kernels: the latency probe behind the Huffman decoder's LUT.

Counterpart of ``tools/pallas_mosaic_repro.py``, kept inside the package.
The core operation of the entropy kernel (``csrc/entropy.cu``) is "peek 16
stream bits, index a 65,536-entry LUT"; these two kernels isolate it:

* :func:`lut_chain_probe` — one thread, a chain of dependent probes
  ``acc += lut[(idx[i] + acc) & 0xFFFF]`` (the JAX file's ``lane_kernel`` and
  ``sublane_kernel``, which compute the same value): the latency of one
  Huffman lane's probe chain, with the table in device memory.
* :func:`lut_gather` — one thread per index, ``lut[idx & 0xFFFF]`` (the JAX
  file's ``vecprobe_kernel``): the per-lane probe.

Each launches ``csrc/lut_probe.cu`` on CUDA tensors (built with nvcc for
sm_90a at first use, bound with ctypes) and counts its launches in
``<function>.launches``; on CPU tensors it runs its plain twin
(:func:`lut_chain_torch`, :func:`lut_gather_torch`).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .._build import CudaLib, launch_check

#: The JAX file's chain indices (tools/pallas_mosaic_repro.py:37).
CHAIN_IDX = (17, 4093, 65535, 2, 9, 100, 7, 31)
LUT_SIZE = 1 << 16

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lut, idx, out
         ctypes.c_int64, ctypes.c_void_p]                    # n, stream
LIB = CudaLib("lut_probe.cu", "jd_lut_probe",
              {"jd_lut_chain": _ARGS, "jd_lut_gather": _ARGS})
_count_lock = threading.Lock()


def build():
    """Compile ``csrc/lut_probe.cu`` (once per source and flag set) and
    load it."""
    return LIB.load()


def chain_expected(idx) -> int:
    """The chain's value, computed as the JAX file computes ``expected``."""
    acc = 0
    for v in idx:
        acc += (int(v) + acc) & 0xFFFF
    return acc


def _check(lut: torch.Tensor, idx: torch.Tensor) -> None:
    if idx.device != lut.device:
        raise ValueError(f"idx on {idx.device}, lut on {lut.device}")
    if lut.dtype != torch.int32 or tuple(lut.shape) != (LUT_SIZE,):
        raise TypeError(f"lut must be ({LUT_SIZE},) int32, got {lut.dtype} "
                        f"{tuple(lut.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    for name, t in (("lut", lut), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(fn: str, lut: torch.Tensor, idx: torch.Tensor,
            out: torch.Tensor) -> None:
    if lut.device.type != "cuda":
        raise ValueError(f"no kernel for device {lut.device}")
    lib = build()
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream(lut.device).cuda_stream
        rc = getattr(lib, fn)(lut.data_ptr(), idx.data_ptr(), out.data_ptr(),
                              idx.numel(), stream)
    launch_check(rc, fn)


def lut_chain_torch(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`lut_chain_probe` (int32, wrapping)."""
    acc = torch.zeros((), dtype=torch.int32, device=lut.device)
    for v in idx.reshape(-1):
        acc = acc + lut[(v + acc) & 0xFFFF]
    return acc


def lut_chain_probe(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dependent probe chain over ``idx`` (any shape, read in order) into a
    (65536,) int32 LUT; returns the 0-d int32 sum.  Launches the kernel on
    CUDA tensors, runs :func:`lut_chain_torch` on CPU tensors."""
    _check(lut, idx)
    if lut.device.type == "cpu":
        return lut_chain_torch(lut, idx)
    out = torch.empty((), dtype=torch.int32, device=lut.device)
    _launch("jd_lut_chain", lut, idx, out)
    with _count_lock:
        lut_chain_probe.launches += 1
    return out


#: Launches of the chain kernel since the count was last set to 0.
lut_chain_probe.launches = 0


def lut_gather_torch(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`lut_gather`."""
    return lut[(idx & 0xFFFF).to(torch.int64)]


def lut_gather(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``lut[idx & 0xFFFF]`` for int32 ``idx`` of any shape, one thread per
    index.  Launches the kernel on CUDA tensors, runs
    :func:`lut_gather_torch` on CPU tensors."""
    _check(lut, idx)
    if lut.device.type == "cpu":
        return lut_gather_torch(lut, idx)
    out = torch.empty_like(idx)
    _launch("jd_lut_gather", lut, idx, out)
    with _count_lock:
        lut_gather.launches += 1
    return out


#: Launches of the gather kernel since the count was last set to 0.
lut_gather.launches = 0
