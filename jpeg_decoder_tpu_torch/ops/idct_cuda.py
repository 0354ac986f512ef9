"""Fused dequantize + 8x8 IDCT: the hand-written CUDA kernel and its twin.

Counterpart of ``jpeg_decoder_tpu/ops/idct_pallas.py``.  The separable 2-D
IDCT ``out = M @ X @ M^T`` is rewritten via the Kronecker identity
``vec(M X M^T) = (M (x) M) vec(X)``, so every 8x8 block is a 64-vector and
the whole transform is one ``(N, 64) @ (64, 64)`` product, with the
dequantising multiply fused in front of it.

* :func:`fused_dequant_idct` launches ``csrc/idct.cu`` on a CUDA tensor
  (built with nvcc for sm_90a at first use into ``.cache/torch/kernels/``,
  bound with ctypes) and counts its launches in
  ``fused_dequant_idct.launches``.  The kernel sums the product separably
  (row pass, column pass) and recomputes in the Kronecker order the samples
  that lie near a half, so it rounds as the twin does.  A failed build or
  launch raises.  On a CPU tensor it runs :func:`idct_kron`; that is the
  only way a plain version is reached.
* :func:`idct_kron` is the plain PyTorch twin, the reference the kernel is
  held to.
* :func:`idct_separable` is the plain version of the kernel's own
  arithmetic, in its order, for the CPU tests; no path runs it.

The JAX kernel takes one image's (N, 64) blocks and a (64,) qtable under a
``vmap``; here the batch is written out: (B, N, 64) blocks and (B, 64)
qtables, one launch per component for a whole geometry group.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .._build import CudaLib, KernelBuildFailure, launch_check
from .pixel import IDCT_M, trunc_int32

__all__ = ["KernelBuildFailure", "build", "fused_dequant_idct", "idct_kron",
           "idct_separable"]

#: (64, 64) Kronecker IDCT basis: KRON[p*8+q, u*8+v] = M[p,u] * M[q,v].
IDCT_KRON = np.kron(IDCT_M, IDCT_M).astype(np.float32)
#: The kernel's separable basis, sqrt(8) * IDCT_M in float32: column 0 is
#: exactly 1.0, so a DC-only block comes out as exactly dc*q/8 (the kernel
#: multiplies by 1/8 last, exactly).  csrc/idct.cu holds the same values.
IDCT_S = (np.sqrt(8.0) * IDCT_M).astype(np.float32)
#: A separable sample within EPS_SCALE * sum|deq| of a half is recomputed in
#: the Kronecker order (2^-22 of the block's sum|deq|/8).
EPS_SCALE = 2.0 ** -25

LIB = CudaLib("idct.cu", "jd_idct", {"jd_fused_dequant_idct": [
    ctypes.c_void_p, ctypes.c_void_p,   # blocks, qtable
    ctypes.c_void_p, ctypes.c_void_p,   # kron, out
    ctypes.c_int64, ctypes.c_int64,     # n_img, n_blk
    ctypes.c_void_p,                    # stream
]})

_count_lock = threading.Lock()
_basis_cache: dict[tuple[torch.device, bool], torch.Tensor] = {}


def build():
    """Compile ``csrc/idct.cu`` (once per source and flag set, into
    ``.cache/torch/kernels/``) and load it."""
    return LIB.load()


def _basis(device: torch.device, transpose: bool) -> torch.Tensor:
    """IDCT_KRON (the kernel's row per sample) or its transpose (the twin's
    right operand) as a float32 tensor on ``device``, cached per device."""
    t = _basis_cache.get((device, transpose))
    if t is None:
        m = IDCT_KRON.T if transpose else IDCT_KRON
        t = torch.from_numpy(np.ascontiguousarray(m)).to(device)
        _basis_cache[(device, transpose)] = t
    return t


def _basis_t(device: torch.device) -> torch.Tensor:
    """IDCT_KRON^T on ``device``: ``deq @ _basis_t`` is the product."""
    return _basis(device, True)


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
    # Saturating, as XLA's convert and the kernel's __float2int_rn are.
    return trunc_int32(torch.round(out))


def _fma(a, b, c):
    """float32 fma(a, b, c) emulated in float64 (the product is exact there;
    the sum then rounds twice, which differs from one rounding only on an
    exact float32 tie of it, far rarer than anything the tests count)."""
    return (a.double() * b.double() + c.double()).float()


def _separable(x: torch.Tensor):
    """The kernel's separable sum of dequantised (B, N, 64) float32 blocks:
    (B, N, 64) float32 samples before rounding, and each block's eps."""
    b, n, _ = x.shape
    xr = x.reshape(b, n, 8, 8)                      # [.., u, v]
    s = torch.from_numpy(IDCT_S).to(x.device)
    t = xr[..., :, None, 0] * s[:, 0]               # [.., u, c]
    for v in range(1, 8):
        t = _fma(xr[..., :, None, v], s[:, v], t)
    o = s[:, None, 0] * t[..., None, 0, :]          # [.., p, c]
    for u in range(1, 8):
        o = _fma(s[:, None, u], t[..., None, u, :], o)
    rows = xr.abs()
    acc = rows[..., 0]
    for v in range(1, 8):
        acc = acc + rows[..., v]
    acc = acc[..., 0::2] + acc[..., 1::2]
    acc = acc[..., 0::2] + acc[..., 1::2]
    return (o * 0.125).reshape(b, n, 64), (acc[..., 0] + acc[..., 1]) * \
        EPS_SCALE


def idct_separable(blocks: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """Plain version of the CUDA kernel's arithmetic, in the kernel's order.

    blocks: (B, N, 64) int32, qtable: (B, 64) int32, as :func:`idct_kron`.
    Row pass t[u][c] = sum_v x[u][v] S[c][v], column pass o[p][c] = sum_u
    S[p][u] t[u][c] / 8, each a float32 FMA chain in index order with
    S = :data:`IDCT_S`; then a sample within eps = sum|x| * 2^-25 of a half
    (sum|x| summed per row in order, then over rows 0+1, 2+3, ... as the
    kernel's lane shuffles do) is recomputed as the 64-term Kronecker FMA
    chain in k order; rint half to even.  Returns (B, N, 64) int32.
    """
    x = (blocks * qtable[:, None, :].to(torch.int32)).to(torch.float32)
    o, eps = _separable(x)
    near = (o - torch.floor(o) - 0.5).abs() < eps[..., None]
    res = torch.round(o)
    bi, ni, pi = torch.nonzero(near, as_tuple=True)
    if len(bi):
        xs = x[bi, ni]                               # (M, 64)
        w = torch.from_numpy(IDCT_KRON).to(blocks.device)[pi]
        acc = torch.zeros(len(bi), dtype=torch.float32,
                          device=blocks.device)
        for k in range(64):
            acc = _fma(xs[:, k], w[:, k], acc)
        res[bi, ni, pi] = torch.round(acc)
    return res.to(torch.int32)


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
    basis = _basis(blocks.device, False)
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        rc = lib.jd_fused_dequant_idct(
            blocks.data_ptr(), qtable.data_ptr(), basis.data_ptr(),
            out.data_ptr(), blocks.shape[0], blocks.shape[1], stream)
    launch_check(rc, "fused_dequant_idct")
    with _count_lock:
        fused_dequant_idct.launches += 1
    return out


#: Launches of the CUDA kernel since the count was last set to 0.
fused_dequant_idct.launches = 0
