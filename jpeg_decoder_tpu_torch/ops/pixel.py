"""Device pixel pipeline: dequantize -> 8x8 IDCT -> upsample + YCbCr->RGB.

Counterpart of ``jpeg_decoder_tpu/ops/pixel.py``, in PyTorch.  Where the
JAX package maps one image under ``vmap``, every function here takes the
batch as its leading dimension: planes are (B, H, W), coefficient planes
(B, rows, cols, 64), quantisation tables (B, 64).

IDCT modes:

* ``pallas`` — the fused dequant+IDCT kernel (``ops/idct_cuda.py``): the
  hand-written CUDA kernel on a CUDA tensor, its plain twin on a CPU tensor.
  Unlike the JAX package, it never silently turns into ``kron``.
* ``kron`` — the plain twin itself (same arithmetic).
* ``fast`` — the orthonormal 2-D IDCT as two 8x8 contractions
  (``M @ X @ M^T``), within +-1 of the other two.

``exact`` (the bit-exact AAN butterfly), CMYK/YCCK/RGB colour and 12-bit
frames are not ported yet.

Colour conversion (jpeg.cpp:521-535): R = Y + 1.402 Cr + 128, etc., computed
in float32 in the reference's op order and truncated toward zero on int
conversion, then clamped to [0, 255].
"""

from __future__ import annotations

import numpy as np
import torch

#: Orthonormal IDCT basis: IDCT_M[p, u] = a(u) * cos((2p+1) u pi / 16),
#: a(0) = 1/sqrt(8), a(u>0) = 1/2.  out = M @ X @ M^T.  Built by the same
#: numpy expressions as the JAX package, so the two are bit-identical.
IDCT_M = np.zeros((8, 8), dtype=np.float64)
for _p in range(8):
    for _u in range(8):
        a = np.sqrt(1.0 / 8.0) if _u == 0 else 0.5
        IDCT_M[_p, _u] = a * np.cos((2 * _p + 1) * _u * np.pi / 16.0)
IDCT_M_F32 = IDCT_M.astype(np.float32)

_F32 = torch.float32


def dequantize(coefs: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """int32 coefficient planes (B, ..., 64) * natural-order qtables (B, 64).

    Parity: dequantizeMCUComponent (jpeg.cpp:563-569) — plain int multiply.
    """
    q = qtable.to(torch.int32).reshape(
        qtable.shape[0], *([1] * (coefs.dim() - 2)), 64)
    return coefs * q


def idct_fast(blocks: torch.Tensor) -> torch.Tensor:
    """Orthonormal IDCT on int32 blocks (..., 8, 8): out = M @ X @ M^T,
    rounded half to even to int32."""
    m = torch.from_numpy(IDCT_M_F32).to(blocks.device)
    y = torch.einsum("pu,...uv,qv->...pq", m, blocks.to(_F32), m)
    return torch.round(y).to(torch.int32)


def blocks_to_plane(plane: torch.Tensor) -> torch.Tensor:
    """(B, rows, cols, 64) block planes -> (B, rows*8, cols*8) pixel planes."""
    b, rows, cols = plane.shape[:3]
    return (plane.reshape(b, rows, cols, 8, 8)
                 .transpose(2, 3)
                 .reshape(b, rows * 8, cols * 8))


def upsample_nn(plane: torch.Tensor, vy: int, vx: int) -> torch.Tensor:
    """Nearest-neighbor chroma upsampling of (B, H, W) planes (parity:
    jpeg.cpp:517-520)."""
    if vy > 1:
        plane = torch.repeat_interleave(plane, vy, dim=1)
    if vx > 1:
        plane = torch.repeat_interleave(plane, vx, dim=2)
    return plane


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Interleave two equal-shape tensors along ``dim`` (a first)."""
    shape = list(a.shape)
    shape[dim] *= 2
    return torch.stack([a, b], dim=dim + 1).reshape(shape)


def _shift_down(x: torch.Tensor, edge_rows) -> torch.Tensor:
    """Row i+1 of (B, H, W) ``x`` with edge replication at the LAST VALID
    row: ``edge_rows`` is None (the array height) or a (B,) tensor of
    valid row counts when the plane carries geometry-bucket padding."""
    down = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    if edge_rows is None:
        return down
    iota = torch.arange(x.shape[1], device=x.device).view(1, -1, 1)
    return torch.where(iota + 1 >= edge_rows.view(-1, 1, 1), x, down)


def _shift_right(x: torch.Tensor, edge_cols) -> torch.Tensor:
    """Column j+1 of ``x`` with edge replication at the last valid column."""
    right = torch.cat([x[:, :, 1:], x[:, :, -1:]], dim=2)
    if edge_cols is None:
        return right
    iota = torch.arange(x.shape[2], device=x.device).view(1, 1, -1)
    return torch.where(iota + 1 >= edge_cols.view(-1, 1, 1), x, right)


def upsample_fancy(plane: torch.Tensor, vy: int, vx: int,
                   edge=None) -> torch.Tensor:
    """libjpeg-style 'fancy' triangular chroma upsampling of (B, H, W)
    level-shift-free samples (jdsample.c semantics): 3:1 triangle filter
    with centered sample grid.

    ``edge``: optional ((B,), (B,)) tensors of the TRUE sample extent
    (rows, cols) when the planes are geometry-bucket padded — edge
    replication then happens at each image's true edge, so samples inside
    it equal the unpadded pipeline's.

    libjpeg's fancy path exists only for the (2,1)/(1,2)/(2,2) ratios; any
    other ratio falls back to plain replication on both axes.
    """
    x = plane.to(torch.int32)
    e_r, e_c = edge if edge is not None else (None, None)
    if vy not in (1, 2) or vx not in (1, 2):
        return upsample_nn(x, vy, vx)
    if vy == 2 and vx == 2:
        up = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        down = _shift_down(x, e_r)
        rows_a = 3 * x + up      # contributes to output row 2i
        rows_b = 3 * x + down    # contributes to output row 2i+1
        cols = _interleave(rows_a, rows_b, dim=1)  # 0..1020 scale
        left = torch.cat([cols[:, :, :1], cols[:, :, :-1]], dim=2)
        right = _shift_right(cols, e_c)
        even = (3 * cols + left + 8) >> 4
        odd = (3 * cols + right + 7) >> 4
        return _interleave(even, odd, dim=2)
    out = x
    if vy == 2:
        up = torch.cat([out[:, :1], out[:, :-1]], dim=1)
        down = _shift_down(out, e_r)
        even = (3 * out + up + 1) >> 2
        odd = (3 * out + down + 2) >> 2
        out = _interleave(even, odd, dim=1)
    if vx == 2:
        left = torch.cat([out[:, :, :1], out[:, :, :-1]], dim=2)
        right = _shift_right(out, e_c)
        even = (3 * out + left + 1) >> 2
        odd = (3 * out + right + 2) >> 2
        out = _interleave(even, odd, dim=2)
    return out


def _ycbcr_channels(y: torch.Tensor, cb: torch.Tensor,
                    cr: torch.Tensor) -> torch.Tensor:
    """YCbCr -> clamped int32 (..., 3) with the reference's float32 op
    order and truncating int conversion (jpeg.cpp:521-535).  Every constant
    is a float32 tensor so each op rounds to float32 as in the reference."""
    dev = y.device

    def c(v):
        return torch.tensor(v, dtype=_F32, device=dev)

    yf, cbf, crf = y.to(_F32), cb.to(_F32), cr.to(_F32)
    center = c(128.0)
    r = yf + c(1.402) * crf + center
    g = yf - c(0.344) * cbf - c(0.714) * crf + center
    b = yf + c(1.772) * cbf + center
    rgb = torch.stack([r, g, b], dim=-1)
    # float->int conversion truncates toward zero; clamp after.
    return torch.clamp(rgb.to(torch.int32), 0, 255)


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor,
                 cr: torch.Tensor) -> torch.Tensor:
    """Colour conversion (jpeg.cpp:521-535); output uint8 (..., 3)."""
    return _ycbcr_channels(y, cb, cr).to(torch.uint8)


def gray_to_rgb(y: torch.Tensor) -> torch.Tensor:
    v = torch.clamp(y + 128, 0, 255).to(torch.uint8)
    return torch.stack([v, v, v], dim=-1)


def pixel_pipeline_impl(planes, qtables, *, height: int, width: int,
                        samplings: tuple, idct: str = "pallas",
                        upsample: str = "fancy", color: str = "auto",
                        true_dims=None) -> torch.Tensor:
    """Full pixel pipeline on per-component coefficient planes.

    Args:
      planes: tuple of (B, rows_c, cols_c, 64) int32 quantized-coefficient
        planes, one per component.
      qtables: tuple of (B, 64) int32 natural-order quant tables.
      height/width: output crop.
      samplings: tuple of (v_repeat, h_repeat) per component — the
        upsampling factors v_max//v_c, h_max//h_c.
      idct: "pallas" (kernel), "kron" (its plain twin) or "fast".
      upsample: "fancy" or "nn".
      color: "auto" (by component count), "gray" or "ycbcr".
      true_dims: optional ((B,), (B,)) tensors (true_height, true_width)
        when ``height``/``width`` are GEOMETRY-BUCKET dims and the planes
        carry zero-padding blocks beyond each image's real extent; the
        fancy upsampler then replicates at the true edge.

    Returns (B, height, width, 3) uint8 RGB.
    """
    from . import idct_cuda

    if idct not in ("pallas", "kron", "fast"):
        raise ValueError(f"idct={idct!r} is not ported")
    if upsample not in ("fancy", "nn"):
        raise ValueError(f"unknown upsample {upsample!r}")
    if color == "auto":
        color = {1: "gray", 3: "ycbcr"}.get(len(planes), "unsupported")
    if (color, len(planes)) not in (("gray", 1), ("ycbcr", 3)):
        raise ValueError(f"colour {color!r} with {len(planes)} components "
                         "is not ported")
    pix = []
    for plane, q, (vy, vx) in zip(planes, qtables, samplings):
        b, rows, cols = plane.shape[:3]
        if idct == "fast":
            deq = dequantize(plane, q)
            out = idct_fast(deq.reshape(*deq.shape[:-1], 8, 8))
        else:
            fn = (idct_cuda.fused_dequant_idct if idct == "pallas"
                  else idct_cuda.idct_kron)
            out = fn(plane.reshape(b, rows * cols, 64), q)
        img = blocks_to_plane(out.reshape(b, rows, cols, 64))
        if (vy, vx) != (1, 1):
            # Upsample from the component's UNPADDED sample grid (T.81
            # A.1.1: ceil(dim / factor)), like libjpeg: the fancy filter's
            # edge replication must happen at the true edge.
            img = img[:, : -(-height // vy), : -(-width // vx)]
            if upsample == "nn":
                img = upsample_nn(img, vy, vx)
            else:
                edge = None
                if true_dims is not None:
                    th, tw = true_dims
                    edge = ((th + vy - 1) // vy, (tw + vx - 1) // vx)
                img = upsample_fancy(img, vy, vx, edge=edge)
        pix.append(img)
    if color == "gray":
        rgb = gray_to_rgb(pix[0])
    else:
        h = min(p.shape[1] for p in pix)
        w = min(p.shape[2] for p in pix)
        rgb = ycbcr_to_rgb(*(p[:, :h, :w] for p in pix))
    return rgb[:, :height, :width]
