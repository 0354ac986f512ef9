"""Device pixel pipeline: dequantize -> 8x8 IDCT -> upsample + YCbCr->RGB.

Counterpart of ``jpeg_decoder_tpu/ops/pixel.py``, in PyTorch.  Where the
JAX package maps one image under ``vmap``, every function here takes the
batch as its leading dimension: planes are (B, H, W), coefficient planes
(B, rows, cols, 64), quantisation tables (B, 64).

IDCT modes:

* ``exact`` — the reference's AAN float butterfly with int32 truncating
  stores between the column and row passes (jpeg.cpp:594-753), bit-exact
  with the reference decoder: the hand-written CUDA kernel
  (``ops/idct_exact_cuda.py``) on a CUDA tensor, its plain op-by-op twin
  :func:`idct_exact` on a CPU tensor.  Every float32 operation rounds on
  its own in both (no contraction into FMAs), so the port has no "strict"
  variant: ``exact`` always gives the JAX package's eager strict bytes.
* ``pallas`` — the fused dequant+IDCT kernel (``ops/idct_cuda.py``): the
  hand-written CUDA kernel on a CUDA tensor, its plain twin on a CPU tensor.
  Unlike the JAX package, it never silently turns into ``kron``.
* ``kron`` — the plain twin itself (same arithmetic).
* ``fast`` — the orthonormal 2-D IDCT as two 8x8 contractions
  (``M @ X @ M^T``), within +-1 of the other two.

Colour (jpeg.cpp:521-535 and Pillow's conversions): gray, YCbCr, Adobe RGB
(stored as-is), CMYK and YCCK sources, to RGB or (4-component sources) to
PIL-convention CMYK; 12-bit gray and YCbCr frames come out as uint16
(0..4095).  Colour conversion computes in float32 in the reference's op
order and truncates toward zero on int conversion, then clamps.
"""

from __future__ import annotations

import numpy as np
import torch

# AAN constants (parity: reference types.hpp:5-19 — computed in float64,
# stored float32), by the JAX package's numpy expressions; the CUDA kernel
# holds the same values as hex literals (csrc/idct_exact.cu).
_M0 = np.float32(2.0 * np.cos(1.0 / 16.0 * 2.0 * np.pi))
_M1 = np.float32(2.0 * np.cos(2.0 / 16.0 * 2.0 * np.pi))
_M3 = _M1
_M5 = np.float32(2.0 * np.cos(3.0 / 16.0 * 2.0 * np.pi))
_M2 = np.float32(_M0 - _M5)
_M4 = np.float32(_M0 + _M5)

_S = [np.float32(np.cos(0.0) / np.sqrt(8.0))] + [
    np.float32(np.cos(k / 16.0 * np.pi) / 2.0) for k in range(1, 8)
]

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


def _f32(v, device) -> torch.Tensor:
    """A float32 scalar tensor: an op with it rounds to float32, as the
    reference's float constants do."""
    return torch.tensor(float(v), dtype=_F32, device=device)


def _aan_1d(x: torch.Tensor) -> torch.Tensor:
    """One scaled-AAN 1-D IDCT pass along dim -2 of float32 (..., 8, k).

    Mirrors inverseDCTComponent's column pass (jpeg.cpp:596-663) op for op,
    one float32 rounding per op, so the result matches the reference bit
    for bit."""
    dev = x.device
    s = [_f32(v, dev) for v in _S]
    m1, m2, m3, m4, m5 = (_f32(v, dev) for v in (_M1, _M2, _M3, _M4, _M5))
    g0 = x[..., 0, :] * s[0]
    g1 = x[..., 4, :] * s[4]
    g2 = x[..., 2, :] * s[2]
    g3 = x[..., 6, :] * s[6]
    g4 = x[..., 5, :] * s[5]
    g5 = x[..., 1, :] * s[1]
    g6 = x[..., 7, :] * s[7]
    g7 = x[..., 3, :] * s[3]

    f4 = g4 - g7
    f5 = g5 + g6
    f6 = g5 - g6
    f7 = g4 + g7

    e2 = g2 - g3
    e3 = g2 + g3
    e5 = f5 - f7
    e7 = f5 + f7
    e8 = f4 + f6

    d2 = e2 * m1
    d4 = f4 * m2
    d5 = e5 * m3
    d6 = f6 * m4
    d8 = e8 * m5

    c0 = g0 + g1
    c1 = g0 - g1
    c2 = d2 - e3
    c3 = e3
    c4 = d4 + d8
    c5 = d5 + e7
    c6 = d6 - d8
    c7 = e7
    c8 = c5 - c6

    b0 = c0 + c3
    b1 = c1 + c2
    b2 = c1 - c2
    b3 = c0 - c3
    b4 = c4 - c8
    b5 = c8
    b6 = c6 - c7
    b7 = c7

    return torch.stack(
        [b0 + b7, b1 + b6, b2 + b5, b3 + b4,
         b3 - b4, b2 - b5, b1 - b6, b0 - b7],
        dim=-2,
    )


#: Largest float32 below 2^31.
_F32_BELOW_2_31 = 2147483520.0


def trunc_int32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 toward zero, saturating at the int32 range as XLA's
    convert and CUDA's ``__float2int_rz`` do (a plain ``.to(torch.int32)``
    on the CPU gives INT_MIN for any value outside it)."""
    y = x.clamp(-2.0 ** 31, _F32_BELOW_2_31).to(torch.int32)
    return torch.where(x >= 2.0 ** 31,
                       torch.tensor(2 ** 31 - 1, dtype=torch.int32,
                                    device=x.device), y)


def idct_exact(blocks: torch.Tensor) -> torch.Tensor:
    """Bit-exact reference IDCT on int32 blocks (..., 8, 8) -> int32.

    Column pass, truncate to int32 (C++ float->int truncates toward zero,
    jpeg.cpp:655-662), then row pass, truncate again (jpeg.cpp:723-730)."""
    x = blocks.to(_F32)
    cols = trunc_int32(_aan_1d(x))  # truncating store between passes
    rows = _aan_1d(cols.to(_F32).transpose(-1, -2))
    return trunc_int32(rows).transpose(-1, -2)


def idct_fast(blocks: torch.Tensor) -> torch.Tensor:
    """Orthonormal IDCT on int32 blocks (..., 8, 8): out = M @ X @ M^T,
    rounded half to even to int32, saturating at the int32 range as XLA's
    convert does.

    The contractions must run in full float32: on a CUDA tensor this needs
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default),
    and the function raises rather than compute in TF32."""
    if blocks.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "idct_fast needs full float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    m = torch.from_numpy(IDCT_M_F32).to(blocks.device)
    y = torch.einsum("pu,...uv,qv->...pq", m, blocks.to(_F32), m)
    return trunc_int32(torch.round(y))


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


def _ycbcr_channels(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                    precision: int = 8) -> torch.Tensor:
    """YCbCr -> clamped int32 (..., 3) with the reference's float32 op
    order and truncating int conversion (jpeg.cpp:521-535).  Every constant
    is a float32 tensor so each op rounds to float32 as in the reference.
    For 12-bit frames (T.81 extended) the level shift is 2048 and the clamp
    0..4095."""
    dev = y.device
    center = _f32(1 << (precision - 1), dev)
    maxv = (1 << precision) - 1
    yf, cbf, crf = y.to(_F32), cb.to(_F32), cr.to(_F32)
    r = yf + _f32(np.float32(1.402), dev) * crf + center
    g = (yf - _f32(np.float32(0.344), dev) * cbf
         - _f32(np.float32(0.714), dev) * crf + center)
    b = yf + _f32(np.float32(1.772), dev) * cbf + center
    rgb = torch.stack([r, g, b], dim=-1)
    # Truncating toward zero, then clamping, equals clamping the float and
    # then truncating, for every finite value; clamping first keeps the int
    # conversion in range.
    return torch.clamp(rgb, 0, maxv).to(torch.int32)


def _sample_dtype(precision: int) -> torch.dtype:
    return torch.uint8 if precision <= 8 else torch.uint16


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 precision: int = 8) -> torch.Tensor:
    """Colour conversion (jpeg.cpp:521-535); output uint8 (..., 3) (uint16
    for 12-bit frames)."""
    return _ycbcr_channels(y, cb, cr, precision).to(_sample_dtype(precision))


def gray_to_rgb(y: torch.Tensor, precision: int = 8) -> torch.Tensor:
    v = torch.clamp(y + (1 << (precision - 1)), 0, (1 << precision) - 1)
    return torch.stack([v, v, v], dim=-1).to(_sample_dtype(precision))


def _level_shift_u8(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p + 128, 0, 255)


def cmyk_to_rgb(cmyk: torch.Tensor) -> torch.Tensor:
    """(..., 4) int32 CMYK (PIL convention: 0 = no ink) -> uint8 RGB.

    Bit-exact reimplementation of Pillow's ``cmyk2rgb`` (libImaging/
    Convert.c): ``out = nk - MULDIV255(in, nk)`` with ``nk = 255 - K`` and
    the ``(t + (t >> 8)) >> 8`` rounding of MULDIV255."""
    nk = 255 - cmyk[..., 3:4]
    t = cmyk[..., :3] * nk + 128
    scaled = (t + (t >> 8)) >> 8
    return torch.clamp(nk - scaled, 0, 255).to(torch.uint8)


def decoded_to_cmyk(pix: list, color: str) -> torch.Tensor:
    """Per-component decoded sample planes -> (..., 4) int32 CMYK in the
    PIL/Adobe-inverted convention (0 = no ink), i.e. exactly what
    ``np.array(PIL.Image.open(f))`` yields for the same JPEG.

    * ``ycck`` (Adobe transform 2): libjpeg's ycck_cmyk_convert computes
      C = 255 - R(y,cb,cr), M = 255 - G, Y = 255 - B, K as stored; PIL
      then inverts all four channels — the composition is
      (R, G, B, 255 - K_stored).
    * ``cmyk`` (transform 0 / no Adobe marker): samples stored as-is;
      PIL's inversion gives 255 - stored."""
    if color == "ycck":
        rgbish = _ycbcr_channels(pix[0], pix[1], pix[2])
        k = 255 - _level_shift_u8(pix[3])
        return torch.cat([rgbish, k[..., None]], dim=-1)
    return torch.stack([255 - _level_shift_u8(p) for p in pix], dim=-1)


def pixel_pipeline_impl(planes, qtables, *, height: int, width: int,
                        samplings: tuple, idct: str = "exact",
                        upsample: str = "fancy", color: str = "auto",
                        out_cmyk: bool = False, precision: int = 8,
                        true_dims=None) -> torch.Tensor:
    """Full pixel pipeline on per-component coefficient planes.

    Args:
      planes: tuple of (B, rows_c, cols_c, 64) int32 quantized-coefficient
        planes, one per component.
      qtables: tuple of (B, 64) int32 natural-order quant tables.
      height/width: output crop.
      samplings: tuple of (v_repeat, h_repeat) per component — the
        upsampling factors v_max//v_c, h_max//h_c.
      idct: "exact" (K5; its op-by-op twin on the CPU), "pallas" (K1; its
        twin on the CPU), "kron" (K1's twin) or "fast".
      upsample: "fancy" or "nn".
      color: source colour space — "auto" (by component count), "gray",
        "ycbcr", "rgb" (stored as-is), "ycck" or "cmyk".
      out_cmyk: for 4-component sources, return the (B, H, W, 4) CMYK
        planes (PIL-inverted convention) instead of converting to RGB.
      precision: sample precision of the frame (8 or 12); 12-bit frames
        (gray and YCbCr only) come out as uint16.
      true_dims: optional ((B,), (B,)) tensors (true_height, true_width)
        when ``height``/``width`` are GEOMETRY-BUCKET dims and the planes
        carry zero-padding blocks beyond each image's real extent; the
        fancy upsampler then replicates at the true edge.

    Returns (B, height, width, 3) uint8 RGB (uint16 for 12-bit frames), or
    (B, height, width, 4) uint8 CMYK.
    """
    from . import idct_cuda, idct_exact_cuda

    if idct not in ("exact", "pallas", "kron", "fast"):
        raise ValueError(f"unknown idct {idct!r}")
    if upsample not in ("fancy", "nn"):
        raise ValueError(f"unknown upsample {upsample!r}")
    if color == "auto":
        color = {1: "gray", 3: "ycbcr", 4: "cmyk"}.get(len(planes), "ycbcr")
    if precision != 8 and color in ("rgb", "ycck", "cmyk"):
        raise ValueError(
            "12-bit decode is supported for gray/YCbCr frames only")
    pix = []
    for plane, q, (vy, vx) in zip(planes, qtables, samplings):
        b, rows, cols = plane.shape[:3]
        if idct == "fast":
            deq = dequantize(plane, q)
            out = idct_fast(deq.reshape(*deq.shape[:-1], 8, 8))
        else:
            fn = {"exact": idct_exact_cuda.dequant_idct_exact,
                  "pallas": idct_cuda.fused_dequant_idct,
                  "kron": idct_cuda.idct_kron}[idct]
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
    if len(pix) == 1:
        rgb = gray_to_rgb(pix[0], precision)
    else:
        h = min(p.shape[1] for p in pix)
        w = min(p.shape[2] for p in pix)
        pix = [p[:, :h, :w] for p in pix]
        if color == "rgb":
            rgb = torch.stack([_level_shift_u8(p) for p in pix],
                              dim=-1).to(torch.uint8)
        elif color in ("ycck", "cmyk"):
            cmyk = decoded_to_cmyk(pix, color)
            if out_cmyk:
                return cmyk[:, :height, :width].to(torch.uint8)
            rgb = cmyk_to_rgb(cmyk)
        else:
            rgb = ycbcr_to_rgb(pix[0], pix[1], pix[2], precision)
    return rgb[:, :height, :width]


def pixel_pipeline_from_scan(blocks, qtables, comp_srcs, *,
                             comp_shapes: tuple, height: int, width: int,
                             samplings: tuple, idct: str = "exact",
                             upsample: str = "fancy", color: str = "auto",
                             out_cmyk: bool = False,
                             precision: int = 8) -> torch.Tensor:
    """Pixel pipeline of one image from raw scan-order blocks.

    ``blocks``: (N, 64) int32 scan-order blocks on the device (what the
    entropy decoder wrote); ``comp_srcs``: per component, the (rows*cols,)
    int64 scan index of each plane cell (``layout.scan_layout``'s
    ``comp_src``) on the same device; ``qtables``: per component, a (64,)
    int32 natural-order table.  Plane assembly is one device gather per
    component, then :func:`pixel_pipeline_impl` with a batch of 1.

    Returns (height, width, 3) RGB (or (height, width, 4) CMYK) on the
    blocks' device.
    """
    planes = tuple(
        blocks.index_select(0, src).view(1, rows, cols, 64)
        for src, (rows, cols) in zip(comp_srcs, comp_shapes))
    qts = tuple(q.reshape(1, 64) for q in qtables)
    return pixel_pipeline_impl(
        planes, qts, height=height, width=width, samplings=samplings,
        idct=idct, upsample=upsample, color=color, out_cmyk=out_cmyk,
        precision=precision)[0]
