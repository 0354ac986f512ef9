"""The plain reference: a frame's RGB from its quantised coefficients.

Written from T.81 and the configuration's stated pixel semantics, in plain
torch, importing nothing of the program.  It starts from the coefficient
planes that the benchmark's encoder coded (``corpus.Frame.planes``): the
entropy layer is lossless, so these are exactly what the program's parse
and Huffman decode must reconstruct, and a fault there shows in the RGB.

Semantics (``pixels`` in a configuration file):

* ``idct``: ``"round"`` is the orthonormal 2-D IDCT of the dequantised
  block, rounded half to even (the port's ``kron``), computed in a scaled
  basis whose rational entries are exact, so that a sample lying on a half
  (a flat chroma block's DC times its quantiser over 8, say) rounds as in
  exact arithmetic; ``"trunc"`` is the
  separable IDCT with the result of each 1-D pass truncated toward zero
  (the port's ``exact``, the reference decoder's float AAN semantics);
  samples stay level-shift-free and unclamped;
* ``upsample``: ``"nn"`` replicates chroma samples; ``"fancy"`` is
  libjpeg's triangle filter (jdsample.c), in integers, on the chroma plane
  cut to its true extent (T.81 A.1.1), edges replicated;
* colour: JFIF YCbCr to RGB with the constants 1.402, 0.344, 0.714 and
  1.772, plus 128, clamped to 0..255 and truncated.

``precision`` names the arithmetic of the IDCT and the colour conversion:
``"float64"`` for the reference itself, ``"tf32"`` for the control
(``portbench/control.py``): float32 matrix products of operands rounded to
TF32's 10-bit mantissa, which is what the tensor cores compute, here on
any device (cuBLAS may pick a non-TF32 kernel for 8 x 8 products even
where TF32 is allowed).
"""

from __future__ import annotations

import numpy as np
import torch

_PRECISIONS = {"float64": torch.float64, "tf32": torch.float32}


def idct_matrix() -> np.ndarray:
    """M[p, u] = a(u) cos((2p + 1) u pi / 16), a(0) = 1/sqrt(8), else 1/2:
    samples = M @ coefficients @ M.T."""
    p = np.arange(8)[:, None]
    u = np.arange(8)[None, :]
    return np.cos((2 * p + 1) * u * np.pi / 16) * np.where(
        u == 0, np.sqrt(1 / 8), 0.5)


def scaled_matrix() -> np.ndarray:
    """sqrt(8) * :func:`idct_matrix` with its rational entries exact:
    column 0 is 1 and column 4 is +-1 (cos(pi/4) / sqrt(2) * sqrt(8) / 2),
    so that a block whose only coefficients sit at frequencies 0 and 4
    gives its samples exactly (M X M^T = S X S^T / 8), and a sample that
    lies on a half rounds to even as it should."""
    s = np.sqrt(8.0) * idct_matrix()
    s[:, 0] = 1.0
    s[:, 4] = np.sign(s[:, 4])
    return s


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits, ties away
    from zero), as the tensor cores read them."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b``; under ``"tf32"`` the operands rounded to TF32 first and
    the products summed in float32, as the tensor cores do, on any
    device."""
    if precision != "tf32":
        return a @ b
    return _tf32(a) @ _tf32(b)


def samples(plane: torch.Tensor, qtable, idct: str,
            precision: str = "float64") -> torch.Tensor:
    """(rows, cols, 64) quantised coefficients -> (rows*8, cols*8) int32
    level-shift-free samples."""
    dt = _PRECISIONS[precision]
    dev = plane.device
    rows, cols = plane.shape[:2]
    q = torch.as_tensor(np.asarray(qtable), device=dev).to(torch.int64)
    x = (plane.to(torch.int64) * q).to(dt).reshape(rows, cols, 8, 8)
    m = torch.from_numpy(idct_matrix()).to(dev, dt)
    if idct == "round":
        s = torch.from_numpy(scaled_matrix()).to(dev, dt)
        y = torch.round(_matmul(_matmul(s, x, precision), s.T, precision)
                        / 8)
    elif idct == "trunc":
        t = torch.trunc(_matmul(m, x, precision))
        y = torch.trunc(_matmul(t, m.T, precision))
    else:
        raise ValueError(f"unknown idct semantics {idct!r}")
    y = y.to(torch.int32)
    return y.permute(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def _fancy(x: torch.Tensor, vy: int, vx: int) -> torch.Tensor:
    """libjpeg's triangle filter on (h, w) int32 samples: h2v1, h1v2 and
    h2v2 (jdsample.c), plain replication for other ratios."""
    if vy not in (1, 2) or vx not in (1, 2):
        return x.repeat_interleave(vy, 0).repeat_interleave(vx, 1)
    if vy == 2 and vx == 2:
        above = torch.cat([x[:1], x[:-1]], 0)
        below = torch.cat([x[1:], x[-1:]], 0)
        colsum = torch.stack([3 * x + above, 3 * x + below], 1) \
            .reshape(-1, x.shape[1])
        left = torch.cat([colsum[:, :1], colsum[:, :-1]], 1)
        right = torch.cat([colsum[:, 1:], colsum[:, -1:]], 1)
        even = (3 * colsum + left + 8) >> 4
        odd = (3 * colsum + right + 7) >> 4
        return torch.stack([even, odd], 2).reshape(colsum.shape[0], -1)
    if vy == 2:
        above = torch.cat([x[:1], x[:-1]], 0)
        below = torch.cat([x[1:], x[-1:]], 0)
        x = torch.stack([(3 * x + above + 1) >> 2, (3 * x + below + 2) >> 2],
                        1).reshape(-1, x.shape[1])
    if vx == 2:
        left = torch.cat([x[:, :1], x[:, :-1]], 1)
        right = torch.cat([x[:, 1:], x[:, -1:]], 1)
        x = torch.stack([(3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2],
                        2).reshape(x.shape[0], -1)
    return x


def rgb(planes, qtables, samplings, height: int, width: int, *, idct: str,
        upsample: str, precision: str = "float64") -> torch.Tensor:
    """A YCbCr frame's (height, width, 3) uint8 RGB on the planes' device."""
    h_max = max(s[0] for s in samplings)
    v_max = max(s[1] for s in samplings)
    comps = []
    for plane, qt, (h, v) in zip(planes, qtables, samplings):
        s = samples(plane, qt, idct, precision)
        vy, vx = v_max // v, h_max // h
        if (vy, vx) != (1, 1):
            s = s[:-(-height // vy), :-(-width // vx)]
            if upsample == "nn":
                s = s.repeat_interleave(vy, 0).repeat_interleave(vx, 1)
            elif upsample == "fancy":
                s = _fancy(s, vy, vx)
            else:
                raise ValueError(f"unknown upsampling {upsample!r}")
        comps.append(s[:height, :width])
    dt = _PRECISIONS[precision]
    y, cb, cr = (c.to(dt) for c in comps)
    r = y + 1.402 * cr + 128
    g = y - 0.344 * cb - 0.714 * cr + 128
    b = y + 1.772 * cb + 128
    out = torch.stack([r, g, b], -1)
    return torch.clamp(out, 0, 255).to(torch.int32).to(torch.uint8)


def compare(got: torch.Tensor, want: torch.Tensor) -> tuple[int, int, int]:
    """(samples that differ, the largest difference, samples compared)
    between two uint8 RGB images of one shape."""
    if got.shape != want.shape:
        return want.numel(), 255, want.numel()
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return int((d > 0).sum()), int(d.max()), d.numel()
