"""Strict ``exact`` IDCT of the PyTorch port against the JAX package.

The port's op-by-op twin (``ops/pixel.py:idct_exact``) and the CPU path of
the K5 wrapper (``ops/idct_exact_cuda.py``) must equal the JAX package's
``idct_exact(dequantize(...))`` called eagerly, with 0 samples differing,
on blocks in the 8-bit and 12-bit ranges, DC-only blocks, sweeps over
truncation boundaries and blocks at the extremes of a 12-bit frame with
16-bit quant tables (int32 wraparound of the product, float->int
saturation).  ``decode(idct="exact")`` on the CPU must equal JAX's
``decode(idct="exact", strict=True)`` byte for byte, and stay within +-2
of JAX's jitted default (the jitted form may contract FMAs and flip a
truncation by one count, times the colour transform's x1.402).  The kernel
itself runs on the card in tests/test_torch_cuda.py.
"""

import io
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu.models import decoder as jdecoder  # noqa: E402
from jpeg_decoder_tpu.ops import pixel as jpixel  # noqa: E402

from jpeg_decoder_tpu_torch import decode  # noqa: E402
from jpeg_decoder_tpu_torch.ops import (  # noqa: E402
    idct_cuda, idct_exact_cuda, pixel)

RGB_TOL = 2   # jitted JAX: one truncation flipped, times the x1.402 gain
# K5's constants live in the header K5 (idct_exact.cu) and K6b share.
KERNEL_SRC = os.path.join(os.path.dirname(__file__), "..",
                          "jpeg_decoder_tpu_torch", "csrc",
                          "idct_common.cuh")


def _jax_exact(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """JAX eager: (B, N, 64) blocks and (B, 64) tables -> (B, N, 64)."""
    out = []
    for b in range(blocks.shape[0]):
        deq = jpixel.dequantize(jnp.asarray(blocks[b]), jnp.asarray(q[b]))
        out.append(np.asarray(jpixel.idct_exact(
            deq.reshape(-1, 8, 8))).reshape(-1, 64))
    return np.stack(out)


def _blocks(case: str):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "8bit":
        blocks = rng.integers(-1024, 1024, (2, 300, 64))
        q = rng.integers(1, 100, (2, 64))
    elif case == "12bit":
        blocks = rng.integers(-16384, 16384, (2, 300, 64))
        q = rng.integers(1, 256, (2, 64))
    elif case == "sparse_jpeg_like":
        blocks = np.where(rng.random((2, 300, 64)) < 0.1,
                          rng.integers(-40, 40, (2, 300, 64)), 0)
        blocks[..., 0] = rng.integers(-1024, 1024, (2, 300))
        q = rng.integers(1, 60, (2, 64))
    elif case == "dc_only":
        blocks = np.zeros((2, 300, 64), np.int64)
        blocks[..., 0] = rng.integers(-2048, 2048, (2, 300))
        q = rng.integers(1, 100, (2, 64))
    elif case == "dc_sweep":
        # Every DC value of a 12-bit frame against q = 1 and 8: outputs
        # dc*S0 (then again *S0) cross every integer, many land on one
        # exactly, and the negative half checks truncation toward zero.
        dc = np.arange(-32768, 32768).reshape(2, -1)
        blocks = np.zeros((2, dc.shape[1], 64), np.int64)
        blocks[..., 0] = dc
        q = np.ones((2, 64))
        q[1] = 8
    elif case == "one_ac_sweep":
        # One AC term at each position in turn, every value in +-300:
        # outputs are one cosine product each, near-integers included.
        vals = np.arange(-300, 301)
        blocks = np.zeros((1, 63 * len(vals), 64), np.int64)
        for k in range(1, 64):
            blocks[0, (k - 1) * len(vals):k * len(vals), k] = vals
        q = np.full((1, 64), 3)
    elif case == "saturating":
        # 12-bit coefficients up to 2^15 times 16-bit tables (Pq=1): the
        # int32 product wraps, and the passes leave the int32 range, where
        # the conversion saturates.
        blocks = rng.integers(-32768, 32768, (2, 200, 64))
        blocks[0, :20] = 32767
        blocks[0, 20:40] = -32768
        q = rng.integers(40000, 65536, (2, 64))
        q[0] = 65535
    else:
        raise ValueError(case)
    return blocks.astype(np.int32), q.astype(np.int32)


CASES = ["8bit", "12bit", "sparse_jpeg_like", "dc_only", "dc_sweep",
         "one_ac_sweep", "saturating"]


def test_aan_constants_are_jax_values():
    got = [pixel._M0, pixel._M1, pixel._M2, pixel._M3, pixel._M4, pixel._M5,
           *pixel._S]
    ref = [jpixel._M0, jpixel._M1, jpixel._M2, jpixel._M3, jpixel._M4,
           jpixel._M5, *jpixel._S]
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_kernel_hex_constants_equal_numpy():
    """The float literals of K5 (csrc/idct_common.cuh, which
    csrc/idct_exact.cu includes) are the numpy float32 constants, bit for
    bit."""
    with open(KERNEL_SRC) as f:
        src = f.read()
    src = src[src.index("// ---- K5"):]
    with open(idct_exact_cuda.LIB.src) as f:
        assert '#include "idct_common.cuh"' in f.read()
    lits = dict(re.findall(
        r"constexpr float (\w+) = (0x[0-9a-fA-F.]+p[+-]?\d+)f;", src))
    want = {"M1": pixel._M1, "M2": pixel._M2, "M3": pixel._M3,
            "M4": pixel._M4, "M5": pixel._M5,
            **{f"S{k}": s for k, s in enumerate(pixel._S)}}
    assert set(lits) == set(want)
    for name, v in want.items():
        assert np.float32(float.fromhex(lits[name])).tobytes() == \
            v.tobytes(), name


@pytest.mark.parametrize("case", CASES)
def test_idct_exact_twin_matches_jax(case):
    blocks, q = _blocks(case)
    ref = _jax_exact(blocks, q)
    got = idct_exact_cuda.exact_twin(torch.from_numpy(blocks),
                                     torch.from_numpy(q)).numpy()
    assert got.dtype == np.int32
    assert int((got != ref).sum()) == 0
    if case == "saturating":
        assert (ref == 2 ** 31 - 1).any() and (ref == -2 ** 31).any()


@pytest.mark.parametrize("case", ["8bit", "dc_only", "saturating"])
def test_kernel_cpu_path_is_the_twin(case):
    """On a CPU tensor the wrapper runs the twin and launches nothing."""
    blocks, q = _blocks(case)
    tb, tq = torch.from_numpy(blocks), torch.from_numpy(q)
    before = idct_exact_cuda.dequant_idct_exact.launches
    got = idct_exact_cuda.dequant_idct_exact(tb, tq)
    assert idct_exact_cuda.dequant_idct_exact.launches == before
    assert torch.equal(got, idct_exact_cuda.exact_twin(tb, tq))


def test_trunc_int32_saturates_like_jax():
    x = np.array([3e9, -3e9, 2147483520.0, 2 ** 31, -2 ** 31, -2147483904.0,
                  1e20, -1e20, -1.5, 1.5, -0.5, 0.0], np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = pixel.trunc_int32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("idct", ["fast", "kron"])
def test_fast_and_kron_saturate_like_jax(idct):
    """The extreme block (12-bit coefficients up to 2^15 times 16-bit
    tables, Pq=1) under ``fast`` and ``kron``: where JAX's rounded float
    leaves the int32 range it saturates, and the port must give the same
    saturated value (a plain ``.to(int32)`` gives INT_MIN on the CPU).
    ``kron``'s product sums in JAX's order: equal everywhere.  ``fast``
    contracts in another order than XLA's einsum: elsewhere within two
    float32 8-term contractions' rounding, 2^-22 of the block's sum|deq|,
    plus the final +-1."""
    from jpeg_decoder_tpu.ops import idct_pallas as jidct

    blocks, q = _blocks("saturating")
    if idct == "kron":
        ref = np.stack([np.asarray(jidct.idct_kron(jnp.asarray(blocks[b]),
                                                   jnp.asarray(q[b])))
                        for b in range(len(blocks))])
        got = idct_cuda.idct_kron(torch.from_numpy(blocks),
                                  torch.from_numpy(q)).numpy()
        bound = np.zeros(ref.shape)
    else:
        deq = (blocks * q[:, None, :]).reshape(-1, 8, 8)
        ref = np.asarray(jpixel.idct_fast(jnp.asarray(deq))).reshape(
            blocks.shape)
        got = pixel.idct_fast(torch.from_numpy(deq)).numpy().reshape(
            blocks.shape)
        bound = 1 + 2.0 ** -22 * np.abs(deq.astype(np.float64)).sum(
            (1, 2)).reshape(blocks.shape[:2])[..., None]
    assert got.dtype == np.int32
    sat = (ref == 2 ** 31 - 1) | (ref == -2 ** 31)
    assert (ref == 2 ** 31 - 1).any() and (ref == -2 ** 31).any()
    np.testing.assert_array_equal(got[sat], ref[sat])
    assert ((got == 2 ** 31 - 1) | (got == -2 ** 31))[~sat].sum() == 0
    d = np.abs(got.astype(np.int64) - ref)
    assert (d <= bound).all()


@pytest.mark.parametrize("kw,err", [
    (dict(dtype=torch.int64), TypeError),
    (dict(shape=(2, 10, 63)), ValueError),
    (dict(qshape=(3, 64)), ValueError),
])
def test_wrapper_checks_inputs(kw, err):
    blocks = torch.zeros(kw.get("shape", (2, 10, 64)),
                         dtype=kw.get("dtype", torch.int32))
    q = torch.ones(kw.get("qshape", (2, 64)), dtype=torch.int32)
    with pytest.raises(err):
        idct_exact_cuda.dequant_idct_exact(blocks, q)


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 8.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _pil(seed, h, w, **kw):
    buf = io.BytesIO()
    Image.fromarray(_rgb(seed, h, w)).save(buf, "JPEG", **kw)
    return buf.getvalue()


FRAMES = {
    "420": encode(_rgb(0, 37, 53), quality=90)[0],
    "420_dri2": encode(_rgb(1, 37, 53), quality=75, restart_interval=2)[0],
    "422": _pil(9, 33, 30, quality=85, subsampling=1),
    "422_dri1": _pil(2, 33, 30, quality=85, subsampling=1,
                     restart_marker_blocks=1),
    "444": encode(_rgb(3, 40, 48), samplings=((1, 1),) * 3, quality=95)[0],
    "444_dri5": encode(_rgb(4, 40, 48), samplings=((1, 1),) * 3,
                       quality=95, restart_interval=5)[0],
    "gray": encode(_rgb(5, 24, 40)[..., 0], grayscale=True,
                   samplings=((1, 1),), quality=85)[0],
    "gray_dri3": encode(_rgb(6, 24, 40)[..., 1], grayscale=True,
                        samplings=((1, 1),), quality=85,
                        restart_interval=3)[0],
    "progressive": _pil(7, 40, 56, quality=85, progressive=True),
    "arithmetic": encode(_rgb(8, 40, 56), arithmetic=True)[0],
}


@pytest.mark.parametrize("upsample", ["nn", "fancy"])
@pytest.mark.parametrize("name", list(FRAMES))
def test_strict_decode_equals_jax(name, upsample):
    blob = FRAMES[name]
    ref = jdecoder.decode(blob, idct="exact", strict=True, upsample=upsample)
    for strict in (True, False):
        got = decode(blob, idct="exact", strict=strict, upsample=upsample,
                     device="cpu")
        assert got.rgb.dtype == torch.uint8
        np.testing.assert_array_equal(got.rgb.numpy(), ref.rgb)


def test_default_arguments_decode_exact():
    """``decode(blob, device="cpu")`` takes JAX's defaults (idct="exact",
    upsample="nn") and gives JAX's strict bytes."""
    blob = FRAMES["420_dri2"]
    got = decode(blob, device="cpu")
    ref = jdecoder.decode(blob, strict=True)
    np.testing.assert_array_equal(got.rgb.numpy(), ref.rgb)


@pytest.mark.parametrize("name", ["420", "444_dri5", "gray", "progressive"])
def test_exact_within_jitted_jax(name):
    blob = FRAMES[name]
    ref = jdecoder.decode(blob, idct="exact", upsample="fancy")
    got = decode(blob, idct="exact", upsample="fancy", device="cpu")
    d = np.abs(got.rgb.numpy().astype(np.int32) - ref.rgb.astype(np.int32))
    assert d.max() <= RGB_TOL
