"""Fused dequant+IDCT of the PyTorch port against the JAX package.

The state the port carries across is constant: the IDCT bases, built by
the same numpy expressions, must be bit-identical.  The plain twin
``idct_kron`` is held to JAX's ``idct_kron`` and to the Pallas kernel run
in interpret mode, within +-1 (the bound of the JAX package's own test,
tests/test_entropy_pallas.py:70: the Kronecker form sums in another order
than the separable one).  ``idct_separable``, the plain version of the CUDA
kernel's own arithmetic (separable passes, then the Kronecker order for
samples near a half), is held to both within +-1 and equal on 99.99% of the
samples, with DC ties exact.  The CUDA kernel is held to the twin on the
card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_decoder_tpu.ops import idct_pallas as jidct
from jpeg_decoder_tpu.ops import pixel as jpixel

from jpeg_decoder_tpu_torch.ops import idct_cuda
from jpeg_decoder_tpu_torch.ops import pixel as tpixel

TOL = 1   # Kronecker-form rounding bound (tests/test_entropy_pallas.py:70)
# Both sides compute the same float32 dot; only another summation order can
# flip a rounding, which is rare.  A rounding fault (e.g. truncating instead
# of rounding half to even) changes about half of the samples.
MIN_EQUAL = 0.999


def _inputs(seed, b, n, lo=-512, hi=512):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(lo, hi, size=(b, n, 64)).astype(np.int32)
    q = rng.integers(1, 40, size=(b, 64)).astype(np.int32)
    return blocks, q


@pytest.mark.parametrize("name", ["IDCT_M", "IDCT_M_F32"])
def test_idct_m_bit_identical(name):
    got, ref = getattr(tpixel, name), getattr(jpixel, name)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()


def test_idct_kron_bit_identical():
    assert idct_cuda.IDCT_KRON.dtype == jidct.IDCT_KRON.dtype == np.float32
    assert idct_cuda.IDCT_KRON.tobytes() == jidct.IDCT_KRON.tobytes()


@pytest.mark.parametrize("seed,n", [(0, 2000), (1, 20000)])
def test_idct_kron_matches_jax_kron(seed, n):
    blocks, q = _inputs(seed, 1, n)
    ref = np.asarray(jidct.idct_kron(jnp.asarray(blocks[0]),
                                     jnp.asarray(q[0])))
    got = idct_cuda.idct_kron(torch.from_numpy(blocks),
                              torch.from_numpy(q))[0].numpy()
    assert got.dtype == np.int32
    assert np.abs(got.astype(np.int64) - ref).max() <= TOL
    assert (got == ref).mean() >= MIN_EQUAL


def test_idct_kron_matches_pallas_interpret():
    blocks, q = _inputs(2, 1, 700)
    ref = np.asarray(jidct.fused_dequant_idct(
        jnp.asarray(blocks[0]), jnp.asarray(q[0]), interpret=True))
    got = idct_cuda.idct_kron(torch.from_numpy(blocks),
                              torch.from_numpy(q))[0].numpy()
    assert np.abs(got.astype(np.int64) - ref).max() <= TOL
    assert (got == ref).mean() >= MIN_EQUAL


@pytest.mark.parametrize("ref", ["exact", "jax_kron", "pallas_interpret"])
def test_dc_ties_round_half_to_even(ref):
    """DC-only blocks: IDCT_KRON[:, 0] is exactly 1/8 in float32, so every
    sample is exactly dc*q/8; halves must round to even (``jnp.round``)
    in the twin as in the JAX kernel, with no sample differing."""
    assert (idct_cuda.IDCT_KRON[:, 0] == np.float32(0.125)).all()
    rng = np.random.default_rng(9)
    dc = rng.integers(-1024, 1024, size=(1, 600)).astype(np.int32)
    q = rng.integers(1, 40, size=(1, 64)).astype(np.int32)
    blocks = np.zeros((1, 600, 64), np.int32)
    blocks[:, :, 0] = dc
    assert (dc * q[:, :1] % 8 == 4).any()
    got = idct_cuda.idct_kron(torch.from_numpy(blocks),
                              torch.from_numpy(q))[0].numpy()
    if ref == "exact":
        want = np.broadcast_to(np.rint(dc[0] * q[0, 0] / 8.0)[:, None],
                               got.shape)
    elif ref == "jax_kron":
        want = jidct.idct_kron(jnp.asarray(blocks[0]), jnp.asarray(q[0]))
    else:
        want = jidct.fused_dequant_idct(jnp.asarray(blocks[0]),
                                        jnp.asarray(q[0]), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


SEP_MIN_EQUAL = 0.9999   # the kernel's bar against its twin on the card


def test_separable_basis_matches_kernel_constants():
    """K1's kS (csrc/idct_common.cuh, which csrc/idct.cu includes) is
    IDCT_S bit for bit, and its column 0 is exactly 1.0 (which makes
    DC-only blocks exact)."""
    import os
    import re

    assert '#include "idct_common.cuh"' in open(idct_cuda.LIB.src).read()
    src = open(os.path.join(os.path.dirname(idct_cuda.LIB.src),
                            "idct_common.cuh")).read()
    body = src[src.index("kS[8][8] = {"):]
    body = body[:body.index("};")]
    lits = re.findall(r"(-?0x1(?:\.[0-9a-f]+)?p[+-]\d+)f", body)
    got = np.array([float.fromhex(v) for v in lits], np.float32)
    assert got.shape == (64,)
    assert got.tobytes() == idct_cuda.IDCT_S.reshape(-1).tobytes()
    assert (idct_cuda.IDCT_S[:, 0] == np.float32(1.0)).all()
    m = re.search(r"kEpsScale = 0x1p(-\d+)f", src)
    assert 2.0 ** int(m.group(1)) == idct_cuda.EPS_SCALE


@pytest.mark.parametrize("seed,n", [(0, 2000), (1, 20000)])
def test_idct_separable_matches_twin_and_jax_kron(seed, n):
    """The kernel's arithmetic against the twin and JAX's idct_kron: +-1
    and equal on at least 99.99% of the samples."""
    blocks, q = _inputs(seed, 1, n)
    tb, tq = torch.from_numpy(blocks), torch.from_numpy(q)
    got = idct_cuda.idct_separable(tb, tq)[0].numpy()
    assert got.dtype == np.int32
    for ref in (idct_cuda.idct_kron(tb, tq)[0].numpy(),
                np.asarray(jidct.idct_kron(jnp.asarray(blocks[0]),
                                           jnp.asarray(q[0])))):
        assert np.abs(got.astype(np.int64) - ref).max() <= TOL
        assert (got == ref).mean() >= SEP_MIN_EQUAL


def test_idct_separable_matches_pallas_interpret():
    blocks, q = _inputs(2, 1, 700)
    ref = np.asarray(jidct.fused_dequant_idct(
        jnp.asarray(blocks[0]), jnp.asarray(q[0]), interpret=True))
    got = idct_cuda.idct_separable(torch.from_numpy(blocks),
                                   torch.from_numpy(q))[0].numpy()
    assert np.abs(got.astype(np.int64) - ref).max() <= TOL
    assert (got == ref).mean() >= SEP_MIN_EQUAL


@pytest.mark.parametrize("ref", ["exact", "jax_kron", "pallas_interpret"])
def test_idct_separable_dc_ties_round_half_to_even(ref):
    """DC-only blocks: S's column 0 is 1.0 and the last step an exact 1/8,
    so every sample is exactly dc*q/8 and its halves round to even."""
    rng = np.random.default_rng(9)
    dc = rng.integers(-1024, 1024, size=(1, 600)).astype(np.int32)
    q = rng.integers(1, 40, size=(1, 64)).astype(np.int32)
    blocks = np.zeros((1, 600, 64), np.int32)
    blocks[:, :, 0] = dc
    assert (dc * q[:, :1] % 8 == 4).any()
    got = idct_cuda.idct_separable(torch.from_numpy(blocks),
                                   torch.from_numpy(q))[0].numpy()
    if ref == "exact":
        want = np.broadcast_to(np.rint(dc[0] * q[0, 0] / 8.0)[:, None],
                               got.shape)
    elif ref == "jax_kron":
        want = jidct.idct_kron(jnp.asarray(blocks[0]), jnp.asarray(q[0]))
    else:
        want = jidct.fused_dequant_idct(jnp.asarray(blocks[0]),
                                        jnp.asarray(q[0]), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_separable_sum_needs_and_gets_the_recheck():
    """Rounded as it is, the separable sum differs from the twin on some
    samples; all but a rare one (the threshold sits below the largest gap,
    for speed) lie within eps of a half, so the kernel recomputes them, and
    the gap to the Kronecker sum stays within 2 eps."""
    blocks, q = _inputs(1, 1, 20000)
    tb, tq = torch.from_numpy(blocks), torch.from_numpy(q)
    x = (tb * tq[:, None, :]).to(torch.float32)
    o, eps = idct_cuda._separable(x)
    kron = torch.matmul(x, idct_cuda._basis_t(x.device))
    twin = idct_cuda.idct_kron(tb, tq)
    flips = torch.round(o).to(torch.int32) != twin
    assert int(flips.sum()) > 0
    near = (o - torch.floor(o) - 0.5).abs() < eps[..., None]
    assert int((flips & ~near).sum()) <= 2
    assert float(((o - kron).abs() / eps[..., None]).max()) < 2.0
    # Blocks of uniform +-512 * q<40 coefficients are the worst case (eps
    # grows with sum|x|): still most samples keep the separable value.
    assert float(near.float().mean()) < 0.25


def test_batched_twin_is_per_image():
    """One qtable per image: row b uses qtable b only."""
    blocks, q = _inputs(3, 3, 50)
    tb, tq = torch.from_numpy(blocks), torch.from_numpy(q)
    whole = idct_cuda.idct_kron(tb, tq)
    for b in range(3):
        one = idct_cuda.idct_kron(tb[b:b + 1], tq[b:b + 1])
        assert torch.equal(whole[b:b + 1], one)


def test_wrapper_on_cpu_runs_twin_without_counting():
    blocks, q = _inputs(4, 2, 129)
    tb, tq = torch.from_numpy(blocks), torch.from_numpy(q)
    before = idct_cuda.fused_dequant_idct.launches
    got = idct_cuda.fused_dequant_idct(tb, tq)
    assert torch.equal(got, idct_cuda.idct_kron(tb, tq))
    assert idct_cuda.fused_dequant_idct.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "qshape", "strided",
                                 "device"])
def test_wrapper_rejects_bad_input(bad):
    blocks, q = _inputs(5, 2, 16)
    tb, tq = torch.from_numpy(blocks), torch.from_numpy(q)
    if bad == "dtype":
        tb = tb.to(torch.int64)
    elif bad == "shape":
        tb = tb.reshape(2, 16, 8, 8)
    elif bad == "qshape":
        tq = tq[:1]
    elif bad == "strided":
        tb = tb[:, ::2]
        assert not tb.is_contiguous()
    elif bad == "device":
        tb, tq = tb.to("meta"), tq.to("meta")
    with pytest.raises((TypeError, ValueError)):
        idct_cuda.fused_dequant_idct(tb, tq)
