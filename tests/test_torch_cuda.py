"""The port's CUDA kernel and slice on the card, held to the plain twins.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports neither jax nor PIL, so that it runs on a machine
that has only torch; on the card run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax).
"""

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu_torch.models import batch as tbatch
from jpeg_decoder_tpu_torch.ops import idct_cuda
from jpeg_decoder_tpu_torch.testing.encoder import encode

pytestmark = pytest.mark.cuda

TOL = 1       # Kronecker-form rounding: kernel and twin sum in other orders
RGB_TOL = 2   # that +-1 times the colour transform's x1.402
# Another summation order flips a rounding only where a sum lies within an
# ulp of a half; a rounding fault (truncation, off by one) changes far more.
MIN_EQUAL = 0.9999


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, b, n):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-512, 512, size=(b, n, 64)).astype(np.int32)
    q = rng.integers(1, 40, size=(b, 64)).astype(np.int32)
    return blocks, q


@pytest.mark.parametrize("b,n", [(1, 1), (3, 1000), (2, 4160), (32, 4096)])
def test_kernel_matches_twin(cuda_device, b, n):
    blocks, q = _inputs(6 + n, b, n)
    tb = torch.from_numpy(blocks).to(cuda_device)
    tq = torch.from_numpy(q).to(cuda_device)
    before = idct_cuda.fused_dequant_idct.launches
    got = idct_cuda.fused_dequant_idct(tb, tq)
    ref = idct_cuda.idct_kron(tb, tq)
    torch.cuda.synchronize()
    assert idct_cuda.fused_dequant_idct.launches == before + 1
    assert got.is_cuda and got.dtype == torch.int32
    assert int((got - ref).abs().max()) <= TOL
    assert float((got == ref).float().mean()) >= MIN_EQUAL


def test_kernel_rounds_ties_half_to_even(cuda_device):
    """DC-only blocks: IDCT_KRON[:, 0] is exactly 1/8 in float32, so every
    sample is exactly dc*q/8, and the halves must round to even."""
    rng = np.random.default_rng(11)
    dc = rng.integers(-1024, 1024, size=(4, 3000)).astype(np.int32)
    q = rng.integers(1, 40, size=(4, 64)).astype(np.int32)
    blocks = np.zeros((4, 3000, 64), np.int32)
    blocks[:, :, 0] = dc
    exact = np.rint(dc * q[:, :1] / 8.0).astype(np.int32)[:, :, None]
    assert (dc * q[:, :1] % 8 == 4).any()
    got = idct_cuda.fused_dequant_idct(
        torch.from_numpy(blocks).to(cuda_device),
        torch.from_numpy(q).to(cuda_device)).cpu().numpy()
    np.testing.assert_array_equal(got, np.broadcast_to(exact, got.shape))


def test_kernel_rejects_strided_input(cuda_device):
    blocks, q = _inputs(1, 2, 64)
    tb = torch.from_numpy(blocks).to(cuda_device)[:, ::2]
    tq = torch.from_numpy(q).to(cuda_device)
    with pytest.raises(ValueError):
        idct_cuda.fused_dequant_idct(tb, tq)


def test_twin_refuses_tf32(cuda_device):
    blocks, q = _inputs(7, 1, 8)
    tb = torch.from_numpy(blocks).to(cuda_device)
    tq = torch.from_numpy(q).to(cuda_device)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            idct_cuda.idct_kron(tb, tq)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 6.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def test_slice_on_card_matches_cpu(cuda_device):
    """Two 4:2:0 buckets, 4:4:4 with DRI, an odd size and a corrupt blob:
    the card's RGB (kernel) against the CPU's (plain twin), within
    RGB_TOL and equal on at least MIN_EQUAL of the samples."""
    blobs = [encode(_rgb(0, 64, 96), quality=90)[0],
             encode(_rgb(1, 48, 40), samplings=((1, 1),) * 3, quality=95,
                    restart_interval=5)[0],
             encode(_rgb(2, 37, 53), quality=75, restart_interval=2)[0],
             encode(_rgb(3, 60, 90), quality=85)[0],
             b"\xff\xd8\xff\xdb\x00\x04garbage"]
    with tbatch.BatchDecoder(device=cuda_device) as bd:
        before = idct_cuda.fused_dequant_idct.launches
        got = bd.decode(blobs)
        torch.cuda.synchronize()
        launched = idct_cuda.fused_dequant_idct.launches - before
    with tbatch.BatchDecoder(device="cpu") as bd:
        ref = bd.decode(blobs)
    groups = {id(it.rgb_batch) for it in got if it.ok}
    assert len(groups) == 3
    assert launched == 3 * len(groups)
    assert [it.ok for it in got] == [True] * 4 + [False]
    for g, r in zip(got[:4], ref[:4]):
        assert g.rgb.is_cuda
        d = (g.rgb.cpu().to(torch.int32) - r.rgb.to(torch.int32)).abs()
        assert int(d.max()) <= RGB_TOL
        assert float((d == 0).float().mean()) >= MIN_EQUAL
