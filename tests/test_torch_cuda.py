"""The port's CUDA kernels and slices on the card, held to the plain twins.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports neither jax nor PIL, so that it runs on a machine
that has only torch; on the card run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py imports jax).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu_torch import JPEGError, decode
from jpeg_decoder_tpu_torch.entropy import python_ref
from jpeg_decoder_tpu_torch.io import parser
from jpeg_decoder_tpu_torch.models import batch as tbatch
from jpeg_decoder_tpu_torch.ops import (emit_carry_cuda, entropy_cuda,
                                        entropy_emit_cuda, entropy_spec,
                                        idct_cuda, idct_exact_cuda, pixel,
                                        pixels_cuda, scan_prep)
from jpeg_decoder_tpu_torch.probes import lut_probe
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


def _k_counts(before=None) -> dict:
    """Launches of K1, K6a and K6b (since ``before``)."""
    now = {"K1": idct_cuda.fused_dequant_idct.launches,
           "K6a": pixels_cuda.unpack_nibble.launches,
           "K6b": pixels_cuda.blocks_to_rgb.launches}
    return now if before is None else {k: now[k] - before[k] for k in now}


def _pix_counts(before=None) -> dict:
    """Launches of the pixel kernels K1, K5 and K6b (since ``before``)."""
    now = {"K1": idct_cuda.fused_dequant_idct.launches,
           "K5": idct_exact_cuda.dequant_idct_exact.launches,
           "K6b": pixels_cuda.blocks_to_rgb.launches}
    return now if before is None else {k: now[k] - before[k] for k in now}


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


def test_kernel_equals_separable_model(cuda_device):
    """The kernel's arithmetic is idct_separable's (the CPU model of its
    order, recheck included): equal on every sample but a float64-emulated
    FMA's rare double rounding."""
    blocks, q = _inputs(12, 3, 5000)
    got = idct_cuda.fused_dequant_idct(
        torch.from_numpy(blocks).to(cuda_device),
        torch.from_numpy(q).to(cuda_device)).cpu()
    ref = idct_cuda.idct_separable(torch.from_numpy(blocks),
                                   torch.from_numpy(q))
    assert int((got - ref).abs().max()) <= TOL
    assert int((got != ref).sum()) <= 2


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


def test_idct_fast_refuses_tf32(cuda_device):
    """idct="fast" computes in full float32 or raises: with the global
    TF32 flag set it raises; with it cleared (restored here) it equals the
    CPU result within +-1."""
    blocks, _ = _inputs(8, 1, 64)
    tb = torch.from_numpy(blocks).view(-1, 8, 8)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full float32"):
            pixel.idct_fast(tb.to(cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    got = pixel.idct_fast(tb.to(cuda_device)).cpu()
    assert int((got - pixel.idct_fast(tb)).abs().max()) <= TOL


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
    with tbatch.BatchDecoder(device=cuda_device, idct="pallas") as bd:
        before = _k_counts()
        got = bd.decode(blobs)
        torch.cuda.synchronize()
        launched = _k_counts(before)
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        ref = bd.decode(blobs)
    groups = {id(it.rgb_batch) for it in got if it.ok}
    assert len(groups) == 3
    # Per group one K6a (the nibble wire) and one K6b; K1 only inside K6b.
    assert launched == {"K1": 0, "K6a": 3, "K6b": 3}
    assert [it.ok for it in got] == [True] * 4 + [False]
    for g, r in zip(got[:4], ref[:4]):
        assert g.rgb.is_cuda
        d = (g.rgb.cpu().to(torch.int32) - r.rgb.to(torch.int32)).abs()
        assert int(d.max()) <= RGB_TOL
        assert float((d == 0).float().mean()) >= MIN_EQUAL


# (samplings, quality, restart_interval, (h, w)) for the entropy kernel.
ENTROPY_CASES = [
    (((2, 2), (1, 1), (1, 1)), 90, 0, (64, 96)),
    (((1, 1), (1, 1), (1, 1)), 95, 1, (48, 40)),
    (((2, 2), (1, 1), (1, 1)), 75, 2, (37, 53)),
    (((2, 1), (1, 1), (1, 1)), 85, 5, (33, 70)),
    (((2, 2), (1, 1), (1, 1)), 90, 8, (240, 320)),
]


def _segments(blob, dev):
    """The kernel's inputs for one blob's scan, on ``dev``."""
    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    words, nm, block_comp, max_mcus, _ = scan_prep.prepare_scan(hdr, scan)
    luts = entropy_cuda.device_tables(hdr, scan, dev)[0]
    kw = dict(block_comp=block_comp, n_comps=len(hdr.components),
              max_mcus=max_mcus)
    return hdr, torch.from_numpy(words).to(dev), torch.from_numpy(nm).to(
        dev), luts, kw


@pytest.mark.parametrize("case", range(len(ENTROPY_CASES)))
def test_entropy_kernel_matches_twin_and_python_ref(cuda_device, case):
    samp, q, ri, (h, w) = ENTROPY_CASES[case]
    blob = encode(_rgb(20 + case, h, w), samplings=samp, quality=q,
                  restart_interval=ri)[0]
    hdr, words, nm, luts, kw = _segments(blob, cuda_device)
    before = entropy_cuda.decode_segments.launches
    out, err = entropy_cuda.decode_segments(words, nm, luts, **kw)
    torch.cuda.synchronize()
    assert entropy_cuda.decode_segments.launches == before + 1
    ref, ref_err = entropy_cuda.decode_segments_torch(
        words.cpu(), nm.cpu(), luts.cpu(), **kw)
    assert not err.any() and not ref_err.any()
    assert torch.equal(out.cpu(), ref)
    scan_ref = python_ref.decode_scan_baseline(hdr, hdr.scans[0])
    got = entropy_cuda.decode_scan_baseline(hdr, hdr.scans[0], cuda_device)
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), scan_ref)


def test_entropy_kernel_flags_corrupt_segments_as_twin(cuda_device):
    """Random words after the first in every third segment, and one
    all-ones segment (the all-ones code is never assigned): the kernel flags
    exactly the twin's segments and agrees on the blocks of every unflagged
    one, garbage decodes included."""
    blob = encode(_rgb(30, 96, 128), quality=90, restart_interval=2)[0]
    _, words, nm, luts, kw = _segments(blob, cuda_device)
    w = words.cpu().numpy().copy()
    rng = np.random.default_rng(3)
    for s in range(0, len(w), 3):
        w[s, 1:] = rng.integers(0, 2**32, w.shape[1] - 1, dtype=np.uint64)
    w[1, :] = 0xFFFFFFFF
    bad = torch.from_numpy(w)
    out, err = entropy_cuda.decode_segments(bad.to(cuda_device), nm, luts,
                                            **kw)
    ref, ref_err = entropy_cuda.decode_segments_torch(bad, nm.cpu(),
                                                      luts.cpu(), **kw)
    assert bool(ref_err[1]) and int(ref_err.sum()) >= 2
    assert torch.equal(err.cpu(), ref_err)
    ok = ref_err == 0
    assert torch.equal(out.cpu()[ok], ref[ok])


def test_entropy_kernel_decodes_at_most_max_mcus(cuda_device):
    """MCU counts above max_mcus: the kernel stays inside each segment's
    rows and agrees with the twin, which clamps the same way."""
    blob = encode(_rgb(32, 37, 53), quality=75, restart_interval=1)[0]
    _, words, nm, luts, kw = _segments(blob, cuda_device)
    out, err = entropy_cuda.decode_segments(words, nm + 3, luts, **kw)
    ref, ref_err = entropy_cuda.decode_segments_torch(
        words.cpu(), nm.cpu() + 3, luts.cpu(), **kw)
    assert torch.equal(err.cpu(), ref_err)
    assert torch.equal(out.cpu(), ref)


def test_entropy_kernel_dri0_one_lane(cuda_device):
    """A DRI=0 scan is one lane of the kernel, exact against python_ref."""
    blob = encode(_rgb(31, 480, 640), quality=85)[0]
    hdr = parser.parse(blob)
    got = entropy_cuda.decode_scan_baseline(hdr, hdr.scans[0], cuda_device)
    np.testing.assert_array_equal(
        got.cpu().numpy(), python_ref.decode_scan_baseline(hdr,
                                                           hdr.scans[0]))


@pytest.mark.parametrize("chunk_bits", [128, 1024])
def test_entropy_kernel_dri0_chunked_matches_twin_and_native(cuda_device,
                                                            chunk_bits):
    """A DRI=0 scan cut into chunks that synchronise (at 128 bits, several
    CTAs of them): equal to the sequential twin, the chunked model and the
    native host decoder."""
    from jpeg_decoder_tpu_torch.entropy import native

    blob = encode(_rgb(33, 160, 240), quality=90)[0]
    hdr, words, nm, luts, kw = _segments(blob, cuda_device)
    assert words.shape[0] == 1
    tail = []
    out, err = entropy_cuda.decode_segments(words, nm, luts, **kw,
                                            chunk_bits=chunk_bits, tail=tail)
    stats = entropy_cuda.launch_stats(tail[0])
    ref, ref_err = entropy_cuda.decode_segments_torch(
        words.cpu(), nm.cpu(), luts.cpu(), **kw)
    assert not err.any() and not ref_err.any()
    assert torch.equal(out.cpu(), ref)
    model, _ = entropy_cuda.decode_segments_chunked_torch(
        words.cpu(), nm.cpu(), luts.cpu(), **kw, chunk_bits=chunk_bits)
    assert torch.equal(model, ref)
    n = hdr.mcus_x * hdr.mcus_y * len(kw["block_comp"])
    np.testing.assert_array_equal(
        out.view(-1, 64)[:n].cpu().numpy(),
        native.decode_scan_baseline(hdr, hdr.scans[0]))
    assert stats["chunks"] == int(entropy_cuda.seg_chunks(
        words.cpu(), chunk_bits)[0])
    assert stats["sync_decodes"] > stats["chunks"] - 1
    assert torch.equal(tail[0][-1:], err)


def test_entropy_first_level_kernel_matches_plain(cuda_device):
    blob = encode(_rgb(34, 32, 32), quality=75)[0]
    _, _, _, luts, _ = _segments(blob, cuda_device)
    got = entropy_cuda.first_level(luts)
    assert got.is_cuda and got.dtype == torch.int16
    assert torch.equal(got.cpu(), entropy_cuda.first_level_torch(luts.cpu()))


def test_entropy_kernel_rejects_bad_options(cuda_device):
    blob = encode(_rgb(35, 32, 32), quality=75)[0]
    _, words, nm, luts, kw = _segments(blob, cuda_device)
    with pytest.raises(ValueError):
        entropy_cuda.decode_segments(words, nm, luts, **kw, chunk_bits=100)
    with pytest.raises(TypeError):
        entropy_cuda.decode_segments(words, nm, luts, **kw,
                                     l1=torch.zeros(3, device=cuda_device))


def test_lut_probes_match_twins(cuda_device):
    lut = torch.arange(lut_probe.LUT_SIZE, dtype=torch.int32)
    idx = torch.tensor(lut_probe.CHAIN_IDX, dtype=torch.int32).view(8, 1)
    before = (lut_probe.lut_chain_probe.launches,
              lut_probe.lut_gather.launches)
    got = lut_probe.lut_chain_probe(lut.to(cuda_device), idx.to(cuda_device))
    assert int(got) == lut_probe.chain_expected(lut_probe.CHAIN_IDX)
    assert int(got) == int(lut_probe.lut_chain_torch(lut, idx))
    rng = np.random.default_rng(0)
    gidx = torch.from_numpy(rng.integers(0, 65536, (8, 128), np.int32))
    gl = torch.from_numpy(rng.integers(-2**31, 2**31, 65536, np.int64)
                          .astype(np.int32))
    out = lut_probe.lut_gather(gl.to(cuda_device), gidx.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), lut_probe.lut_gather_torch(gl, gidx))
    assert (lut_probe.lut_chain_probe.launches,
            lut_probe.lut_gather.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("entropy", ["pallas", "native"])
def test_decode_on_card_matches_cpu(cuda_device, entropy):
    """decode() on the card (both kernels) against the CPU decode (plain
    twins); the pallas route launches K2 once and K6b once (K1's
    arithmetic inside it), K1 never."""
    for k, (samp, q, ri, (h, w)) in enumerate(ENTROPY_CASES):
        blob = encode(_rgb(40 + k, h, w), samplings=samp, quality=q,
                      restart_interval=ri)[0]
        k2 = entropy_cuda.decode_segments.launches
        before = _pix_counts()
        got = decode(blob, entropy=entropy, idct="pallas", upsample="fancy",
                     device=cuda_device)
        torch.cuda.synchronize()
        assert entropy_cuda.decode_segments.launches - k2 == (
            entropy == "pallas")
        assert _pix_counts(before) == {"K1": 0, "K5": 0, "K6b": 1}
        ref = decode(blob, entropy="native", idct="pallas",
                     upsample="fancy", device="cpu")
        assert got.rgb.is_cuda and got.rgb.shape == (h, w, 3)
        d = (got.rgb.cpu().to(torch.int32) - ref.rgb.to(torch.int32)).abs()
        assert int(d.max()) <= RGB_TOL
        assert float((d == 0).float().mean()) >= MIN_EQUAL


def corrupt_first_segment(blob: bytes) -> bytes:
    """Overwrite 8 bytes inside the first restart segment with stuffed
    0xFF bytes: 64 one bits, a window no standard code takes."""
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
    assert blob.index(b"\xff\xd0", start) - start > 24
    return blob[:start + 8] + b"\xff\x00" * 8 + blob[start + 24:]


def test_decode_corrupt_stream_raises_on_card(cuda_device):
    blob = corrupt_first_segment(encode(_rgb(50, 64, 64), quality=90,
                                        restart_interval=2)[0])
    with pytest.raises(JPEGError, match="segments \\[0\\]"):
        decode(bytes(blob), entropy="pallas", idct="pallas",
               device=cuda_device)


def _batch_blobs():
    """Two 4:2:0 sizes of one bucket, 4:4:4 with DRI, arithmetic and
    multi-scan fallback frames, a corrupt blob."""
    return [encode(_rgb(60, 64, 96), quality=90)[0],
            encode(_rgb(61, 48, 80), quality=85)[0],
            encode(_rgb(62, 48, 40), samplings=((1, 1),) * 3, quality=95,
                   restart_interval=5)[0],
            encode(_rgb(63, 40, 56), arithmetic=True)[0],
            encode(_rgb(64, 40, 56), scans=[(0,), (1, 2)])[0],
            b"\xff\xd8\xff\xdb\x00\x04garbage"]


def test_wires_identical_on_card(cuda_device):
    """Every wire gives the nibble wire's RGB bit for bit on the card, K6b
    once per group (K6a too on the nibble wire, K1 never), and the CPU
    decode's RGB within RGB_TOL."""
    blobs = _batch_blobs()
    got = {}
    for wire in tbatch.WIRES:
        with tbatch.BatchDecoder(device=cuda_device, wire=wire,
                                 idct="pallas") as bd:
            before = _k_counts()
            got[wire] = bd.decode(blobs)
            torch.cuda.synchronize()
            groups = {id(it.rgb_batch) for it in got[wire] if it.ok}
            n = len(groups)
            assert _k_counts(before) == {
                "K1": 0, "K6a": n if wire == "nibble" else 0, "K6b": n}
    assert [it.ok for it in got["nibble"]] == [True] * 5 + [False]
    for wire in tbatch.WIRES:
        for a, b in zip(got["nibble"][:5], got[wire][:5]):
            assert b.rgb.is_cuda and torch.equal(a.rgb, b.rgb)
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        ref = bd.decode(blobs)
    for g, r in zip(got["nibble"][:5], ref[:5]):
        d = (g.rgb.cpu().to(torch.int32) - r.rgb.to(torch.int32)).abs()
        assert int(d.max()) <= RGB_TOL
        assert float((d == 0).float().mean()) >= MIN_EQUAL


def test_waves_equal_single_pass_on_card(cuda_device):
    """Waves of 2 (pinned staging, the decoder's own stream, a worker
    thread) equal one pass bit for bit and in input order; the caller's
    stream sees finished outputs."""
    blobs = _batch_blobs() * 2
    with tbatch.BatchDecoder(device=cuda_device, idct="pallas") as bd:
        one = bd.decode(blobs)
        waved = bd.decode(blobs, wave=2)
        again = bd.decode(blobs, wave=2)
    for a, b, c in zip(one, waved, again):
        assert a.ok == b.ok == c.ok
        if a.ok:
            assert torch.equal(a.rgb, b.rgb) and torch.equal(a.rgb, c.rgb)


def test_batch_pallas_entropy_equals_native(cuda_device):
    """entropy="pallas": K2 once per baseline image (fallback frames take
    the host), RGB equal to the native backend's."""
    blobs = _batch_blobs()
    with tbatch.BatchDecoder(device=cuda_device, entropy="pallas",
                             idct="pallas") as bd:
        k2 = entropy_cuda.decode_segments.launches
        got = bd.decode(blobs)
        torch.cuda.synchronize()
        assert entropy_cuda.decode_segments.launches - k2 == 3
    with tbatch.BatchDecoder(device=cuda_device, idct="pallas") as bd:
        ref = bd.decode(blobs)
    for a, b in zip(got[:5], ref[:5]):
        assert torch.equal(a.rgb, b.rgb)


# -- K5: strict exact dequant + AAN IDCT ------------------------------------

def _exact_inputs(case, b, n):
    rng = np.random.default_rng(b * 7919 + n)
    if case == "dc_only":
        blocks = np.zeros((b, n, 64), np.int32)
        blocks[..., 0] = rng.integers(-2048, 2048, (b, n))
        q = rng.integers(1, 100, (b, 64))
    elif case == "saturating":
        blocks = rng.integers(-32768, 32768, (b, n, 64))
        q = rng.integers(40000, 65536, (b, 64))
    else:
        blocks = rng.integers(-1024, 1024, (b, n, 64))
        q = rng.integers(1, 100, (b, 64))
    return (torch.from_numpy(blocks.astype(np.int32)),
            torch.from_numpy(q.astype(np.int32)))


@pytest.mark.parametrize("case", ["random", "dc_only", "saturating"])
@pytest.mark.parametrize("b,n", [(1, 1), (3, 1000), (2, 4161), (32, 4096)])
def test_exact_kernel_equals_twin(cuda_device, case, b, n):
    """K5 equals its op-by-op twin on every sample, run on the card and on
    the CPU, and counts one launch."""
    blocks, q = _exact_inputs(case, b, n)
    tb, tq = blocks.to(cuda_device), q.to(cuda_device)
    before = idct_exact_cuda.dequant_idct_exact.launches
    got = idct_exact_cuda.dequant_idct_exact(tb, tq)
    on_card = idct_exact_cuda.exact_twin(tb, tq)
    torch.cuda.synchronize()
    assert idct_exact_cuda.dequant_idct_exact.launches == before + 1
    assert torch.equal(got, on_card)
    assert torch.equal(got.cpu(), idct_exact_cuda.exact_twin(blocks, q))


def _colour_blobs():
    rgb = _rgb(41, 72, 96)
    planes = [rgb[..., k % 3].astype(np.float64) for k in range(4)]
    return {
        "420": encode(rgb, quality=90, restart_interval=3)[0],
        "cmyk": encode(rgb, raw_planes=planes, samplings=((1, 1),) * 4,
                       app14_transform=0)[0],
        "ycck": encode(rgb, raw_planes=planes,
                       samplings=((2, 2), (1, 1), (1, 1), (2, 2)),
                       app14_transform=2)[0],
        "12bit": encode(rgb, precision=12, quality=90)[0],
    }


@pytest.mark.parametrize("upsample", ["nn", "fancy"])
def test_exact_decode_on_card_equals_cpu(cuda_device, upsample):
    """decode(idct="exact") on the card: K6b once (K5's arithmetic inside
    it), K5 and K1 never, and the CPU twin's bytes."""
    for name, blob in _colour_blobs().items():
        before = _pix_counts()
        got = decode(blob, idct="exact", strict=True, upsample=upsample,
                     device=cuda_device)
        torch.cuda.synchronize()
        assert _pix_counts(before) == {"K1": 0, "K5": 0, "K6b": 1}, name
        ref = decode(blob, idct="exact", upsample=upsample, device="cpu")
        assert got.rgb.is_cuda and torch.equal(got.rgb.cpu(), ref.rgb), name


def _route_blobs() -> dict:
    """A frame of every kind of ``pixel_cases.FRAME_KINDS`` the test
    encoder makes (all but "odd", whose 3:2 ratios it refuses), odd dims,
    DRI 3, and the frames of :func:`_colour_blobs`."""
    from jpeg_decoder_tpu_torch.testing import pixel_cases

    out = {k[0]: pixel_cases.frame_blob(k[0], 230, 45, 61,
                                        restart_interval=3)
           for k in pixel_cases.FRAME_KINDS if k[0] != "odd"}
    out.update({f"colour {n}": b for n, b in _colour_blobs().items()})
    return out


@pytest.mark.parametrize("upsample", ["nn", "fancy"])
@pytest.mark.parametrize("idct", ["exact", "pallas"])
def test_decode_takes_k6b_on_card(cuda_device, idct, upsample, monkeypatch):
    """decode() to RGB under ``exact`` and ``pallas``: one K6b launch, no
    K5 and no K1; under ``exact`` the CPU decode's bytes, under
    ``pallas`` the torch route's on the card (``k6b_route`` forced off).
    The "odd" kind's samplings on random blocks, K6b's arguments as
    decode() makes them against the torch route."""
    from jpeg_decoder_tpu_torch.layout import scan_layout
    from jpeg_decoder_tpu_torch.models import decoder as tdec
    from jpeg_decoder_tpu_torch.testing import pixel_cases

    for name, blob in _route_blobs().items():
        before = _pix_counts()
        got = decode(blob, idct=idct, upsample=upsample,
                     device=cuda_device).rgb
        torch.cuda.synchronize()
        assert _pix_counts(before) == {"K1": 0, "K5": 0, "K6b": 1}, name
        if idct == "exact":
            ref = decode(blob, idct=idct, upsample=upsample,
                         device="cpu").rgb
        else:
            with monkeypatch.context() as m:
                m.setattr(tdec, "k6b_route", lambda *a: False)
                ref = decode(blob, idct=idct, upsample=upsample,
                             device=cuda_device).rgb
            torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == ref.dtype, name
        assert torch.equal(got.cpu(), ref.cpu()), name
    hv = {k[0]: k[1] for k in pixel_cases.FRAME_KINDS}["odd"]
    base = parser.parse(pixel_cases.frame_blob("444", 231, 45, 61))
    hdr = dataclasses.replace(base, components=[
        dataclasses.replace(c, h=h, v=v)
        for c, (h, v) in zip(base.components, hv)])
    lay = scan_layout(hdr)
    blocks = torch.from_numpy(pixel_cases.random_blocks(
        np.random.default_rng(12), lay.n_mcus * lay.blocks_per_mcu, 0.2,
        spread=12, dc=60)).to(cuda_device)
    samplings = tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                      for c in hdr.components)
    plan = tdec._k6b_plan(hdr, upsample)
    assert tdec.k6b_route(idct, False, "cuda", plan)
    got = tdec._k6b_pixels(hdr, blocks, plan,
                           comp_shapes=tuple(lay.comp_shapes),
                           samplings=samplings, idct=idct, upsample=upsample)
    qts = tuple(torch.from_numpy(hdr.quant_tables[c.tq].values
                                 .astype(np.int32)).to(cuda_device)
                for c in hdr.components)
    ref = pixel.pixel_pipeline_from_scan(
        blocks, qts, tdec._comp_srcs(hdr, cuda_device),
        comp_shapes=tuple(lay.comp_shapes), height=hdr.height,
        width=hdr.width, samplings=samplings, idct=idct, upsample=upsample,
        color=hdr.colorspace, precision=hdr.precision)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("idct", ["exact", "pallas", "kron", "fast"])
def test_decode_torch_routes_on_card(cuda_device, idct):
    """Under ``kron`` and ``fast``, and to CMYK, decode() keeps the torch
    route: no K6b, K5 or K1 once a component (``kron`` and ``fast``
    neither: torch ops), the CPU
    decode's bytes (byte for byte under ``exact``, else within the +-1
    IDCT bound, as tests/test_torch_decoder.py holds them)."""
    for name, blob in _route_blobs().items():
        hdr = parser.parse(blob)
        kw = dict(idct=idct, upsample="fancy")
        if idct in ("exact", "pallas"):
            if hdr.colorspace not in ("cmyk", "ycck"):
                continue
            kw["colorspace"] = "cmyk"
        before = _pix_counts()
        got = decode(blob, device=cuda_device, **kw).rgb
        torch.cuda.synchronize()
        n = len(hdr.components)
        want = {"K1": n if idct == "pallas" else 0,
                "K5": n if idct == "exact" else 0, "K6b": 0}
        assert _pix_counts(before) == want, name
        ref = decode(blob, device="cpu", **kw).rgb
        if idct == "exact":
            assert torch.equal(got.cpu(), ref), name
        else:
            d = (got.cpu().to(torch.int32) - ref.to(torch.int32)).abs()
            assert int(d.max()) <= RGB_TOL, name
            assert float((d == 0).float().mean()) >= MIN_EQUAL, name


def test_second_decode_makes_two_host_copies(cuda_device):
    """The cell's call (``hybrid`` on a restart stream, ``exact``, nn) a
    second time: two host-to-device copies (K2's words and segment
    counts), none in the pixel stage, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from jpeg_decoder_tpu_torch.testing import pixel_cases

    blob = pixel_cases.frame_blob("420", 232, 120, 192, restart_interval=4)
    kw = dict(entropy="hybrid", idct="exact", upsample="nn",
              device=cuda_device)
    decode(blob, **kw)
    torch.cuda.synchronize()
    before = _pix_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode(blob, **kw)
        torch.cuda.synchronize()
    assert _pix_counts(before) == {"K1": 0, "K5": 0, "K6b": 1}
    h2d = [e.name for e in prof.events() if "Memcpy HtoD" in e.name]
    assert len(h2d) == 2, h2d


def test_dri0_decode_counts_k2_stats(cuda_device, monkeypatch):
    """A DRI-0 ``decode()`` (``photo12_ingest``'s call, at 1024 x 768, a
    stream of 13 CTAs): with the recorder on, one launch's four
    ``k2.*`` counters, ``k2.chunks`` equal to the stream's chunks, in an
    ``entropy.stats`` span; on or off, the same two copies to the card and
    one copy back, the flags' (which brings the statistics with it)."""
    from torch.profiler import ProfilerActivity, profile

    from jpeg_decoder_tpu_torch.testing import pixel_cases
    from jpeg_decoder_tpu_torch.utils import profiling

    blob = pixel_cases.frame_blob("420", 233, 768, 1024)
    kw = dict(entropy="pallas", idct="exact", upsample="fancy",
              device=cuda_device)
    hdr = parser.parse(blob)
    words = scan_prep.prepare_scan(hdr, hdr.scans[0])[0]
    chunks = int(entropy_cuda.seg_chunks(torch.from_numpy(words),
                                         entropy_cuda.CHUNK_BITS).sum())
    assert words.shape[0] == 1 and chunks > 12 * entropy_cuda.SYNC_LANES
    want = decode(blob, **kw).rgb
    copies = {}
    for on in (True, False):
        if not on:
            monkeypatch.setattr(profiling, "recording", lambda: False)
        decode(blob, **kw)
        torch.cuda.synchronize()
        t0 = time.time_ns()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = decode(blob, **kw).rgb
            torch.cuda.synchronize()
            counted = {}
            for c in profiling.counts():
                if c.name.startswith("k2.") and c.t_ns >= t0:
                    counted[c.name] = counted.get(c.name, 0) + c.n
            names = [s.name for s in profiling.spans() if s.start_ns >= t0]
        assert torch.equal(got, want)
        copies[on] = [sum(w in e.name for e in prof.events())
                      for w in ("Memcpy HtoD", "Memcpy DtoH")]
        if on:
            assert set(counted) == set(entropy_cuda.COUNTERS)
            assert counted["k2.chunks"] == chunks
            assert counted["k2.sync_decodes"] >= chunks - 1
            assert names.count("entropy.stats") == 1
        else:
            assert counted == {} and "entropy.stats" not in names
    assert copies == {True: [2, 1], False: [2, 1]}


def test_exact_batch_on_card_equals_cpu(cuda_device):
    blobs = list(_colour_blobs().values())
    with tbatch.BatchDecoder(device=cuda_device, idct="exact") as bd:
        got = bd.decode(blobs)
    for g, blob in zip(got, blobs):
        ref = decode(blob, idct="exact", upsample="fancy", device="cpu")
        assert g.ok and torch.equal(g.rgb.cpu(), ref.rgb)


# -- K7: emit lanes from true MCU starts; K2 at 12 bits --------------------

def _lane_inputs(blob, dev):
    """The host plan of ``blob`` and K7's inputs on ``dev``."""
    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    (pools, starts, nm, lane_off, t_sym, _, _, seg_first,
     ok) = entropy_spec.device_plan(hdr, [scan], threads=1)
    assert ok.all()
    luts, l1 = entropy_cuda.device_tables(hdr, scan, dev)
    args = tuple(torch.from_numpy(a).to(dev) for a in (pools, starts, nm,
                                                       lane_off, seg_first))
    kw = dict(block_comp=entropy_spec._block_comp(hdr),
              n_comps=len(hdr.components), n_mcus=hdr.mcus_x * hdr.mcus_y,
              trips=t_sym, precision=hdr.precision)
    return hdr, args + (luts,), kw, l1


@pytest.mark.parametrize("precision", [8, 12])
@pytest.mark.parametrize("ri", [0, 4])
def test_emit_kernel_matches_plain_and_native(cuda_device, ri, precision):
    """K7 on a 1920x1080 4:2:0 frame under decode()'s plan (thousands of
    lanes, so the carry scan spans many tiles): every coefficient and the
    flag equal to decode_lanes_torch (run on the card) and to the native
    decoder; one launch counted."""
    from jpeg_decoder_tpu_torch.entropy import native

    blob = encode(_rgb(70 + ri, 1080, 1920), quality=90, restart_interval=ri,
                  precision=precision)[0]
    hdr, args, kw, l1 = _lane_inputs(blob, cuda_device)
    before = entropy_emit_cuda.decode_lanes.launches
    out, err = entropy_emit_cuda.decode_lanes(*args, **kw, l1=l1)
    torch.cuda.synchronize()
    assert entropy_emit_cuda.decode_lanes.launches == before + 1
    ref, ref_err = entropy_emit_cuda.decode_lanes_torch(*args, **kw)
    assert not err.any() and not ref_err.any()
    assert torch.equal(out, ref)
    np.testing.assert_array_equal(
        out[0].cpu().numpy(), native.decode_scan_baseline(hdr, hdr.scans[0]))


@pytest.mark.parametrize("ri", [0, 8])
def test_emit_lane_share_matches_plain(cuda_device, ri):
    """K7 on a rank's share of the lanes (``lanes=``, the mesh route): the
    rows those lanes own and the flag equal to decode_lanes_torch's on the
    same share (whose carry also starts from 0 at the share), and past the
    share's first restart segment equal to one launch over every lane."""
    blob = encode(_rgb(90 + ri, 480, 640), quality=90,
                  restart_interval=ri)[0]
    hdr, args, kw, l1 = _lane_inputs(blob, cuda_device)
    bpm = len(kw["block_comp"])
    c = args[1].shape[1]
    off = args[3][0].cpu().numpy() // (64 * bpm)
    whole, _ = entropy_emit_cuda.decode_lanes(*args, **kw, l1=l1)
    for lo, hi in ((0, c // 2), (c // 2, c), (c // 3, 2 * c // 3)):
        out, err = entropy_emit_cuda.decode_lanes(*args, **kw, l1=l1,
                                                  lanes=(lo, hi))
        ref, ref_err = entropy_emit_cuda.decode_lanes_torch(
            *args, **kw, lanes=(lo, hi))
        m0, m1 = int(off[lo]), int(off[hi]) if hi < c else kw["n_mcus"]
        assert int(err[0]) == int(ref_err[0]) == 0
        assert torch.equal(out[0, m0 * bpm:m1 * bpm],
                           ref[0, m0 * bpm:m1 * bpm].to(cuda_device))
        if ri:
            m = min((m0 // ri + 1) * ri, m1)
            assert torch.equal(out[0, m * bpm:m1 * bpm],
                               whole[0, m * bpm:m1 * bpm])


@pytest.mark.parametrize("ranks,b,rows,comps", [
    (2, 24, 48960, (0, 0, 0, 0, 1, 2)), (4, 3, 1000, (0, 1, 2)),
    (3, 2, 777, (0,))])
def test_emit_carry_matches_plain(cuda_device, ranks, b, rows, comps):
    """K7c, the DC carry across ranks, equal to add_carry_torch on random
    blocks, totals, rank masks and row ranges (int32 wrap included); one
    launch counted."""
    from jpeg_decoder_tpu_torch.ops import emit_carry_cuda

    g = torch.Generator().manual_seed(ranks * 100 + b)
    out = torch.randint(-2**31, 2**31 - 1, (b, rows, 64), dtype=torch.int32,
                        generator=g)
    tot = torch.randint(-2**31, 2**31 - 1, (ranks, b, max(comps) + 1),
                        dtype=torch.int32, generator=g)
    w = torch.randint(0, 2, (ranks, b), dtype=torch.int32, generator=g)
    lo = torch.randint(0, rows, (b,), generator=g)
    hi = torch.minimum(lo + torch.randint(0, rows, (b,), generator=g),
                       torch.tensor(rows))
    w, lo, hi = (t.numpy() for t in (w, lo, hi))
    ref = emit_carry_cuda.add_carry_torch(out.clone(), tot, w, lo, hi,
                                          block_comp=comps)
    before = emit_carry_cuda.add_carry.launches
    got = emit_carry_cuda.add_carry(
        out.to(cuda_device), tot.to(cuda_device), w, lo, hi,
        block_comp=comps)
    torch.cuda.synchronize()
    assert emit_carry_cuda.add_carry.launches == before + 1
    assert torch.equal(got.cpu(), ref)


def _pack_case(seed, ranks, b, rows, comps, dev):
    """Random blocks (full int32 range), totals and a carry_pack plan:
    owned MCU ranges (some empty), carried rows from each image's first
    owned row, random rank masks, a random pad."""
    bpm = len(comps)
    rng = np.random.default_rng(seed)
    ends = np.sort(rng.integers(0, rows // bpm + 1, (b, 2)), axis=1) * bpm
    own_lo, own_hi = ends[:, 0], ends[:, 1]
    hi = own_lo + ((own_hi - own_lo) * rng.random(b)).astype(np.int64)
    span = int((own_hi - own_lo).sum())
    plan = emit_carry_cuda.pack_plan(
        rng.integers(0, 2, (ranks, b)), own_lo, hi, own_lo, own_hi,
        rows=rows, bpm=bpm, n_send=span + int(rng.integers(0, 40)) or 1,
        device=dev)
    blocks = torch.from_numpy(rng.integers(-2**31, 2**31, (b, rows, 64),
                                           dtype=np.int64).astype(np.int32))
    tot = torch.from_numpy(rng.integers(-2**31, 2**31,
                                        (ranks, b, max(comps) + 1),
                                        dtype=np.int64).astype(np.int32))
    return plan, blocks, tot


@pytest.mark.parametrize("ranks,b,rows,comps", [
    (2, 24, 48960, (0, 0, 0, 0, 1, 2)), (4, 3, 1000, (0, 1, 2)),
    (3, 2, 777, (0,)), (2, 300, 60, (0, 1, 2)), (64, 5, 96, (0, 0, 1, 2))])
def test_carry_pack_matches_plain(cuda_device, ranks, b, rows, comps):
    """K7c's carry-and-pack form equal to carry_pack_torch, and to the
    first form followed by the gather and the pad, on random plans (the
    same shapes as test_emit_carry_matches_plain, a plan of 300 images
    read from the card, 64 ranks); send buffer and the blocks' carried DC
    bit for bit; one launch counted."""
    plan, blocks, tot = _pack_case(ranks * 100 + b, ranks, b, rows, comps,
                                   cuda_device)
    assert (plan.on_card is not None) == (b > emit_carry_cuda.INLINE_IMAGES)
    ref_blocks = blocks.clone()
    ref = emit_carry_cuda.carry_pack_torch(ref_blocks, tot, plan,
                                           block_comp=comps)
    got_blocks, tot_d = blocks.to(cuda_device), tot.to(cuda_device)
    before = emit_carry_cuda.carry_pack.launches
    got = emit_carry_cuda.carry_pack(got_blocks, tot_d, plan,
                                     block_comp=comps)
    torch.cuda.synchronize()
    assert emit_carry_cuda.carry_pack.launches == before + 1
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(got_blocks.cpu(), ref_blocks)
    v1 = emit_carry_cuda.add_carry(blocks.to(cuda_device), tot_d, plan.w,
                                   plan.lo, plan.hi, block_comp=comps)
    mine = v1.view(-1, 64)[torch.from_numpy(
        emit_carry_cuda.owned_rows(plan)).to(cuda_device)]
    assert torch.equal(got[:plan.n_own], mine)
    assert not got[plan.n_own:].any()


def test_carry_pack_refuses(cuda_device):
    """A blocks tensor off a 16-byte boundary, and a plan of more images
    than the launch's parameters hold that was not put on the card: both
    refused before any launch."""
    plan, blocks, tot = _pack_case(1, 2, 4, 30, (0, 1, 2), cuda_device)
    raw = torch.zeros(blocks.numel() + 4, dtype=torch.int32,
                      device=cuda_device)
    shifted = raw[1:1 + blocks.numel()].view(blocks.shape)
    before = emit_carry_cuda.carry_pack.launches
    with pytest.raises(ValueError, match="16-byte"):
        emit_carry_cuda.carry_pack(shifted, tot.to(cuda_device), plan,
                                   block_comp=(0, 1, 2))
    big, blocks, tot = _pack_case(2, 2, 130, 30, (0, 1, 2), None)
    with pytest.raises(ValueError, match="on cuda"):
        emit_carry_cuda.carry_pack(blocks.to(cuda_device),
                                   tot.to(cuda_device), big,
                                   block_comp=(0, 1, 2))
    assert emit_carry_cuda.carry_pack.launches == before


def test_emit_kernel_flags_as_plain(cuda_device):
    """Corrupt words in one lane, and a plan with a gap between two lanes:
    both flag the image in the kernel and in the plain version."""
    blob = encode(_rgb(80, 240, 320), quality=90)[0]
    _, args, kw, l1 = _lane_inputs(blob, cuda_device)
    pools, starts, nm, lane_off = (a.clone() for a in args[:4])
    pools[0, pools.shape[1] // 2:pools.shape[1] // 2 + 8] = 0xFFFFFFFF
    gap = nm.clone()
    gap[0, 1] -= 1
    for bad in ((pools,) + args[1:], args[:2] + (gap,) + args[3:]):
        _, err = entropy_emit_cuda.decode_lanes(*bad, **kw, l1=l1)
        _, ref_err = entropy_emit_cuda.decode_lanes_torch(*bad, **kw)
        assert int(err[0]) == int(ref_err[0]) == 1


@pytest.mark.parametrize("ri", [0, 3])
def test_entropy_kernel_12bit_matches_native(cuda_device, ri):
    from jpeg_decoder_tpu_torch.entropy import native

    blob = encode(_rgb(75 + ri, 240, 320), quality=90, precision=12,
                  restart_interval=ri)[0]
    hdr = parser.parse(blob)
    before = entropy_cuda.decode_segments.launches
    got = entropy_cuda.decode_scan_baseline(hdr, hdr.scans[0], cuda_device)
    torch.cuda.synchronize()
    assert entropy_cuda.decode_segments.launches == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), native.decode_scan_baseline(hdr, hdr.scans[0]))


@pytest.mark.parametrize("entropy", ["jax", "hybrid"])
def test_lane_backends_on_card_equal_native(cuda_device, entropy):
    """decode(entropy="jax"|"hybrid") on the card: planes equal the native
    decoder's and RGB equals entropy="native"'s bit for bit (the same pixel
    stage), 8- and 12-bit, DRI 0 and DRI > 0; K7 once on a DRI-0 stream
    under hybrid, K2 once otherwise."""
    for k, (precision, ri) in enumerate([(8, 0), (8, 5), (12, 0), (12, 2)]):
        blob = encode(_rgb(90 + k, 120, 200), quality=90,
                      precision=precision, restart_interval=ri)[0]
        k2 = entropy_cuda.decode_segments.launches
        k7 = entropy_emit_cuda.decode_lanes.launches
        got = decode(blob, entropy=entropy, idct="pallas", keep_planes=True,
                     device=cuda_device)
        torch.cuda.synchronize()
        on_k7 = entropy == "hybrid" and ri == 0
        assert entropy_emit_cuda.decode_lanes.launches - k7 == int(on_k7)
        assert entropy_cuda.decode_segments.launches - k2 == int(not on_k7)
        ref = decode(blob, entropy="native", idct="pallas", keep_planes=True,
                     device=cuda_device)
        for a, b in zip(got.quantized_planes, ref.quantized_planes):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(got.rgb, ref.rgb)


# -- K7's schedule: staged words, look-back carry, blocks written once -----

def _plan_inputs(blobs, dev, target_steps=None):
    """K7's inputs for same-geometry ``blobs`` (decode()'s plan, or
    ``target_steps`` paired steps per lane) and the native blocks."""
    from jpeg_decoder_tpu_torch.entropy import native

    hdrs = [parser.parse(b) for b in blobs]
    hdr = hdrs[0]
    n_mcus = hdr.mcus_x * hdr.mcus_y
    scans = [h.scans[0] for h in hdrs]
    if target_steps is None:
        plan = entropy_spec.device_plan(hdr, scans, threads=1)
    else:
        plan = entropy_spec.prepare_hybrid_batch_emit(
            hdr, scans, threads=1, max_chunks=n_mcus,
            target_steps=target_steps)
    assert plan[-1].all()
    luts, l1 = entropy_cuda.device_tables(hdr, scans[0], dev)
    args = tuple(torch.from_numpy(a).to(dev) for a in (
        plan[0], plan[1], plan[2], plan[3], plan[7])) + (luts,)
    kw = dict(block_comp=entropy_spec._block_comp(hdr),
              n_comps=len(hdr.components), n_mcus=n_mcus, trips=plan[4],
              precision=hdr.precision)
    refs = [torch.from_numpy(native.decode_scan_baseline(h, h.scans[0]))
            for h in hdrs]
    return args, kw, l1, refs


@pytest.mark.parametrize("precision", [8, 12])
@pytest.mark.parametrize("ri", [0, 2, 7])
def test_emit_schedule_stages_and_matches_plain(cuda_device, ri, precision):
    """decode()'s plan on a 640x480 frame: the kernel equals
    decode_lanes_torch and the native decoder, every lane group staged its
    words (none over budget) and no probe left shared memory."""
    blob = encode(_rgb(100 + ri + precision, 480, 640), quality=90,
                  restart_interval=ri, precision=precision)[0]
    args, kw, l1, refs = _plan_inputs([blob], cuda_device)
    out, err = entropy_emit_cuda.decode_lanes(*args, **kw, l1=l1)
    torch.cuda.synchronize()
    stats = dict(zip(entropy_emit_cuda.STATS,
                     entropy_emit_cuda.decode_lanes.last_stats.tolist()))
    ref, ref_err = entropy_emit_cuda.decode_lanes_torch(*args, **kw)
    assert not err.any() and not ref_err.any()
    assert torch.equal(out, ref) and torch.equal(out[0].cpu(), refs[0])
    assert stats["groups_staged"] > 0 and stats["groups_over_budget"] == 0
    assert stats["lut_misses"] == 0


def test_emit_batch_of_three_with_an_empty_image(cuda_device):
    """One B = 3 launch: images with different lane counts and one whose
    plan has no lane (it decodes to zeros, unflagged, though the output is
    not zero-filled first)."""
    blobs = [encode(_rgb(110 + k, 240, 320), quality=q)[0]
             for k, q in enumerate((90, 50, 97))]
    args, kw, l1, refs = _plan_inputs(blobs, cuda_device, target_steps=16)
    counts = (args[2] > 0).sum(1).tolist()
    assert len(set(counts)) == 3
    nm = args[2].clone()
    nm[1] = 0
    for _ in range(2):
        # Dirty the allocator's free blocks: the output is not zero-filled.
        junk = torch.full((3, kw["n_mcus"] * len(kw["block_comp"]), 64),
                          0x5A5A5A5A, dtype=torch.int32, device=cuda_device)
        del junk
        out, err = entropy_emit_cuda.decode_lanes(
            *args[:2], nm, *args[3:], **kw, l1=l1)
        torch.cuda.synchronize()
        assert err.tolist() == [0, 0, 0]
        assert not out[1].any()
        for i in (0, 2):
            assert torch.equal(out[i].cpu(), refs[i])
    ref, _ = entropy_emit_cuda.decode_lanes_torch(*args[:2], nm, *args[3:],
                                                  **kw)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("budget", [4, 64])
def test_emit_over_budget_groups_read_device_memory(cuda_device, budget):
    """A staging budget far below a group's words: the groups read the rest
    from device memory (counted over budget) and the output is unchanged."""
    blob = encode(_rgb(120, 480, 640), quality=90)[0]
    args, kw, l1, refs = _plan_inputs([blob], cuda_device)
    out, scratch = entropy_emit_cuda.buffers(
        args[0], args[1], kw["n_mcus"], len(kw["block_comp"]), 32)
    entropy_emit_cuda.launch(args + (l1,), out, scratch, group_lanes=32,
                             budget_words=budget, **kw)
    torch.cuda.synchronize()
    stats = entropy_emit_cuda.stats(scratch, 1)
    assert int(scratch[0]) == 0 and torch.equal(out[0].cpu(), refs[0])
    assert stats["groups_over_budget"] > 0


@pytest.mark.parametrize("group_lanes", [32, 64, 128])
def test_emit_group_sizes_agree(cuda_device, group_lanes):
    """Each group size gives the same blocks (the look-back carry spans
    many groups of a DRI-0 frame)."""
    blob = encode(_rgb(130, 480, 640), quality=90)[0]
    args, kw, l1, refs = _plan_inputs([blob], cuda_device, target_steps=16)
    lanes, budget = entropy_emit_cuda.schedule(
        1, args[0].shape[1], args[1].shape[1], args[5].shape[0], 1)
    out, scratch = entropy_emit_cuda.buffers(
        args[0], args[1], kw["n_mcus"], len(kw["block_comp"]), group_lanes)
    entropy_emit_cuda.launch(args + (l1,), out, scratch,
                             group_lanes=group_lanes, budget_words=budget,
                             **kw)
    torch.cuda.synchronize()
    assert int(scratch[0]) == 0 and torch.equal(out[0].cpu(), refs[0])


def test_emit_first_form_equals_new(cuda_device):
    """The first-form baseline (testing/emit_v1.py) gives the same blocks
    and flags as the kernel, corrupt words included."""
    from jpeg_decoder_tpu_torch.testing import emit_v1

    blob = encode(_rgb(140, 240, 320), quality=90)[0]
    args, kw, l1, refs = _plan_inputs([blob], cuda_device)
    out, err = entropy_emit_cuda.decode_lanes(*args, **kw, l1=l1)
    o1, e1 = emit_v1.decode_lanes_v1(*args, **kw, l1=l1)
    assert torch.equal(out, o1) and torch.equal(err, e1)
    pools = args[0].clone()
    pools[0, pools.shape[1] // 3:pools.shape[1] // 3 + 6] = 0xFFFFFFFF
    _, err = entropy_emit_cuda.decode_lanes(pools, *args[1:], **kw, l1=l1)
    _, e1 = emit_v1.decode_lanes_v1(pools, *args[1:], **kw, l1=l1)
    assert int(err[0]) == int(e1[0]) == 1


def test_emit_shapes_in_any_order(cuda_device):
    """Launches whose shared memory grows, shrinks and grows again (a
    larger staging budget, then a smaller one, then the larger one, from
    the per-shape cache) all run: the kernel's shared memory limit is never
    lowered under a launch."""
    blob = encode(_rgb(150, 240, 320), quality=90)[0]
    args, kw, l1, refs = _plan_inputs([blob], cuda_device)
    for budget in (30000, 512, 30000, 4096, 512):
        out, scratch = entropy_emit_cuda.buffers(
            args[0], args[1], kw["n_mcus"], len(kw["block_comp"]), 128)
        entropy_emit_cuda.launch(args + (l1,), out, scratch,
                                 group_lanes=128, budget_words=budget, **kw)
        torch.cuda.synchronize()
        assert int(scratch[0]) == 0 and torch.equal(out[0].cpu(), refs[0])


# -- K7 with per-image table sets and geometry; the device-entropy batch ---

def _bucket_blobs():
    """Five 4:2:0 frames of one power-of-two MCU bucket: four sizes, DRI 0
    and 4, two Huffman table sets (the test encoder's, and the same with
    luma and chroma tables exchanged)."""
    from jpeg_decoder_tpu_torch.testing.encoder import encode_swapped_tables

    specs = [(240, 320, 0, encode), (200, 288, 4, encode_swapped_tables),
             (232, 304, 4, encode), (240, 320, 0, encode_swapped_tables),
             (176, 272, 0, encode)]
    return [enc(_rgb(160 + k, h, w), quality=90, restart_interval=ri)[0]
            for k, (h, w, ri, enc) in enumerate(specs)]


def test_emit_kernel_table_sets_in_shuffled_order(cuda_device):
    """One K7 launch over a bucket whose rows alternate between two table
    sets (every CTA restages): equal to decode_lanes_torch on the card and
    to the native decoder per image, each image's rows past its blocks and
    the fill row zero though the output is not zero-filled first, no group
    over budget, no LUT miss, more table stagings than one per set."""
    from jpeg_decoder_tpu_torch.entropy import native

    blobs = _bucket_blobs()
    hdrs = [parser.parse(b) for b in blobs]
    plan = entropy_spec.plan_bucket_group(hdrs, [h.scans[0] for h in hdrs],
                                          threads=1)
    assert plan.skel_ok.all() and len(plan.sets) == 2
    rows_order = [0, 3, 1, 4, 2]          # sets 0, 1, 0, 1, 0
    assert [int(plan.lut_base[r]) for r in rows_order] == [0, 6, 0, 6, 0]
    pick = [plan.order[r] for r in rows_order]

    def rows(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows_order])).to(
            cuda_device)

    luts, l1 = entropy_cuda.device_table_stack(plan.sets, cuda_device)
    bpm = 6
    n_rows = plan.n_mcus * bpm + 1
    args = (rows(plan.pools), rows(plan.starts), rows(plan.nm_lane),
            rows(plan.lane_off), None, luts)
    kw = dict(block_comp=(0, 0, 0, 0, 1, 2), n_comps=3, n_mcus=plan.n_mcus,
              trips=plan.trips, precision=8, rows=n_rows,
              lut_base=rows(plan.lut_base), n_mcus_img=rows(plan.n_mcus_img),
              ri=rows(plan.ri))
    junk = torch.full((5, n_rows, 64), 0x5A5A5A5A, dtype=torch.int32,
                      device=cuda_device)
    del junk
    before = entropy_emit_cuda.decode_lanes.launches
    out, err = entropy_emit_cuda.decode_lanes(*args, **kw, l1=l1)
    torch.cuda.synchronize()
    assert entropy_emit_cuda.decode_lanes.launches == before + 1
    stats = dict(zip(entropy_emit_cuda.STATS,
                     entropy_emit_cuda.decode_lanes.last_stats.tolist()))
    ref, ref_err = entropy_emit_cuda.decode_lanes_torch(*args, **kw)
    assert not err.any() and not ref_err.any()
    assert torch.equal(out, ref)
    for row, k in enumerate(pick):
        n = hdrs[k].mcus_x * hdrs[k].mcus_y * bpm
        np.testing.assert_array_equal(
            out[row, :n].cpu().numpy(),
            native.decode_scan_baseline(hdrs[k], hdrs[k].scans[0]))
        assert not out[row, n:].any()
    assert stats["groups_over_budget"] == 0 and stats["lut_misses"] == 0
    assert stats["table_stages"] > 2


def test_sharded_batch_on_card_equals_cpu(cuda_device, monkeypatch):
    """decode_batch_sharded(idct="exact") on the card equals the same call
    on the CPU (plain versions) item for item, byte for byte: a uniform
    DRI-0 group and the bucket (K7 once each), a restart group over the
    segment threshold (K2 once), a 12-bit frame (K7) and a corrupt stream
    that fails alone."""
    from jpeg_decoder_tpu_torch.parallel import sharded

    monkeypatch.setenv("JD_RESTART_EMIT_MAX_LANES", "100")
    same = [encode(_rgb(170 + k, 120, 160), quality=90)[0] for k in range(3)]
    bad = bytearray(same[1])
    sos = bytes(bad).index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(bad[sos + 2:sos + 4], "big")
    bad[start + 4:start + 20] = b"\xff\x00" * 8
    blobs = (same + [bytes(bad)] + _bucket_blobs()
             + [encode(_rgb(180 + k, 80, 128), quality=85,
                       restart_interval=1)[0] for k in range(3)]
             + [encode(_rgb(190, 120, 200), quality=90, precision=12)[0]])
    k7 = entropy_emit_cuda.decode_lanes.launches
    k2 = entropy_cuda.decode_segments.launches
    k6b = pixels_cuda.blocks_to_rgb.launches
    got = sharded.decode_batch_sharded(blobs, cuda_device, idct="exact")
    torch.cuda.synchronize()
    assert entropy_emit_cuda.decode_lanes.launches - k7 == 3
    assert entropy_cuda.decode_segments.launches - k2 == 1
    assert pixels_cuda.blocks_to_rgb.launches - k6b == 4   # one a group
    ref = sharded.decode_batch_sharded(blobs, "cpu", idct="exact")
    assert [it.ok for it in got] == [k != 3 for k in range(len(blobs))]
    for g, r in zip(got, ref):
        assert g.ok == r.ok
        if g.ok:
            assert g.rgb.is_cuda and torch.equal(g.rgb.cpu(), r.rgb)
    for rec in sharded.decode_batch_sharded.last_timing["groups"]:
        if "k7_stats" in rec:
            assert rec["k7_stats"]["groups_over_budget"] == 0
            assert rec["k7_stats"]["lut_misses"] == 0


# ---------------------------------------------------------------------------
# The progressive lanes (K8a-K8d)
# ---------------------------------------------------------------------------

def _prog_fixture(name):
    from jpeg_decoder_tpu_torch.testing import photo

    return photo.fixture(name)[0]


@pytest.mark.parametrize("name", ["progressive_512.jpg",
                                  "progressive_1080p_dri.jpg"])
def test_prog_kernels_match_plain_per_scan(cuda_device, name):
    """Every scan of a fixture through K8a-K8d and through their plain
    versions on the card, from the native decoder's prior planes: planes
    and flags equal, and equal to the native decoder's posterior.  The
    DRI-0 512x512 fixture takes skeleton lanes, the 1080p one with restart
    markers its segments."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states
    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8

    hdr = parser.parse(_prog_fixture(name))
    states = native_prog_states(hdr)
    nzmaps: dict = {}
    seen = set()
    skeleton = hdr.scans[0].restart_interval == 0
    for k, scan in enumerate(hdr.scans):
        lane_tab = (ep.hybrid_scan_prep(hdr, scan, nzmaps, target_lanes=700)
                    if skeleton else None)
        args = ep.scan_inputs(hdr, scan, lane_tab, cuda_device)
        got = {}
        for kernel in (True, False):
            planes = [torch.tensor(p, device=cuda_device) for p in states[k]]
            before = {n: f.launches for n, f in k8.KERNELS.items()}
            err = ep.launch_scan(scan, args, planes, plain=not kernel)
            torch.cuda.synchronize()
            after = {n: f.launches for n, f in k8.KERNELS.items()}
            assert sum(after.values()) - sum(before.values()) == int(kernel)
            seen |= {n for n in after if after[n] != before[n]}
            got[kernel] = (err.cpu(), [p.cpu().numpy() for p in planes])
        assert torch.equal(got[True][0], got[False][0])
        assert not got[True][0].any(), f"scan {k} flagged"
        for ci in range(len(planes)):
            np.testing.assert_array_equal(got[True][1][ci], got[False][1][ci])
            np.testing.assert_array_equal(got[True][1][ci], states[k + 1][ci])
    assert seen == {"K8a", "K8b", "K8c", "K8d"}


def test_prog_kernels_flag_corrupt_scans_as_plain(cuda_device):
    """Scans of the 512x512 fixture with bytes flipped, decoded from the
    skeleton lanes of the intact scans: each kernel's lane flags equal its
    plain version's."""
    import copy

    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    hdr = parser.parse(_prog_fixture("progressive_512.jpg"))
    states = native_prog_states(hdr)
    rng = np.random.default_rng(5)
    flagged = 0
    nzmaps: dict = {}
    for k, scan in enumerate(hdr.scans):
        lane_tab = ep.hybrid_scan_prep(hdr, scan, nzmaps, target_lanes=700)
        for _ in range(3):
            bad = copy.copy(scan)
            data = scan.data.copy()
            q = int(rng.integers(0, max(1, len(data) - 4)))
            data[q:q + 4] ^= 0x5A
            bad.data = data
            args = ep.scan_inputs(hdr, bad, lane_tab, cuda_device)
            flags = []
            for plain in (False, True):
                planes = [torch.tensor(p, device=cuda_device)
                          for p in states[k]]
                flags.append(ep.launch_scan(bad, args, planes,
                                            plain=plain).cpu())
            assert torch.equal(flags[0], flags[1]), k
            flagged += int(flags[0].any())
    assert flagged > 0


@pytest.mark.parametrize("name", ["progressive_512.jpg",
                                  "progressive_1080p_dri.jpg"])
@pytest.mark.parametrize("entropy", ["pallas", "jax", "hybrid"])
def test_prog_decode_on_card_equals_native(cuda_device, name, entropy):
    """decode() of a progressive fixture under a device backend: K8 launched,
    planes equal to the native decoder's, strict RGB byte-equal to the CPU
    decode."""
    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.models import decoder as dec_mod
    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8

    blob = _prog_fixture(name)
    hdr = parser.parse(blob)
    for f in k8.KERNELS.values():
        f.launches = 0
    planes = dec_mod.decode_to_planes(hdr, entropy=entropy,
                                      device=cuda_device)
    assert all(f.launches > 0 for f in k8.KERNELS.values())
    for a, b in zip(planes, native.decode_progressive(hdr)):
        np.testing.assert_array_equal(a, b)
    got = decode(blob, entropy=entropy, idct="exact", upsample="fancy",
                 device=cuda_device).rgb
    want = decode(blob, entropy="native", idct="exact", upsample="fancy",
                  device="cpu").rgb
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("lanes", [1, 3, 512, 100_000])
def test_prog_lane_counts_on_card(cuda_device, lanes):
    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep

    hdr = parser.parse(_prog_fixture("progressive_512.jpg"))
    got = ep.decode_progressive_hybrid(hdr, cuda_device, target_lanes=lanes)
    for a, b in zip(got, native.decode_progressive(hdr)):
        np.testing.assert_array_equal(a, b)


def test_prog_corrupt_decode_raises_on_card(cuda_device):
    blob = bytearray(_prog_fixture("progressive_512.jpg"))
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
    blob[start:start + 24] = b"\xff\x00" * 12
    with pytest.raises(JPEGError):
        decode(bytes(blob), entropy="hybrid", device=cuda_device)


# The redesigned K8c and K8d (one warp per lane, staged tables and words,
# history as bit masks) against their plain versions and their first forms.

def _ac_forms(refine: bool) -> tuple:
    """The forms of K8c (warp, thread) or K8d (warp)."""
    return ("warp",) if refine else ("warp", "thread")


def _ac_all_ways(scan, args, prior, dev, budget=None):
    """One AC scan through the kernel in each of its forms, its first form
    and its plain version, each from ``prior``: [(flags, plane)] in that
    order, and each form's counters (l2 slots, lanes over budget, table
    misses) by form."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
    from jpeg_decoder_tpu_torch.testing import prog_v1

    refine = scan.ah > 0
    new = k8.ac_refine if refine else k8.ac_first
    forms = _ac_forms(refine)
    fns = [lambda *a, f=f, **k: k8._ac(
               refine, *a, k["ss"], k["se"], k["al"], args.ac_table, form=f,
               budget=budget) for f in forms]
    fns += [prog_v1.ac_refine_v1 if refine else prog_v1.ac_first_v1,
            k8.ac_refine_torch if refine else k8.ac_first_torch]
    out, stats = [], {}
    for i, fn in enumerate(fns):
        plane = torch.tensor(prior, device=dev)
        err = fn(args.words, args.lanes, args.luts, plane, args.geom,
                 ss=scan.ss, se=scan.se, al=scan.al)
        torch.cuda.synchronize()
        out.append((err.cpu(), plane.cpu().numpy()))
        if i < len(forms):
            stats[forms[i]] = new.last_stats.tolist()
    return out, stats


@pytest.mark.parametrize("name,target", [("progressive_512.jpg", 700),
                                         ("progressive_512.jpg", 1),
                                         ("progressive_1080p_dri.jpg", None)])
def test_prog_ac_kernels_match_plain_and_first_form(cuda_device, name,
                                                    target):
    """Every AC scan of a fixture (skeleton lanes at 700 and at 1 target
    lanes, or the restart fixture's segment lanes: 135 luma lanes of 240
    blocks) through K8c in both forms and K8d, their first forms and their
    plain versions:
    flags and planes equal, equal to the native decoder's, and no lane over
    its staging budget nor a table probe in device memory."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    hdr = parser.parse(_prog_fixture(name))
    states = native_prog_states(hdr)
    nzmaps: dict = {}
    n_ac = 0
    for k, scan in enumerate(hdr.scans):
        lane_tab = (ep.hybrid_scan_prep(hdr, scan, nzmaps, target_lanes=target)
                    if target else None)
        if scan.ss == 0:
            continue
        args = ep.scan_inputs(hdr, scan, lane_tab, cuda_device)
        ci = args.cis[0]
        got, stats = _ac_all_ways(scan, args, states[k][ci], cuda_device)
        for err, plane in got:
            assert torch.equal(err, got[-1][0]) and not err.any(), k
            np.testing.assert_array_equal(plane, states[k + 1][ci])
        if target is None and ci == 0:
            assert args.lanes.n == 135
        # The form the wrapper picks stages every word (unless one lane is
        # the whole scan); no form probes the full table.
        picked = "thread" if k8.use_threads(scan.ah > 0, args.lanes) \
            else "warp"
        assert stats[picked][1] == 0 or target == 1, stats
        assert all(st[2] == 0 for st in stats.values()), stats
        n_ac += 1
    assert n_ac >= 4


@pytest.mark.parametrize("kind", ["first", "refine"])
@pytest.mark.parametrize("case", range(7))
def test_prog_ac_band_scans_on_card(cuda_device, kind, case):
    """testing/ac_scan.py's partial-band scans (bands 1-5, 6-63, 2-2,
    63-63, 1-63; al 0-3; codes over 11 bits, whose decode takes the
    second-level tables; a table with more long-code prefixes than the
    kernels keep, whose probes then read device memory), lanes cut inside
    EOB runs: K8c in both forms and K8d at the default budget and at 4 words
    (lanes over budget), their first forms and plain versions all give the
    written planes, unflagged, and the counters say so."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
    from jpeg_decoder_tpu_torch.testing import ac_scan

    bands = [(1, 5, 0, "flat"), (6, 63, 1, "long"), (2, 2, 2, "flat"),
             (63, 63, 3, "long"), (1, 63, 0, "long"), (1, 63, 3, "flat"),
             (1, 63, 2, "wide")]
    c = ac_scan.band_case(kind, *bands[case],
                          seed=case + 10 * (kind == "refine"))
    args = ep.scan_inputs(c.hdr, c.scan, c.lanes, cuda_device)
    prior = np.concatenate([c.prior, np.zeros((1, 64), np.int32)])
    # Lanes whose words (start word rounded down to 4, end word plus the
    # reader's lookahead of 3) exceed a budget of 4 words.
    lo = (args.lanes.base.cpu().numpy() >> 5) & ~3
    hi = np.minimum((args.lanes.end.cpu().numpy() >> 5) + 3,
                    args.words.numel())
    n_exceed = int((hi - lo > 4).sum())
    assert n_exceed > 0 or bands[case][:2] == (63, 63)
    for budget in (None, 4):
        got, stats = _ac_all_ways(c.scan, args, prior, cuda_device, budget)
        for err, plane in got:
            assert not err.any()
            np.testing.assert_array_equal(plane[:-1], c.post)
        for form, (slots, over, misses) in stats.items():
            assert slots == args.ac_table.n_slots
            # A 4-word budget: in the warp form at most the lanes whose own
            # words exceed it read outside; in the thread form a warp's
            # lanes share one 4-word range.
            limit = 0 if budget is None else (
                n_exceed if form == "warp" else args.lanes.n)
            assert over <= limit
            assert (misses > 0) == (bands[case][3] == "wide")


def test_prog_ac_corrupt_scans_flag_as_plain_and_first_form(cuda_device):
    """AC scans of the 512x512 fixture with bytes flipped, decoded from the
    intact scans' skeleton lanes: K8c's (both forms) and K8d's flags equal
    their first forms' and their plain versions', and so do the planes of a
    scan none of them flags."""
    import copy

    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    hdr = parser.parse(_prog_fixture("progressive_512.jpg"))
    states = native_prog_states(hdr)
    rng = np.random.default_rng(9)
    flagged = 0
    nzmaps: dict = {}
    for k, scan in enumerate(hdr.scans):
        lane_tab = ep.hybrid_scan_prep(hdr, scan, nzmaps, target_lanes=300)
        if scan.ss == 0:
            continue
        for _ in range(3):
            bad = copy.copy(scan)
            data = scan.data.copy()
            q = int(rng.integers(0, max(1, len(data) - 4)))
            data[q:q + 4] ^= 0x5A
            bad.data = data
            args = ep.scan_inputs(hdr, bad, lane_tab, cuda_device)
            got, _ = _ac_all_ways(bad, args, states[k][args.cis[0]],
                                  cuda_device)
            for err, _ in got[:-1]:
                assert torch.equal(err, got[-1][0]), k
            flagged += int(got[0][0].any())
            if not got[-1][0].any():   # a flagged lane's blocks: unspecified
                for _, plane in got[:-1]:
                    np.testing.assert_array_equal(plane, got[-1][1])
    assert flagged > 0


@pytest.mark.parametrize("lanes", [1, 3, 512, 4096])
def test_prog_ac_lane_counts_on_card(cuda_device, lanes):
    """The 1080p (a) fixture's AC scans at 1, 3, 512 and 4,096 target
    skeleton lanes: K8c/K8d (the form the wrapper picks, and K8c in both
    forms) equal their first forms and the native decoder's planes (its
    plain versions take minutes at this size)."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.testing import prog_v1
    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    hdr = parser.parse(_prog_fixture("progressive_1080p_a.jpg"))
    states = native_prog_states(hdr)
    nzmaps: dict = {}
    for k, scan in enumerate(hdr.scans):
        lane_tab = ep.hybrid_scan_prep(hdr, scan, nzmaps, target_lanes=lanes)
        if scan.ss == 0:
            continue
        args = ep.scan_inputs(hdr, scan, lane_tab, cuda_device)
        ci = args.cis[0]
        refine = scan.ah > 0
        new = k8.ac_refine if refine else k8.ac_first
        fns = [new] + [lambda *a, f=f, **kw: k8._ac(
            refine, *a, kw["ss"], kw["se"], kw["al"], kw["table"], form=f)
            for f in _ac_forms(refine)]
        fns.append(prog_v1.ac_refine_v1 if refine else prog_v1.ac_first_v1)
        for fn in fns:
            plane = torch.tensor(states[k][ci], device=cuda_device)
            err = fn(args.words, args.lanes, args.luts, plane, args.geom,
                     ss=scan.ss, se=scan.se, al=scan.al,
                     table=args.ac_table)
            assert not err.cpu().any()
            np.testing.assert_array_equal(plane.cpu().numpy(),
                                          states[k + 1][ci])


# The redesigned K8a (a warp or a thread per lane, staged tables and words)
# and K8b (a thread per block) against their plain versions and their first
# forms.

DC_FIXTURES = ("progressive_512.jpg", "progressive_1080p_a.jpg",
               "progressive_gray.jpg", "progressive_422.jpg")
#: The longest lane, in block slots, that the plain K8a walks in a test
#: (one Python step per slot).
DC_PLAIN_SLOTS = 10_000


def _dc_lanes(hdr, scan, target):
    """A DC scan's lane table at ``target`` lanes: K8a's skeleton lanes,
    or K8b's bits cut into chained lanes of ceil(units / target) units (a
    refinement's bit of block t lies at bit t); None: restart segments."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep

    if target is None:
        return None
    if scan.ah == 0:
        return ep.hybrid_scan_prep(hdr, scan, {}, target_lanes=target)
    n = ep.scan_units(hdr, scan)
    stride = max(1, -(-n // target))
    first = np.arange(0, n, stride, dtype=np.int64)
    n_per = np.minimum(stride, n - first).astype(np.int32)
    bpm = ep.scan_geometry(hdr, scan)[1].bpm
    return (first * bpm, n_per, first, np.zeros(len(first), np.int32),
            np.zeros((len(first), len(scan.comp_indices)), np.int32))


def _dc_all_ways(scan, args, prior, dev, budget=None, plain=True):
    """One DC scan through K8a in both forms (or K8b), its first form and,
    unless ``plain`` is false or the longest lane is over
    DC_PLAIN_SLOTS, its plain version, each from ``prior`` (the frame's
    planes): {way: (flags, the scan's planes)}, and K8a's counters (l2
    slots, lanes over budget, table misses) by form."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
    from jpeg_decoder_tpu_torch.testing import prog_v1

    g, al = args.geom, scan.al
    if scan.ah == 0:
        ways = {f: lambda w, l, pl, f=f: k8._dc_first(
            w, l, args.luts, pl, g, al, args.dc_table, form=f,
            budget=budget) for f in ("warp", "thread")}
        ways["v1"] = lambda w, l, pl: prog_v1.dc_first_v1(
            w, l, args.luts, pl, g, al=al)
        ways["plain"] = lambda w, l, pl: k8.dc_first_torch(
            w, l, args.luts, pl, g, al=al)
    else:
        ways = {"new": lambda w, l, pl: k8.dc_refine(w, l, pl, g, al=al),
                "v1": lambda w, l, pl: prog_v1.dc_refine_v1(w, l, pl, g,
                                                            al=al),
                "plain": lambda w, l, pl: k8.dc_refine_torch(w, l, pl, g,
                                                             al=al)}
    if not plain or (scan.ah == 0 and
                     args.lanes.max_units * g.bpm > DC_PLAIN_SLOTS):
        del ways["plain"]
    out, stats = {}, {}
    for name, fn in ways.items():
        planes = [torch.tensor(p, device=dev) for p in prior]
        err = fn(args.words, args.lanes, [planes[ci] for ci in args.cis])
        torch.cuda.synchronize()
        out[name] = (err.cpu(), [planes[ci].cpu().numpy() for ci in args.cis])
        if name in ("warp", "thread"):
            stats[name] = k8.dc_first.last_stats.tolist()
    return out, stats


@pytest.mark.parametrize("name,target",
                         [(n, t) for n in DC_FIXTURES
                          for t in (1, 3, 512, 4096, 1_000_000)]
                         + [("progressive_1080p_dri.jpg", None)])
def test_prog_dc_kernels_match_plain_and_first_form(cuda_device, name,
                                                    target):
    """Every DC scan of a fixture (4:2:0, gray: one block per unit, 4:2:2:
    four per MCU) at 1, 3, 512, 4,096 and more lanes than units, or the
    restart fixture's 68 segment lanes of 120 MCUs: K8a in both forms (K8b),
    the first forms and the plain versions give equal flags and planes,
    none flagged, equal to the native decoder's; K8a's form the wrapper
    picks reads no word outside its staging (unless the budget is capped)
    and no form probes a table in device memory."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    hdr = parser.parse(_prog_fixture(name))
    states = native_prog_states(hdr)
    n_dc = 0
    for k, scan in enumerate(hdr.scans):
        if scan.ss:
            continue
        args = ep.scan_inputs(hdr, scan, _dc_lanes(hdr, scan, target),
                              cuda_device)
        if target is None:
            assert args.lanes.n == 68 and args.lanes.max_units == 120
        got, stats = _dc_all_ways(scan, args, states[k], cuda_device)
        for way, (err, planes) in got.items():
            assert not err.any(), (k, way)
            for ci, plane in zip(args.cis, planes):
                np.testing.assert_array_equal(plane, states[k + 1][ci],
                                              err_msg=f"scan {k} {way}")
        if scan.ah == 0:
            assert "plain" in got or args.lanes.n < 4
            picked = "thread" if k8.dc_use_threads(args.lanes) else "warp"
            capped = k8.dc_budget_words(
                args.lanes, picked == "thread") == k8.AC_MAX_BUDGET
            for form, (slots, over, misses) in stats.items():
                assert slots == args.dc_table.n_slots and misses == 0
                assert over == 0 or capped or form != picked, stats
        n_dc += 1
    assert n_dc == 2


@pytest.mark.parametrize("kind", ["long", "wide"])
def test_prog_dc_long_tables_on_card(cuda_device, kind):
    """The DC first scans of the 512x512 and 4:2:2 fixtures written anew
    with codes over 11 bits (testing/dc_scan.py; "wide": more long-code
    prefixes than K8a keeps), at 64 and 4,096 lanes: K8a in both forms, its
    first form and its plain version give the native planes, and only the
    wide table's probes read the LUT in device memory."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.testing import dc_scan
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    spec = dc_scan.dc_spec(kind)
    for name in ("progressive_512.jpg", "progressive_422.jpg"):
        hdr = parser.parse(_prog_fixture(name))
        states = native_prog_states(hdr)
        k = 0
        scan = dc_scan.rewrite_dc_first(hdr, hdr.scans[k], states[k + 1],
                                        spec)
        for target in (64, 4096):
            args = ep.scan_inputs(hdr, scan, _dc_lanes(hdr, scan, target),
                                  cuda_device)
            assert bool(args.dc_table.l2_full) == (kind == "wide")
            got, stats = _dc_all_ways(scan, args, states[k], cuda_device)
            for way, (err, planes) in got.items():
                assert not err.any(), (name, target, way)
                for ci, plane in zip(args.cis, planes):
                    np.testing.assert_array_equal(plane, states[k + 1][ci])
            for slots, over, misses in stats.values():
                assert slots == args.dc_table.n_slots > 0 and over == 0
                assert (misses > 0) == (kind == "wide")


def test_prog_dc_corrupt_scans_flag_as_plain_and_first_form(cuda_device):
    """DC scans of the 512x512 fixture with bytes flipped (skeleton lanes
    of the intact scans, and K8b's lanes), a skeleton lane's start moved on
    by one bit, and its recorded luma predictor off by one: K8a's (both
    forms) and K8b's flags equal their first forms' and their plain
    versions', and so do the planes of a scan none of them flags."""
    import copy

    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    hdr = parser.parse(_prog_fixture("progressive_512.jpg"))
    states = native_prog_states(hdr)
    rng = np.random.default_rng(11)
    flagged = 0

    def all_agree(scan, lanes, k):
        args = ep.scan_inputs(hdr, scan, lanes, cuda_device)
        got, _ = _dc_all_ways(scan, args, states[k], cuda_device)
        ref = got.pop("plain")
        for way, (err, planes) in got.items():
            assert torch.equal(err, ref[0]), (k, way)
            if not ref[0].any():   # a flagged lane's blocks: unspecified
                for a, b in zip(planes, ref[1]):
                    np.testing.assert_array_equal(a, b)
        return int(ref[0].any())

    for k, scan in enumerate(hdr.scans):
        if scan.ss:
            continue
        lanes = _dc_lanes(hdr, scan, 300)
        for _ in range(4):
            bad = copy.copy(scan)
            data = scan.data.copy()
            q = int(rng.integers(0, max(1, len(data) - 4)))
            data[q:q + 4] ^= 0x5A
            bad.data = data
            flagged += all_agree(bad, lanes, k)
        if scan.ah:
            continue
        for field in ("base", "pred0"):
            base, n_per, first, eob0, pred0 = (np.asarray(a).copy()
                                               for a in lanes)
            if field == "base":
                base[1] += 1
            else:
                pred0[1, 0] += 1
            assert all_agree(scan, (base, n_per, first, eob0, pred0), k)
            flagged += 1
    assert flagged > 2


def test_prog_dc_shapes_in_any_order(cuda_device):
    """K8a launches whose shared memory grows, shrinks and grows again (one
    table or three, a staging budget of 4 words, the default or the most,
    each form), from the per-shape occupancy cache, all run and give the
    native planes: one shape never sets another's limit."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    cases = {}
    for name in ("progressive_gray.jpg", "progressive_512.jpg"):
        hdr = parser.parse(_prog_fixture(name))
        scan = hdr.scans[0]
        cases[name] = (native_prog_states(hdr), ep.scan_inputs(
            hdr, scan, _dc_lanes(hdr, scan, 64), cuda_device), scan.al)
    order = [("progressive_512.jpg", "warp", k8.AC_MAX_BUDGET),
             ("progressive_gray.jpg", "warp", 4),
             ("progressive_512.jpg", "thread", None),
             ("progressive_gray.jpg", "thread", k8.AC_MAX_BUDGET),
             ("progressive_512.jpg", "warp", 4),
             ("progressive_512.jpg", "warp", k8.AC_MAX_BUDGET),
             ("progressive_gray.jpg", "warp", None)]
    for name, form, budget in order:
        states, args, al = cases[name]
        planes = [torch.tensor(p, device=cuda_device) for p in states[0]]
        err = k8._dc_first(args.words, args.lanes, args.luts,
                           [planes[ci] for ci in args.cis], args.geom, al,
                           args.dc_table, form=form, budget=budget)
        torch.cuda.synchronize()
        assert not err.cpu().any(), (name, form, budget)
        for ci in args.cis:
            np.testing.assert_array_equal(planes[ci].cpu().numpy(),
                                          states[1][ci])


def test_prog_dc_and_ac_chains_share_planes_on_two_streams(cuda_device):
    """A DC first scan (K8a) and an AC refinement scan (K8d) of the
    512x512 fixture launched at once on two streams into one set of
    planes: coefficient 0 holds the DC scan's result, the band the
    refinement's (no store of either touches the other's elements)."""
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    hdr = parser.parse(_prog_fixture("progressive_512.jpg"))
    states = native_prog_states(hdr)
    dc = 0
    assert hdr.scans[dc].ss == 0 and hdr.scans[dc].ah == 0
    k_ac = max(k for k, s in enumerate(hdr.scans) if s.ss and s.ah)
    nzmaps: dict = {}
    lane_tabs = {}
    for k, scan in enumerate(hdr.scans):
        lane_tabs[k] = ep.hybrid_scan_prep(hdr, scan, nzmaps,
                                           target_lanes=64)
    a_dc = ep.scan_inputs(hdr, hdr.scans[dc], lane_tabs[dc], cuda_device)
    a_ac = ep.scan_inputs(hdr, hdr.scans[k_ac], lane_tabs[k_ac], cuda_device)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for _ in range(5):
        planes = [torch.tensor(p, device=cuda_device)
                  for p in states[k_ac]]
        for p in planes:
            p[:, 0] = 0
        torch.cuda.synchronize()
        with torch.cuda.stream(s1):
            e1 = ep.launch_scan(hdr.scans[dc], a_dc, planes)
        with torch.cuda.stream(s2):
            e2 = ep.launch_scan(hdr.scans[k_ac], a_ac, planes)
        torch.cuda.synchronize()
        assert not e1.cpu().any() and not e2.cpu().any()
        for ci, p in enumerate(planes):
            got = p.cpu().numpy()
            np.testing.assert_array_equal(got[:, 0], states[1][ci][:, 0])
            want = states[k_ac + 1][ci]
            np.testing.assert_array_equal(got[:, 1:], want[:, 1:])


# ---------------------------------------------------------------------------
# The batch routes' pixel stage: K6a (nibble wire -> blocks) and K6b
# (scan-order blocks -> RGB)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blk,seed", [(40, 0), (700, 1), (6000, 2)])
def test_unpack_nibble_kernel_equals_plain(cuda_device, n_blk, seed):
    """K6a equals the plain ``unpack_nibble`` on every element (run on the
    card and on the CPU), the trap row included, with one count a call;
    and again on entry rows whose length is no multiple of 16."""
    from jpeg_decoder_tpu_torch.testing import pixel_cases

    arrays = list(pixel_cases.nibble_group(seed, n_blk))
    for cut in (0, 11):
        if cut:
            k = arrays[1].shape[1]
            arrays[1] = np.ascontiguousarray(arrays[1][:, :k - k % 16 + cut])
        cpu = [torch.from_numpy(a) for a in arrays]
        dev = [t.to(cuda_device) for t in cpu]
        before = pixels_cuda.unpack_nibble.launches
        got = pixels_cuda.unpack_nibble(*dev)
        torch.cuda.synchronize()
        assert pixels_cuda.unpack_nibble.launches == before + 1
        assert torch.equal(got, tbatch.unpack_nibble(*dev))
        assert torch.equal(got.cpu(), tbatch.unpack_nibble(*cpu))


def _nibble_trims(b, n_blk):
    return [(None, None), (b, n_blk), (b - 1, n_blk - 9),
            (max(b - 2, 1), n_blk // 3), (1, 0)]


@pytest.mark.parametrize("n_blk,seed", [(40, 3), (700, 4), (6000, 5)])
def test_unpack_nibble_kernel_trims(cuda_device, n_blk, seed):
    """K6a with and without the trim (``n_img``/``n_rows``) equals the plain
    version on the cut wire, on padded groups with the trap row (escapes
    that fall) and with sorted escapes only; its first form
    (``jd_unpack_nibble_v1``) equals the whole plain output; one count a
    call of each."""
    from jpeg_decoder_tpu_torch.testing import pixel_cases, pixel_v1

    arrays = list(pixel_cases.nibble_group(seed, n_blk))
    for sort in (False, True):
        if sort:
            arrays[3][arrays[3] < 0] = n_blk * 64
            arrays[3] = np.sort(arrays[3], axis=1)
        cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        dev = [t.to(cuda_device) for t in cpu]
        for n_img, n_rows in _nibble_trims(cpu[0].shape[0], n_blk):
            before = pixels_cuda.unpack_nibble.launches
            got = pixels_cuda.unpack_nibble(*dev, n_img=n_img, n_rows=n_rows)
            torch.cuda.synchronize()
            assert pixels_cuda.unpack_nibble.launches == before + 1
            ref = pixels_cuda.unpack_nibble(*cpu, n_img=n_img, n_rows=n_rows)
            assert torch.equal(got.cpu(), ref), (n_img, n_rows)
        before = pixel_v1.unpack_nibble_v1.launches
        v1 = pixel_v1.unpack_nibble_v1(*dev)
        torch.cuda.synchronize()
        assert pixel_v1.unpack_nibble_v1.launches == before + 1
        assert torch.equal(v1.cpu(), tbatch.unpack_nibble(*cpu))


def test_unpack_nibble_kernel_edges(cuda_device):
    """K6a on each edge case of its kernel (a real gap-0 entry that opens a
    chunk, chunks of extenders only, rows of fillers only, escapes on DC
    slots, out of range and out of order, overflow values, 12-bit values),
    whole and trimmed, equals the plain version; and on a group whose rows
    cross windows of every kind: a chunk of extenders, a value that opens
    a chunk, a row whose tail of filler chunks holds a value."""
    from jpeg_decoder_tpu_torch.testing import pixel_cases

    cases = [pixel_cases.nibble_edge(n)[0] for n in pixel_cases.NIBBLE_EDGES]
    n_blk = 40000
    rng = np.random.default_rng(21)
    e = np.zeros((2, 9 * 4096 + 100), np.uint8)
    e[0, :4095] = 0x11
    e[0, 4095] = 0x30
    e[0, 4096] = 0x05               # gap 0, value 5: opens chunk 1
    e[0, 4097:8192] = 0xF0           # chunk 1 advances 240 an entry
    e[0, 8192:8200] = 0x1F
    e[1, :12000] = rng.integers(0, 256, 12000)
    e[1, 30000] = 0x03              # past six chunks of fillers
    esc = np.full((2, 300), n_blk * 64, np.int32)
    esc[0, :4] = (65, 4146, 4338, 4339)
    esc[1, :260] = np.sort(rng.integers(0, n_blk * 64, 260))
    cases.append([rng.integers(-99, 99, (2, n_blk)).astype(np.int16), e,
                  rng.integers(-128, 128, (2, 700)).astype(np.int8), esc,
                  rng.integers(-3000, 3000, (2, 300)).astype(np.int16)])
    for arrays in cases:
        cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        dev = [t.to(cuda_device) for t in cpu]
        n_blk = cpu[0].shape[1]
        for n_img, n_rows in _nibble_trims(2, n_blk):
            got = pixels_cuda.unpack_nibble(*dev, n_img=n_img, n_rows=n_rows)
            ref = pixels_cuda.unpack_nibble(*cpu, n_img=n_img, n_rows=n_rows)
            assert torch.equal(got.cpu(), ref), (n_blk, n_img, n_rows)


@pytest.mark.parametrize("idct", ["pallas", "exact", "kron", "fast"])
def test_blocks_to_rgb_short_blocks(cuda_device, idct):
    """K6b on blocks of fewer images than the geometry equals K6b on the
    zero-padded blocks, byte for byte, for every frame kind (the images
    past the blocks the colour of zeros)."""
    from jpeg_decoder_tpu_torch.testing import pixel_cases

    for name, hv, color, prec in pixel_cases.FRAME_KINDS:
        blocks, qt, geom, kw = pixel_cases.bucket_group(
            5, hv, color, prec, pixel_cases.odd_dims(hv, (5, 3)), (8, 4),
            pad=6)
        dev = [torch.from_numpy(a).to(cuda_device)
               for a in (blocks, qt, geom)]
        for n in (3, 1, 0):
            padded = dev[0].clone()
            padded[n:] = 0
            want = pixels_cuda.blocks_to_rgb(padded, dev[1], dev[2],
                                             idct=idct, upsample="fancy",
                                             **kw)
            got = pixels_cuda.blocks_to_rgb(
                dev[0][:n].contiguous(), dev[1], dev[2], idct=idct,
                upsample="fancy", **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, n)


def test_batch_route_trim_equals_whole(cuda_device):
    """``BatchDecoder``'s pixels from K6a's trimmed blocks equal K6b on the
    first form's whole blocks, byte for byte, under every IDCT, on a
    mixed-size bucket of three images in a batch of 4 and other groups."""
    from jpeg_decoder_tpu_torch import BatchDecoder
    from jpeg_decoder_tpu_torch.testing import pixel_v1
    from jpeg_decoder_tpu_torch.testing.photo import synthetic_photo

    rng = np.random.default_rng(17)
    blobs = [encode(synthetic_photo(rng, h, w), samplings=s)[0]
             for h, w, s in ((48, 80, ((2, 2), (1, 1), (1, 1))),
                             (40, 72, ((2, 2), (1, 1), (1, 1))),
                             (60, 100, ((2, 2), (1, 1), (1, 1))),
                             (200, 300, ((1, 1),) * 3))]
    for idct in ("pallas", "exact", "kron", "fast"):
        with BatchDecoder(device=cuda_device, idct=idct) as bd:
            groups = bd.group(bd.host_stage(blobs))
            assert sorted(len(g.idxs) for g in groups) == [1, 3]
            for g in groups:
                t = bd.to_device(g)
                kw = dict(comp_shapes=g.comp_shapes, comp_hv=g.comp_hv,
                          height=g.height, width=g.width,
                          samplings=g.samplings, idct=idct,
                          upsample="fancy", color=g.color,
                          precision=g.precision)
                got = bd.pixels(g, t)
                want = pixels_cuda.blocks_to_rgb(
                    pixel_v1.unpack_nibble_v1(*t[:-2]), t[-2], t[-1], **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (idct, len(g.idxs))


def _k6b_kinds():
    from jpeg_decoder_tpu_torch.testing import pixel_cases

    return [k[0] for k in pixel_cases.FRAME_KINDS]


def _k6b_equal(got, ref, idct) -> None:
    """Byte-equal under ``pallas`` and ``exact``; under ``kron`` (K1's
    arithmetic against the route's GEMM) and ``fast`` (the kernel's
    separable form against the route's einsum) the +-1 IDCT bound
    (RGB_TOL after the colour transform, MIN_EQUAL)."""
    assert got.is_cuda and got.dtype == ref.dtype and got.shape == ref.shape
    if idct in ("kron", "fast"):
        d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
        assert int(d.max()) <= RGB_TOL
        assert float((d == 0).float().mean()) >= MIN_EQUAL
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("idct", ["pallas", "exact", "kron", "fast"])
@pytest.mark.parametrize("kind", _k6b_kinds())
def test_blocks_to_rgb_kernel_equals_route(cuda_device, kind, idct,
                                           monkeypatch):
    """K6b on a bucketed group (odd true dims, a tiny image, a padding
    row), under fancy and nn, at its tile, at one MCU and at 32x128, and
    with a grid of one CTA a multiprocessor, equals the route it replaces
    on the card (``rgb_from_blocks_torch``: the plane gather, K1 or K5 or
    the torch product, torch ops) over the whole tensor, padding included
    (``_k6b_equal``); under ``exact`` it equals the CPU route too.  Every
    call is one launch and no ``scan_samples``."""
    from jpeg_decoder_tpu_torch.testing import pixel_cases

    hv, color, prec = {k[0]: k[1:] for k in pixel_cases.FRAME_KINDS}[kind]
    arrays = pixel_cases.bucket_group(
        len(kind), hv, color, prec, pixel_cases.odd_dims(hv, (5, 3)),
        (8, 4), pad=4)
    kw = arrays[3]
    cpu = [torch.from_numpy(a) for a in arrays[:3]]
    dev = [t.to(cuda_device) for t in cpu]
    mcu = (8 * max(v for _, v in hv), 8 * max(h for h, _ in hv))
    for up in ("fancy", "nn"):
        ref = tbatch.rgb_from_blocks_torch(*dev, idct=idct, upsample=up,
                                           **kw)
        for tile, ctas in ((pixels_cuda.TILE, None), (mcu, 1),
                           ((32, 128), 2)):
            monkeypatch.setattr(pixels_cuda, "TILE", tile)
            monkeypatch.setitem(pixels_cuda.CTAS_PER_SM, idct,
                                ctas or pixels_cuda.CTAS_PER_SM[idct])
            before = pixels_cuda.blocks_to_rgb.launches
            products = pixels_cuda.scan_samples.launches
            got = pixels_cuda.blocks_to_rgb(*dev, idct=idct, upsample=up,
                                            **kw)
            torch.cuda.synchronize()
            assert pixels_cuda.blocks_to_rgb.launches == before + 1
            assert pixels_cuda.scan_samples.launches == products
            _k6b_equal(got, ref, idct)
        if idct == "exact":
            assert torch.equal(got.cpu(), tbatch.rgb_from_blocks_torch(
                *cpu, idct=idct, upsample=up, **kw))


@pytest.mark.parametrize("idct", ["pallas", "kron"])
def test_blocks_to_rgb_kernel_rounds_ties(cuda_device, idct):
    """DC-only blocks whose samples all lie exactly on a half (odd DC
    times a table of 4): K1's check sends every sample through its
    recheck, which rounds half to even as the route does."""
    from jpeg_decoder_tpu_torch.testing import pixel_cases

    hv = ((2, 2), (1, 1), (1, 1))
    blocks, qt, geom, kw = pixel_cases.bucket_group(
        3, hv, "ycbcr", 8, pixel_cases.odd_dims(hv, (5, 3)), (8, 4), pad=4)
    rng = np.random.default_rng(9)
    blocks[:, :, 1:] = 0
    blocks[:, :, 0] = rng.integers(-60, 60, blocks.shape[:2]) * 2 + 1
    blocks[:, -1] = 0   # the route's zero fill row
    qt[:] = 4
    dev = [torch.from_numpy(a).to(cuda_device) for a in (blocks, qt, geom)]
    got = pixels_cuda.blocks_to_rgb(*dev, idct=idct, upsample="fancy", **kw)
    ref = tbatch.rgb_from_blocks_torch(*dev, idct=idct, upsample="fancy",
                                       **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("idct", ["pallas", "exact", "kron", "fast"])
def test_blocks_to_rgb_kernel_unaligned_rows(cuda_device, idct):
    """K6b's stores where the output rows leave 16-byte boundaries: a
    1000x750 4:2:0 group (a 3,000-byte pitch), a 12-bit group (uint16
    rows) and the header geometry of odd-width frames (53 pixels: a
    159-byte pitch, ``sharded._pixels``) against the route on the card,
    and the odd frames against the CPU route under ``exact``."""
    from jpeg_decoder_tpu_torch.layout import scan_layout
    from jpeg_decoder_tpu_torch.models import decoder as tdec
    from jpeg_decoder_tpu_torch.parallel import sharded
    from jpeg_decoder_tpu_torch.testing import pixel_cases

    hv = ((2, 2), (1, 1), (1, 1))
    for dims, bucket, prec in (([(750, 1000), (733, 999)], (63, 47), 8),
                               ([(120, 200), (37, 53)], (13, 8), 12)):
        arrays = pixel_cases.bucket_group(3, hv, "ycbcr", prec, dims, bucket,
                                          pad=3)
        kw = arrays[3]
        dev = [torch.from_numpy(a).to(cuda_device) for a in arrays[:3]]
        got = pixels_cuda.blocks_to_rgb(*dev, idct=idct, upsample="fancy",
                                        **kw)
        ref = tbatch.rgb_from_blocks_torch(*dev, idct=idct,
                                           upsample="fancy", **kw)
        torch.cuda.synchronize()
        _k6b_equal(got, ref, idct)
    for k, shv in enumerate((hv, ((2, 1), (1, 1), (1, 1)), ((1, 1),) * 3)):
        hdr = parser.parse(encode(_rgb(210 + k, 37, 53), samplings=shv)[0])
        lay = scan_layout(hdr)
        rng = np.random.default_rng(k)
        n = lay.n_mcus * lay.blocks_per_mcu + 5
        blocks = torch.from_numpy(pixel_cases.random_blocks(
            rng, 2 * n, 0.2, spread=12, dc=60).reshape(2, n, 64))
        qt = torch.from_numpy(rng.integers(1, 30, (2, 3, 64))
                              .astype(np.int32))
        got = sharded._pixels(blocks.to(cuda_device), qt.to(cuda_device),
                              tdec._comp_srcs(hdr, cuda_device), hdr,
                              idct=idct, upsample="fancy")
        assert got.shape[2] == 53
        ref = sharded._pixels(blocks, qt, tdec._comp_srcs(hdr, "cpu"), hdr,
                              idct=idct, upsample="fancy")
        torch.cuda.synchronize()
        if idct == "exact":
            assert torch.equal(got.cpu(), ref)
        else:
            d = (got.cpu().to(torch.int32) - ref.to(torch.int32)).abs()
            assert int(d.max()) <= RGB_TOL
            assert float((d == 0).float().mean()) >= MIN_EQUAL


@pytest.mark.parametrize("idct", ["pallas", "exact", "kron", "fast"])
def test_batch_routes_launch_k6b_alone(cuda_device, idct):
    """Under every IDCT both batch routes launch one K6b per group and no
    K1, no K5 and no ``scan_samples`` product; their RGB is the CPU
    route's (byte for byte under ``exact``, else within RGB_TOL and
    MIN_EQUAL)."""
    from jpeg_decoder_tpu_torch.parallel import sharded

    blobs = [encode(_rgb(220, 64, 96), quality=90)[0],
             encode(_rgb(221, 48, 40), samplings=((1, 1),) * 3,
                    quality=95, restart_interval=5)[0],
             encode(_rgb(222, 37, 53), quality=75)[0]]

    def batch_decoder(dev):
        with tbatch.BatchDecoder(device=dev, idct=idct) as bd:
            return bd.decode(blobs)

    for name, run in (
            ("BatchDecoder", batch_decoder),
            ("decode_batch_sharded",
             lambda dev: sharded.decode_batch_sharded(blobs, dev,
                                                      idct=idct))):
        k1 = idct_cuda.fused_dequant_idct.launches
        k5 = idct_exact_cuda.dequant_idct_exact.launches
        k6b = pixels_cuda.blocks_to_rgb.launches
        products = pixels_cuda.scan_samples.launches
        got = run(cuda_device)
        torch.cuda.synchronize()
        groups = len({id(it.rgb_batch) for it in got if it.ok})
        assert pixels_cuda.blocks_to_rgb.launches - k6b == groups, name
        assert idct_cuda.fused_dequant_idct.launches == k1, name
        assert idct_exact_cuda.dequant_idct_exact.launches == k5, name
        assert pixels_cuda.scan_samples.launches == products, name
        ref = run("cpu")
        for g, r in zip(got, ref):
            assert g.ok and r.ok
            d = (g.rgb.cpu().to(torch.int32) - r.rgb.to(torch.int32)).abs()
            if idct == "exact":
                assert int(d.max()) == 0, name
            else:
                assert int(d.max()) <= RGB_TOL, name
                assert float((d == 0).float().mean()) >= MIN_EQUAL, name


def test_blocks_to_rgb_kernel_takes_the_header_geometry(cuda_device):
    """``sharded._pixels`` on the card (K6b with the header's geometry, no
    fill row) equals its CPU route (the scan layout's gather) byte for byte
    under ``exact``, for a 4:2:0 and a 4:2:2 frame of odd dims."""
    from jpeg_decoder_tpu_torch.layout import scan_layout
    from jpeg_decoder_tpu_torch.models import decoder as tdec
    from jpeg_decoder_tpu_torch.parallel import sharded
    from jpeg_decoder_tpu_torch.testing import pixel_cases

    for k, hv in enumerate((((2, 2), (1, 1), (1, 1)),
                            ((2, 1), (1, 1), (1, 1)))):
        hdr = parser.parse(encode(_rgb(200 + k, 37, 53), samplings=hv)[0])
        lay = scan_layout(hdr)
        rng = np.random.default_rng(k)
        n = lay.n_mcus * lay.blocks_per_mcu + 5
        blocks = torch.from_numpy(pixel_cases.random_blocks(
            rng, 2 * n, 0.2, spread=12, dc=60).reshape(2, n, 64))
        qt = torch.from_numpy(rng.integers(1, 30, (2, 3, 64))
                              .astype(np.int32))
        before = pixels_cuda.blocks_to_rgb.launches
        got = sharded._pixels(blocks.to(cuda_device), qt.to(cuda_device),
                              tdec._comp_srcs(hdr, cuda_device), hdr,
                              idct="exact", upsample="fancy")
        ref = sharded._pixels(blocks, qt, tdec._comp_srcs(hdr, "cpu"), hdr,
                              idct="exact", upsample="fancy")
        torch.cuda.synchronize()
        assert pixels_cuda.blocks_to_rgb.launches == before + 1
        assert torch.equal(got.cpu(), ref)
