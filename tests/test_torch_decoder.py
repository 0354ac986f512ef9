"""Single-image decode() of the PyTorch port against the JAX package.

The same blobs, made from a numpy seed by tools/encoder.py and PIL, go
through JAX's ``decode()`` (on the CPU: the Pallas entropy kernel in
interpret mode, ``idct="pallas"`` as its ``kron`` twin) and the port's
``decode(device="cpu")`` (the plain twins of both kernels).  Tolerance: RGB
max |diff| <= 2 with >= 99.99% of samples equal — the IDCT may round +-1
differently (another summation order), and the colour transform's x1.402
can turn that into 2.  Coefficient planes are integer results and must be
equal.  The card runs the same calls in tests/test_torch_cuda.py.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu import JPEGError as JaxJPEGError  # noqa: E402
from jpeg_decoder_tpu.models import decoder as jdecoder  # noqa: E402

from jpeg_decoder_tpu_torch import JPEGError, decode  # noqa: E402
from jpeg_decoder_tpu_torch.models import batch as tbatch  # noqa: E402
from jpeg_decoder_tpu_torch.models import decoder as tdecoder  # noqa: E402

RGB_TOL = 2          # +-1 IDCT rounding times the x1.402 colour gain
MIN_EQUAL = 0.9999   # share of RGB samples that must match exactly


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 6.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _pil(seed, h, w, **kw):
    buf = io.BytesIO()
    Image.fromarray(_rgb(seed, h, w)).save(buf, "JPEG", **kw)
    return buf.getvalue()


BLOBS = {
    "420_dri2_odd": encode(_rgb(0, 37, 53), quality=75,
                           restart_interval=2)[0],
    "444_dri5": encode(_rgb(1, 40, 48), samplings=((1, 1),) * 3,
                       quality=95, restart_interval=5)[0],
    "gray_dri0": encode(_rgb(2, 24, 40)[..., 0], grayscale=True,
                        samplings=((1, 1),), quality=85)[0],
    "pil_422_dri1": _pil(3, 33, 30, quality=80, subsampling=1,
                         restart_marker_blocks=1),
}


def _assert_rgb_close(got: torch.Tensor, ref: np.ndarray):
    assert got.device.type == "cpu" and got.numpy().dtype == ref.dtype
    assert tuple(got.shape) == ref.shape
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= RGB_TOL
    assert (d == 0).mean() >= MIN_EQUAL


@pytest.mark.parametrize("upsample", ["fancy", "nn"])
@pytest.mark.parametrize("idct", ["pallas", "kron", "fast"])
@pytest.mark.parametrize("entropy", ["pallas", "python", "native", "auto"])
def test_decode_matches_jax(entropy, idct, upsample):
    for name, blob in BLOBS.items():
        ref = jdecoder.decode(blob, entropy=entropy, idct=idct,
                              upsample=upsample)
        got = decode(blob, entropy=entropy, idct=idct, upsample=upsample,
                     device="cpu")
        assert isinstance(got, tdecoder.DecodeResult), name
        _assert_rgb_close(got.rgb, ref.rgb)


@pytest.mark.parametrize("entropy", ["pallas", "native"])
@pytest.mark.parametrize("name", list(BLOBS))
def test_keep_planes_equal_jax(name, entropy):
    blob = BLOBS[name]
    ref = jdecoder.decode(blob, entropy=entropy, idct="kron",
                          upsample="fancy", keep_planes=True)
    got = decode(blob, entropy=entropy, idct="kron", upsample="fancy",
                 keep_planes=True, device="cpu")
    for kind in ("quantized_planes", "dequantized_planes"):
        g, r = getattr(got, kind), getattr(ref, kind)
        assert len(g) == len(r)
        for a, b in zip(g, r):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    _assert_rgb_close(got.rgb, ref.rgb)


def _drop_second_rst(blob: bytes) -> bytes:
    """Remove the RST1 marker: one restart segment fewer than DRI says."""
    i = blob.index(b"\xff\xd1")
    return blob[:i] + blob[i + 2:]


@pytest.mark.parametrize("entropy", ["pallas", "native", "python"])
def test_restart_mismatch_matches_jax_resilient(entropy):
    """A stream with one RST removed decodes best-effort, as JAX's."""
    blob = _drop_second_rst(BLOBS["444_dri5"])
    ref = jdecoder.decode(blob, entropy=entropy, idct="kron",
                          upsample="fancy", keep_planes=True)
    got = decode(blob, entropy=entropy, idct="kron", upsample="fancy",
                 keep_planes=True, device="cpu")
    for a, b in zip(got.quantized_planes, ref.quantized_planes):
        np.testing.assert_array_equal(a, b)
    _assert_rgb_close(got.rgb, ref.rgb)
    fast = decode(blob, entropy=entropy, idct="kron", upsample="fancy",
                  device="cpu")
    assert torch.equal(fast.rgb, got.rgb)


def _corrupt_first_segment(blob: bytes) -> bytes:
    """Overwrite 8 bytes inside the first restart segment with stuffed
    0xFF bytes: 64 one bits, a window no standard code takes."""
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
    assert blob.index(b"\xff\xd0", start) - start > 24
    return blob[:start + 8] + b"\xff\x00" * 8 + blob[start + 24:]


@pytest.mark.parametrize("entropy", ["pallas", "python", "native"])
def test_corrupt_stream_raises_in_both(entropy):
    blob = _corrupt_first_segment(
        encode(_rgb(4, 64, 64), quality=90, restart_interval=2)[0])
    with pytest.raises(JaxJPEGError):
        jdecoder.decode(blob, entropy=entropy, idct="kron")
    with pytest.raises(JPEGError):
        decode(blob, entropy=entropy, idct="kron", device="cpu")


def _not_ported_blobs():
    rgb = _rgb(5, 24, 32)
    return {
        "progressive": _pil(5, 24, 32, quality=85, progressive=True),
        "arithmetic": encode(rgb, arithmetic=True)[0],
        "12-bit": encode(rgb, precision=12)[0],
        "multi-scan": encode(rgb, scans=[(0,), (1, 2)])[0],
        "cmyk": encode(rgb, raw_planes=[rgb[..., 0].astype(float)] * 4,
                       samplings=((1, 1),) * 4, app14_transform=0)[0],
    }


#: Backends under which both packages raise JPEGError: JAX's Pallas kernel
#: flags 12-bit size categories past the 8-bit limits, and the port's K2
#: refuses 12-bit frames.
BOTH_RAISE = {"12-bit": ("pallas",)}


@pytest.mark.parametrize("kind", list(_not_ported_blobs()))
def test_frames_not_ported_raise(kind):
    """Each frame kind either raises JPEGError in both packages or decodes
    within the slice's tolerance of JAX (the name predates the host-plane
    fallback, the colour port and the progressive lanes, which progressive
    frames under pallas now take in both packages)."""
    blob = _not_ported_blobs()[kind]
    for entropy in ("pallas", "native"):
        if entropy in BOTH_RAISE.get(kind, ()):
            with pytest.raises(JaxJPEGError):
                jdecoder.decode(blob, entropy=entropy, idct="pallas")
            with pytest.raises(JPEGError):
                decode(blob, entropy=entropy, idct="pallas", device="cpu")
            continue
        ref = jdecoder.decode(blob, entropy=entropy, idct="pallas",
                              upsample="fancy")
        got = decode(blob, entropy=entropy, idct="pallas", upsample="fancy",
                     device="cpu")
        _assert_rgb_close(got.rgb, ref.rgb)


@pytest.mark.parametrize("kw", [
    {}, {"idct": "exact"}, {"idct": "pallas", "strict": True},
    {"idct": "pallas", "colorspace": "cmyk"},
    {"idct": "pallas", "entropy": "jax"},
    {"idct": "pallas", "entropy": "hybrid"},
    {"idct": "pallas", "entropy": "speculative"},
])
def test_options_not_ported_raise(kw):
    """Every option of the JAX decode() is ported (the name predates the
    jax and hybrid backends).  JAX's default idct="exact" (with or without
    strict) gives JAX's strict bytes; strict mode with another IDCT stays
    within the tolerance; CMYK output of a 3-component frame raises
    JPEGError in both packages; the speculative backend equals native; the
    jax and hybrid backends give JAX's planes and RGB within the
    tolerance."""
    blob = BLOBS["444_dri5"]
    if kw.get("entropy") in ("jax", "hybrid"):
        ref = jdecoder.decode(blob, keep_planes=True, **kw)
        got = decode(blob, device="cpu", keep_planes=True, **kw)
        for a, b in zip(got.quantized_planes, ref.quantized_planes):
            np.testing.assert_array_equal(a, b)
        _assert_rgb_close(got.rgb, ref.rgb)
        return
    if kw.get("entropy") == "speculative":
        got = decode(blob, device="cpu", **kw)
        ref = decode(blob, device="cpu", **dict(kw, entropy="native"))
        assert torch.equal(got.rgb, ref.rgb)
        return
    if kw.get("colorspace") == "cmyk":
        with pytest.raises(JaxJPEGError, match="4-component"):
            jdecoder.decode(blob, **kw)
        with pytest.raises(JPEGError, match="4-component"):
            decode(blob, device="cpu", **kw)
        return
    ref = jdecoder.decode(blob, **dict(kw, strict=True))
    got = decode(blob, device="cpu", **kw)
    if kw.get("idct", "exact") == "exact":
        np.testing.assert_array_equal(got.rgb.numpy(), ref.rgb)
    else:
        _assert_rgb_close(got.rgb, ref.rgb)


@pytest.mark.parametrize("orientation", [None, 1, 2, 3, 4, 5, 6, 7, 8])
def test_apply_exif_orientation_matches_jax(orientation):
    arr = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    ref = jdecoder.apply_exif_orientation(arr, orientation)
    got = tdecoder.apply_exif_orientation(torch.from_numpy(arr), orientation)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_orientation_respect_matches_jax():
    exif = Image.Exif()
    exif[0x0112] = 6
    blob = _pil(6, 24, 40, quality=90, exif=exif.tobytes())
    ref = jdecoder.decode(blob, entropy="native", idct="kron",
                          orientation="respect")
    got = decode(blob, entropy="native", idct="kron", orientation="respect",
                 device="cpu")
    assert got.header.exif_orientation == 6 and got.rgb.shape == (40, 24, 3)
    assert got.rgb.is_contiguous()
    _assert_rgb_close(got.rgb, ref.rgb)


def test_decode_reads_a_path(tmp_path):
    path = tmp_path / "img.jpg"
    path.write_bytes(BLOBS["gray_dri0"])
    got = decode(str(path), entropy="native", idct="fast", device="cpu")
    ref = decode(BLOBS["gray_dri0"], entropy="native", idct="fast",
                 device="cpu")
    assert torch.equal(got.rgb, ref.rgb)


def test_entry_points_need_a_card_by_default(monkeypatch):
    """With no card, decode_batch and decode() raise by default and name the
    CPU option; they never fall back to the CPU (BatchDecoder() itself:
    tests/test_torch_batch.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = BLOBS["444_dri5"]
    for call in (lambda: tbatch.decode_batch([blob]),
                 lambda: decode(blob, entropy="pallas", idct="pallas"),
                 lambda: decode(blob, idct="fast", device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
