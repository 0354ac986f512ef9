"""Host-plane fallback frames of the port against the JAX package.

Progressive Huffman (PIL), arithmetic SOF9 and SOF10, multi-scan,
non-interleaved 2x2 gray, restart-mismatched, 12-bit and CMYK frames, made
small from a numpy seed by tools/encoder.py and PIL.  Coefficient planes are
integer results and must equal JAX's ``decode_to_planes`` exactly under
``native``, ``python`` and ``auto``, and the port's copies of the pure-Python
decoders (``progressive.py``, ``arith.py``) and its native bindings must
equal the originals.  RGB from ``decode()`` and ``BatchDecoder`` on the CPU
(plain twins) is within +-2 of JAX's and equal on >= 99.99% of samples;
under ``idct="exact"`` it equals JAX's strict bytes.
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

from jpeg_decoder_tpu.entropy import arith as jarith  # noqa: E402
from jpeg_decoder_tpu.entropy import native as jnative  # noqa: E402
from jpeg_decoder_tpu.entropy import progressive as jprog  # noqa: E402
from jpeg_decoder_tpu.io import parser as jparser  # noqa: E402
from jpeg_decoder_tpu.models import batch as jbatch  # noqa: E402
from jpeg_decoder_tpu.models import decoder as jdecoder  # noqa: E402

from jpeg_decoder_tpu_torch import decode  # noqa: E402
from jpeg_decoder_tpu_torch.entropy import arith as tarith  # noqa: E402
from jpeg_decoder_tpu_torch.entropy import native as tnative  # noqa: E402
from jpeg_decoder_tpu_torch.entropy import progressive as tprog  # noqa: E402
from jpeg_decoder_tpu_torch.io import parser as tparser  # noqa: E402
from jpeg_decoder_tpu_torch.models import batch as tbatch  # noqa: E402
from jpeg_decoder_tpu_torch.models import decoder as tdecoder  # noqa: E402
from jpeg_decoder_tpu_torch.testing import photo  # noqa: E402

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


def _drop_last_rst(blob: bytes) -> bytes:
    """Remove the last RSTn marker: one restart segment fewer than DRI
    says (the last two intervals merge)."""
    i = max(blob.rfind(bytes([0xFF, 0xD0 + k])) for k in range(8))
    return blob[:i] + blob[i + 2:]


def _kinds():
    rgb = _rgb(7, 40, 56)
    return {
        "progressive": _pil(1, 40, 56, quality=85, progressive=True),
        "progressive_dri": _pil(2, 33, 47, quality=80, progressive=True,
                                restart_marker_blocks=3),
        "sof9": encode(rgb, arithmetic=True, restart_interval=2)[0],
        "sof9_dac": encode(_rgb(8, 24, 40), arithmetic=True,
                           dac={"dc": {0: (1, 3)}, "ac": {1: 9}})[0],
        "sof10": encode(_rgb(9, 37, 53), arithmetic=True, progressive=True,
                        restart_interval=3)[0],
        "multi_scan": encode(_rgb(10, 40, 56), scans=[(0,), (1, 2)],
                             restart_interval=4)[0],
        "gray_2x2": encode(_rgb(11, 37, 45)[..., 1], grayscale=True,
                           samplings=((2, 2),), quality=90)[0],
        "restart_mismatch": _drop_last_rst(
            encode(_rgb(12, 48, 40), samplings=((1, 1),) * 3, quality=95,
                   restart_interval=5)[0]),
        "12bit": encode(_rgb(13, 24, 32), precision=12)[0],
        "cmyk": encode(rgb, raw_planes=[rgb[..., 0].astype(float)] * 4,
                       samplings=((1, 1),) * 4, app14_transform=0)[0],
    }


KINDS = _kinds()
DECODABLE = list(KINDS)


def _assert_planes_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert isinstance(a, np.ndarray) and a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))


def _assert_rgb_close(got: torch.Tensor, ref: np.ndarray):
    assert got.device.type == "cpu" and got.numpy().dtype == ref.dtype
    assert tuple(got.shape) == ref.shape
    d = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= RGB_TOL
    assert (d == 0).mean() >= MIN_EQUAL


@pytest.mark.parametrize("entropy", ["native", "python", "auto"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_to_planes_matches_jax(kind, entropy):
    blob = KINDS[kind]
    ref = jdecoder.decode_to_planes(jparser.parse(blob), entropy=entropy)
    got = tdecoder.decode_to_planes(tparser.parse(blob), entropy=entropy)
    _assert_planes_equal(got, ref)


def test_kinds_route_as_named():
    hdr = {k: tparser.parse(b) for k, b in KINDS.items()}
    assert hdr["progressive"].progressive and not hdr["sof9"].progressive
    assert hdr["sof9"].arithmetic and hdr["sof10"].progressive
    assert tdecoder.needs_scan_loop(hdr["multi_scan"])
    assert tdecoder.needs_scan_loop(hdr["gray_2x2"])
    h = hdr["restart_mismatch"]
    assert tdecoder.segment_mismatch(h, h.scans[0])
    assert hdr["12bit"].precision == 12 and hdr["cmyk"].colorspace == "cmyk"


@pytest.mark.parametrize("kind", ["progressive", "progressive_dri"])
def test_progressive_copies_match_jax(kind):
    """The port's pure-Python progressive decoder and its native binding
    both equal JAX's pure-Python decoder."""
    ref = jprog.decode_progressive(jparser.parse(KINDS[kind]))
    hdr = tparser.parse(KINDS[kind])
    _assert_planes_equal(tprog.decode_progressive(hdr), ref)
    _assert_planes_equal(tnative.decode_progressive(hdr), ref)


@pytest.mark.parametrize("kind", ["sof9", "sof9_dac"])
def test_arith_sequential_copies_match_jax(kind):
    jh, th = jparser.parse(KINDS[kind]), tparser.parse(KINDS[kind])
    ref = jarith.decode_scan_baseline(jh, jh.scans[0])
    np.testing.assert_array_equal(
        tarith.decode_scan_baseline(th, th.scans[0]), ref)
    np.testing.assert_array_equal(tnative.decode_scan_arith(th, th.scans[0]),
                                  ref)
    np.testing.assert_array_equal(jnative.decode_scan_arith(jh, jh.scans[0]),
                                  ref)


def test_arith_progressive_copies_match_jax():
    jh, th = jparser.parse(KINDS["sof10"]), tparser.parse(KINDS["sof10"])
    ref = jarith._decode_progressive(jh)
    _assert_planes_equal(tarith._decode_progressive(th), ref)
    _assert_planes_equal(tnative.decode_progressive_arith(th), ref)


@pytest.mark.parametrize("kind", ["multi_scan", "gray_2x2"])
def test_subset_scans_match_jax(kind):
    jh, th = jparser.parse(KINDS[kind]), tparser.parse(KINDS[kind])
    for js, ts in zip(jh.scans, th.scans):
        np.testing.assert_array_equal(tnative.decode_scan_subset(th, ts),
                                      jnative.decode_scan_subset(jh, js))


def test_native_progressive_checks_buffers():
    """The bindings refuse a plane smaller than the scan writes and a band
    outside T.81's limits before calling C."""
    hdr = tparser.parse(KINDS["progressive"])
    lib = tnative._load()
    planes = tnative._empty_planes(hdr)
    small = [p[:-1] for p in planes]
    with pytest.raises(ValueError, match="plane must be"):
        tnative._run_prog_scan(lib, hdr, small, hdr.scans[0])
    wrong = [p.astype(np.int64) for p in planes]
    with pytest.raises(ValueError, match="plane must be"):
        tnative._run_prog_scan(lib, hdr, wrong, hdr.scans[0])
    ac = next(s for s in hdr.scans if s.ss > 0)
    for ss, se in ((5, 3), (1, 64)):
        bad = tparser.parse(KINDS["progressive"]).scans[hdr.scans.index(ac)]
        bad.ss, bad.se = ss, se
        with pytest.raises(tdecoder.JPEGError, match="band"):
            tnative._run_prog_scan(lib, hdr, planes, bad)


@pytest.mark.parametrize("kind", DECODABLE)
def test_decode_matches_jax(kind):
    blob = KINDS[kind]
    ref = jdecoder.decode(blob, entropy="native", idct="pallas",
                          upsample="fancy")
    got = decode(blob, entropy="native", idct="pallas", upsample="fancy",
                 device="cpu")
    _assert_rgb_close(got.rgb, ref.rgb)


@pytest.mark.parametrize("kind", ["12bit", "cmyk"])
def test_decode_pixel_stage_not_ported(kind):
    """The frames the pixel stage once refused: JAX's strict bytes under
    idct="exact" (the name predates the colour port)."""
    ref = jdecoder.decode(KINDS[kind], entropy="native", idct="exact",
                          strict=True)
    got = decode(KINDS[kind], entropy="native", idct="exact", device="cpu")
    np.testing.assert_array_equal(got.rgb.numpy(), ref.rgb)


@pytest.mark.parametrize("kind", ["progressive", "progressive_dri"])
def test_progressive_under_pallas_matches_jax(kind):
    """Under entropy="pallas" both packages decode progressive frames on
    their device lanes (ROADMAP queue 1 item 7): RGB within the K1 bound."""
    ref = jdecoder.decode(KINDS[kind], entropy="pallas", idct="pallas",
                          upsample="fancy")
    got = decode(KINDS[kind], entropy="pallas", idct="pallas",
                 upsample="fancy", device="cpu")
    _assert_rgb_close(got.rgb, ref.rgb)


@pytest.fixture(scope="module")
def mixed():
    """Every kind through both batch decoders (one pass, nibble wire)."""
    blobs = list(KINDS.values()) + [b"\xff\xd8\xff\xc0\x00\x03x"]
    ref = jbatch.BatchDecoder(entropy="native", idct="pallas",
                              upsample="fancy").decode(blobs)
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        got = bd.decode(blobs)
    return blobs, ref, got


@pytest.mark.parametrize("kind", DECODABLE)
def test_batch_fallback_matches_jax(mixed, kind):
    k = list(KINDS).index(kind)
    _, ref, got = mixed
    assert ref[k].ok and got[k].ok, got[k].error
    _assert_rgb_close(got[k].rgb, np.asarray(ref[k].rgb))


def test_batch_isolates_not_ported_and_corrupt(mixed):
    """The corrupt blob fails alone; the 12-bit and CMYK frames, once
    not ported, decode (uint16 and uint8)."""
    _, _, got = mixed
    names = list(KINDS)
    assert got[names.index("12bit")].rgb.dtype == torch.uint16
    assert got[names.index("cmyk")].rgb.dtype == torch.uint8
    assert isinstance(got[-1].error, tdecoder.JPEGError)
    assert sum(it.ok for it in got) == len(DECODABLE)


def test_batch_isolates_progressive_under_pallas():
    """BatchDecoder(entropy="pallas") decodes the progressive frame on the
    device lanes through its host-plane fallback, as JAX's does; both items
    equal JAX's."""
    blobs = [KINDS["progressive"], KINDS["sof9"]]
    ref = jbatch.BatchDecoder(entropy="pallas", idct="pallas",
                              upsample="fancy").decode(blobs)
    with tbatch.BatchDecoder(device="cpu", idct="pallas",
                             entropy="pallas") as bd:
        got = bd.decode(blobs)
    for r, g in zip(ref, got):
        assert r.ok and g.ok, g.error
        _assert_rgb_close(g.rgb, np.asarray(r.rgb))


@pytest.mark.parametrize("kind", ["progressive", "sof10", "multi_scan"])
@pytest.mark.parametrize("wire", ["sparse", "packed", "slots"])
def test_batch_fallback_rides_every_wire(kind, wire):
    blob = KINDS[kind]
    with tbatch.BatchDecoder(device="cpu", idct="pallas", wire=wire) as bd:
        got = bd.decode([blob])[0]
    ref = decode(blob, entropy="native", idct="pallas", upsample="fancy",
                 device="cpu")
    assert torch.equal(got.rgb, ref.rgb)


def test_speculative_equals_native():
    blob = encode(_rgb(20, 96, 128), quality=90)[0]      # DRI 0
    hdr = tparser.parse(blob)
    ref = tnative.decode_scan_baseline(hdr, hdr.scans[0])
    for n in (1, 3, 8):
        np.testing.assert_array_equal(
            tnative.decode_scan_speculative(hdr, hdr.scans[0], n_threads=n),
            ref)
    jh = jparser.parse(blob)
    np.testing.assert_array_equal(
        jnative.decode_scan_speculative(jh, jh.scans[0]), ref)
    kw = dict(idct="pallas", upsample="fancy", device="cpu")
    for b in (blob, KINDS["restart_mismatch"]):
        assert torch.equal(decode(b, entropy="speculative", **kw).rgb,
                           decode(b, entropy="native", **kw).rgb)
    with tbatch.BatchDecoder(device="cpu", idct="pallas",
                             entropy="speculative") as bd:
        got = bd.decode([blob, KINDS["progressive"]])
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        want = bd.decode([blob, KINDS["progressive"]])
    for a, b in zip(got, want):
        assert torch.equal(a.rgb, b.rgb)


@pytest.mark.parametrize("name", list(photo.PROGRESSIVE_FIXTURES))
def test_committed_fixtures_match_jax(name):
    """The progressive fixtures the card's smoke run decodes: the same
    planes in both packages, and a faithful decode of their source."""
    blob, src = photo.fixture(name)
    hdr = tparser.parse(blob)
    assert hdr.progressive and src.shape == (hdr.height, hdr.width, 3)
    _assert_planes_equal(
        tdecoder.decode_to_planes(hdr, entropy="native"),
        jdecoder.decode_to_planes(jparser.parse(blob), entropy="native"))
    rgb = decode(blob, entropy="native", idct="fast", upsample="fancy",
                 device="cpu").rgb.numpy().astype(np.float64)
    mse = ((rgb - src) ** 2).mean()
    assert 10 * np.log10(255.0 ** 2 / mse) >= 30.0
