"""Colour spaces, 12-bit frames and the file writers of the PyTorch port
against the JAX package.

Frames made small from a numpy seed by tools/encoder.py: CMYK (Adobe
transform 0), YCCK (transform 2), Adobe RGB (3 components, transform 0),
12-bit gray and 12-bit YCbCr.  Under ``idct="exact"`` the port's
``decode(device="cpu")`` must equal JAX's eager ``decode(idct="exact",
strict=True)`` byte for byte; under ``idct="pallas"`` (JAX: its ``kron``
twin) it must stay within +-2 with >= 99.99% of samples equal (another
summation order rounds +-1, times the colour transform's x1.402).
``BatchDecoder`` takes the same frames on all four wires.  The writers must
give the JAX writers' bytes for the same array.
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu import JPEGError as JaxJPEGError  # noqa: E402
from jpeg_decoder_tpu.io import writers as jwriters  # noqa: E402
from jpeg_decoder_tpu.models import batch as jbatch  # noqa: E402
from jpeg_decoder_tpu.models import decoder as jdecoder  # noqa: E402

from jpeg_decoder_tpu_torch import JPEGError, decode, decode_to_file  # noqa: E402
from jpeg_decoder_tpu_torch.io import parser as tparser  # noqa: E402
from jpeg_decoder_tpu_torch.io import writers  # noqa: E402
from jpeg_decoder_tpu_torch.models import batch as tbatch  # noqa: E402

RGB_TOL = 2
MIN_EQUAL = 0.9999


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 8.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _planes(rgb, n):
    return [rgb[..., k % 3].astype(np.float64) * (1.0 - 0.2 * (k // 3))
            for k in range(n)]


def _kinds():
    rgb = _rgb(11, 40, 56)
    return {
        "cmyk": encode(rgb, raw_planes=_planes(rgb, 4),
                       samplings=((1, 1),) * 4, app14_transform=0)[0],
        "cmyk_dri2": encode(rgb, raw_planes=_planes(rgb, 4),
                            samplings=((1, 1),) * 4, app14_transform=0,
                            restart_interval=2)[0],
        "ycck": encode(rgb, raw_planes=_planes(rgb, 4),
                       samplings=((2, 2), (1, 1), (1, 1), (2, 2)),
                       app14_transform=2)[0],
        "adobe_rgb": encode(rgb, raw_planes=_planes(rgb, 3),
                            samplings=((1, 1),) * 3, app14_transform=0)[0],
        "gray12": encode(rgb[..., 1], grayscale=True, samplings=((1, 1),),
                         precision=12, quality=90)[0],
        "ycbcr12": encode(rgb, precision=12, quality=90,
                          restart_interval=3)[0],
    }


KINDS = _kinds()
FOUR = ("cmyk", "cmyk_dri2", "ycck")


def test_kinds_parse_as_named():
    want = {"cmyk": "cmyk", "cmyk_dri2": "cmyk", "ycck": "ycck",
            "adobe_rgb": "rgb", "gray12": "gray", "ycbcr12": "ycbcr"}
    for kind, blob in KINDS.items():
        hdr = tparser.parse(blob)
        assert hdr.colorspace == want[kind], kind
        assert hdr.precision == (12 if kind.endswith("12") else 8)


def _close(got: np.ndarray, ref: np.ndarray):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= RGB_TOL
    assert (d == 0).mean() >= MIN_EQUAL


def _colorspaces(kind):
    return ("rgb", "cmyk") if kind in FOUR else ("rgb",)


@pytest.mark.parametrize("upsample", ["nn", "fancy"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_exact_strict_equals_jax(kind, upsample):
    for cs in _colorspaces(kind):
        ref = jdecoder.decode(KINDS[kind], idct="exact", strict=True,
                              upsample=upsample, colorspace=cs)
        got = decode(KINDS[kind], idct="exact", strict=True,
                     upsample=upsample, colorspace=cs, device="cpu")
        assert got.rgb.shape[-1] == (4 if cs == "cmyk" else 3)
        np.testing.assert_array_equal(got.rgb.numpy(), ref.rgb)


@pytest.mark.parametrize("kind", [k for k in KINDS if not k.endswith("12")])
def test_device_entropy_colour_equals_jax(kind):
    """The entropy kernel's path (its twin here; JAX's Pallas kernel in
    interpret mode) on 3- and 4-component frames: the same coefficient
    planes, and JAX's strict bytes under exact."""
    ref = jdecoder.decode(KINDS[kind], entropy="pallas", idct="exact",
                          strict=True, keep_planes=True)
    got = decode(KINDS[kind], entropy="pallas", idct="exact",
                 keep_planes=True, device="cpu")
    for a, b in zip(got.quantized_planes, ref.quantized_planes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.rgb.numpy(), ref.rgb)
    fast = decode(KINDS[kind], entropy="pallas", idct="exact", device="cpu")
    assert torch.equal(fast.rgb, got.rgb)


@pytest.mark.parametrize("kind", list(KINDS))
def test_pallas_within_tolerance_of_jax(kind):
    for cs in _colorspaces(kind):
        ref = jdecoder.decode(KINDS[kind], idct="pallas", upsample="fancy",
                              colorspace=cs)
        got = decode(KINDS[kind], idct="pallas", upsample="fancy",
                     colorspace=cs, device="cpu")
        _close(got.rgb.numpy(), ref.rgb)


@pytest.mark.parametrize("kind", ["gray12", "ycbcr12"])
def test_12bit_is_uint16(kind):
    for idct in ("exact", "pallas", "fast"):
        rgb = decode(KINDS[kind], idct=idct, device="cpu").rgb
        assert rgb.dtype == torch.uint16
        assert int(rgb.to(torch.int32).max()) <= 4095
        assert int(rgb.to(torch.int32).max()) > 255


def _with_exif_orientation(blob: bytes, orientation: int) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = orientation
    payload = exif.tobytes()
    if not payload.startswith(b"Exif"):
        payload = b"Exif\x00\x00" + payload
    seg = b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload
    return blob[:2] + seg + blob[2:]


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_12bit_orientation_respect(orientation):
    blob = _with_exif_orientation(KINDS["ycbcr12"], orientation)
    ref = jdecoder.decode(blob, idct="exact", strict=True,
                          orientation="respect")
    got = decode(blob, idct="exact", orientation="respect", device="cpu")
    assert got.header.exif_orientation == orientation
    assert got.rgb.dtype == torch.uint16 and got.rgb.is_contiguous()
    np.testing.assert_array_equal(got.rgb.numpy(), ref.rgb)


def test_cmyk_output_of_3_components_raises():
    for blob in (KINDS["adobe_rgb"], KINDS["ycbcr12"]):
        with pytest.raises(JaxJPEGError, match="4-component"):
            jdecoder.decode(blob, colorspace="cmyk")
        with pytest.raises(JPEGError, match="4-component"):
            decode(blob, colorspace="cmyk", device="cpu")


@pytest.fixture(scope="module")
def jax_batch():
    blobs = list(KINDS.values())
    return blobs, jbatch.BatchDecoder(entropy="native", idct="exact",
                                      upsample="fancy").decode(blobs)


@pytest.mark.parametrize("wire", ["nibble", "sparse", "packed", "slots"])
def test_batch_every_kind_every_wire(jax_batch, wire):
    """The JAX batch runs ``exact`` jitted, so the port's strict bytes are
    held to it within the tolerance; each item also equals the port's own
    single-image ``decode()`` exactly."""
    blobs, ref = jax_batch
    with tbatch.BatchDecoder(device="cpu", idct="exact", wire=wire) as bd:
        got = bd.decode(blobs)
    for kind, g, r, blob in zip(KINDS, got, ref, blobs):
        assert g.ok and r.ok, (kind, g.error)
        _close(g.rgb.numpy(), np.asarray(r.rgb))
        single = decode(blob, idct="exact", upsample="fancy", device="cpu")
        assert torch.equal(g.rgb, single.rgb), kind


def test_batch_groups_by_precision_and_colour():
    """A 12-bit and an 8-bit frame of the same geometry, and a CMYK and an
    Adobe RGB one, land in different groups."""
    rgb = _rgb(12, 40, 56)
    blobs = [encode(rgb, precision=12)[0], encode(rgb)[0],
             KINDS["cmyk"], KINDS["adobe_rgb"]]
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        groups = bd.group(bd.host_stage(blobs))
        got = bd.decode(blobs)
    assert sorted(len(g.idxs) for g in groups) == [1, 1, 1, 1]
    assert {(g.color, g.precision) for g in groups} == {
        ("ycbcr", 12), ("ycbcr", 8), ("cmyk", 8), ("rgb", 8)}
    assert [it.rgb.dtype for it in got] == [torch.uint16] + [torch.uint8] * 3
    assert len({id(it.rgb_batch) for it in got}) == 4


def _arrays():
    rng = np.random.default_rng(21)
    return {
        "u8_w7": rng.integers(0, 256, (5, 7, 3), dtype=np.uint8),
        "u8_w8": rng.integers(0, 256, (4, 8, 3), dtype=np.uint8),
        "u16": rng.integers(0, 4096, (6, 5, 3)).astype(np.uint16),
    }


@pytest.mark.parametrize("ext", ["bmp", "ppm", "npy", "png"])
@pytest.mark.parametrize("name", list(_arrays()))
def test_writers_equal_jax_bytes(tmp_path, name, ext):
    arr = _arrays()[name]
    mine, theirs = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
    writers.write_image(str(mine), arr)
    jwriters.write_image(str(theirs), arr)
    assert mine.read_bytes() == theirs.read_bytes()
    if ext == "bmp":
        back = writers.read_bmp(str(mine))
        want = (arr >> 4).astype(np.uint8) if arr.dtype == np.uint16 else arr
        np.testing.assert_array_equal(back, want)
    if ext == "npy":
        np.testing.assert_array_equal(np.load(mine), arr)


def test_png_without_pillow_names_the_format(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PNG output needs Pillow"):
        writers.write_image(str(tmp_path / "x.png"), _arrays()["u8_w7"])
    writers.write_image(str(tmp_path / "x.bmp"), _arrays()["u8_w7"])


@pytest.mark.parametrize("kind", ["cmyk", "ycbcr12"])
def test_decode_to_file_equals_jax(tmp_path, kind):
    for ext in ("bmp", "npy"):
        mine, theirs = tmp_path / f"m.{ext}", tmp_path / f"j.{ext}"
        res = decode_to_file(KINDS[kind], str(mine), idct="exact",
                             device="cpu")
        jdecoder.decode_to_file(KINDS[kind], str(theirs), idct="exact",
                                strict=True)
        assert mine.read_bytes() == theirs.read_bytes()
        assert res.rgb.shape[:2] == (40, 56)
