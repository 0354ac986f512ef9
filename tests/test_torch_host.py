"""Host modules of the PyTorch port against the JAX package's, exactly.

The port (jpeg_decoder_tpu_torch) carries numpy-only copies of the host
modules, because importing anything under jpeg_decoder_tpu loads jax.
These tests hold each copy to its original on the same inputs: the parser's
headers field by field, scan layouts, the native nibble-wire emitter, the
routing predicates, the wire helpers, the Huffman LUTs and the synthetic
encoder's bytes.
"""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode as ref_encode  # noqa: E402

from jpeg_decoder_tpu import huffman as jhuff  # noqa: E402
from jpeg_decoder_tpu import layout as jlayout  # noqa: E402
from jpeg_decoder_tpu.entropy import native as jnative  # noqa: E402
from jpeg_decoder_tpu.io import parser as jparser  # noqa: E402
from jpeg_decoder_tpu.models import batch as jbatch  # noqa: E402
from jpeg_decoder_tpu.models import decoder as jdecoder  # noqa: E402

from jpeg_decoder_tpu_torch import huffman as thuff  # noqa: E402
from jpeg_decoder_tpu_torch import layout as tlayout  # noqa: E402
from jpeg_decoder_tpu_torch.entropy import native as tnative  # noqa: E402
from jpeg_decoder_tpu_torch.io import parser as tparser  # noqa: E402
from jpeg_decoder_tpu_torch.models import batch as tbatch  # noqa: E402
from jpeg_decoder_tpu_torch.models import routing as trouting  # noqa: E402
from jpeg_decoder_tpu_torch.testing import encoder as tencoder  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rgb(seed, h, w):
    """Smooth gradient plus Gaussian noise, (h, w, 3) uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    noise = rng.normal(0.0, 6.0, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


# (samplings, quality, restart_interval, (h, w)) — baseline-Huffman cases.
ENCODER_CASES = [
    (((2, 2), (1, 1), (1, 1)), 90, 0, (64, 96)),
    (((1, 1), (1, 1), (1, 1)), 95, 5, (48, 40)),
    (((2, 2), (1, 1), (1, 1)), 75, 2, (37, 53)),
    (((2, 1), (1, 1), (1, 1)), 85, 3, (33, 70)),
    (((1, 2), (1, 1), (1, 1)), 45, 1, (41, 29)),
    (((2, 2), (1, 1), (1, 1)), 100, 4, (24, 40)),
    (((1, 1), (1, 1), (1, 1)), 10, 0, (16, 24)),
]


def _blobs():
    """Encoder cases, a PIL progressive stream and a PIL restart stream."""
    out = []
    for k, (samp, q, ri, (h, w)) in enumerate(ENCODER_CASES):
        out.append(ref_encode(_rgb(k, h, w), samplings=samp, quality=q,
                              restart_interval=ri)[0])
    buf = io.BytesIO()
    Image.fromarray(_rgb(7, 40, 56)).save(buf, "JPEG", quality=85,
                                          progressive=True)
    out.append(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(_rgb(8, 48, 64)).save(buf, "JPEG", quality=80,
                                          restart_marker_blocks=2)
    out.append(buf.getvalue())
    return out


BLOBS = _blobs()
PROGRESSIVE = len(ENCODER_CASES)        # index of the PIL progressive blob


def test_import_leaves_out_jax():
    """Importing every module of the port loads neither jax nor the JAX
    package (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import jpeg_decoder_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jpeg_decoder_tpu' or m.startswith('jpeg_decoder_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'jpeg_decoder_tpu_torch.models.batch' in sys.modules\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("case", range(len(ENCODER_CASES)))
def test_encoder_bytes_identical(case):
    samp, q, ri, (h, w) = ENCODER_CASES[case]
    rgb = _rgb(case, h, w)
    ref, ref_planes = ref_encode(rgb, samplings=samp, quality=q,
                                 restart_interval=ri)
    got, planes = tencoder.encode(rgb, samplings=samp, quality=q,
                                  restart_interval=ri)
    assert got == ref
    for a, b in zip(planes, ref_planes):
        np.testing.assert_array_equal(a, b)


def _asdict(x):
    return dataclasses.asdict(x)


@pytest.mark.parametrize("k", range(len(BLOBS)))
def test_parse_matches_jax(k):
    ref = jparser.parse(BLOBS[k])
    got = tparser.parse(BLOBS[k])
    for name in ("width", "height", "precision", "progressive",
                 "arithmetic", "restart_interval", "zero_based_ids",
                 "adobe_transform", "saw_jfif", "exif_orientation",
                 "icc_profile", "colorspace", "mcus_x", "mcus_y",
                 "blocks_per_mcu"):
        assert getattr(got, name) == getattr(ref, name), name
    assert [_asdict(c) for c in got.components] == [
        _asdict(c) for c in ref.components]
    assert sorted(got.quant_tables) == sorted(ref.quant_tables)
    for tid, qt in ref.quant_tables.items():
        np.testing.assert_array_equal(got.quant_tables[tid].values,
                                      qt.values)
    assert len(got.scans) == len(ref.scans)
    for gs, rs in zip(got.scans, ref.scans):
        for name in ("comp_indices", "dc_table_ids", "ac_table_ids", "ss",
                     "se", "ah", "al", "restart_interval"):
            assert getattr(gs, name) == getattr(rs, name), name
        np.testing.assert_array_equal(gs.data, rs.data)
        np.testing.assert_array_equal(gs.seg_offsets, rs.seg_offsets)
        assert (gs.data_padded is None) == (rs.data_padded is None)
        for specs in ("dc_specs", "ac_specs"):
            g, r = getattr(gs, specs), getattr(rs, specs)
            assert sorted(g) == sorted(r)
            for tid in r:
                np.testing.assert_array_equal(g[tid].counts, r[tid].counts)
                np.testing.assert_array_equal(g[tid].symbols,
                                              r[tid].symbols)


@pytest.mark.parametrize("k", range(len(BLOBS)))
def test_unstuff_native_numpy_and_jax_agree(k):
    data = np.frombuffer(BLOBS[k], np.uint8)
    sos = int(np.flatnonzero((data[:-1] == 0xFF) & (data[1:] == 0xDA))[0])
    start = sos + 2 + (int(data[sos + 2]) << 8 | int(data[sos + 3]))
    ref = jparser.unstuff_entropy_numpy(data, start)
    for got in (tnative.unstuff(data, start),
                tparser.unstuff_entropy_numpy(data, start)):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2] == ref[2]


@pytest.mark.parametrize("k", range(len(ENCODER_CASES)))
def test_scan_layout_matches_jax(k):
    ref_hdr = jparser.parse(BLOBS[k])
    got_hdr = tparser.parse(BLOBS[k])
    ref = jlayout.scan_layout(ref_hdr)
    got = tlayout.scan_layout(got_hdr)
    np.testing.assert_array_equal(got.comp_of_block, ref.comp_of_block)
    np.testing.assert_array_equal(got.dest_in_comp, ref.dest_in_comp)
    assert got.comp_shapes == ref.comp_shapes
    assert (got.blocks_per_mcu, got.n_mcus) == (ref.blocks_per_mcu,
                                                ref.n_mcus)
    for a, b in zip(got.comp_src, ref.comp_src):
        np.testing.assert_array_equal(a, b)
    for ci in range(len(ref_hdr.components)):
        assert (tlayout.comp_dims_unpadded(got_hdr, ci)
                == jlayout.comp_dims_unpadded(ref_hdr, ci))


@pytest.mark.parametrize("n_threads", [1, 2])
@pytest.mark.parametrize("k", [k for k in range(len(BLOBS))
                               if k != PROGRESSIVE])
def test_decode_scan_nibble_matches_jax(k, n_threads):
    ref_hdr = jparser.parse(BLOBS[k])
    got_hdr = tparser.parse(BLOBS[k])
    ref = jnative.decode_scan_nibble(ref_hdr, ref_hdr.scans[0],
                                     n_threads=n_threads)
    got = tnative.decode_scan_nibble(got_hdr, got_hdr.scans[0],
                                     n_threads=n_threads)
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _routing_headers():
    """Headers that exercise every routing predicate both ways."""
    blobs = list(BLOBS)
    rgb = _rgb(11, 40, 48)
    blobs.append(ref_encode(rgb, scans=[(0,), (1, 2)])[0])   # multi-scan
    blobs.append(ref_encode(rgb[..., 0], grayscale=True,
                            samplings=((2, 2),))[0])     # 1-comp, h*v > 1
    blobs.append(ref_encode(rgb[..., 0], grayscale=True,
                            samplings=((1, 1),))[0])
    return blobs


@pytest.mark.parametrize("blob", _routing_headers())
def test_routing_matches_jax(blob):
    ref = jparser.parse(blob)
    got = tparser.parse(blob)
    assert trouting.needs_scan_loop(got) == jdecoder.needs_scan_loop(ref)
    assert (trouting.segment_mismatch(got, got.scans[0])
            == jdecoder.segment_mismatch(ref, ref.scans[0]))


def test_routing_flags_restart_mismatch():
    """A stream whose RST count disagrees with DRI is flagged by both."""
    blob = BLOBS[1]                               # DRI 5
    i = blob.index(b"\xff\xdd\x00\x04")
    bad = blob[:i + 4] + b"\x00\x07" + blob[i + 6:]   # DRI 5 -> 7
    ref, got = jparser.parse(bad), tparser.parse(bad)
    assert jdecoder.segment_mismatch(ref, ref.scans[0])
    assert trouting.segment_mismatch(got, got.scans[0])


@pytest.mark.parametrize("density", [0.0, 0.01, 0.2, 0.9])
def test_wire_helpers_match_jax(density):
    rng = np.random.default_rng(5)
    blocks = np.zeros((97, 64), np.int32)
    mask = rng.random(blocks.shape) < density
    blocks[mask] = rng.integers(-400, 400, mask.sum())
    ref_pack = jbatch.pack_blocks(blocks)
    got_pack = tbatch.pack_blocks(blocks)
    for a, b in zip(got_pack, ref_pack):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tbatch.nibbleize_ac(ref_pack[1]),
                    jbatch.nibbleize_ac(ref_pack[1])):
        np.testing.assert_array_equal(a, b)
    for n in (1, 200, 257, 5000, 70000):
        assert tbatch._bucket(n) == jbatch._bucket(n)
        assert tbatch._bucket(n, 64) == jbatch._bucket(n, 64)
        assert tbatch._bucket_pow2(n) == jbatch._bucket_pow2(n)


@pytest.mark.parametrize("name", ["STD_DC_LUMA", "STD_DC_CHROMA",
                                  "STD_AC_LUMA", "STD_AC_CHROMA"])
def test_huffman_luts_match_jax(name):
    got, ref = getattr(thuff, name), getattr(jhuff, name)
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_array_equal(got.symbols, ref.symbols)
    for a, b in zip(thuff.canonical_codes(got), jhuff.canonical_codes(ref)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(thuff.build_lut(got), jhuff.build_lut(ref))
    np.testing.assert_array_equal(thuff.build_ac_lut32(got),
                                  jhuff.build_ac_lut32(ref))
    np.testing.assert_array_equal(tnative._lut16(got), jnative._lut16(ref))
    np.testing.assert_array_equal(tnative._lut32ac(got),
                                  jnative._lut32ac(ref))
