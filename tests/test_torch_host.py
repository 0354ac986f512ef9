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
    """Importing every module of the port (the single-image decoder, the
    kernels' wrappers, the LUT probes, the progressive and arithmetic
    decoders, the CLI, the writers, the utilities, the collectives, the
    mesh, multi-host and mesh-worker modules among them; not
    ``__main__``, which runs the CLI) and running the encoder (arithmetic
    paths included) loads neither jax nor the JAX package (fresh
    interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import jpeg_decoder_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('.__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "from jpeg_decoder_tpu_torch.testing.encoder import encode\n"
        "import numpy as np\n"
        "x = np.zeros((16, 16, 3), np.uint8)\n"
        "encode(x, arithmetic=True, progressive=True)\n"
        "encode(x, arithmetic=True, scans=[(0,), (1, 2)])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jpeg_decoder_tpu' or m.startswith('jpeg_decoder_tpu.')]\n"
        "assert not bad, bad\n"
        "for m in ('models.batch', 'models.decoder', 'ops.entropy_cuda',\n"
        "          'probes.lut_probe', 'entropy.progressive',\n"
        "          'entropy.arith', 'testing.encoder', 'testing.photo',\n"
        "          'cli', 'utils.config', 'utils.logging',\n"
        "          'utils.profiling', 'io.writers', 'ops.idct_exact_cuda',\n"
        "          'ops.entropy_emit_cuda', 'ops.entropy_spec',\n"
        "          'parallel.sharded', 'ops.entropy_prog',\n"
        "          'ops.entropy_prog_cuda', 'parallel.mesh',\n"
        "          'parallel.multihost', 'testing.mesh_worker',\n"
        "          'ops.emit_carry_cuda', 'collectives'):\n"
        "    assert 'jpeg_decoder_tpu_torch.' + m in sys.modules, m\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


PORT = os.path.join(REPO, "jpeg_decoder_tpu_torch")
JAX_PKG = os.path.join(REPO, "jpeg_decoder_tpu")


def test_native_source_copy_is_byte_identical():
    """The port builds its own copy of the C++ entropy decoder; it must stay
    the JAX package's file, byte for byte."""
    with open(os.path.join(PORT, "csrc", "jpeg_entropy.cpp"), "rb") as f:
        got = f.read()
    with open(os.path.join(JAX_PKG, "entropy", "native_src",
                           "jpeg_entropy.cpp"), "rb") as f:
        ref = f.read()
    assert got == ref
    assert os.path.dirname(tnative._SRC) == os.path.join(PORT, "csrc")


def _port_sources():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh", ".cpp", ".h")):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


# A "file.py:line" citation of the TPU kernel a port kernel replaces.
_CITATION = r"jpeg_decoder_tpu/[\w/]+\.py:\d+"


def test_port_never_opens_jax_package_paths():
    """No source of the port, nor chip_smoke.py, names a path under
    jpeg_decoder_tpu/ in code (only file:line citations in comments and the
    kernel table), and importing every module, building the native library
    and locating every CUDA source opens nothing there (fresh interpreter
    with open/os.open/subprocess recorded)."""
    import ast
    import re

    for path in _port_sources():
        if path.endswith(".py"):
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read())
            docs = {id(n.value) for n in ast.walk(tree)
                    if isinstance(n, ast.Expr)
                    and isinstance(n.value, ast.Constant)}
            for n in ast.walk(tree):
                if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                        and id(n) not in docs):
                    body = re.sub(_CITATION, "", n.value)
                    assert body != "jpeg_decoder_tpu", (path, n.lineno)
                    assert not re.search(r"jpeg_decoder_tpu[/\\]", body), (
                        path, n.lineno, n.value)
        else:
            with open(path, encoding="utf-8") as f:
                for n, line in enumerate(f, 1):
                    code = line.split("//")[0]
                    assert not re.search(r"jpeg_decoder_tpu(?!_torch)\b",
                                         code), (path, n, line)
    code = (
        "import builtins, importlib, io, os, pkgutil, subprocess, sys\n"
        "seen = []\n"
        "def wrap(fn):\n"
        "    def inner(file, *a, **k):\n"
        "        seen.append(os.fspath(file) if isinstance(file, (str, bytes,"
        " os.PathLike)) else str(file))\n"
        "        return fn(file, *a, **k)\n"
        "    return inner\n"
        "builtins.open = io.open = wrap(builtins.open)\n"
        "os.open = wrap(os.open)\n"
        "real_popen = subprocess.Popen.__init__\n"
        "def popen(self, args, *a, **k):\n"
        "    seen.extend(map(str, args if isinstance(args, (list, tuple))"
        " else [args]))\n"
        "    return real_popen(self, args, *a, **k)\n"
        "subprocess.Popen.__init__ = popen\n"
        "import jpeg_decoder_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('.__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "from jpeg_decoder_tpu_torch.entropy import native\n"
        "from jpeg_decoder_tpu_torch.ops import entropy_cuda, idct_cuda,"
        " idct_exact_cuda, entropy_emit_cuda, emit_carry_cuda\n"
        "from jpeg_decoder_tpu_torch.probes import lut_probe\n"
        "native._load()\n"
        "for lib in (entropy_cuda.LIB, idct_cuda.LIB, idct_exact_cuda.LIB,"
        " lut_probe.LIB, entropy_emit_cuda.LIB, emit_carry_cuda.LIB):\n"
        "    lib.path()\n"
        "bad = [s for s in seen if os.path.abspath(s).startswith(\n"
        f"    {JAX_PKG + os.sep!r})]\n"
        "assert not bad, bad\n"
        "assert any(s.endswith(os.path.join('csrc', 'jpeg_entropy.cpp'))"
        " for s in seen), seen\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


# (keyword arguments, (h, w), grayscale) — the encoder's other paths:
# arithmetic SOF9 (with DAC conditioning), progressive arithmetic SOF10,
# multi-scan and non-interleaved scripts, grayscale, 12-bit, CMYK/YCCK.
ENCODER_EXTRA = [
    (dict(arithmetic=True), (37, 53), False),
    (dict(arithmetic=True, restart_interval=3, quality=75,
          dac={"dc": {0: (1, 3)}, "ac": {1: 9}}), (40, 48), False),
    (dict(arithmetic=True, progressive=True), (33, 41), False),
    (dict(arithmetic=True, progressive=True, restart_interval=2,
          samplings=((1, 1),) * 3), (24, 40), False),
    (dict(scans=[(0,), (1, 2)], restart_interval=4), (40, 56), False),
    (dict(scans=[(0,), (1,), (2,)], samplings=((2, 1), (1, 1), (1, 1))),
     (37, 45), False),
    (dict(arithmetic=True, scans=[(0,), (1, 2)]), (29, 35), False),
    (dict(grayscale=True, samplings=((1, 1),), quality=90), (24, 40), True),
    (dict(grayscale=True, samplings=((2, 2),), restart_interval=2),
     (37, 45), True),
    (dict(precision=12), (24, 32), False),
    (dict(samplings=((1, 1),) * 4, app14_transform=2, zero_based_ids=True),
     (24, 24), "cmyk"),
]


@pytest.mark.parametrize("case", range(len(ENCODER_CASES)
                                       + len(ENCODER_EXTRA)))
def test_encoder_bytes_identical(case):
    if case < len(ENCODER_CASES):
        samp, q, ri, (h, w) = ENCODER_CASES[case]
        rgb = _rgb(case, h, w)
        kw = dict(samplings=samp, quality=q, restart_interval=ri)
    else:
        kw, (h, w), kind = ENCODER_EXTRA[case - len(ENCODER_CASES)]
        rgb = _rgb(case, h, w)
        if kind == "cmyk":
            kw = dict(kw, raw_planes=[rgb[..., k % 3].astype(float)
                                      for k in range(4)])
        elif kind:
            rgb = rgb[..., 0]
    ref, ref_planes = ref_encode(rgb, **kw)
    got, planes = tencoder.encode(rgb, **kw)
    assert got == ref
    assert len(planes) == len(ref_planes)
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


# Restart layouts of the vectorised scan_prep.prepare_scan: DRI 1 (one MCU
# per segment), a last segment shorter than the rest (a 5x7-MCU frame at
# DRI 4), a segment of 0 bytes (offsets edited after parsing) and DRI 0.
PREP_LAYOUTS = {"dri1": (1, (40, 56), None), "short_last": (4, (40, 56), None),
                "empty_segment": (2, (48, 64), 3), "dri0": (0, (40, 56), None)}


@pytest.mark.parametrize("name", list(PREP_LAYOUTS))
def test_prepare_scan_matches_jax(name):
    from jpeg_decoder_tpu.ops import scan_prep as jprep

    from jpeg_decoder_tpu_torch.ops import scan_prep as tprep

    ri, (h, w), empty = PREP_LAYOUTS[name]
    blob = ref_encode(_rgb(20 + ri, h, w), samplings=((1, 1),) * 3,
                      quality=80, restart_interval=ri)[0]
    jhdr, thdr = jparser.parse(blob), tparser.parse(blob)
    if empty is not None:
        for hdr in (jhdr, thdr):
            offs = hdr.scans[0].seg_offsets.copy()
            offs[empty + 1] = offs[empty]       # segment `empty` is 0 bytes
            hdr.scans[0].seg_offsets = offs
    lens = np.diff(thdr.scans[0].seg_offsets)
    if name == "short_last":
        assert lens[-1] < lens[:-1].min()
    if empty is not None:
        assert lens[empty] == 0
    ref = jprep.prepare_scan(jhdr, jhdr.scans[0])
    got = tprep.prepare_scan(thdr, thdr.scans[0])
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2:4] == ref[2:4]
