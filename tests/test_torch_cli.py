"""The port's command-line tool against the JAX package's, in-process.

``jpeg_decoder_tpu_torch.cli.main`` and ``jpeg_decoder_tpu.cli.main`` run on
the same inputs in temporary directories (both on the CPU).  Under
``--idct exact --strict`` the written files must be byte-identical; under
``--idct pallas`` (the JAX CLI's ``kron`` twin on the CPU) within +-2 with
>= 99.99% of samples equal, the slice's tolerance.  Also: ``--resume``
skips, ``--dump-coeffs`` writes the dequantised planes, a non-JPEG input
gets its own error line and rc 1 while the others are written, and
``--batch --device-entropy`` (the device-entropy batch route) writes the
JAX CLI's files, a corrupt stream failing alone; without ``--batch`` the
flag is ignored, as in the JAX CLI.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

import jpeg_decoder_tpu  # noqa: E402
from jpeg_decoder_tpu import cli as jcli  # noqa: E402

import jpeg_decoder_tpu_torch  # noqa: E402
from jpeg_decoder_tpu_torch import cli, decode  # noqa: E402
from jpeg_decoder_tpu_torch.io import writers  # noqa: E402

RGB_TOL = 2
MIN_EQUAL = 0.9999


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 8.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _inputs(d):
    """Three frames (4:2:0, CMYK, 12-bit) and one non-JPEG file in ``d``;
    returns their paths, the bad one third."""
    rgb = _rgb(31, 40, 56)
    blobs = {
        "a420.jpg": encode(rgb, quality=90, restart_interval=2)[0],
        "cmyk.jpg": encode(rgb, raw_planes=[rgb[..., k % 3].astype(float)
                                            for k in range(4)],
                           samplings=((1, 1),) * 4, app14_transform=0)[0],
        "bad.jpg": b"this is not a JPEG file",
        "b12.jpg": encode(rgb, precision=12, quality=90)[0],
    }
    os.makedirs(d, exist_ok=True)
    paths = []
    for name, blob in blobs.items():
        p = os.path.join(d, name)
        with open(p, "wb") as f:
            f.write(blob)
        paths.append(p)
    return paths


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("fmt", ["bmp", "ppm", "png"])
def test_single_strict_equals_jax(tmp_path, capsys, fmt):
    paths = _inputs(str(tmp_path / "in"))
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    opts = ["--idct", "exact", "--strict", "--format", fmt, "--platform",
            "cpu", "--upsample", "fancy"]
    rc, out, err = _run(cli.main, [*opts, "-o", mine, *paths], capsys)
    rc_j, _, err_j = _run(jcli.main, [*opts, "-o", theirs, *paths], capsys)
    assert (rc, rc_j) == (1, 1)
    assert "bad.jpg: ERROR: not a JPEG file (missing SOI)" in err
    assert err.count("ERROR") == 1 and err_j.count("ERROR") == 1
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs)) == sorted(
        f"{n}.{fmt}" for n in ("a420", "cmyk", "b12"))
    for name in os.listdir(mine):
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    assert out.count(" -> ") == 3


def _read(path):
    if path.endswith(".bmp"):
        return writers.read_bmp(path)
    with open(path, "rb") as f:
        magic, dims, _, data = f.read().split(b"\n", 3)
    w, h = map(int, dims.split())
    return np.frombuffer(data, np.uint8).reshape(h, w, 3)


def test_batch_pallas_within_tolerance_of_jax(tmp_path, capsys):
    paths = _inputs(str(tmp_path / "in"))
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    opts = ["--batch", "--idct", "pallas", "--format", "ppm", "--platform",
            "cpu", "--upsample", "fancy", "--entropy", "native"]
    rc, _, err = _run(cli.main, [*opts, "-o", mine, *paths], capsys)
    rc_j, _, _ = _run(jcli.main, [*opts, "-o", theirs, *paths], capsys)
    assert (rc, rc_j) == (1, 1) and "bad.jpg: ERROR" in err
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    for name in os.listdir(mine):
        a = _read(os.path.join(mine, name)).astype(np.int32)
        b = _read(os.path.join(theirs, name)).astype(np.int32)
        d = np.abs(a - b)
        assert d.max() <= RGB_TOL and (d == 0).mean() >= MIN_EQUAL, name


@pytest.mark.parametrize("batch", [False, True])
def test_resume_skips_written_outputs(tmp_path, capsys, batch):
    paths = _inputs(str(tmp_path / "in"))
    good = [p for p in paths if not p.endswith("bad.jpg")]
    outdir = str(tmp_path / "out")
    opts = ["--platform", "cpu", "--format", "bmp", "-o", outdir,
            *(["--batch"] if batch else [])]
    assert _run(cli.main, [*opts, *good], capsys)[0] == 0
    stamps = {n: os.path.getmtime(os.path.join(outdir, n))
              for n in os.listdir(outdir)}
    rc, out, _ = _run(cli.main, [*opts, "--resume", *good], capsys)
    assert rc == 0 and out.count("exists, skipped") == len(good)
    assert {n: os.path.getmtime(os.path.join(outdir, n))
            for n in os.listdir(outdir)} == stamps


def test_dump_coeffs_writes_the_planes(tmp_path, capsys):
    paths = _inputs(str(tmp_path / "in"))
    prefix = str(tmp_path / "dump")
    rc, _, _ = _run(cli.main, ["--platform", "cpu", "--format", "bmp", "-o",
                               str(tmp_path / "out"), "--dump-coeffs",
                               prefix, paths[0]], capsys)
    assert rc == 0
    res = decode(paths[0], keep_planes=True, device="cpu")
    for ci, plane in enumerate(res.dequantized_planes):
        np.testing.assert_array_equal(
            np.load(f"{prefix}.a420.comp{ci}.npy"), plane)
    jprefix = str(tmp_path / "jdump")
    _run(jcli.main, ["--platform", "cpu", "--format", "bmp", "-o",
                     str(tmp_path / "jout"), "--dump-coeffs", jprefix,
                     paths[0]], capsys)
    for ci in range(3):
        np.testing.assert_array_equal(np.load(f"{prefix}.a420.comp{ci}.npy"),
                                      np.load(f"{jprefix}.a420.comp{ci}.npy"))


def test_12bit_to_npy_keeps_samples(tmp_path, capsys):
    paths = _inputs(str(tmp_path / "in"))
    out = str(tmp_path / "b12.npy")
    rc, _, _ = _run(cli.main, ["--platform", "cpu", "--idct", "exact",
                               "-o", out, paths[3]], capsys)
    assert rc == 0
    got = np.load(out)
    want = decode(paths[3], idct="exact", device="cpu").rgb
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want.numpy())


def _same_files(mine, theirs):
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    for name in os.listdir(mine):
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


def test_batch_device_entropy_equals_jax(tmp_path, capsys):
    """--batch --device-entropy: the same files as the JAX CLI's (K7 and K2
    plain versions here; the 12-bit frame and CMYK ride the device routes),
    the bad file's error line, rc 1."""
    paths = _inputs(str(tmp_path / "in"))
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    opts = ["--batch", "--device-entropy", "--idct", "pallas", "--format",
            "ppm", "--platform", "cpu", "--upsample", "fancy"]
    rc, out, err = _run(cli.main, [*opts, "-o", mine, *paths], capsys)
    rc_j, _, _ = _run(jcli.main, [*opts, "-o", theirs, *paths], capsys)
    assert (rc, rc_j) == (1, 1) and "bad.jpg: ERROR" in err
    assert out.count(" -> ") == 3
    _same_files(mine, theirs)


def test_device_entropy_without_batch_is_ignored(tmp_path, capsys):
    """Without --batch the flag changes nothing: the single-image path
    writes the same files as without it, as the JAX CLI does."""
    paths = _inputs(str(tmp_path / "in"))
    with_flag, without = str(tmp_path / "with"), str(tmp_path / "without")
    opts = ["--idct", "exact", "--format", "bmp", "--platform", "cpu"]
    rc, _, err = _run(cli.main, [*opts, "--device-entropy", "-o", with_flag,
                                 *paths], capsys)
    rc0, _, _ = _run(cli.main, [*opts, "-o", without, *paths], capsys)
    assert (rc, rc0) == (1, 1) and err.count("ERROR") == 1
    _same_files(with_flag, without)


def test_batch_device_entropy_isolates_a_corrupt_stream(tmp_path, capsys):
    """A frame whose entropy data is corrupt fails alone (rc 1, its error
    line); the other frames of its group are written, equal to decode()."""
    d = str(tmp_path / "in")
    os.makedirs(d)
    paths = []
    for k in range(3):
        blob = encode(_rgb(40 + k, 40, 56), quality=90)[0]
        if k == 1:
            sos = blob.index(b"\xff\xda")
            start = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
            blob = blob[:start + 4] + b"\xff\x00" * 8 + blob[start + 20:]
        paths.append(os.path.join(d, f"f{k}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(blob)
    out_dir = str(tmp_path / "out")
    rc, out, err = _run(cli.main, [
        "--batch", "--device-entropy", "--idct", "exact", "--format", "bmp",
        "--platform", "cpu", "--upsample", "fancy", "-o", out_dir, *paths],
        capsys)
    assert rc == 1 and err.count("ERROR") == 1 and "f1.jpg: ERROR" in err
    assert sorted(os.listdir(out_dir)) == ["f0.bmp", "f2.bmp"]
    for k in (0, 2):
        want = decode(paths[k], idct="exact", upsample="fancy", device="cpu")
        np.testing.assert_array_equal(
            writers.read_bmp(os.path.join(out_dir, f"f{k}.bmp")),
            want.rgb.numpy())


def test_batch_rejects_strict_and_dump(tmp_path, capsys):
    paths = _inputs(str(tmp_path / "in"))
    for flag in (["--strict"], ["--dump-coeffs", str(tmp_path / "d")]):
        rc, _, err = _run(cli.main, ["--platform", "cpu", "--batch", *flag,
                                     paths[0]], capsys)
        assert rc == 2 and "not supported with --batch" in err


def test_default_platform_needs_a_card(tmp_path, monkeypatch):
    paths = _inputs(str(tmp_path / "in"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--format", "bmp", "-o", str(tmp_path / "o"), paths[0]])


def test_profile_and_verbose(tmp_path, capsys):
    paths = _inputs(str(tmp_path / "in"))
    logdir = str(tmp_path / "prof")
    rc, out, _ = _run(cli.main, ["--platform", "cpu", "-vv", "--time",
                                 "--profile", logdir, "--format", "bmp",
                                 "-o", str(tmp_path / "o"), paths[0]],
                      capsys)
    assert rc == 0 and "MP/s" in out
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0


def test_options_match_jax_cli():
    """Every option of the JAX CLI, with its default."""
    def opts(parser):
        return {a.dest: a.default for a in parser._actions}
    assert opts(cli.build_argparser()) == opts(jcli.build_argparser())


def test_package_exports_match_jax(tmp_path):
    """The port's package exports what the JAX one does (``decode``,
    ``decode_to_file``, ``parse``, ``parse_file``, ``FrameHeader``,
    ``JPEGError``, ``DecodeResult``), and ``parse_file`` reads a path."""
    for name in ("decode", "decode_to_file", "parse", "parse_file",
                 "FrameHeader", "JPEGError", "DecodeResult"):
        assert hasattr(jpeg_decoder_tpu, name), name
        assert name in jpeg_decoder_tpu_torch.__all__, name
    path = _inputs(str(tmp_path / "in"))[1]
    got = jpeg_decoder_tpu_torch.parse_file(path)
    ref = jpeg_decoder_tpu.parse_file(path)
    assert isinstance(got, jpeg_decoder_tpu_torch.FrameHeader)
    assert (got.width, got.height, got.precision, got.colorspace) == (
        ref.width, ref.height, ref.precision, ref.colorspace)
