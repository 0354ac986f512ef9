"""The port's examples against the JAX package's, on the CPU.

``examples/torch_serving_pipeline.py`` and ``examples/serving_pipeline.py``
(run as it stands, ``--platform cpu``) decode the same seeded files: the
same lines in the same order, the same failure text, and embeddings within
``EMB_TOL``.  Both decoders give the same ``rgb_batch`` (padding included),
so only the float summation order of the model's mean differs.

``examples/torch_mixed_corpus_serving.py`` runs in two gloo processes on
the grids (1, 2) and (2, 1); each line's sha256 must equal that of the RGB
the JAX package's ``decode_batch_sharded`` gives on the same blobs over a
JAX CPU mesh of the same shape (the conftest's virtual devices), and only
the corrupt blob fails, with JAX's error text.  Both run ``idct="fast"``,
which is byte-equal here on this corpus: the +-1 that the JAX einsum's and
torch's float order may give (tests/test_torch_sharded.py) does not occur
in these frames.

Without a card both examples' default runs stop with "no CUDA device".
Every subprocess starts at module set-up, all together, each with its own
time limit (``TIMEOUT``).
"""

import hashlib
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from jpeg_decoder_tpu.parallel import mesh as jmesh
from jpeg_decoder_tpu.parallel import sharded as jsharded

from jpeg_decoder_tpu_torch.testing.encoder import encode
from jpeg_decoder_tpu_torch.testing.photo import synthetic_photo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
TIMEOUT = 180        # seconds, each subprocess run
EMB_TOL = 1e-5       # absolute, float32 means in two summation orders
GRIDS = [(1, 2), (2, 1)]
# height, width, samplings, quality, restart interval: three geometry
# groups (one with DRI) and a second image of the first group
FILES = [(64, 96, ((2, 2), (1, 1), (1, 1)), 90, 0),
         (48, 80, ((1, 1), (1, 1), (1, 1)), 95, 2),
         (40, 56, ((2, 2), (1, 1), (1, 1)), 90, 0),
         (64, 96, ((2, 2), (1, 1), (1, 1)), 85, 0)]
# Lists the modules of jax, PIL and the JAX package a finished run loaded.
LOADED = ("bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'PIL') or m.startswith('jpeg_decoder_tpu.')]\n"
          "print('loaded', bad)\n")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _popen(argv):
    return subprocess.Popen([sys.executable, *argv], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(stdout, stderr, rc) of every run, by name."""
    d = tmp_path_factory.mktemp("serving")
    for k, (h, w, samplings, quality, ri) in enumerate(FILES):
        blob, _ = encode(synthetic_photo(np.random.default_rng(k), h, w),
                         samplings=samplings, quality=quality,
                         restart_interval=ri)
        (d / f"img{k}.jpg").write_bytes(blob)
    (d / "img9_corrupt.jpg").write_bytes(b"\xff\xd8not-a-jpeg")
    files = str(d / "*.jpg")
    serving = os.path.join(EXAMPLES, "torch_serving_pipeline.py")
    mixed = os.path.join(EXAMPLES, "torch_mixed_corpus_serving.py")
    made = ("import runpy, sys\n"
            f"sys.argv = [{serving!r}, '--device', 'cpu', '--n', '4', "
            "'--scale', '16']\n"
            f"runpy.run_path({serving!r}, run_name='__main__')\n" + LOADED)
    imports = (f"import sys\nsys.path.insert(0, {REPO!r})\n"
               "import importlib.util\n"
               "spec = importlib.util.spec_from_file_location('m', "
               f"{mixed!r})\n"
               "m = importlib.util.module_from_spec(spec)\n"
               "spec.loader.exec_module(m)\n"
               "from jpeg_decoder_tpu_torch import decode_batch_sharded\n"
               "items = decode_batch_sharded(m.corpus(), 'cpu', "
               "idct='fast')\n"
               "print('failed', [i.index for i in items if not i.ok])\n"
               + LOADED)
    procs = {
        "jax_serving": _popen([os.path.join(EXAMPLES, "serving_pipeline.py"),
                               "--platform", "cpu", "--glob", files]),
        "serving": _popen([serving, "--device", "cpu", "--glob", files]),
        "serving_made": _popen(["-c", made]),
        "mixed_imports": _popen(["-c", imports]),
        **{f"mixed_{d}x{s}": _popen([mixed, "--device-type", "cpu",
                                     "--procs", "2", "--grid", str(d),
                                     str(s)]) for d, s in GRIDS},
        "default_serving": _popen([serving, "--glob", files]),
        "default_mixed": _popen([mixed]),
    }
    got = {}
    try:
        for key, p in procs.items():
            got[key] = (*p.communicate(timeout=TIMEOUT), p.returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return got


def _serving_lines(run) -> dict:
    """path -> embedding (3 floats) or failure text, in printed order."""
    stdout, stderr, rc = run
    assert rc == 0, stderr[-3000:]
    out = {}
    for ln in stdout.splitlines():
        m = re.match(r"(.+?): (embedding \[(.*)\]|failed: (.*))$", ln)
        if m:
            out[m[1]] = (np.array(m[3].split(), np.float64)
                         if m[3] is not None else m[4])
    assert stdout.splitlines()[-1].startswith(f"{len(out)} images decoded")
    return out


def test_serving_matches_jax(runs):
    """(a) The same files in the same order, the same failure text, and
    embeddings within EMB_TOL of the JAX example's."""
    ref = _serving_lines(runs["jax_serving"])
    got = _serving_lines(runs["serving"])
    assert list(got) == list(ref) and len(ref) == len(FILES) + 1
    for path, want in ref.items():
        if isinstance(want, str):
            assert got[path] == want and path.endswith("corrupt.jpg")
        else:
            assert got[path].shape == (3,)
            np.testing.assert_allclose(got[path], want, rtol=0, atol=EMB_TOL)


def test_serving_made_inputs_load_no_jax(runs):
    """(b) The serving example on its own seeded inputs: every image
    embedded, the corrupt blob failed, and the process loaded neither jax
    nor PIL nor any module of the JAX package."""
    stdout, stderr, rc = runs["serving_made"]
    assert rc == 0, stderr[-3000:]
    lines = stdout.splitlines()
    assert sum(": embedding [" in ln for ln in lines) == 4, lines
    assert lines[4].startswith("made/corrupt.jpg: failed: "), lines
    assert lines[-1] == "loaded []", lines


def test_mixed_example_loads_no_jax(runs):
    """The mixed example's module and its decode on one device load
    neither jax nor PIL nor any module of the JAX package."""
    stdout, stderr, rc = runs["mixed_imports"]
    assert rc == 0, stderr[-3000:]
    assert stdout.splitlines() == ["failed [4]", "loaded []"]


@pytest.fixture(scope="module")
def jax_lines():
    """What the mixed example's rank 0 prints, from the JAX package's
    ``decode_batch_sharded`` on each grid's shape: per item a sha256 of
    its RGB or its error text."""
    import jax

    blobs = _example("torch_mixed_corpus_serving").corpus()
    out = {}
    for d, s in GRIDS:
        mesh = jmesh.make_mesh((d, s), ("data", "seg"),
                               jax.devices()[:d * s])
        items = jsharded.decode_batch_sharded(blobs, mesh, idct="fast",
                                              upsample="fancy")
        out[(d, s)] = [
            f"FAILED (isolated): {it.error}" if it.error is not None else
            hashlib.sha256(np.ascontiguousarray(
                np.asarray(it.rgb)).tobytes()).hexdigest() for it in items]
    return out


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{d}x{s}" for d, s in GRIDS])
def test_mixed_matches_jax_mesh(runs, jax_lines, grid):
    """(c) Two gloo processes on ``grid``: one line per blob, each RGB's
    sha256 that of JAX's RGB on a mesh of the same shape, and only the
    corrupt blob failed, with JAX's text."""
    stdout, stderr, rc = runs[f"mixed_{grid[0]}x{grid[1]}"]
    assert rc == 0, stderr[-3000:]
    lines = stdout.splitlines()
    assert re.fullmatch(r"6 blobs served in [0-9.]+ ms \(calls .*\) on mesh "
                        rf"\({grid[0]}, {grid[1]}\) cpu; 1 isolated",
                        lines[-1]), lines[-1]
    items = [ln for ln in lines if ln.startswith("[")]
    want = jax_lines[grid]
    assert len(items) == len(want) == 6
    for k, (ln, ref) in enumerate(zip(items, want)):
        assert ln.startswith(f"[{k}] ")
        if ref.startswith("FAILED"):
            assert ln == f"[{k}] {ref}" and k == 4
        else:
            assert ln.endswith(f" sha256 {ref}"), (ln, ref)


@pytest.mark.parametrize("example", ["serving", "mixed"])
def test_examples_default_to_the_card(runs, example):
    """(d) Without a device argument and without a card each example stops
    with the port's error and prints no result."""
    stdout, stderr, rc = runs[f"default_{example}"]
    assert rc != 0
    assert "no CUDA device" in stderr, stderr[-3000:]
    assert "embedding" not in stdout and "sha256" not in stdout
