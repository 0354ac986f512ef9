"""The port's mesh route against the JAX package on the same mesh shapes.

``jpeg_decoder_tpu_torch/testing/mesh_worker.py`` runs in 1, 2, 3 and 4
gloo processes on the CPU (``device_type="cpu"``: every kernel runs its
plain version), each process one rank of a ``DeviceMesh``; the JAX package
runs the same seeded inputs in this process on a mesh of the same shape over
the conftest's virtual CPU devices.  Every ``subprocess`` has its own time
limit (``TIMEOUT``); the four runs start together.  Images are at most 256x256 (``testing/
encoder.py``; PIL for the progressive frames).

Tolerances: coefficients, planes and blocks bit-exact; RGB under
``idct="pallas"`` equal to JAX's; under ``"kron"`` within ``RGB_TOL`` with
at least ``MIN_EQUAL`` of the samples equal (the bounds of
tests/test_torch_sharded.py); the multi-rank port bit-equal to the one-rank
port under both; errors on the same items as JAX's, on every rank.
"""

import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from jpeg_decoder_tpu.entropy import progressive as jprogressive
from jpeg_decoder_tpu.entropy import python_ref as jref
from jpeg_decoder_tpu.io import parser as jparser
from jpeg_decoder_tpu.ops import scan_prep as jscan_prep
from jpeg_decoder_tpu.parallel import mesh as jmesh
from jpeg_decoder_tpu.parallel import multihost as jmultihost
from jpeg_decoder_tpu.parallel import sharded as jsharded

from jpeg_decoder_tpu_torch.io import parser as tparser
from jpeg_decoder_tpu_torch.models.batch import BatchItem
from jpeg_decoder_tpu_torch.models.decoder import decode_to_planes
from jpeg_decoder_tpu_torch.parallel import mesh as tmesh
from jpeg_decoder_tpu_torch.parallel import multihost as tmultihost
from jpeg_decoder_tpu_torch.parallel import sharded as tsharded
from jpeg_decoder_tpu_torch.testing.encoder import encode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RGB_TOL = 2          # +-1 IDCT rounding times the x1.402 colour gain
MIN_EQUAL = 0.9999   # share of RGB samples that must match exactly
TIMEOUT = 120        # seconds, each subprocess run
# Restart groups of 40 segments or more take K2 (both packages read it).
ENV = {"JD_RESTART_EMIT_MAX_LANES": "40"}


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 8.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _pil(seed, h, w, **kw):
    buf = io.BytesIO()
    Image.fromarray(_rgb(seed, h, w)).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _corrupt(blob: bytes) -> bytes:
    """8 stuffed 0xFF bytes early in the entropy data (a window no
    standard code takes)."""
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
    return blob[:start + 4] + b"\xff\x00" * 8 + blob[start + 20:]


# One batch per route of the JAX function (4:2:0 unless named).
ROUTES = {
    # a uniform DRI-0 group (emit)
    "dri0": [encode(_rgb(k, 48, 64), quality=90)[0] for k in range(3)],
    # restart streams under the lane limit (emit): 2 x 10 segments
    "restart": [encode(_rgb(30 + k, 32, 160), quality=90,
                       restart_interval=2)[0] for k in range(2)],
    # a geometry bucket of several sizes, tables and DRIs (dyn)
    "bucket": [encode(_rgb(20, 48, 96), quality=90)[0],
               encode(_rgb(21, 40, 80), quality=75, restart_interval=8)[0],
               _pil(22, 64, 112, quality=85, optimize=True, subsampling=2),
               encode(_rgb(23, 56, 72), quality=90, restart_interval=3)[0]],
    # a wide restart group (K2): 3 x 20 segments, over the limit of 40
    "wide": [encode(_rgb(10 + k, 80, 64), quality=90,
                    restart_interval=1)[0] for k in range(3)],
    # a progressive frame (the progressive lanes) with a baseline one
    "prog": [_pil(40, 40, 56, quality=85, progressive=True),
             encode(_rgb(42, 40, 56), quality=90)[0]],
    # a multi-scan frame (the host fallback) with a baseline one
    "fallback": [encode(_rgb(41, 40, 48), scans=[(0,), (1, 2)])[0],
                 encode(_rgb(43, 40, 48), quality=90)[0]],
    # a corrupt stream between two good ones of its group
    "corrupt": [encode(_rgb(60 + k, 48, 64), quality=90)[0] if k != 1
                else _corrupt(encode(_rgb(61, 48, 64), quality=90)[0])
                for k in range(3)],
}


def _bad(route):
    return [route == "corrupt" and k == 1
            for k in range(len(ROUTES[route]))]


SCANS = {f"dri{ri}": [encode(_rgb(50 + ri, 64, 96), quality=90,
                             restart_interval=ri)[0]] for ri in (1, 7, 64)}
SETS = {
    **{f"r_{k}": v for k, v in ROUTES.items()},
    **SCANS,
    # A DRI-0 and a DRI-8 image whose lane split over two ranks cuts a
    # restart segment (asserted below).
    "carry": [encode(_rgb(4, 80, 112), quality=90)[0],
              encode(_rgb(4, 80, 112), quality=90, restart_interval=8)[0]],
    "cut": [_pil(60, 64, 96, quality=85, progressive=True)],
    "prog": [_pil(61, 48, 80, quality=85, progressive=True),
             _pil(62, 48, 64, quality=85, progressive=True,
                  restart_marker_rows=1)],
    "s444": [encode(_rgb(70 + k, 48, 72), quality=90,
                    samplings=((1, 1),) * 3, restart_interval=3)[0]
             for k in range(3)],
    "s420": [encode(_rgb(75 + k, 64, 80), quality=90,
                    restart_interval=2)[0] for k in range(3)],
    "px": [encode(_rgb(80 + k, 40, 56), quality=90)[0] for k in range(4)],
}
TWO = ["meshes", "collectives@1x2", "collectives@2x1",
       *(f"batch@{g}:r_{k}" for g in ("1x2", "1x2+kron", "2x1")
                   for k in ROUTES), *(f"scan@1x2:{k}" for k in SCANS),
       "planes@1x2:dri7", "emit@1x2:carry", "lanes@1x2:cut", "prog@1x2:prog"]
FOUR = ["meshes", "collectives@2x2", *(f"batch@2x2:r_{k}" for k in ROUTES),
        "step@2x2:s444",
        "step@2x2:s420", "pixels@2x2:px", *(f"scan@1x4:{k}" for k in SCANS)]
ONE = ["meshes", "collectives@1x1", *(f"batch@1x1:r_{k}" for k in ROUTES)]


def _port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(tmp, world: int, phases: list, local: int | None = None):
    """Start the worker in ``world`` gloo CPU processes."""
    out = str(tmp)
    np.savez(os.path.join(out, "in.npz"), **{
        f"{n}/{k}": np.frombuffer(b, np.uint8)
        for n, blobs in SETS.items() for k, b in enumerate(blobs)})
    addr = f"127.0.0.1:{_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **ENV)
    cmd = [sys.executable, "-m", "jpeg_decoder_tpu_torch.testing.mesh_worker",
           "--world", str(world), "--addr", addr, "--grid", "1", str(world),
           "--device-type", "cpu", "--inputs", os.path.join(out, "in.npz"),
           "--out", out, "--phases", ",".join(phases), "--idct", "pallas"]
    if local:
        cmd += ["--local", str(local)]
    return out, [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(world)]


def _finish(out: str, procs: list):
    """Wait for a run's processes (``TIMEOUT`` each); each rank's (facts,
    arrays)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{o}\n{e[-3000:]}"
    return [(json.load(open(os.path.join(out, f"rank{r}.json"))),
             dict(np.load(os.path.join(out, f"rank{r}.npz"))))
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's outputs by world size (1-4 processes, the four runs
    started together; 4 as two hosts of two ranks)."""
    started = {world: _start(tmp_path_factory.mktemp(f"w{world}"), world,
                             phases, local)
               for world, phases, local in ((2, TWO, None), (4, FOUR, 2),
                                            (1, ONE, None),
                                            (3, ["meshes"], None))}
    example = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples",
                                      "torch_sharded_decode.py"),
         "--device-type", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    addr = f"127.0.0.1:{_port()}"
    defaults = {
        "example": example,
        "default_example": subprocess.Popen(
            [sys.executable, os.path.join(REPO, "examples",
                                          "torch_sharded_decode.py")],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, OMP_NUM_THREADS="1")),
        "default_worker": subprocess.Popen(
            [sys.executable, "-m", "jpeg_decoder_tpu_torch.testing.mesh_worker",
             "--rank", "0", "--world", "1", "--addr", addr, "--grid", "1",
             "1", "--out", str(tmp_path_factory.mktemp("default"))],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=REPO,
                                OMP_NUM_THREADS="1"))}
    got = {world: _finish(*run) for world, run in started.items()}
    try:
        for key, p in defaults.items():
            got[key] = (*p.communicate(timeout=TIMEOUT), p.returncode)
    finally:
        for p in defaults.values():
            if p.poll() is None:
                p.kill()
    return got


@pytest.fixture(scope="module")
def jax_env():
    old = {k: os.environ.get(k) for k in ENV}
    os.environ.update(ENV)
    yield
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _jmesh(shape):
    n = int(np.prod(shape))
    return jmesh.make_mesh(shape, ("data", "seg"), jax.devices()[:n])


@pytest.fixture(scope="module")
def one_rank(jax_env):
    """The one-device port route of each route's batch under each IDCT."""
    return {(route, idct): tsharded.decode_batch_sharded(
        blobs, "cpu", idct=idct) for route, blobs in ROUTES.items()
        for idct in ("pallas", "kron")}


def _close(a, b, idct):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    if idct == "pallas":
        assert d.max() == 0, int(d.max())
    else:
        assert d.max() <= RGB_TOL and (d == 0).mean() >= MIN_EQUAL


GRIDS = [(2, "1x2", "pallas"), (2, "1x2+kron", "kron"), (2, "2x1", "pallas"),
         (4, "2x2", "pallas"), (1, "1x1", "pallas")]


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("world,grid,idct", GRIDS, ids=[g[1] for g in GRIDS])
def test_batch_equals_one_rank(runs, one_rank, world, grid, idct, route):
    """decode_batch_sharded over every mesh, one case per route: every
    rank's items, gathered, bit-equal to the one-rank port's, and the errors
    on the same items (the corrupt stream) on every rank."""
    phase = f"batch@{grid}:r_{route}"
    for facts, arrays in runs[world]:
        f = facts[phase]
        assert [e is not None for e in f["errors"]] == _bad(route)
        for k, one in enumerate(one_rank[route, idct]):
            if one.error is None:
                np.testing.assert_array_equal(arrays[f"{phase}/rgb/{k}"],
                                              one.rgb.numpy())


# JAX compiles its progressive chain programs per mesh shape (~9 s on the
# CPU), so the progressive route meets JAX on (1, 2); on (2, 2) it is held
# bit-equal to the one-rank port (test_batch_equals_one_rank).
JAX_CASES = [(world, grid, shape, idct, route)
             for world, grid, shape, idct in (
                 (2, "1x2", (1, 2), "pallas"), (2, "1x2+kron", (1, 2), "kron"),
                 (4, "2x2", (2, 2), "pallas"))
             for route in ROUTES if (grid, route) != ("2x2", "prog")]


@pytest.mark.parametrize("world,grid,shape,idct,route", JAX_CASES,
                         ids=[f"{c[1]}-{c[4]}" for c in JAX_CASES])
def test_batch_matches_jax(runs, jax_env, world, grid, shape, idct, route):
    """decode_batch_sharded on (1, 2) and (2, 2), one case per route:
    every rank's gathered RGB equal to JAX's on the same mesh shape under
    pallas (within the kron bound under kron), the errors on JAX's
    items."""
    ref = jsharded.decode_batch_sharded(ROUTES[route], _jmesh(shape),
                                        idct=idct, upsample="fancy")
    assert [it.error is not None for it in ref] == _bad(route)
    phase = f"batch@{grid}:r_{route}"
    for facts, arrays in runs[world]:
        for k, j in enumerate(ref):
            if j.error is None:
                _close(np.asarray(j.rgb), arrays[f"{phase}/rgb/{k}"], idct)


def test_batch_routes(runs):
    """Each route's batch took its route on every rank of (1, 2): the
    groups' routes, the progressive frame on the lanes and the multi-scan
    frame on the host fallback."""
    want = {"dri0": ["emit"], "restart": ["emit"], "bucket": ["dyn"],
            "wide": ["k2"], "prog": ["emit"], "fallback": ["emit"],
            "corrupt": ["emit"]}
    for facts, _ in runs[2]:
        for route, routes in want.items():
            t = facts[f"batch@1x2:r_{route}"]["timing"]
            assert [g["route"] for g in t["groups"]] == routes, route
            assert t["progressive"] == (route == "prog")
            assert t["host_fallback"] == (route == "fallback")


@pytest.mark.parametrize("world,phase",
                         [(2, "batch@2x1:r_dri0"), (4, "batch@2x2:r_bucket"),
                          (2, "batch@2x1:r_prog")])
def test_batch_rows_held(runs, world, phase):
    """On a mesh with 'data' > 1 each rank holds its group rows
    (local_data_rows' split of the group), equal to the gathered rows;
    ``it.rgb`` of a row held elsewhere raises IndexError; progressive,
    host-fallback and re-decoded rows are whole on every rank."""
    for facts, arrays in runs[world]:
        f = facts[phase]
        held = 0
        for k, rows in enumerate(f["rows"]):
            if f["errors"][k] is not None or rows is None:
                continue
            lo, hi = rows
            if lo <= f["batch_index"][k] < hi:
                held += 1
                np.testing.assert_array_equal(arrays[f"{phase}/own/{k}"],
                                              arrays[f"{phase}/rgb/{k}"])
            else:
                assert k in f["elsewhere_raises"]
        whole = [k for k, r in enumerate(f["rows"]) if r is None]
        if phase.endswith("r_prog"):     # the progressive frame is whole
            assert whole == [0] and held == 1 and f["elsewhere_raises"] == [] \
                or whole == [0] and held == 0 and f["elsewhere_raises"] == [1]
        else:
            assert held and f["elsewhere_raises"] and not whole


def test_rgb_of_row_held_elsewhere_raises():
    item = BatchItem(index=5, header=tparser.parse(SETS["px"][0]),
                     rgb_batch=torch.zeros((2, 40, 56, 3), dtype=torch.uint8),
                     batch_index=3, rows=(0, 2))
    with pytest.raises(IndexError, match="held|holds"):
        item.rgb
    assert item.rgb_batch[0].shape == (40, 56, 3)


@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (1, 4))])
@pytest.mark.parametrize("name", list(SCANS))
def test_scan_sharded_matches_jax(runs, world, shape, name):
    """decode_scan_sharded over 'seg' (DRI 1, 7, 64): the coefficients of
    every rank bit-exact to JAX's decode_scan_sharded on (1, n)."""
    hdr = jparser.parse(SETS[name][0])
    ref = jsharded.decode_scan_sharded(hdr, hdr.scans[0], _jmesh(shape))
    for facts, arrays in runs[world]:
        np.testing.assert_array_equal(
            arrays[f"scan@{shape[0]}x{shape[1]}:{name}/coef/0"], ref)


def test_planes_sharded_matches_jax(runs):
    hdr = jparser.parse(SETS["dri7"][0])
    ref = jsharded.decode_planes_sharded(hdr, _jmesh((1, 2)))
    for facts, arrays in runs[2]:
        for c, plane in enumerate(ref):
            np.testing.assert_array_equal(
                arrays[f"planes@1x2:dri7/plane/0/{c}"], np.asarray(plane))


@pytest.mark.parametrize("name", ["s444", "s420"])
def test_full_decode_step_matches_jax(runs, name):
    """full_decode_step on (2, 2): images over 'data', segments over 'seg';
    the gathered RGB equal to JAX's under pallas, err_img equal."""
    hdrs = [jparser.parse(b) for b in SETS[name]]
    prepped = [jscan_prep.prepare_scan(h, h.scans[0])[:2] for h in hdrs]
    s_max = max(len(nm) for _, nm in prepped)
    w_max = max(w.shape[1] for w, _ in prepped)
    words = np.zeros((len(hdrs), s_max, w_max), np.uint32)
    nm_b = np.zeros((len(hdrs), s_max), np.int32)
    for k, (w, nm) in enumerate(prepped):
        words[k, :w.shape[0], :w.shape[1]] = w
        nm_b[k, :len(nm)] = nm
    rgb, err, err_img = jsharded.full_decode_step(
        hdrs[0], words, nm_b, _jmesh((2, 2)), idct="pallas",
        upsample="fancy")
    for r, (facts, arrays) in enumerate(runs[4]):
        phase = f"step@2x2:{name}"
        np.testing.assert_array_equal(arrays[f"{phase}/rgb"],
                                      np.asarray(rgb))
        np.testing.assert_array_equal(arrays[f"{phase}/err_img"],
                                      np.asarray(err_img))
        np.testing.assert_array_equal(arrays[f"{phase}/err"],
                                      np.asarray(err))
        assert facts[phase]["rows"] == (2 if r < 2 else 1)   # 'data' rows


def test_batch_pixel_pipeline_matches_jax(runs):
    """batch_pixel_pipeline over 'data' x 'seg' (pure image parallelism):
    the gathered RGB equal to JAX's on (2, 2) under pallas."""
    hdrs = [tparser.parse(b) for b in SETS["px"]]
    planes = [decode_to_planes(h, "native") for h in hdrs]
    batch = tuple(np.stack([np.asarray(p[c]) for p in planes])
                  for c in range(3))
    qts = tuple(hdrs[0].quant_tables[c.tq].values for c in
                hdrs[0].components)
    ref = jsharded.batch_pixel_pipeline(batch, qts, jparser.parse(
        SETS["px"][0]), _jmesh((2, 2)), idct="pallas")
    for r, (facts, arrays) in enumerate(runs[4]):
        np.testing.assert_array_equal(arrays["pixels@2x2:px/rgb"],
                                      np.asarray(ref))
        assert facts["pixels@2x2:px"]["rows"] == 1


@pytest.mark.parametrize("k,ri", [(0, 0), (1, 8)])
def test_dc_carry_across_ranks(runs, k, ri):
    """K7 over two ranks with the cut inside a restart segment (DRI 0, and
    DRI 8 cut off a multiple of 8): the blocks of every rank bit-exact to
    the JAX package's reference decoder."""
    hdr = jparser.parse(SETS["carry"][k])
    facts = runs[2][0][0]["emit@1x2:carry"]
    assert facts["ri"][k] == ri
    cut = facts["first_mcu"][k][1]
    assert cut > 0 and (ri == 0 or cut % ri), cut
    ref = jref.decode_scan_baseline(hdr, hdr.scans[0])
    for _, arrays in runs[2]:
        got = arrays[f"emit@1x2:carry/blocks/{k}"]
        np.testing.assert_array_equal(got, ref[:len(got)])


def test_moved_lane_start_flags_the_rank_before(runs):
    """Each chained scan's skeleton lanes with rank 1's first lane start
    moved one bit: rank 0's last lane is flagged (it must end where the
    next rank's first lane starts); the true lanes flag nothing."""
    for r, (facts, _) in enumerate(runs[2]):
        rec = facts["lanes@1x2:cut"]
        assert len(rec) >= 4          # the DC first and AC scans
        for f in rec:
            assert not any(f["true"]), f
            if r == 0:
                assert f["moved"][-1] == 1, f


def test_progressive_planes_match_jax(runs):
    """decode_progressive_lanes over the mesh (skeleton lanes on a DRI-0
    frame, segment lanes on a restart frame): every rank's planes equal to
    the JAX package's progressive decoder."""
    for k, blob in enumerate(SETS["prog"]):
        ref = jprogressive.decode_progressive(jparser.parse(blob))
        for _, arrays in runs[2]:
            for c, plane in enumerate(ref):
                np.testing.assert_array_equal(
                    arrays[f"prog@1x2:prog/plane/{k}/{c}"], plane)


class _Dev:
    def __init__(self, process_index):
        self.process_index = process_index


class _FakeMesh:
    """A JAX mesh stand-in: hosts on 'data', as ``global_mesh`` lays
    them."""

    def __init__(self, shape):
        self.shape = {"data": shape[0], "seg": shape[1]}
        self.devices = np.array([[_Dev(i) for _ in range(shape[1])]
                                 for i in range(shape[0])], dtype=object)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_meshes_match_jax(runs, monkeypatch, world):
    """make_mesh shapes, axis names and rank arrays against JAX's over as
    many devices; local_data_rows against JAX's for the process that owns
    the rank's 'data' row (hosts on 'data'); global_mesh against JAX's with
    the same hosts (4 processes: two hosts of two ranks)."""
    devs = jax.devices()[:world]
    hosts = 2 if world == 4 else 1
    for facts, _ in runs[world]:
        m = facts["meshes"]
        assert m["world"] == world
        for shape, got in m["meshes"].items():
            shape = tuple(json.loads(shape.replace("(", "[")
                                     .replace(")", "]")))
            jm = jmesh.make_mesh(shape, ("data", "seg"), devs)
            assert got["shape"] == list(jm.devices.shape)
            assert got["names"] == list(jm.axis_names)
            assert got["ranks"] == [[d.id for d in row]
                                    for row in jm.devices]
            d = got["coordinate"][0]
            monkeypatch.setattr(jax, "process_index", lambda d=d: d)
            for b, rows in got["rows"].items():
                assert rows == jmultihost.local_data_rows(
                    _FakeMesh(shape), int(b))
        monkeypatch.setattr(jax, "devices", lambda: devs)
        monkeypatch.setattr(jax, "process_count", lambda: hosts)
        jg = jmultihost.global_mesh()
        monkeypatch.undo()
        assert m["global"]["shape"] == list(jg.devices.shape)
        assert m["global"]["ranks"] == [[d.id for d in row]
                                        for row in jg.devices]
        assert m["default"] == list(_jmesh_default(devs))
        assert m["single"] == [[world], ["seg"]]
        assert "no CUDA device" in m["cuda_error"]


def _jmesh_default(devs):
    return jmesh.make_mesh(None, ("data", "seg"), devs).devices.shape


def test_cuda_mesh_without_a_card_raises():
    """No card: a "cuda" mesh and a "cuda" process group raise (before any
    rendezvous); nothing falls back to the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh((1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmultihost.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((1, 1), device_type="cpu")


COLLECTIVES = [(1, "1x1"), (2, "1x2"), (2, "2x1"), (4, "2x2")]


@pytest.mark.parametrize("world,grid", COLLECTIVES,
                         ids=[g for _, g in COLLECTIVES])
def test_collectives_transport(runs, world, grid):
    """The transport under every collective of the mesh routes
    (``gather_over``, ``reduce_over`` and the mesh forms over them) on the
    'seg', 'data' and whole-mesh lines of every rank, one-rank lines
    included: the worker holds each result, exactly, to what the line's
    ranks sent (six dtypes, odd byte counts, uneven row counts) and fails
    the rank on a difference; every check ran, on lines of the mesh's
    shape."""
    d, s = map(int, grid.split("x"))
    for r, (facts, _) in enumerate(runs[world]):
        f = facts[f"collectives@{grid}"]
        lines = f["lines"]
        assert f["backend"] == "gloo"
        assert sorted(lines) == ["data", "data+seg", "seg"]
        assert lines["data+seg"] == list(range(world))
        assert len(lines["seg"]) == s and len(lines["data"]) == d
        assert r in lines["seg"] and r in lines["data"]
        assert f["checked"] == sum(13 * len(v) + 2 for v in lines.values())


@pytest.mark.parametrize("entry", ["worker", "example"])
def test_entry_points_default_to_the_card(runs, entry):
    """The worker and the example decode on the card unless asked for the
    CPU: without ``--device-type`` and without a card they fail with the
    mesh's error, and decode nothing on the CPU."""
    stdout, stderr, rc = runs[f"default_{entry}"]
    assert rc != 0
    assert "no CUDA device" in stderr, stderr[-3000:]
    assert "equal" not in stdout


def test_example_runs_on_two_processes(runs):
    """examples/torch_sharded_decode.py on two gloo CPU processes (started
    with the worker runs)."""
    stdout, stderr, rc = runs["example"]
    assert rc == 0, stderr[-3000:]
    lines = stdout.splitlines()
    assert len(lines) == 3 and all("equal" in ln for ln in lines), lines
