"""The port's device progressive lanes against the JAX package's.

``jpeg_decoder_tpu_torch/ops/entropy_prog.py`` with the kernels K8a-K8d
(``ops/entropy_prog_cuda.py``; on the CPU their plain versions) against
``jpeg_decoder_tpu/ops/entropy_prog.py`` and the Python oracle
(``entropy/progressive.py``), on small seeded PIL progressive frames (JAX's
loops compile per shape).  Planes are integer results and must be equal:
the skeleton bindings' lane records, every scan kind applied to the oracle's
prior planes (restart-segment and skeleton lanes), whole frames through both
lane routes at several lane counts and chain orders; ``decode()`` under
``pallas``, ``jax`` and ``hybrid`` (``exact`` byte-equal to JAX's strict
path, ``pallas`` within the K1 bound), ``BatchDecoder`` and
``decode_batch_sharded`` with progressive items; corrupt streams and a
wrong lane start; the wrappers' refusals.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
from jax.sharding import Mesh

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu.entropy import native as jnative  # noqa: E402
from jpeg_decoder_tpu.entropy import progressive as jprog  # noqa: E402
from jpeg_decoder_tpu.io import parser as jparser  # noqa: E402
from jpeg_decoder_tpu.models import batch as jbatch  # noqa: E402
from jpeg_decoder_tpu.models import decoder as jdecoder  # noqa: E402
from jpeg_decoder_tpu.ops import entropy_prog as jep  # noqa: E402
from jpeg_decoder_tpu.parallel import sharded as jsharded  # noqa: E402

from jpeg_decoder_tpu_torch import JPEGError, decode  # noqa: E402
from jpeg_decoder_tpu_torch.entropy import native as tnative  # noqa: E402
from jpeg_decoder_tpu_torch.entropy import progressive as tprog  # noqa: E402
from jpeg_decoder_tpu_torch.huffman import build_lut  # noqa: E402
from jpeg_decoder_tpu_torch.io import parser as tparser  # noqa: E402
from jpeg_decoder_tpu_torch.models import batch as tbatch  # noqa: E402
from jpeg_decoder_tpu_torch.ops import entropy_prog as ep  # noqa: E402
from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8  # noqa: E402
from jpeg_decoder_tpu_torch.parallel import sharded  # noqa: E402

RGB_TOL = 2          # +-1 IDCT rounding times the x1.402 colour gain
MIN_EQUAL = 0.9999   # share of RGB samples that must match exactly


def _rgb(seed, h, w):
    """A gradient with Gaussian noise: every scan kind has work to do."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 10.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _pil(seed, h, w, restart_blocks=0, quality=85, subsampling=0):
    """A PIL progressive Huffman stream (PIL's 10-scan script: all four
    scan kinds)."""
    kw = dict(quality=quality, progressive=True, subsampling=subsampling)
    if restart_blocks:
        kw["restart_marker_blocks"] = restart_blocks
    buf = io.BytesIO()
    Image.fromarray(_rgb(seed, h, w)).save(buf, "JPEG", **kw)
    return buf.getvalue()


FRAMES = {
    "dri0": lambda: _pil(3, 40, 48),
    "dri4": lambda: _pil(3, 40, 48, restart_blocks=4),
    "dri3": lambda: _pil(11, 32, 64, restart_blocks=3),
    "dri16": lambda: _pil(11, 32, 64, restart_blocks=16),
    "420_dri2": lambda: _pil(7, 48, 56, restart_blocks=2, quality=70,
                             subsampling=2),
    "420_dri0": lambda: _pil(13, 48, 64, quality=75, subsampling=2),
}


def _kinds(hdr):
    return ["dc-first" if s.ss == 0 and s.ah == 0 else
            "dc-refine" if s.ss == 0 else
            "ac-first" if s.ah == 0 else "ac-refine" for s in hdr.scans]


def _oracle_after(hdr, n_scans):
    """The Python oracle's planes after the first ``n_scans`` scans."""
    planes = [np.zeros((hdr.mcus_y * c.v, hdr.mcus_x * c.h, 64), np.int64)
              for c in hdr.components]
    for scan in hdr.scans[:n_scans]:
        if scan.ss == 0:
            tprog._dc_scan(hdr, scan, planes)
        elif scan.ah == 0:
            tprog._ac_first_scan(hdr, scan, planes[scan.comp_indices[0]])
        else:
            tprog._ac_refine_scan(hdr, scan, planes[scan.comp_indices[0]])
    return [p.astype(np.int32) for p in planes]


def _flat(planes):
    """Oracle planes as the lanes' (rows*cols + 1, 64) planes."""
    out = []
    for p in planes:
        flat = np.zeros((p.shape[0] * p.shape[1] + 1, 64), np.int32)
        flat[:-1] = p.reshape(-1, 64)
        out.append(flat)
    return out


def _assert_planes(got, want, what=""):
    assert len(got) == len(want)
    for ci, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w),
                                      err_msg=f"{what} component {ci}")


def _assert_rgb_close(got, ref):
    a = got.numpy().astype(np.int32)
    b = np.asarray(ref).astype(np.int32)
    assert a.shape == b.shape
    d = np.abs(a - b)
    assert d.max() <= RGB_TOL and (d == 0).mean() >= MIN_EQUAL, d.max()


# ---------------------------------------------------------------------------
# The skeleton bindings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 3])
def test_skeleton_bindings_match_jax(stride):
    """Every DC-first and AC scan of a 4:2:0 DRI-0 frame walked by both
    packages' bindings in order: lane bits, predictors, EOB runs, per-block
    symbol/event counts and the band bitmaps they update are equal."""
    blob = FRAMES["420_dri0"]()
    th, jh = tparser.parse(blob), jparser.parse(blob)
    tmaps, jmaps = {}, {}
    walked = set()
    for k, (ts, js) in enumerate(zip(th.scans, jh.scans)):
        if ts.ss == 0 and ts.ah:
            continue
        if ts.ss == 0:
            got = tnative.prog_skeleton_dc(th, ts, stride)
            want = jnative.prog_skeleton_dc(jh, js, stride)
        else:
            ci = ts.comp_indices[0]
            n = len(jmaps.setdefault(ci, np.zeros(
                ep.scan_units(th, ts), np.uint64)))
            tm = tmaps.setdefault(ci, np.zeros(n, np.uint64))
            got = tnative.prog_skeleton_ac(th, ts, stride, tm,
                                           want_syms=True)
            want = jnative.prog_skeleton_ac(jh, js, stride, jmaps[ci],
                                            want_syms=True)
            np.testing.assert_array_equal(tm, jmaps[ci])
            assert tm.any()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        walked.add(_kinds(th)[k])
    assert walked == {"dc-first", "ac-first", "ac-refine"}


def test_skeleton_walks_read_replaced_scan_data():
    """Scans whose ``data`` was replaced by a copy (so that the parser's
    padded buffer no longer aliases it, and the walk pads a new one): the
    port's skeleton walks give JAX's lane records on every scan of the
    512x512 fixture (the padded copy must outlive the C call)."""
    import copy

    from jpeg_decoder_tpu_torch.testing import photo

    blob = photo.fixture("progressive_512.jpg")[0]
    th, jh = tparser.parse(blob), jparser.parse(blob)
    nz_t, nz_j = {}, {}
    for ts, js in zip(th.scans, jh.scans):
        if ts.ss == 0 and ts.ah:
            continue
        ts = copy.copy(ts)
        ts.data = ts.data.copy()
        if ts.ss == 0:
            got = tnative.prog_skeleton_dc(th, ts, 5)
            want = jnative.prog_skeleton_dc(jh, js, 5)
        else:
            n = ep.scan_units(th, ts)
            ci = ts.comp_indices[0]
            got = tnative.prog_skeleton_ac(
                th, ts, 3, nz_t.setdefault(ci, np.zeros(n, np.uint64)))
            want = jnative.prog_skeleton_ac(
                jh, js, 3, nz_j.setdefault(ci, np.zeros(n, np.uint64)))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_skeleton_guards():
    """JAX's guards and the lane guards: restart scans, a bad band bitmap,
    scans of 2^31 bits or more and lane bits out of order raise."""
    hdr = tparser.parse(FRAMES["dri4"]())
    scan = hdr.scans[0]
    with pytest.raises(JPEGError, match="DRI=0"):
        tnative.prog_skeleton_dc(hdr, scan, 1)
    hdr = tparser.parse(FRAMES["dri0"]())
    ac = next(s for s in hdr.scans if s.ss)
    n = ep.scan_units(hdr, ac)
    with pytest.raises(ValueError, match="nzmap"):
        tnative.prog_skeleton_ac(hdr, ac, 1, np.zeros(n, np.int64))
    with pytest.raises(ValueError, match="stride"):
        tnative.prog_skeleton_dc(hdr, hdr.scans[0], 0)
    big = hdr.scans[0]
    data = big.data
    try:
        big.data = np.broadcast_to(np.uint8(0), (1 << 28,))
        with pytest.raises(JPEGError, match="2\\^31"):
            tnative.prog_skeleton_dc(hdr, big, 1)
    finally:
        big.data = data
    with pytest.raises(JPEGError, match="out of order"):
        tnative._check_lane_bits(np.array([0, 9, 8]), big, "DC")
    with pytest.raises(JPEGError, match="outside"):
        tnative._check_lane_bits(np.array([0, len(data) * 8 + 1]), big, "DC")


# ---------------------------------------------------------------------------
# Scan by scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frame", ["dri0", "dri4"])
def test_each_scan_kind_matches_jax_and_oracle(frame):
    """Every scan applied to the oracle's prior planes: the port's
    restart-segment lanes, JAX's ``apply_scan_device`` and the oracle's
    posterior planes are equal (as tests/test_entropy_prog.py:71); at DRI 0
    also the port's skeleton lanes."""
    import jax.numpy as jnp

    blob = FRAMES[frame]()
    th, jh = tparser.parse(blob), jparser.parse(blob)
    kinds = _kinds(th)
    assert set(kinds) == {"dc-first", "dc-refine", "ac-first", "ac-refine"}
    nzmaps: dict = {}
    for k, (ts, js) in enumerate(zip(th.scans, jh.scans)):
        before = _flat(_oracle_after(th, k))
        after = _flat(_oracle_after(th, k + 1))
        got = ep.apply_scan_device(
            th, ts, [torch.from_numpy(p.copy()) for p in before])
        ref = jep.apply_scan_device(jh, js, [jnp.asarray(p) for p in before])
        _assert_planes(got, after, f"scan {k} ({kinds[k]})")
        # JAX's scatter lands other components' slots and lane padding on
        # the drop row (mode="drop" drops only past it); the port's stays 0.
        _assert_planes([g[:-1] for g in got],
                       [np.asarray(r)[:-1] for r in ref], f"jax scan {k}")
        if frame == "dri0":
            lanes = ep.hybrid_scan_prep(th, ts, nzmaps, target_lanes=5)
            got = ep.apply_scan_device(
                th, ts, [torch.from_numpy(p.copy()) for p in before],
                lanes=lanes)
            _assert_planes(got, after, f"skeleton lanes, scan {k}")


@pytest.mark.parametrize("frame", ["dri0", "dri3", "dri16", "420_dri2"])
def test_whole_frame_segment_lanes_match_jax(frame):
    blob = FRAMES[frame]()
    th, jh = tparser.parse(blob), jparser.parse(blob)
    got = ep.decode_progressive_device(th, "cpu")
    _assert_planes(got, jep.decode_progressive_device(jh), "jax")
    _assert_planes(got, tprog.decode_progressive(th), "oracle")
    _assert_planes(got, jprog.decode_progressive(jh), "jax oracle")


@pytest.fixture(scope="module")
def hybrid_ref():
    blob = FRAMES["420_dri0"]()
    return blob, jep.decode_progressive_hybrid(jparser.parse(blob),
                                               target_lanes=8)


@pytest.mark.parametrize("lanes", [1, 3, 512, 1000])
def test_skeleton_lanes_any_count_match_jax(hybrid_ref, lanes):
    """Skeleton lanes at 1, 3, 512 and more lanes than blocks (empty lanes
    then chain through): planes equal to JAX's and the oracle's."""
    blob, ref = hybrid_ref
    hdr = tparser.parse(blob)
    got = ep.decode_progressive_hybrid(hdr, "cpu", target_lanes=lanes)
    _assert_planes(got, ref, f"{lanes} lanes vs jax")
    _assert_planes(got, tprog.decode_progressive(hdr), "oracle")


@pytest.mark.parametrize("order", ["largest_first", "reversed"])
def test_chain_order_does_not_change_planes(hybrid_ref, order):
    """The chains share one set of planes (disjoint coefficients): run one
    after another in either order, they give JAX's planes."""
    blob, ref = hybrid_ref
    hdr = tparser.parse(blob)
    chains = ep.scan_chains(hdr)
    assert len(chains) == 4
    if order == "reversed":
        chains = chains[::-1]
    shapes, planes = ep._zero_planes(hdr, torch.device("cpu"))
    errs: list = []
    for chain in chains:
        ep.run_chain(hdr, chain, planes, errs, target_lanes=7)
    ep.check_errors(errs)
    _assert_planes(ep._finish(planes, shapes, False), ref, order)


def test_lanes_route_like_jax(monkeypatch):
    """decode_progressive_lanes: DRI-0 frames take skeleton lanes, restart
    frames segment lanes, no native library segment lanes too, a 12-bit
    frame the host decoder."""
    calls = []
    for name in ("decode_progressive_hybrid", "decode_progressive_device"):
        real = getattr(ep, name)
        monkeypatch.setattr(ep, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    ep.decode_progressive_lanes(tparser.parse(FRAMES["dri0"]()), "cpu")
    ep.decode_progressive_lanes(tparser.parse(FRAMES["dri4"]()), "cpu")
    monkeypatch.setattr(tnative, "available", lambda: False)
    ep.decode_progressive_lanes(tparser.parse(FRAMES["dri0"]()), "cpu")
    assert calls == ["decode_progressive_hybrid",
                     "decode_progressive_device",
                     "decode_progressive_device"]
    # Another precision (no encoder here writes a 12-bit progressive
    # Huffman stream): the host decoder, as in JAX.
    th, jh = (p.parse(FRAMES["dri4"]()) for p in (tparser, jparser))
    th.precision = jh.precision = 12
    got = ep.decode_progressive_lanes(th, "cpu", as_device=True)
    assert isinstance(got[0], torch.Tensor)
    _assert_planes(got, jep.decode_progressive_lanes(jh))
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frame", ["420_dri0", "dri3"])
@pytest.mark.parametrize("entropy", ["pallas", "jax", "hybrid"])
def test_decode_matches_jax(frame, entropy):
    """decode() under the device backends: ``exact`` byte-equal to JAX's
    strict decode() under the same backend, ``pallas`` within the K1 bound
    of JAX's, and the planes (``keep_planes``) equal."""
    blob = FRAMES[frame]()
    ref = jdecoder.decode(blob, entropy=entropy, idct="exact", strict=True,
                          upsample="fancy", keep_planes=True)
    got = decode(blob, entropy=entropy, idct="exact", upsample="fancy",
                 keep_planes=True, device="cpu")
    np.testing.assert_array_equal(got.rgb.numpy(), np.asarray(ref.rgb))
    _assert_planes(got.quantized_planes, ref.quantized_planes)
    ref = jdecoder.decode(blob, entropy=entropy, idct="pallas",
                          upsample="fancy")
    got = decode(blob, entropy=entropy, idct="pallas", upsample="fancy",
                 device="cpu")
    _assert_rgb_close(got.rgb, ref.rgb)


def test_batch_decoder_progressive_matches_jax():
    """BatchDecoder(entropy="pallas") reaches the lanes through its
    host-plane fallback, as in JAX; every item equals JAX's."""
    blobs = [FRAMES["420_dri0"](), FRAMES["dri3"](),
             encode(_rgb(9, 40, 48), quality=90)[0]]
    ref = jbatch.BatchDecoder(entropy="pallas", idct="pallas",
                              upsample="fancy").decode(blobs)
    with tbatch.BatchDecoder(device="cpu", entropy="pallas",
                             idct="pallas") as bd:
        got = bd.decode(blobs)
    for r, g in zip(ref, got):
        assert r.ok and g.ok, g.error
        _assert_rgb_close(g.rgb, np.asarray(r.rgb))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seg"))


def test_sharded_progressive_rides_the_lanes(mesh, monkeypatch):
    """decode_batch_sharded: progressive frames decode on the lanes (K8a-K8d
    launched, none on the host fallback), every item equal to JAX's."""
    calls = []
    for name in ("dc_first_torch", "dc_refine_torch", "ac_first_torch",
                 "ac_refine_torch"):
        real = getattr(k8, name)
        monkeypatch.setattr(k8, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    blobs = [FRAMES["420_dri0"](), encode(_rgb(9, 40, 48), quality=90)[0],
             FRAMES["dri3"]()]
    ref = jsharded.decode_batch_sharded(blobs, mesh, idct="pallas",
                                        upsample="fancy")
    got = sharded.decode_batch_sharded(blobs, "cpu", idct="pallas",
                                       upsample="fancy")
    timing = sharded.decode_batch_sharded.last_timing
    assert timing["progressive"] == 2
    assert timing["progressive_fallback"] == 0
    assert timing["host_fallback"] == 0
    assert set(calls) == {"dc_first_torch", "dc_refine_torch",
                          "ac_first_torch", "ac_refine_torch"}
    for r, g in zip(ref, got):
        assert r.ok and g.ok, g.error
        np.testing.assert_array_equal(g.rgb.numpy(), np.asarray(r.rgb))


def test_sharded_kernel_failure_is_the_items_error(monkeypatch):
    """decode_batch_sharded: a progressive frame whose kernel fails (its
    wrapper raises as a failed build or launch does) is that image's error,
    not a quiet host decode; the other items decode."""
    def broken(*a, **k):
        raise RuntimeError("entropy_prog.cu: nvcc failed")

    monkeypatch.setattr(k8, "dc_first_torch", broken)
    good = encode(_rgb(9, 40, 48), quality=90)[0]
    got = sharded.decode_batch_sharded([good, FRAMES["dri3"]()], "cpu",
                                       idct="pallas")
    timing = sharded.decode_batch_sharded.last_timing
    assert got[0].ok
    assert isinstance(got[1].error, RuntimeError), got[1].error
    assert (timing["progressive"], timing["progressive_fallback"],
            timing["host_fallback"]) == (1, 0, 0)


def _corrupt_scan(blob: bytes, k: int) -> bytes:
    """Scan ``k``'s first 12 entropy bytes as stuffed 0xFF bytes: 96 one
    bits, a window no standard code takes."""
    pos = -1
    for _ in range(k + 1):
        pos = blob.index(b"\xff\xda", pos + 1)
    start = pos + 2 + int.from_bytes(blob[pos + 2:pos + 4], "big")
    return blob[:start] + b"\xff\x00" * 12 + blob[start + 12:]


def _truncated(blob: bytes) -> bytes:
    """The stream cut inside the last scan (EOI kept)."""
    pos = blob.rindex(b"\xff\xda")
    return blob[:pos + (len(blob) - pos) // 3] + b"\xff\xd9"


BAD = {
    "corrupt_dc_first": lambda: _corrupt_scan(FRAMES["420_dri0"](), 0),
    "corrupt_ac_first": lambda: _corrupt_scan(FRAMES["420_dri0"](), 2),
    "corrupt_restart": lambda: _corrupt_scan(FRAMES["dri3"](), 2),
    "truncated": lambda: _truncated(FRAMES["420_dri0"]()),
}


@pytest.mark.parametrize("case", list(BAD))
def test_bad_stream_raises_and_stays_isolated(case, mesh):
    """A corrupt or truncated progressive stream: decode() under pallas
    raises JPEGError; in BatchDecoder it is that item's error, in
    decode_batch_sharded it leaves the lanes for the host fallback (with
    JAX's outcome there), and the good items decode."""
    blob = BAD[case]()
    with pytest.raises(JPEGError):
        decode(blob, entropy="pallas", idct="pallas", device="cpu")
    good = FRAMES["dri4"]()
    with tbatch.BatchDecoder(device="cpu", entropy="pallas",
                             idct="pallas") as bd:
        got = bd.decode([blob, good])
    assert isinstance(got[0].error, JPEGError) and got[1].ok
    ref = jsharded.decode_batch_sharded([good, blob], mesh, idct="pallas")
    got = sharded.decode_batch_sharded([good, blob], "cpu", idct="pallas")
    timing = sharded.decode_batch_sharded.last_timing
    assert timing["progressive_fallback"] == 1 and got[0].ok
    assert got[1].ok == ref[1].ok
    np.testing.assert_array_equal(got[0].rgb.numpy(), np.asarray(ref[0].rgb))


def test_wrong_lane_start_is_flagged(monkeypatch):
    """A skeleton lane that starts one bit late: the lane before it cannot
    end there and it decodes from a wrong position, so decode() raises
    instead of giving wrong planes."""
    real = ep.hybrid_scan_prep

    def shifted(hdr, scan, nzmaps, **kw):
        lanes = real(hdr, scan, nzmaps, **kw)
        if lanes is not None and len(lanes[0]) > 2 and scan.ss:
            base = lanes[0].copy()
            gaps = np.diff(np.append(base, len(scan.data) * 8))
            base[1 + int(np.argmax(gaps[1:]))] += 1   # still in order
            lanes = (base,) + lanes[1:]
        return lanes

    monkeypatch.setattr(ep, "hybrid_scan_prep", shifted)
    monkeypatch.setenv("JD_PROG_LANES", "8")
    with pytest.raises(JPEGError, match="progressive"):
        decode(FRAMES["420_dri0"](), entropy="hybrid", device="cpu")


# ---------------------------------------------------------------------------
# The kernels' wrappers on the CPU (their plain versions)
# ---------------------------------------------------------------------------

def _scan_args(frame="dri0", k=1):
    hdr = tparser.parse(FRAMES[frame]())
    scan = hdr.scans[k]
    assert scan.ss >= 1
    return hdr, scan, ep.scan_units(hdr, scan), len(scan.data) * 8


@pytest.mark.parametrize("bad", ["sum", "order", "first", "bits_order",
                                 "bits_outside", "chain_gap", "shape"])
def test_lane_table_refuses_plans_that_do_not_tile(bad):
    hdr, scan, n, bits = _scan_args()
    base = np.array([0, 40, 80], np.int64)
    n_per = np.array([n // 3, n // 3, n - 2 * (n // 3)], np.int32)
    first = np.array([0, n // 3, 2 * (n // 3)], np.int64)
    kw = dict(n_units=n, scan_bits=bits, chained=True)
    k8.lane_table(base, n_per, first, **kw)        # the good plan
    end = None
    if bad == "sum":
        n_per[-1] += 1
    elif bad == "order":
        first = first[[0, 2, 1]]
    elif bad == "first":
        first = first + 1
    elif bad == "bits_order":
        base = base[[0, 2, 1]]
    elif bad == "bits_outside":
        base[-1] = bits + 1
    elif bad == "chain_gap":
        end = np.array([30, 80, bits], np.int64)
    else:
        n_per = n_per[:2]
    with pytest.raises(ValueError):
        k8.lane_table(base, n_per, first, end=end, **kw)


def test_wrappers_refuse_big_scans_and_short_pools():
    hdr, scan, n, bits = _scan_args()
    with pytest.raises(JPEGError, match="2\\^31"):
        k8.lane_table([0], [n], [0], n_units=n, scan_bits=1 << 31,
                      chained=True)
    lanes = k8.lane_table([0], [n], [0], n_units=n, scan_bits=bits,
                          chained=True)
    cis, geom = ep.scan_geometry(hdr, scan)
    plane = torch.zeros((geom.n_rows[0] + 1, 64), dtype=torch.int32)
    lut = torch.zeros((1, 1 << 16), dtype=torch.int32)
    words = torch.from_numpy(ep.scan_words(scan))
    with pytest.raises(ValueError, match="word pool"):
        k8.ac_first(words[:-1], lanes, lut, plane, geom, ss=scan.ss,
                    se=scan.se, al=scan.al)
    with pytest.raises(TypeError, match="plane"):
        k8.ac_first(words, lanes, lut, plane[:-1], geom, ss=scan.ss,
                    se=scan.se, al=scan.al)
    with pytest.raises(ValueError, match="do not fit"):
        k8.ac_first(words, k8.lane_table([0], [n + 64], [0], n_units=n + 64,
                                         scan_bits=bits, chained=True),
                    lut, plane, geom, ss=scan.ss, se=scan.se, al=scan.al)


@pytest.mark.parametrize("kind", ["first", "refine"])
def test_ac_refuses_a_misaligned_plane(kind):
    """K8c/K8d take a plane that starts on a 16-byte boundary (K8d's warp
    form loads rows 8 bytes at a time): a contiguous view of the right
    shape at an element offset that is not a multiple of 4 is refused
    before any launch, and the same plane at an aligned start is taken."""
    hdr, scan, n, bits = _scan_args()
    lanes = k8.lane_table([0], [n], [0], n_units=n, scan_bits=bits,
                          chained=True)
    cis, geom = ep.scan_geometry(hdr, scan)
    rows = geom.n_rows[0] + 1
    lut = torch.from_numpy(build_lut(
        scan.ac_specs[scan.ac_table_ids[0]]).copy())[None]
    words = torch.from_numpy(ep.scan_words(scan))
    fn = k8.ac_first if kind == "first" else k8.ac_refine
    store = torch.zeros(rows * 64 + 4, dtype=torch.int32)
    aligned = -(store.data_ptr() % 16) // 4 % 4
    for off in ((aligned + d) % 4 for d in (1, 2, 3)):
        plane = store[off:off + rows * 64].view(rows, 64)
        assert plane.is_contiguous() and plane.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte"):
            fn(words, lanes, lut, plane, geom, ss=scan.ss, se=scan.se,
               al=scan.al)
    plane = store[aligned:aligned + rows * 64].view(rows, 64)
    assert plane.data_ptr() % 16 == 0
    err = fn(words, lanes, lut, plane, geom, ss=scan.ss, se=scan.se,
             al=scan.al)
    assert err.shape == (1,)


@pytest.mark.parametrize("field", ["eob0", "base", "dc_pred0", "dc_base"])
def test_chained_lane_end_state_is_checked(field):
    """Skeleton lanes of an AC-first scan with the second lane's recorded
    EOB run or start bit off by one, and of the DC first scan with its
    recorded luma predictor or start bit off by one: the first lane is
    flagged (it cannot end at the next lane's start), which JAX's lanes do
    not check."""
    hdr = tparser.parse(FRAMES["420_dri0"]())
    dc = field.startswith("dc_")
    nzmaps: dict = {}
    for scan in hdr.scans:
        lanes = ep.hybrid_scan_prep(hdr, scan, nzmaps, target_lanes=6)
        if (scan.ss == 0) == dc and scan.ah == 0:
            break
    base, n_per, first, eob0, pred0 = (a.copy() for a in lanes)
    n = ep.scan_units(hdr, scan)
    cis, geom = ep.scan_geometry(hdr, scan)
    args = dict(n_units=n, scan_bits=len(scan.data) * 8, chained=True)
    words = torch.from_numpy(ep.scan_words(scan))
    if dc:
        luts = torch.from_numpy(np.stack([build_lut(
            scan.dc_specs[t]) for t in scan.dc_table_ids]))
    else:
        lut = torch.from_numpy(build_lut(
            scan.ac_specs[scan.ac_table_ids[0]]).copy())[None]

    def run(b, e, p):
        lt = k8.lane_table(b, n_per, first, eob0=e, pred0=p, **args)
        planes = [torch.zeros((geom.n_rows[i] + 1, 64), dtype=torch.int32)
                  for i in range(len(cis))]
        if dc:
            return k8.dc_first(words, lt, luts, planes, geom, al=scan.al)
        return k8.ac_first(words, lt, lut, planes[0], geom, ss=scan.ss,
                           se=scan.se, al=scan.al)

    assert len(base) > 2
    assert not run(base, eob0, pred0).any()
    if field == "eob0":
        eob0[1] += 1
    elif field == "dc_pred0":
        pred0[1, 0] += 1
    else:
        base[1] += 1
    err = run(base, eob0, pred0)
    assert err[0] == 1


# ---------------------------------------------------------------------------
# The device default
# ---------------------------------------------------------------------------

def test_device_defaults_to_the_card(monkeypatch):
    """Without ``device`` the progressive lane functions and
    decode_to_planes under a device backend decode on the card, and raise
    like routing.resolve_device where there is none; the host backends
    need no card."""
    from jpeg_decoder_tpu_torch.models import decoder as tdecoder
    from jpeg_decoder_tpu_torch.models.routing import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device(None)
    blob = FRAMES["dri0"]()
    calls = [lambda h: ep.decode_progressive_device(h),
             lambda h: ep.decode_progressive_hybrid(h),
             lambda h: ep.decode_progressive_lanes(h),
             lambda h: tdecoder.decode_to_planes(h, entropy="pallas"),
             lambda h: tdecoder.decode_to_planes(h, entropy="hybrid")]
    for call in calls:
        with pytest.raises(RuntimeError) as got:
            call(tparser.parse(blob))
        assert str(got.value) == str(want.value)
    ref = tprog.decode_progressive(tparser.parse(blob))
    for entropy in ("native", "python", "auto"):
        _assert_planes(tdecoder.decode_to_planes(tparser.parse(blob),
                                                 entropy=entropy), ref)


# ---------------------------------------------------------------------------
# Single AC scans over any band (testing/ac_scan.py)
# ---------------------------------------------------------------------------

from jpeg_decoder_tpu.types import HuffmanSpec as JHuffmanSpec  # noqa: E402
from jpeg_decoder_tpu_torch.testing import ac_scan  # noqa: E402
from jpeg_decoder_tpu_torch.testing.encoder import \
    encode as tencode  # noqa: E402

# (ss, se, al, table): partial bands, each al 0-3, codes over 11 bits, a
# table with more long-code prefixes than K8c/K8d keep.
BANDS = [(1, 5, 0, "flat"), (6, 63, 1, "long"), (2, 2, 2, "flat"),
         (63, 63, 3, "long"), (1, 63, 0, "long"), (1, 63, 3, "flat"),
         (1, 63, 2, "wide")]


def _band_case(kind, ss, se, al, table, seed):
    """``testing/ac_scan.band_case`` and the same scan for JAX: ((port
    hdr, JAX hdr), (port scan, JAX scan), prior, post, lanes, written)."""
    case = ac_scan.band_case(kind, ss, se, al, table, seed)
    jh = jparser.parse(tencode(np.full((72, 88), 128, np.uint8),
                               grayscale=True, samplings=((1, 1),))[0])
    w = case.written
    ac_scan.set_scan(jh.scans[0], w, kind, ss, se, al,
                     spec=JHuffmanSpec(1, 0, w.spec.counts.copy(),
                                       w.spec.symbols.copy()))
    return ((case.hdr, jh), (case.scan, jh.scans[0]), case.prior, case.post,
            case.lanes, w)


def _rows1(plane):
    return np.concatenate([plane, np.zeros((1, 64), np.int32)])


@pytest.mark.parametrize("kind", ["first", "refine"])
@pytest.mark.parametrize("case", range(len(BANDS)))
def test_band_scans_match_jax_and_oracle(kind, case):
    """One written AC scan over a partial band (or the whole band at al
    3), with EOB runs that cross lane edges: the port's oracle, JAX's
    ``decode_ac_first``/``decode_ac_refine`` (through its
    ``apply_scan_device`` with the same chained lanes), the port's plain
    versions through ``apply_scan_device`` and the wrappers on the CPU
    all give the planes the scan was written for, with no lane flagged."""
    import jax.numpy as jnp

    ss, se, al, table = BANDS[case]
    (th, jh), (ts, js), prior, post, lanes, acs = _band_case(
        kind, ss, se, al, table, seed=case + 10 * (kind == "refine"))
    assert (acs.eobs > 0).any() and len(lanes[0]) > 2
    rows, cols = 9, 11
    oracle = prior.reshape(rows, cols, 64).astype(np.int64)
    fn = tprog._ac_first_scan if kind == "first" else tprog._ac_refine_scan
    fn(th, ts, oracle)
    np.testing.assert_array_equal(oracle.reshape(-1, 64), post)
    got = ep.apply_scan_device(th, ts, [torch.from_numpy(_rows1(prior))],
                               lanes=lanes)
    np.testing.assert_array_equal(got[0][:-1].numpy(), post)
    errs: list = []
    ref = jep.apply_scan_device(jh, js, [jnp.asarray(_rows1(prior))],
                                lanes=lanes, err_sink=errs)
    assert not any(bool(np.asarray(e).any()) for e in errs)
    np.testing.assert_array_equal(np.asarray(ref[0])[:-1], post)
    inp = ep.scan_inputs(th, ts, lanes, "cpu")
    plane = torch.from_numpy(_rows1(prior))
    wrapper = k8.ac_first if kind == "first" else k8.ac_refine
    err = wrapper(inp.words, inp.lanes, inp.luts, plane, inp.geom, ss=ss,
                  se=se, al=al)
    assert not err.any()
    np.testing.assert_array_equal(plane[:-1].numpy(), post)


@pytest.mark.parametrize("case", [0, 1, 4])
def test_history_masks_match_jax_nextp(case):
    """K8d's mask build (its plain version) against JAX's
    ``_refine_emit_prep``: each block's band positions with history and
    ``nextp``, on a written refinement's prior plane."""
    ss, se, al, table = BANDS[case]
    (th, _), (ts, _), prior, _, _, _ = _band_case("refine", ss, se, al,
                                                  table, seed=40 + case)
    n = prior.shape[0]
    _, geom = ep.scan_geometry(th, ts)
    masks, nextp = k8.history_masks_torch(torch.from_numpy(_rows1(prior)),
                                          geom, n, ss=ss, se=se)
    zz_m, jnextp = jep._refine_emit_prep(
        np.asarray(_rows1(prior)), ss=ss, se=se, cols_u=11, plane_cols=11,
        n_blocks=n)
    zz = np.asarray(zz_m)[:n, :]
    want = np.zeros(n, np.uint64)
    for k in range(ss, se + 1):
        want |= (zz[:, k] != 0).astype(np.uint64) << np.uint64(k)
    np.testing.assert_array_equal(masks.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(nextp.numpy(),
                                  np.asarray(jnextp)[:n + 1])
    assert (nextp.numpy()[:-1] > np.arange(n)).any()


def _dc_frame_luts():
    """Every DC table of the FRAMES fixtures' DC first scans, per scan."""
    out = []
    for make in FRAMES.values():
        hdr = tparser.parse(make())
        out += [[build_lut(s.dc_specs[t]) for t in s.dc_table_ids]
                for s in hdr.scans if s.ss == 0 and s.ah == 0]
    return out


def _probe_compact(l1, l2, full: bool, lut):
    """Every 16-bit window probed as K8a/K8c/K8d probe their compact
    tables: the first level, a second level, or (``full``: prefixes left
    out) the LUT; with the mask of the probes that read the LUT."""
    p = np.arange(1 << 16)
    e = l1[p >> 5]
    probe = np.where(e > 0, e, 0)
    in_l2 = e < 0
    probe[in_l2] = l2[-e[in_l2] - 1, p[in_l2] & 31]
    missed = (e == 0) & (lut != 0)
    if full:
        probe[missed] = lut[missed]
    return probe, missed


@pytest.mark.parametrize("table", ["flat", "long", "wide", "standard",
                                   "dc_frames", "dc_long", "dc_wide"])
def test_compact_table_probes_like_the_lut(table):
    """K8c/K8d's compact table (``entropy_prog_cuda.compact_table``) and
    K8a's set of a scan's DC tables (``dc_tables``: every DC table of the
    FRAMES fixtures, and dc_scan.py's long and wide tables for three
    components), probed as the kernels probe them, give every 16-bit window
    the LUT's length and symbol; the prefixes they leave out (more
    long-code prefixes than the second levels) are exactly the probes the
    kernels send to the full LUT."""
    from jpeg_decoder_tpu_torch.testing import dc_scan
    from jpeg_decoder_tpu_torch.testing.encoder import STD_AC_LUMA

    if table.startswith("dc_"):
        sets = _dc_frame_luts() if table == "dc_frames" else \
            [[build_lut(dc_scan.dc_spec(table[3:]))] * 3]
        for luts in sets:
            got = k8.dc_tables(luts)
            assert k8.dc_tables(luts) is got        # memoised per LUT set
            tab = np.asarray(got.tab).astype(np.int32)
            nsc = len(luts)
            l2 = tab[nsc << 11:].reshape(-1, 32)
            assert len(l2) == got.n_slots <= k8.AC_L2_SLOTS
            for c, lut in enumerate(luts):
                full = bool(got.l2_full >> c & 1)
                probe, missed = _probe_compact(
                    tab[c << 11:(c + 1) << 11], l2, full, lut)
                assert bool(missed.any()) == full == (table == "dc_wide")
                np.testing.assert_array_equal(probe & 0x1FFF, lut & 0x1FFF)
        return
    if table == "standard":
        spec = STD_AC_LUMA
    else:
        spec = ac_scan.band_case("first", 1, 63, 0, table, seed=3).written.spec
    lut = build_lut(spec)
    got = k8.compact_table(lut)
    assert k8.compact_table(lut) is got            # memoised per LUT
    tab = np.asarray(got.tab).astype(np.int32)
    l1, l2 = tab[:1 << 11], tab[1 << 11:].reshape(-1, 32)
    assert len(l2) == got.n_slots <= k8.AC_L2_SLOTS
    probe, missed = _probe_compact(l1, l2, True, lut)
    assert bool(missed.any()) == got.l2_full == (table == "wide")
    np.testing.assert_array_equal(probe & 0x1FFF, lut & 0x1FFF)


@pytest.mark.parametrize("kind", ["long", "wide"])
def test_dc_scan_writer_matches_jax_and_oracle(kind):
    """testing/dc_scan.py's DC first scans with codes over 11 bits (the
    "wide" table with more long-code prefixes than K8a keeps): the port's
    lanes (segment and skeleton), JAX's ``apply_scan_device`` and the
    oracle's posterior planes are equal."""
    import jax.numpy as jnp

    from jpeg_decoder_tpu_torch.testing import dc_scan

    blob = FRAMES["420_dri0"]()
    th, jh = tparser.parse(blob), jparser.parse(blob)
    k = 0
    assert th.scans[k].ss == 0 and th.scans[k].ah == 0
    before = _flat(_oracle_after(th, k))
    after = _flat(_oracle_after(th, k + 1))
    spec = dc_scan.dc_spec(kind)
    scan = dc_scan.rewrite_dc_first(th, th.scans[k], after, spec)
    jscan = jh.scans[k]
    jscan.data, jscan.seg_offsets = scan.data, scan.seg_offsets
    jscan.data_padded = None
    jscan.dc_specs = {t: JHuffmanSpec(0, t, spec.counts, spec.symbols)
                      for t in jscan.dc_table_ids}
    ref = jep.apply_scan_device(jh, jscan, [jnp.asarray(p) for p in before])
    _assert_planes([np.asarray(r)[:-1] for r in ref],
                   [a[:-1] for a in after], "jax")
    for lanes in (None, ep.hybrid_scan_prep(th, scan, {}, target_lanes=7)):
        got = ep.apply_scan_device(
            th, scan, [torch.from_numpy(p.copy()) for p in before],
            lanes=lanes)
        _assert_planes(got, after, "port")
    assert k8.dc_tables([build_lut(spec)] * 3).l2_full == (
        0b111 if kind == "wide" else 0)


def test_dc_form_and_budget_by_lane_count():
    """K8a runs one warp per lane up to DC_WARP_LANES_MAX lanes and one
    thread per lane beyond: one lane, the restart fixture's 68 segment
    lanes (120 MCUs of six blocks each) and 1080p (a)'s 4,080 skeleton
    lanes at 4,096 target lanes (two MCUs each), and lanes with empty ones
    among them; its grid is a CTA per lane up to what fits on the card
    (then the CTAs walk the lanes in turn) or a CTA per 32 lanes; its
    staging budget follows the form; a form it lacks is refused."""
    from jpeg_decoder_tpu_torch.testing import photo

    def dc_lanes(name, target):
        hdr = tparser.parse(photo.fixture(name)[0])
        scan = hdr.scans[0]
        assert scan.ss == 0 and scan.ah == 0 and len(scan.comp_indices) == 3
        lanes = None if target is None else \
            ep.hybrid_scan_prep(hdr, scan, {}, target_lanes=target)
        return ep.scan_inputs(hdr, scan, lanes, "cpu").lanes

    one = dc_lanes("progressive_1080p_a.jpg", 1)
    seg = dc_lanes("progressive_1080p_dri.jpg", None)
    many = dc_lanes("progressive_1080p_a.jpg", 4096)
    assert (one.n, seg.n, many.n) == (1, 68, 4080)
    assert seg.max_units == 120 and many.max_units == 2
    assert not seg.chained and many.chained
    resident = 132 * 24
    for lanes, threads, grid in ((one, False, 1), (seg, False, 68),
                                 (many, True, 128)):
        assert k8.dc_use_threads(lanes) == threads
        assert k8.dc_grid(lanes, threads, resident) == grid
        assert k8.dc_budget_words(lanes, threads) == min(
            k8.AC_MAX_BUDGET, -(-((lanes.max_group_bits if threads
                                   else lanes.max_bits) // 32 + 12) // 4) * 4)
    assert k8.dc_grid(many, False, resident) == resident   # CTAs walk lanes
    assert k8.dc_budget_words(one, False) == k8.AC_MAX_BUDGET  # one long lane
    assert not k8.dc_use_threads(many, "warp")
    assert k8.dc_use_threads(seg, "thread")
    # Empty lanes (no units, no bits) among lanes of one unit each.
    n = k8.DC_WARP_LANES_MAX + 1
    n_per = np.arange(n, dtype=np.int32) % 2
    first = np.concatenate([[0], np.cumsum(n_per)[:-1]]).astype(np.int64)
    base = first * 16
    empty = k8.lane_table(base, n_per, first, n_units=int(n_per.sum()),
                          scan_bits=int(n_per.sum()) * 16, chained=True)
    assert k8.dc_use_threads(empty)
    assert k8.dc_grid(empty, True, resident) == -(-n // 32)
    assert k8.dc_budget_words(empty, True) == 20   # 32 lanes: 8 words + 12
    hdr = tparser.parse(FRAMES["dri0"]())
    scan = hdr.scans[0]
    args = ep.scan_inputs(hdr, scan, None, "cpu")
    planes = [torch.zeros((g + 1, 64), dtype=torch.int32)
              for g in args.geom.n_rows]
    with pytest.raises(ValueError, match="form"):
        k8._dc_first(args.words, args.lanes, args.luts, planes, args.geom,
                     scan.al, args.dc_table, form="block")


def test_ac_form_and_budget_by_lane_count():
    """K8c runs one warp per lane up to WARP_LANES_MAX lanes and one thread
    per lane beyond, K8d one warp per lane at any count; the staging budget
    follows the form (a lane's words, or 32 lanes' words, capped), and a
    form the kernel lacks is refused."""
    def lanes(n, bits_each):
        base = np.arange(n, dtype=np.int64) * bits_each
        return k8.lane_table(base, np.ones(n, np.int32),
                             np.arange(n, dtype=np.int64), n_units=n,
                             scan_bits=n * bits_each, chained=True)

    few, many = lanes(k8.WARP_LANES_MAX, 64), lanes(k8.WARP_LANES_MAX + 1, 64)
    assert not k8.use_threads(False, few) and k8.use_threads(False, many)
    assert not k8.use_threads(True, few) and not k8.use_threads(True, many)
    hdr, scan, n, bits = _scan_args()
    cis, geom = ep.scan_geometry(hdr, scan)
    one = k8.lane_table([0], [n], [0], n_units=n, scan_bits=bits,
                        chained=True)
    plane = torch.zeros((geom.n_rows[0] + 1, 64), dtype=torch.int32)
    lut = torch.zeros((1, 1 << 16), dtype=torch.int32)
    words = torch.from_numpy(ep.scan_words(scan))
    for refine, form in ((True, "thread"), (False, "block")):
        with pytest.raises(ValueError, match="form"):
            k8._ac(refine, words, one, lut, plane, geom, 1, 63, 0,
                   form=form)
    assert k8.budget_words(few) == 12            # 64 bits: 2 words + 8
    assert k8.budget_words(few, True) == 72      # 32 lanes: 64 words + 8
    huge = lanes(40, 1 << 20)
    assert k8.budget_words(huge) == k8.AC_MAX_BUDGET
    assert k8.budget_words(huge, True) == k8.AC_MAX_BUDGET
