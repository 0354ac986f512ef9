"""The port's device-entropy batch route against the JAX package's.

The same seeded blobs (tools/encoder.py and PIL) go through
``jpeg_decoder_tpu.parallel.sharded.decode_batch_sharded`` on a 1x1 CPU
mesh and the port's ``decode_batch_sharded(device="cpu")``, where every
kernel runs its plain version: the RGB of every item is equal under
``idct="pallas"``, within the +-1 IDCT bound (+-2 after the colour
transform, >= 99.99% equal) under ``"kron"``, and under ``"exact"`` equal
to the JAX package's strict ``decode()`` byte for byte (the JAX batch runs
``exact`` jitted, which may differ from strict by 1; the port has no jitted
form) and within 1 of the JAX batch; failures stay on the same items.  One
case per route of the JAX function: uniform DRI 0, uniform restart streams
under and over ``JD_RESTART_EMIT_MAX_LANES``, a geometry bucket of several
sizes, table sets and DRIs, a 12-bit frame, CMYK and Adobe RGB frames, a
progressive frame (host fallback here), a corrupt stream and a failed walk.
Also K7's plain version with per-image table sets and geometry against the
JAX bucketed emission step, and which kernel each route takes.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu.entropy import native as jnative  # noqa: E402
from jpeg_decoder_tpu.io import parser as jparser  # noqa: E402
from jpeg_decoder_tpu.models import decoder as jdecoder  # noqa: E402
from jpeg_decoder_tpu.ops import entropy_flat as jflat  # noqa: E402
from jpeg_decoder_tpu.ops import entropy_spec as jspec  # noqa: E402
from jpeg_decoder_tpu.parallel import sharded as jsharded  # noqa: E402
from jpeg_decoder_tpu.types import ZIGZAG_INV  # noqa: E402

from jpeg_decoder_tpu_torch import decode  # noqa: E402
from jpeg_decoder_tpu_torch.entropy import native as tnative  # noqa: E402
from jpeg_decoder_tpu_torch.io import parser as tparser  # noqa: E402
from jpeg_decoder_tpu_torch.ops import entropy_cuda  # noqa: E402
from jpeg_decoder_tpu_torch.ops import entropy_emit_cuda  # noqa: E402
from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda  # noqa: E402
from jpeg_decoder_tpu_torch.ops import entropy_spec  # noqa: E402
from jpeg_decoder_tpu_torch.parallel import sharded  # noqa: E402

RGB_TOL = 2          # +-1 IDCT rounding times the x1.402 colour gain
MIN_EQUAL = 0.9999   # share of RGB samples that must match exactly


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seg"))


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


def _cmyk(seed, h, w, transform=0):
    rgb = _rgb(seed, h, w)
    return encode(rgb, raw_planes=[rgb[..., k % 3].astype(float)
                                   for k in range(4)],
                  samplings=((1, 1),) * 4, app14_transform=transform)[0]


def _corrupt(blob: bytes) -> bytes:
    """8 stuffed 0xFF bytes early in the entropy data: 64 one bits, a
    window no standard code takes."""
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
    return blob[:start + 4] + b"\xff\x00" * 8 + blob[start + 20:]


# One batch per route of the JAX function (4:2:0 unless named; sizes of a
# bucket share its power-of-two MCU grid).
CASES = {
    "uniform_dri0": lambda: [encode(_rgb(k, 48, 64), quality=90)[0]
                             for k in range(3)],
    "uniform_restart": lambda: [encode(_rgb(10 + k, 80, 64), quality=90,
                                       restart_interval=1)[0]
                                for k in range(3)],
    "bucket": lambda: [
        encode(_rgb(20, 48, 96), quality=90)[0],
        encode(_rgb(21, 40, 80), quality=75, restart_interval=8)[0],
        _pil(22, 64, 112, quality=85, optimize=True, subsampling=2),
        encode(_rgb(23, 56, 72), quality=90, restart_interval=3)[0],
        _pil(24, 48, 96, quality=70, optimize=True, subsampling=2)],
    "12bit": lambda: [encode(_rgb(30, 32, 48), precision=12, quality=90)[0],
                      encode(_rgb(31, 32, 48), precision=12, quality=90,
                             restart_interval=2)[0]],
    "cmyk_adobe": lambda: [_cmyk(40, 24, 40), _cmyk(41, 32, 56),
                           encode(_rgb(42, 40, 48), samplings=((1, 1),) * 3,
                                  app14_transform=0)[0],
                           encode(_rgb(43, 40, 48), samplings=((1, 1),) * 3,
                                  app14_transform=0)[0]],
    "progressive": lambda: [_pil(50, 40, 56, quality=85, progressive=True),
                            encode(_rgb(51, 40, 56), quality=90)[0]],
    "corrupt": lambda: [encode(_rgb(60 + k, 48, 64), quality=90)[0]
                        if k != 1 else
                        _corrupt(encode(_rgb(61, 48, 64), quality=90)[0])
                        for k in range(3)],
}


def _compare(jitems, titems, tol: str):
    """Items of the two packages: the same failures; RGB ``"equal"``,
    within ``"1"`` count, or within the ``"kron"`` bound (RGB_TOL and
    MIN_EQUAL)."""
    assert len(jitems) == len(titems)
    for j, t in zip(jitems, titems):
        assert (j.error is None) == (t.error is None), (j.error, t.error)
        assert t.index == j.index
        if j.error is not None:
            continue
        a = np.asarray(j.rgb).astype(np.int32)
        b = t.rgb.numpy().astype(np.int32)
        assert a.shape == b.shape and t.rgb.dtype == {
            np.uint8: torch.uint8, np.uint16: torch.uint16}[
                np.asarray(j.rgb).dtype.type]
        d = np.abs(a - b)
        if tol == "equal":
            assert d.max() == 0, (t.index, int(d.max()))
        elif tol == "1":
            assert d.max() <= 1, (t.index, int(d.max()))
        else:
            assert d.max() <= RGB_TOL and (d == 0).mean() >= MIN_EQUAL


@pytest.mark.parametrize("idct", ["pallas", "exact", "kron"])
@pytest.mark.parametrize("case", list(CASES))
def test_routes_match_jax(mesh, case, idct):
    blobs = CASES[case]()
    ref = jsharded.decode_batch_sharded(blobs, mesh, idct=idct,
                                        upsample="fancy")
    got = sharded.decode_batch_sharded(blobs, "cpu", idct=idct,
                                       upsample="fancy")
    _compare(ref, got, {"pallas": "equal", "exact": "1",
                        "kron": "kron"}[idct])
    if idct == "exact":
        for blob, it in zip(blobs, got):
            if it.ok:
                strict = jdecoder.decode(blob, idct="exact", strict=True,
                                         upsample="fancy").rgb
                np.testing.assert_array_equal(it.rgb.numpy(),
                                              np.asarray(strict))
    if case == "corrupt":
        assert [it.ok for it in got] == [True, False, True]
    else:
        assert all(it.ok for it in got)


@pytest.mark.parametrize("max_lanes", ["8", "40"])
def test_wide_restart_group_takes_k2(mesh, monkeypatch, max_lanes):
    """Restart streams over JD_RESTART_EMIT_MAX_LANES, read by both
    packages: at 8 each image's 20 segments exceed it (the exact-geometry
    route), at 40 only the group's 60 do (the bucketed route's uniform
    special case); both take K2 in one launch and equal JAX."""
    monkeypatch.setenv("JD_RESTART_EMIT_MAX_LANES", max_lanes)
    blobs = CASES["uniform_restart"]()
    ref = jsharded.decode_batch_sharded(blobs, mesh, idct="pallas")
    got = sharded.decode_batch_sharded(blobs, "cpu", idct="pallas")
    _compare(ref, got, "equal")
    assert [g["route"] for g in sharded.decode_batch_sharded.last_timing[
        "groups"]] == ["k2"]


def test_spec_route_matches_jax(mesh, monkeypatch):
    """JD_DEVICE_ENTROPY=spec: DRI-0 groups take K2 over one segment per
    image (JAX: its speculative lanes), restart groups K2; a corrupt
    stream stays its own error."""
    monkeypatch.setenv("JD_DEVICE_ENTROPY", "spec")
    blobs = CASES["corrupt"]() + CASES["uniform_restart"]()[:2]
    ref = jsharded.decode_batch_sharded(blobs, mesh, idct="pallas")
    got = sharded.decode_batch_sharded(blobs, "cpu", idct="pallas")
    _compare(ref, got, "equal")
    assert [it.ok for it in got] == [True, False, True, True, True]
    assert sorted(g["route"] for g in sharded.decode_batch_sharded
                  .last_timing["groups"]) == ["k2", "spec"]


@pytest.mark.parametrize("case", ["uniform_dri0", "bucket"])
def test_failed_walk_falls_back_per_image(mesh, monkeypatch, case):
    """The skeleton walk of one image fails (both packages' emit_prep
    raise for it): that row decodes again on the host, equal to JAX's
    fallback and to decode(); its group mates stay on the device."""
    blobs = CASES[case]()
    victim = len(tparser.parse(blobs[1]).scans[0].data)
    for mod, err in ((jnative, jnative.JPEGError),
                     (tnative, tnative.JPEGError)):
        real = mod.emit_prep

        def fail(hdr, scan, *a, _real=real, _err=err, **k):
            if len(scan.data) == victim:
                raise _err("walk failed")
            return _real(hdr, scan, *a, **k)
        monkeypatch.setattr(mod, "emit_prep", fail)
    ref = jsharded.decode_batch_sharded(blobs, mesh, idct="pallas")
    got = sharded.decode_batch_sharded(blobs, "cpu", idct="pallas")
    _compare(ref, got, "equal")
    assert all(it.ok for it in got)
    one = decode(blobs[1], idct="pallas", upsample="fancy", device="cpu")
    assert torch.equal(got[1].rgb, one.rgb)


def test_routes_take_the_named_kernels(monkeypatch):
    """Which kernel each group launches: a uniform DRI-0 group and a
    bucketed group K7 once each, a wide restart group K2 once, and the
    progressive frame the progressive lanes (K8a-K8d, once per scan of its
    kind), not the host fallback."""
    monkeypatch.setenv("JD_RESTART_EMIT_MAX_LANES", "40")
    calls = []
    for mod, fn in ((entropy_emit_cuda, "decode_lanes_torch"),
                    (entropy_cuda, "decode_segments_torch"),
                    *((entropy_prog_cuda, f"{k}_torch") for k in (
                        "dc_first", "dc_refine", "ac_first", "ac_refine"))):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _f=real, _n=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    blobs = (CASES["uniform_dri0"]() + CASES["bucket"]()
             + CASES["uniform_restart"]()
             + CASES["progressive"]()[:1])
    got = sharded.decode_batch_sharded(blobs, "cpu", idct="pallas")
    assert all(it.ok for it in got)
    timing = sharded.decode_batch_sharded.last_timing
    routes = sorted(g["route"] for g in timing["groups"])
    assert routes == ["dyn", "emit", "k2"]
    assert (timing["progressive"], timing["progressive_fallback"],
            timing["host_fallback"]) == (1, 0, 0)
    kinds = [(s.ss > 0, s.ah > 0)
             for s in tparser.parse(blobs[-1]).scans]
    assert sorted(calls) == sorted(
        ["decode_lanes_torch"] * 2 + ["decode_segments_torch"]
        + [{(False, False): "dc_first_torch", (False, True):
            "dc_refine_torch", (True, False): "ac_first_torch",
            (True, True): "ac_refine_torch"}[k] for k in kinds])
    dyn = [g for g in sharded.decode_batch_sharded.last_timing["groups"]
           if g["route"] == "dyn"][0]
    assert dyn["images"] == 5 and dyn["table_sets"] == 3


def _jax_dyn_blocks(plan, hdr0):
    """JAX's bucketed emission step on one device: decode_emit2 over every
    lane with its image's ``lut_base``, the scatter into scan order, then
    the DC prefix sum with segment starts from each image's DRI
    (jax sharded.py:793-840 without the mesh)."""
    hdrs = [jparser.parse(b) for b in plan["set_blobs"]]
    luts = np.concatenate([jflat.merged_luts(h, h.scans[0]) for h in hdrs])
    b, c = plan["starts"].shape
    w = plan["pools"].shape[1]
    bpm, nb = plan["bpm"], plan["n_mcus"]
    img_base = (np.arange(b, dtype=np.int32) * (w * 32))[:, None]
    base_abs = jnp.asarray((img_base + plan["starts"]).reshape(-1))
    nblocks = jnp.asarray((plan["nm"] * bpm).reshape(-1))
    lutb = jnp.asarray(np.repeat(plan["lut_base"], c))
    pos, val, err, n_done = jflat.decode_emit2(
        jnp.asarray(plan["pools"].reshape(-1)), base_abs, nblocks,
        jnp.asarray(luts), lutb, block_comp=plan["block_comp"],
        n_comps=plan["n_comps"], T=plan["t_pair"],
        precision=hdr0.precision)
    pos = pos.reshape(-1, base_abs.shape[0])
    val = val.reshape(-1, base_abs.shape[0])
    img_out = (np.arange(b, dtype=np.int64) * (nb * bpm * 64))[:, None]
    out_off = jnp.asarray((img_out + plan["lane_off"]).reshape(-1)
                          .astype(np.int32))
    n_total = b * nb * bpm * 64
    flat_pos = jnp.where(pos >= 0, pos + out_off[None, :], n_total)
    out = jnp.zeros((n_total,), jnp.int32).at[flat_pos.reshape(-1)].add(
        val.reshape(-1), mode="drop").reshape(b, nb * bpm, 64)
    out = jnp.take(out, jnp.asarray(ZIGZAG_INV), axis=2)
    m = np.arange(nb, dtype=np.int32)
    blocks = []
    for k in range(b):
        ri = int(plan["ri"][k])
        seg_first = (m // max(ri, 1)) * ri if ri else np.zeros_like(m)
        blocks.append(jspec._dc_prefix_sum_seg(
            out[k].reshape(nb, bpm, 64), jnp.asarray(seg_first),
            block_comp=plan["block_comp"], n_comps=plan["n_comps"]))
    bad = (err | (n_done < nblocks)).reshape(b, c).any(1)
    return np.stack([np.asarray(x).reshape(nb * bpm, 64) for x in blocks]), \
        np.asarray(bad)


def test_plain_lanes_with_table_sets_match_jax_dyn_step():
    """decode_lanes_torch with per-image lut_base, n_mcus_img and ri (the
    bucket plan of sizes, three table sets and DRIs 0/3/8) equals JAX's
    bucketed emission step on every block of every image (and the native
    decoder), zeroes each image's rows past its blocks and the fill row
    (where JAX's prefix sum leaves DC sums that its gather never reads),
    and flags a set outside the stack and an n_mcus_img past the
    bucket."""
    blobs = CASES["bucket"]()
    thdrs = [tparser.parse(b) for b in blobs]
    plan = entropy_spec.plan_bucket_group(thdrs, [h.scans[0] for h in thdrs],
                                          threads=1)
    assert plan.skel_ok.all() and len(plan.sets) == 3
    assert sorted(plan.lut_base.tolist()) == plan.lut_base.tolist()
    luts, _ = entropy_cuda.device_table_stack(plan.sets, "cpu")
    bpm = len(entropy_spec._block_comp(thdrs[0]))
    rows = plan.n_mcus * bpm + 1
    args = tuple(torch.from_numpy(a) for a in (
        plan.pools, plan.starts, plan.nm_lane, plan.lane_off))
    per = dict(lut_base=torch.from_numpy(plan.lut_base),
               n_mcus_img=torch.from_numpy(plan.n_mcus_img),
               ri=torch.from_numpy(plan.ri))
    kw = dict(block_comp=entropy_spec._block_comp(thdrs[0]), n_comps=3,
              n_mcus=plan.n_mcus, trips=plan.trips, precision=8, rows=rows)
    got, err = entropy_emit_cuda.decode_lanes(*args, None, luts, **kw, **per)
    assert not err.any() and got.shape == (len(blobs), rows, 64)
    # JAX's step on the same plan (its paired kernel needs the paired trip
    # bound: the bucketed T2 of every image's plan).
    t_pair = max(entropy_spec.device_plan(h, [h.scans[0]], threads=1)[5]
                 for h in thdrs)
    keys = [entropy_cuda.table_key(h, h.scans[0]) for h in thdrs]
    set_blobs = [blobs[keys.index(entropy_cuda.table_key(h, s))]
                 for h, s in plan.sets]
    ref, bad = _jax_dyn_blocks(dict(
        set_blobs=set_blobs, starts=plan.starts,
        pools=plan.pools, nm=plan.nm_lane, lane_off=plan.lane_off,
        lut_base=plan.lut_base, ri=plan.ri, bpm=bpm, n_mcus=plan.n_mcus,
        block_comp=kw["block_comp"], n_comps=3, t_pair=t_pair), thdrs[0])
    assert not bad.any()
    for row, k in enumerate(plan.order):
        n = thdrs[k].mcus_x * thdrs[k].mcus_y * bpm
        np.testing.assert_array_equal(got[row, :n].numpy(), ref[row, :n])
        assert not got[row, n:].any()
        np.testing.assert_array_equal(
            got[row, :n].numpy(),
            tnative.decode_scan_baseline(thdrs[k], thdrs[k].scans[0]))
    bad_set = per["lut_base"].clone()
    bad_set[1] = luts.shape[0] - 2
    bad_n = per["n_mcus_img"].clone()
    bad_n[2] = plan.n_mcus + 1
    for row, change in ((1, dict(lut_base=bad_set)),
                        (2, dict(n_mcus_img=bad_n))):
        _, err = entropy_emit_cuda.decode_lanes(
            *args, None, luts, **kw, **{**per, **change})
        assert err.tolist() == [int(k == row) for k in range(len(blobs))]


def test_plain_lanes_uniform_arguments_change_nothing():
    """The uniform route's call (seg_first, one set) and the same plan
    given as per-image arguments (ri, n_mcus_img, lut_base 0, no
    seg_first) give the same blocks."""
    blobs = CASES["uniform_restart"]()[:2]
    hdrs = [tparser.parse(b) for b in blobs]
    plan = entropy_spec.device_plan(hdrs[0], [h.scans[0] for h in hdrs],
                                    threads=1)
    luts = entropy_cuda.device_tables(hdrs[0], hdrs[0].scans[0], "cpu")[0]
    args = [torch.from_numpy(a) for a in plan[:4]]
    n_mcus = hdrs[0].mcus_x * hdrs[0].mcus_y
    kw = dict(block_comp=entropy_spec._block_comp(hdrs[0]), n_comps=3,
              n_mcus=n_mcus, trips=plan[4], precision=8)
    a, ea = entropy_emit_cuda.decode_lanes(
        *args, torch.from_numpy(plan[7]), luts, **kw)
    b, eb = entropy_emit_cuda.decode_lanes(
        *args, None, luts, **kw, lut_base=torch.zeros(2, dtype=torch.int32),
        n_mcus_img=torch.full((2,), n_mcus, dtype=torch.int32),
        ri=torch.full((2,), 1, dtype=torch.int32))
    assert not ea.any() and not eb.any() and torch.equal(a, b)


@pytest.mark.parametrize("change,err", [
    (dict(lut_base=torch.int64), TypeError),
    (dict(ri=torch.int16), TypeError),
    (dict(rows=1), ValueError),
])
def test_decode_lanes_checks_group_inputs(change, err):
    blobs = CASES["uniform_dri0"]()[:1]
    hdr = tparser.parse(blobs[0])
    plan = entropy_spec.device_plan(hdr, [hdr.scans[0]], threads=1)
    luts = entropy_cuda.device_tables(hdr, hdr.scans[0], "cpu")[0]
    per = dict(lut_base=torch.zeros(1, dtype=torch.int32),
               ri=torch.zeros(1, dtype=torch.int32), rows=None)
    for k, v in change.items():
        per[k] = per[k].to(v) if isinstance(v, torch.dtype) else v
    with pytest.raises(err):
        entropy_emit_cuda.decode_lanes(
            *(torch.from_numpy(a) for a in plan[:4]), None, luts,
            block_comp=entropy_spec._block_comp(hdr), n_comps=3,
            n_mcus=hdr.mcus_x * hdr.mcus_y, trips=plan[4], **per)


def test_decode_scan_and_planes_sharded_match_jax(mesh):
    blob = encode(_rgb(70, 48, 64), quality=90, restart_interval=2)[0]
    jhdr, thdr = jparser.parse(blob), tparser.parse(blob)
    np.testing.assert_array_equal(
        sharded.decode_scan_sharded(thdr, thdr.scans[0], "cpu"),
        jsharded.decode_scan_sharded(jhdr, jhdr.scans[0], mesh))
    for a, b in zip(sharded.decode_planes_sharded(thdr, "cpu"),
                    jsharded.decode_planes_sharded(jhdr, mesh)):
        np.testing.assert_array_equal(a, b)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded.decode_batch_sharded(CASES["uniform_dri0"]()[:1])
