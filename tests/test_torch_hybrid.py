"""The ``jax`` and ``hybrid`` entropy backends of the port against the JAX
package.

The same blobs, made from a numpy seed by tools/encoder.py, go through both
packages on the CPU:

* the port's ``native.emit_prep`` (the skeleton walk's lane plan) against
  JAX's, and ``ops/entropy_spec.prepare_hybrid_batch_emit`` against JAX's:
  equal arrays (the port's lane_off is int64, JAX's int32);
* the plain version of K7, ``entropy_emit_cuda.decode_lanes_torch``, against
  JAX's ``_hybrid_pipeline_batch_emit`` on the same plan, pools and LUTs:
  equal blocks and error flags;
* ``decode(entropy="jax"|"hybrid", device="cpu")`` against JAX's
  ``decode(entropy="jax"|"hybrid")`` at 8 and 12 bits, DRI 0 and DRI > 0,
  4:2:0, 4:4:4 and gray: equal planes, RGB within the tolerance of
  tests/test_torch_decoder.py (max |diff| <= 2 and >= 99.99% equal; the
  IDCT is ``pallas``, whose twin may round another way);
* a corrupt stream raising in both packages, and ``BatchDecoder`` under
  both backends against JAX's batch, one bad image isolated.

Images stay tiny: JAX compiles its device loops once per shape.  The CUDA
kernel K7 is held to its plain version on the card in
tests/test_torch_cuda.py.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu import JPEGError as JaxJPEGError  # noqa: E402
from jpeg_decoder_tpu.entropy import native as jnative  # noqa: E402
from jpeg_decoder_tpu.io import parser as jparser  # noqa: E402
from jpeg_decoder_tpu.models import batch as jbatch  # noqa: E402
from jpeg_decoder_tpu.models import decoder as jdecoder  # noqa: E402
from jpeg_decoder_tpu.ops import entropy_flat as jflat  # noqa: E402
from jpeg_decoder_tpu.ops import entropy_spec as jspec  # noqa: E402

from jpeg_decoder_tpu_torch import JPEGError, decode  # noqa: E402
from jpeg_decoder_tpu_torch.entropy import native as tnative  # noqa: E402
from jpeg_decoder_tpu_torch.io import parser as tparser  # noqa: E402
from jpeg_decoder_tpu_torch.models import batch as tbatch  # noqa: E402
from jpeg_decoder_tpu_torch.ops import entropy_cuda  # noqa: E402
from jpeg_decoder_tpu_torch.ops import entropy_emit_cuda  # noqa: E402
from jpeg_decoder_tpu_torch.ops import entropy_spec  # noqa: E402

RGB_TOL = 2          # +-1 IDCT rounding times the x1.402 colour gain
MIN_EQUAL = 0.9999   # share of RGB samples that must match exactly


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 6.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


# name -> (samplings or "gray", precision, restart_interval, (h, w))
KINDS = {
    "420_dri0": (((2, 2), (1, 1), (1, 1)), 8, 0, (40, 56)),
    "420_dri3": (((2, 2), (1, 1), (1, 1)), 8, 3, (37, 53)),
    "444_dri0": (((1, 1), (1, 1), (1, 1)), 8, 0, (24, 40)),
    "gray_dri2": ("gray", 8, 2, (24, 40)),
    "12bit_420_dri0": (((2, 2), (1, 1), (1, 1)), 12, 0, (32, 48)),
    "12bit_444_dri2": (((1, 1), (1, 1), (1, 1)), 12, 2, (24, 32)),
    "12bit_gray_dri0": ("gray", 12, 0, (24, 40)),
}


def _blob(name, seed=0):
    samp, precision, ri, (h, w) = KINDS[name]
    img = _rgb(seed + len(name), h, w)
    if samp == "gray":
        return encode(img[..., 1], grayscale=True, samplings=((1, 1),),
                      precision=precision, restart_interval=ri,
                      quality=85)[0]
    return encode(img, samplings=samp, precision=precision,
                  restart_interval=ri, quality=85)[0]


BLOBS = {name: _blob(name) for name in KINDS}


def _corrupt(blob: bytes) -> bytes:
    """Overwrite 8 bytes early in the entropy data with stuffed 0xFF bytes:
    64 one bits, a window no standard code takes."""
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
    return blob[:start + 8] + b"\xff\x00" * 8 + blob[start + 24:]


def _both(blob):
    jhdr, thdr = jparser.parse(blob), tparser.parse(blob)
    return jhdr, jhdr.scans[0], thdr, thdr.scans[0]


@pytest.mark.parametrize("name", list(KINDS))
def test_emit_prep_matches_jax(name):
    jhdr, jscan, thdr, tscan = _both(BLOBS[name])
    for kw in ({}, dict(max_chunks=4, target_steps=64, cap_factor=2)):
        ref = jnative.emit_prep(jhdr, jscan, **kw)
        got = tnative.emit_prep(thdr, tscan, **kw)
        for a, b in zip(got[:3], ref[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[3:] == ref[3:]


def test_emit_prep_refuses_what_c_cannot_hold():
    """A scan of 2^31 bits or more is refused before the C call (its start
    bits are int32); a corrupt stream raises JPEGError as in JAX."""
    thdr = tparser.parse(BLOBS["420_dri0"])
    scan = thdr.scans[0]
    huge = np.lib.stride_tricks.as_strided(scan.data[:1], shape=(1 << 28,),
                                           strides=(0,))
    big = copy.copy(scan)
    big.data = huge
    with pytest.raises(JPEGError, match="2\\^31"):
        tnative.emit_prep(thdr, big)
    bad = _corrupt(BLOBS["420_dri0"])
    jhdr, jscan, thdr, tscan = _both(bad)
    with pytest.raises(JaxJPEGError):
        jnative.emit_prep(jhdr, jscan)
    with pytest.raises(JPEGError):
        tnative.emit_prep(thdr, tscan)


PREP_SETS = {
    "420_dri0": ["420_dri0"],
    "420_dri3 x3": ["420_dri3"] * 3,
    "12bit_444_dri2": ["12bit_444_dri2"],
    "12bit_420_dri0 x2, one corrupt": ["12bit_420_dri0", "corrupt"],
}


def _scans(names, seed=0):
    """Same-geometry scans of ``names`` (each a KINDS name, "corrupt" for
    a corrupt copy of the first), through both parsers."""
    blobs = [_blob(names[0], seed + k) if n != "corrupt"
             else _corrupt(_blob(names[0], seed)) for k, n in
             enumerate(names)]
    jh, th = [jparser.parse(b) for b in blobs], [tparser.parse(b)
                                                 for b in blobs]
    return jh, th


@pytest.mark.parametrize("plan", ["jax", "device"])
@pytest.mark.parametrize("key", list(PREP_SETS))
def test_prepare_hybrid_batch_emit_matches_jax(key, plan):
    """The host plan equals JAX's, under JAX's defaults and under the
    port's device plan (the same function with ``target_steps`` =
    LANE_STEPS and no lane cap)."""
    jh, th = _scans(PREP_SETS[key])
    kw = {}
    if plan == "device":
        kw = dict(max_chunks=th[0].mcus_x * th[0].mcus_y,
                  target_steps=entropy_spec.LANE_STEPS)
    ref = jspec.prepare_hybrid_batch_emit(jh[0], [h.scans[0] for h in jh],
                                          **kw)
    if plan == "device":
        got = entropy_spec.device_plan(th[0], [h.scans[0] for h in th])
    else:
        got = entropy_spec.prepare_hybrid_batch_emit(
            th[0], [h.scans[0] for h in th])
    names = ("pools", "starts", "nm", "lane_off", "T", "T2", "C",
             "seg_first", "skel_ok")
    for name, a, b in zip(names, got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[3].dtype == np.int64 and got[1].dtype == np.int32
    assert got[-1].all() == ("corrupt" not in PREP_SETS[key])


def _lane_args(th, plan="jax"):
    """The port's plan of ``th`` (JAX's defaults, or the device plan) as
    K7's CPU inputs, and JAX's pipeline arguments on the same plan."""
    prep = (entropy_spec.device_plan if plan == "device"
            else entropy_spec.prepare_hybrid_batch_emit)
    (pools, starts, nm, lane_off, t_sym, t_pair, c, seg_first,
     _) = prep(th[0], [h.scans[0] for h in th])
    hdr, scan = th[0], th[0].scans[0]
    luts = entropy_cuda.device_tables(hdr, scan, "cpu")[0]
    args = tuple(torch.from_numpy(a) for a in (pools, starts, nm, lane_off,
                                               seg_first)) + (luts,)
    kw = dict(block_comp=entropy_spec._block_comp(hdr),
              n_comps=len(hdr.components), n_mcus=hdr.mcus_x * hdr.mcus_y,
              trips=t_sym, precision=hdr.precision)
    jargs = (jnp.asarray(pools), jnp.asarray(starts), jnp.asarray(nm),
             jnp.asarray(lane_off.astype(np.int32)), jnp.asarray(seg_first))
    return args, kw, jargs, (t_sym, t_pair, c)


@pytest.mark.parametrize("pair,plan", [(True, "jax"), (False, "jax"),
                                       (True, "device")])
@pytest.mark.parametrize("key", list(PREP_SETS))
def test_plain_lanes_match_jax_pipeline(key, pair, plan):
    """decode_lanes_torch equals JAX's emission pipeline (the paired
    kernel, its default, and the single-symbol one) on the same plan:
    blocks of every unflagged image and the flags (an image without lanes
    decodes to zeros unflagged in both)."""
    jh, th = _scans(PREP_SETS[key])
    args, kw, jargs, (t_sym, t_pair, c) = _lane_args(th, plan)
    blocks, err = entropy_emit_cuda.decode_lanes_torch(*args, **kw)
    jblocks, jbad = jspec._hybrid_pipeline_batch_emit(
        *jargs, jnp.asarray(jflat.merged_luts(jh[0], jh[0].scans[0])),
        block_comp=kw["block_comp"], n_comps=kw["n_comps"],
        T=t_pair if pair else t_sym, n_mcus=kw["n_mcus"], C=c,
        precision=kw["precision"], pair=pair)
    assert blocks.dtype == torch.int32 and err.dtype == torch.int32
    np.testing.assert_array_equal(err.numpy().astype(bool), np.asarray(jbad))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jblocks))


def test_plain_lanes_flag_short_trips_and_bad_plans():
    """Too few trips, a gap between two lanes and a lane crossing a restart
    segment start each flag the image; the others decode unchanged."""
    _, th = _scans(["420_dri3"] * 2)
    args, kw, _, _ = _lane_args(th)
    good, err = entropy_emit_cuda.decode_lanes_torch(*args, **kw)
    assert not err.any()
    _, err = entropy_emit_cuda.decode_lanes_torch(*args, **dict(kw, trips=9))
    assert err.all()
    nm, off = args[2].clone(), args[3].clone()
    nm[1, 0] -= 1                                    # a gap after lane 0
    got, err = entropy_emit_cuda.decode_lanes_torch(
        *args[:2], nm, *args[3:], **kw)
    assert err.tolist() == [0, 1] and torch.equal(got[0], good[0])
    # Lanes 0 and 1 of image 0 merged: one lane across a segment start.
    nm = args[2].clone()
    nm[0, 0] += nm[0, 1]
    nm[0, 1:-1] = nm[0, 2:].clone()
    nm[0, -1] = 0
    off[0, 1:-1] = off[0, 2:].clone()
    starts = args[1].clone()
    starts[0, 1:-1] = starts[0, 2:].clone()
    _, err = entropy_emit_cuda.decode_lanes_torch(
        args[0], starts, nm, off, *args[4:], **kw)
    assert err.tolist() == [1, 0]


def test_decode_lanes_cpu_path_is_plain_version():
    _, th = _scans(["420_dri0"])
    args, kw, _, _ = _lane_args(th)
    before = entropy_emit_cuda.decode_lanes.launches
    got = entropy_emit_cuda.decode_lanes(*args, **kw)
    assert entropy_emit_cuda.decode_lanes.launches == before
    ref = entropy_emit_cuda.decode_lanes_torch(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    np.testing.assert_array_equal(
        got[0][0].numpy(), tnative.decode_scan_baseline(th[0], th[0].scans[0]))


@pytest.mark.parametrize("change,err", [
    (dict(lane_off=torch.int32), TypeError),
    (dict(pools=torch.int32), TypeError),
    (dict(seg_first=torch.int64), TypeError),
    (dict(precision=10), ValueError),
    (dict(trips=-1), ValueError),
])
def test_decode_lanes_checks_inputs(change, err):
    _, th = _scans(["420_dri0"])
    args, kw, _, _ = _lane_args(th)
    names = ("pools", "starts", "nm_lane", "lane_off", "seg_first", "luts")
    named = dict(zip(names, args))
    for k, v in change.items():
        if k in named:
            named[k] = named[k].to(v)
        else:
            kw[k] = v
    with pytest.raises(err):
        entropy_emit_cuda.decode_lanes(*named.values(), **kw)


@pytest.mark.parametrize("entropy", ["jax", "hybrid"])
@pytest.mark.parametrize("name", list(KINDS))
def test_decode_matches_jax(name, entropy):
    ref = jdecoder.decode(BLOBS[name], entropy=entropy, idct="pallas",
                          upsample="fancy", keep_planes=True)
    got = decode(BLOBS[name], entropy=entropy, idct="pallas",
                 upsample="fancy", keep_planes=True, device="cpu")
    for a, b in zip(got.quantized_planes, ref.quantized_planes):
        np.testing.assert_array_equal(a, b)
    assert got.rgb.dtype == (torch.uint16 if KINDS[name][1] == 12
                             else torch.uint8)
    d = np.abs(got.rgb.numpy().astype(np.int32) - ref.rgb.astype(np.int32))
    assert d.max() <= RGB_TOL and (d == 0).mean() >= MIN_EQUAL
    fast = decode(BLOBS[name], entropy=entropy, idct="pallas",
                  upsample="fancy", device="cpu")
    assert torch.equal(fast.rgb, got.rgb)


@pytest.mark.parametrize("entropy", ["jax", "hybrid"])
def test_routes_take_the_named_lanes(entropy, monkeypatch):
    """hybrid sends a DRI=0 stream to K7 (its plain version here) and a
    restart stream to K2; jax sends both to K2."""
    calls = []
    for mod, fn in ((entropy_emit_cuda, "decode_lanes_torch"),
                    (entropy_cuda, "decode_segments_torch")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _f=real, _n=fn, **k: (
            calls.append(_n), _f(*a, **k))[1])
    for name in ("420_dri0", "420_dri3"):
        calls.clear()
        decode(BLOBS[name], entropy=entropy, idct="pallas", device="cpu")
        k7 = entropy == "hybrid" and name == "420_dri0"
        assert calls == ["decode_lanes_torch" if k7
                         else "decode_segments_torch"]


@pytest.mark.parametrize("entropy", ["jax", "hybrid"])
@pytest.mark.parametrize("name", ["420_dri0", "12bit_444_dri2"])
def test_corrupt_stream_raises_in_both(name, entropy):
    blob = _corrupt(BLOBS[name])
    with pytest.raises(JaxJPEGError):
        jdecoder.decode(blob, entropy=entropy, idct="pallas")
    with pytest.raises(JPEGError):
        decode(blob, entropy=entropy, idct="pallas", device="cpu")


@pytest.mark.parametrize("entropy", ["jax", "hybrid"])
def test_batch_matches_jax(entropy):
    """BatchDecoder under jax/hybrid: every good image within the tolerance
    of JAX's batch (12-bit through host planes decoded by the lanes), the
    corrupt one isolated as its own error in both."""
    blobs = [BLOBS["420_dri0"], _corrupt(BLOBS["420_dri0"]),
             BLOBS["420_dri3"], BLOBS["12bit_420_dri0"], BLOBS["444_dri0"]]
    ref = jbatch.BatchDecoder(entropy=entropy, idct="pallas",
                              upsample="fancy").decode(blobs)
    with tbatch.BatchDecoder(device="cpu", entropy=entropy,
                             idct="pallas") as bd:
        got = bd.decode(blobs)
    assert [it.ok for it in got] == [it.ok for it in ref] == [
        True, False, True, True, True]
    assert isinstance(got[1].error, JPEGError)
    for g, r in zip(got, ref):
        if not r.ok:
            continue
        d = np.abs(g.rgb.numpy().astype(np.int32)
                   - np.asarray(r.rgb).astype(np.int32))
        assert d.max() <= RGB_TOL and (d == 0).mean() >= MIN_EQUAL
