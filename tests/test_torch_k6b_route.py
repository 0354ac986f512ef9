"""decode()'s pixel route on the card, on the CPU: the choice of K6b
(``models/decoder.k6b_route``), its plan cache (``_k6b_plan``), its
device-resident constants (``_k6b_consts``) and the launch's arguments
(``_k6b_pixels``, which on CPU tensors runs K6b's plain version) against
the torch route it replaces (``ops/pixel.pixel_pipeline_from_scan``).  The
card's side is in tests/test_torch_cuda.py.  No jax."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import profile

from jpeg_decoder_tpu_torch import decode
from jpeg_decoder_tpu_torch.io import parser
from jpeg_decoder_tpu_torch.models import decoder as tdec
from jpeg_decoder_tpu_torch.ops import pixel, pixels_cuda
from jpeg_decoder_tpu_torch.testing import pixel_cases
from jpeg_decoder_tpu_torch.utils import profiling

#: The frame kinds the test encoder makes: "odd" (ratios 3:2) it refuses,
#: so that kind is tested on a header with its samplings swapped in.
BLOB_KINDS = [k[0] for k in pixel_cases.FRAME_KINDS if k[0] != "odd"]


def _hdr(kind="420", seed=0, h=37, w=53, **kw):
    return parser.parse(pixel_cases.frame_blob(kind, seed, h, w, **kw))


def _plan(hdr, upsample="nn", tile=None):
    """K6b's plan of the frame (at ``tile``, else the kernel's tiles)."""
    kw = dict(comp_shapes=tuple(tdec.layout_mod.scan_layout(hdr).comp_shapes),
              comp_hv=tuple((c.h, c.v) for c in hdr.components),
              height=hdr.height, width=hdr.width,
              samplings=tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                              for c in hdr.components),
              upsample=upsample, color=hdr.colorspace,
              precision=hdr.precision)
    if tile is None:
        return pixels_cuda.kernel_plan(**kw)
    return pixels_cuda.rgb_plan(tile=tile, **kw)


def _recorded(fn):
    """``fn()`` under a CPU profile on a cleared recorder: its result, the
    counters' totals and the spans."""
    profiling.count("test.mark")     # off: the next record clears
    with profile():
        profiling.count("test.mark")
        out = fn()
        return out, profiling.counters(), profiling.spans()


@pytest.fixture(autouse=True)
def _fresh_caches():
    tdec._k6b_plans.clear()
    tdec._k6b_const_cache.clear()
    yield
    tdec._k6b_plans.clear()
    tdec._k6b_const_cache.clear()


# -- the route choice ---------------------------------------------------------

@pytest.mark.parametrize("idct,out_cmyk,device_type,plan,want", [
    ("exact", False, "cuda", "fits", True),
    ("pallas", False, "cuda", "fits", True),
    ("exact", False, "cuda", "fits 12-bit", True),
    ("kron", False, "cuda", "fits", False),
    ("fast", False, "cuda", "fits", False),
    ("exact", True, "cuda", "fits", False),
    ("pallas", True, "cuda", "fits", False),
    ("exact", False, "cpu", "fits", False),
    ("pallas", False, "cpu", "fits", False),
    ("exact", False, "cuda", None, False),
    ("exact", False, "cuda", "too big", False),
    ("pallas", False, "cuda", "too big", False),
])
def test_route_choice(idct, out_cmyk, device_type, plan, want):
    """K6b exactly where it keeps the torch route's bytes: a CUDA device,
    ``exact`` or ``pallas``, RGB out, a plan that fits in shared memory."""
    plans = {None: None, "fits": _plan(_hdr()),
             "fits 12-bit": _plan(_hdr("12-bit 420")),
             "too big": _plan(_hdr(), tile=(512, 512))}
    got = plans[plan]
    if got is not None:
        fits = got.layout(idct, 1 if got.maxv < 256 else 2)["smem"] \
            <= pixels_cuda.SMEM_MAX
        assert fits == (plan != "too big")
    assert tdec.k6b_route(idct, out_cmyk, device_type, got) is want


def test_plan_cached_per_geometry_and_refusals_are_none():
    hdr = _hdr()
    plan = tdec._k6b_plan(hdr, "nn")
    assert plan == _plan(hdr)
    assert tdec._k6b_plan(_hdr(seed=5), "nn") is plan      # same geometry
    assert tdec._k6b_plan(hdr, "fancy") == _plan(hdr, "fancy") != plan
    assert tdec._k6b_plan(_hdr(h=45), "nn") != plan
    # 12-bit CMYK: K6b (and the torch route) refuse it.
    cmyk = dataclasses.replace(_hdr("cmyk"), precision=12)
    assert tdec._k6b_plan(cmyk, "nn") is None
    with pytest.raises(ValueError):
        _plan(cmyk)
    assert len(tdec._k6b_plans) == 4


def test_plan_cache_is_bounded():
    hdr = _hdr()
    for k in range(300):
        tdec._k6b_plan(dataclasses.replace(hdr, height=hdr.height - k % 8,
                                           width=8 + k), "nn")
        assert len(tdec._k6b_plans) <= 257


# -- the device-resident constants --------------------------------------------

def _tables(hdr) -> np.ndarray:
    return np.stack([hdr.quant_tables[c.tq].values
                     for c in hdr.components]).astype(np.int32)


def test_consts_one_upload_then_hits():
    hdr = _hdr()
    cpu = torch.device("cpu")
    (buf, qt, geom), first, _ = _recorded(lambda: tdec._k6b_consts(hdr, cpu))
    again, second, _ = _recorded(lambda: tdec._k6b_consts(_hdr(seed=3), cpu))
    assert first.get("pixel.consts_upload") == 1
    assert "pixel.consts_upload" not in second
    assert all(a is b for a, b in zip(again, (buf, qt, geom)))
    assert qt.dtype == geom.dtype == torch.int32
    assert qt.is_contiguous() and geom.is_contiguous()
    assert torch.equal(qt, torch.from_numpy(_tables(hdr))[None])
    assert geom.tolist() == [[hdr.mcus_x, hdr.mcus_y, hdr.height,
                              hdr.width]]
    assert qt.data_ptr() == buf.data_ptr()
    assert (geom.data_ptr() - buf.data_ptr()) % 16 == 0


def test_consts_distinct_for_other_tables_or_dims():
    a = _hdr()
    b = _hdr(quality=40)                 # same geometry, other tables
    c = _hdr(h=45)                       # same MCU grid, other height
    assert (a.mcus_x, a.mcus_y) == (b.mcus_x, b.mcus_y) == (c.mcus_x,
                                                            c.mcus_y)
    assert not np.array_equal(_tables(a), _tables(b))
    got, counts, _ = _recorded(lambda: [
        tdec._k6b_consts(h, torch.device("cpu")) for h in (a, b, c)])
    assert counts.get("pixel.consts_upload") == 3
    assert len(tdec._k6b_const_cache) == 3
    assert torch.equal(got[1][1], torch.from_numpy(_tables(b))[None])
    assert got[2][2].tolist() == [[c.mcus_x, c.mcus_y, 45, 53]]
    assert not torch.equal(got[0][1], got[1][1])


def test_consts_cache_is_bounded():
    hdr = _hdr()
    for k in range(300):
        tdec._k6b_consts(dataclasses.replace(hdr, width=8 + k),
                         torch.device("cpu"))
        assert len(tdec._k6b_const_cache) <= 257


# -- the launch's arguments against the torch route ---------------------------

def _scan_blocks(hdr) -> torch.Tensor:
    blocks = tdec._decode_scan_robust(hdr, hdr.scans[0], "auto",
                                      torch.device("cpu"))
    return torch.from_numpy(blocks)


def _torch_route(hdr, blocks, idct, upsample):
    lay = tdec.layout_mod.scan_layout(hdr)
    qts = tuple(torch.from_numpy(hdr.quant_tables[c.tq].values
                                 .astype(np.int32)) for c in hdr.components)
    return pixel.pixel_pipeline_from_scan(
        blocks, qts, tdec._comp_srcs(hdr, torch.device("cpu")),
        comp_shapes=tuple(lay.comp_shapes), height=hdr.height,
        width=hdr.width,
        samplings=tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                        for c in hdr.components),
        idct=idct, upsample=upsample, color=hdr.colorspace,
        precision=hdr.precision)


def _k6b(hdr, blocks, idct, upsample):
    return tdec._k6b_pixels(
        hdr, blocks, tdec._k6b_plan(hdr, upsample),
        comp_shapes=tuple(tdec.layout_mod.scan_layout(hdr).comp_shapes),
        samplings=tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                        for c in hdr.components),
        idct=idct, upsample=upsample)


@pytest.mark.parametrize("idct", ["exact", "pallas"])
@pytest.mark.parametrize("kind", BLOB_KINDS)
def test_k6b_arguments_give_the_torch_route(kind, idct):
    """K6b's plain version fed what ``decode()`` feeds the kernel (the
    scan-order blocks as one image, the cached tables and geometry row)
    equals the torch route byte for byte, nn and fancy, odd dims and a
    restart interval."""
    hdr = _hdr(kind, seed=7, h=37, w=53, restart_interval=2)
    blocks = _scan_blocks(hdr)
    for up in ("nn", "fancy"):
        got = _k6b(hdr, blocks, idct, up)
        ref = _torch_route(hdr, blocks, idct, up)
        assert got.shape == ref.shape == (37, 53, 3), kind
        assert got.dtype == ref.dtype
        assert torch.equal(got, ref), (kind, up)


@pytest.mark.parametrize("idct", ["exact", "pallas"])
def test_k6b_arguments_odd_ratios(idct):
    """The "odd" kind (3:2 ratios, a plane narrower than the output) on
    random blocks under a header with its samplings."""
    hv = {k[0]: k[1] for k in pixel_cases.FRAME_KINDS}["odd"]
    base = _hdr("444", h=45, w=61)
    comps = [dataclasses.replace(c, h=h, v=v)
             for c, (h, v) in zip(base.components, hv)]
    hdr = dataclasses.replace(base, components=comps)
    lay = tdec.layout_mod.scan_layout(hdr)
    rng = np.random.default_rng(11)
    blocks = torch.from_numpy(pixel_cases.random_blocks(
        rng, lay.n_mcus * lay.blocks_per_mcu, 0.2, spread=12, dc=60))
    for up in ("nn", "fancy"):
        got = _k6b(hdr, blocks, idct, up)
        ref = _torch_route(hdr, blocks, idct, up)
        assert got.shape == ref.shape and torch.equal(got, ref), up


# -- decode() ----------------------------------------------------------------

def _frames():
    return {kind: pixel_cases.frame_blob(kind, 3, 29, 41, restart_interval=3)
            for kind in BLOB_KINDS}


@pytest.mark.parametrize("idct", ["exact", "pallas", "kron", "fast"])
def test_decode_on_cpu_keeps_the_torch_route(idct):
    """``decode(device="cpu")``: no K6b, no constant upload, two
    ``pixel.enqueue`` spans, the torch route's bytes."""
    for kind, blob in _frames().items():
        hdr = parser.parse(blob)
        got, counts, spans = _recorded(lambda: decode(
            blob, entropy="native", idct=idct, upsample="fancy",
            device="cpu").rgb)
        enq = [s for s in spans if s.name == "pixel.enqueue"]
        assert "pixel.k6b" not in counts and \
            "pixel.consts_upload" not in counts, kind
        assert len(enq) == 2, kind
        ref = _torch_route(hdr, _scan_blocks(hdr), idct, "fancy")
        assert torch.equal(got, ref), kind
    assert not tdec._k6b_plans and not tdec._k6b_const_cache


@pytest.mark.parametrize("upsample", ["nn", "fancy"])
def test_decode_through_the_k6b_branch(upsample, monkeypatch):
    """``decode()`` with the route chosen (as on the card) runs K6b's plain
    version on the CPU: one ``pixel.enqueue`` span, ``pixel.k6b`` once a
    call, one constant upload for two calls, the torch route's bytes; a
    CMYK output and ``kron`` keep the torch route."""
    real = tdec.k6b_route
    monkeypatch.setattr(tdec, "k6b_route",
                        lambda idct, out_cmyk, device_type, plan:
                        real(idct, out_cmyk, "cuda", _plan_of[0]))
    _plan_of = [None]
    for kind, blob in _frames().items():
        hdr = parser.parse(blob)
        _plan_of[0] = tdec._k6b_plan(hdr, upsample)
        ref = _torch_route(hdr, _scan_blocks(hdr), "exact", upsample)
        tdec._k6b_const_cache.clear()
        got, counts, spans = _recorded(lambda: [decode(
            blob, idct="exact", upsample=upsample, device="cpu").rgb
            for _ in range(2)])
        enq = [s for s in spans if s.name == "pixel.enqueue"]
        assert counts.get("pixel.k6b") == 2, kind
        assert counts.get("pixel.consts_upload") == 1, kind
        assert len(enq) == 2, kind
        assert all(torch.equal(g, ref) for g in got), kind
        def torch_routes():
            decode(blob, idct="kron", upsample=upsample, device="cpu")
            if hdr.colorspace in ("cmyk", "ycck"):
                decode(blob, idct="exact", upsample=upsample,
                       colorspace="cmyk", device="cpu")

        _, counts, _ = _recorded(torch_routes)
        assert "pixel.k6b" not in counts, kind
