"""The batch routes' pixel stage, K6a and K6b, against the JAX package and
the port's plain versions, at small sizes.

The kernels run only on the card (tests/test_torch_cuda.py); here their
decompositions run as plain models (``ops/pixels_cuda.py``):

* K6a's first form's chunked double prefix sum (``unpack_nibble_chunked``;
  the kernel's own model is tested in tests/test_torch_unpack.py) equals the
  port's ``unpack_nibble`` and the blocks the JAX package's
  ``_batched_from_nibble`` builds, exactly, at the kernel's chunk and at
  chunks a few entries long (chunk edges inside runs of overflow codes,
  all-filler rows, fillers after a real value, gap-0 entries, escapes that
  overwrite values and DC);
* K6b's decomposition as the kernel runs it (``rgb_tiles_torch`` with a
  persistent grid: each CTA's tiles in order, tiles of padding given the
  colour of zeros, the kernel's own ``fast``) equals the plain route
  ``rgb_from_blocks_torch`` byte for byte over the whole tensor, padding
  included, under ``exact``, ``pallas`` and ``kron``, and within the +-1
  IDCT bound under ``fast`` (the kernel's separable ``fast`` against the
  route's einsum), for every frame kind, both upsamplers, whole-MCU, odd
  and large tiles (images shorter than a tile); the kernel's ``fast``
  arithmetic (``fast_separable``) is within +-1 of the JAX package's
  ``idct_fast``, and the CUDA route launches K6b alone (no
  ``scan_samples``), with each IDCT's mode code;
* K6b's first form's tiles (``rgb_tiles_torch``: output tiles, each
  component's window with the fancy filter's halo, blocks from the
  closed-form geometry, zero blocks outside it) equal the plain route
  ``rgb_from_blocks_torch`` byte for byte over the whole tensor, padding
  included, for every frame kind, both upsamplers and all four IDCTs; and
  each image's true region equals the JAX package's ``_rgb_one_dyn``, byte
  for byte under ``exact`` (JAX eager is its strict path) and under
  ``kron`` and ``pallas`` (JAX's ``pallas`` is its Kronecker twin off the
  TPU), within the +-1 IDCT bound under ``fast`` (einsum orders differ; +-2
  after the colour transform);
* the header geometry ``sharded._pixels`` hands K6b gives
  ``scan_layout``'s ``comp_src`` for every frame kind the K2 and K7 groups
  take, and the same RGB as the plain ``_pixels``.
"""

import os
import re
import sys

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu.models import batch as jbatch  # noqa: E402
from jpeg_decoder_tpu.ops import pixel as jpixel  # noqa: E402

from jpeg_decoder_tpu_torch.io import parser  # noqa: E402
from jpeg_decoder_tpu_torch.layout import scan_layout  # noqa: E402
from jpeg_decoder_tpu_torch.models import batch as tbatch  # noqa: E402
from jpeg_decoder_tpu_torch.models import decoder as tdecoder  # noqa: E402
from jpeg_decoder_tpu_torch.ops import idct_cuda  # noqa: E402
from jpeg_decoder_tpu_torch.ops import pixels_cuda as k6  # noqa: E402
from jpeg_decoder_tpu_torch.parallel import sharded  # noqa: E402
from jpeg_decoder_tpu_torch.testing import pixel_cases  # noqa: E402

KINDS = {k[0]: k[1:] for k in pixel_cases.FRAME_KINDS}
IDCTS = ("exact", "pallas", "kron", "fast")
RGB_TOL = 2          # +-1 IDCT rounding times the x1.402 colour gain
MIN_EQUAL = 0.9999


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- K6a ----------------------------------------------------------------------

@pytest.mark.parametrize("n_blk,seed,threads,per", [
    (40, 0, 256, 16), (300, 1, 256, 16), (2000, 2, 256, 16),
    (40, 3, 4, 3), (300, 4, 2, 5), (700, 5, 8, 16), (5, 6, 1, 1)])
def test_nibble_model_equals_plain_and_jax(n_blk, seed, threads, per,
                                           monkeypatch):
    """The chunked model, the plain unpack and JAX's blocks agree on every
    element of a padded group with a made-up row of traps.  (The trap
    row's escape at index -3 goes past the end here: JAX's ``.at[]`` wraps
    a negative index, which its docstring and the port drop; the host
    never writes one, nor a value before the first position.)"""
    arrays = pixel_cases.nibble_group(seed, n_blk)
    arrays[3][arrays[3] < 0] = n_blk * 64 + 1
    args = _t(arrays)
    plain = tbatch.unpack_nibble(*args)
    model = k6.unpack_nibble_chunked(*args, threads=threads, per=per)
    assert torch.equal(model, plain)
    assert not plain[:, -1].any()
    monkeypatch.setattr(jbatch, "_rgb_one_dyn",
                        lambda blocks, *a, **k: blocks)
    b = arrays[0].shape[0]
    ref = jbatch._batched_from_nibble.__wrapped__(
        *(jnp.asarray(a) for a in arrays),
        jnp.zeros((b, 3, 64), jnp.int32), jnp.zeros((b, 4), jnp.int32),
        comp_shapes=(), comp_hv=(), height=8, width=8, samplings=(),
        idct="kron", upsample="fancy")
    np.testing.assert_array_equal(plain[:, :-1].numpy(), np.asarray(ref))


def test_nibble_model_traps_cross_chunk_edges():
    """At 12-entry chunks the trap row's run of overflow codes (entries
    20-29) crosses a chunk edge, its fillers follow a real value, a gap-0
    entry lands on a position twice, and its escapes hit a DC slot (DC
    wins), a value (the escape wins) and fall outside the row (dropped)."""
    dc, e, ov, ei, ev = pixel_cases.nibble_group(7, 64)
    t = dc.shape[0] - 1
    assert (e[t, 20:30] & 15 == 8).all() and 20 < 24 < 30
    plain = tbatch.unpack_nibble(*_t((dc, e, ov, ei, ev)))
    model = k6.unpack_nibble_chunked(*_t((dc, e, ov, ei, ev)), threads=4,
                                     per=3)
    assert torch.equal(model, plain)
    assert int(plain[t, 1, 0]) == int(dc[t, 1])           # DC over escape
    assert int(plain[t, 1, 6]) == -500                    # escape over value
    fill = k6.unpack_nibble_chunked(*_t((dc[:1], np.zeros_like(e[:1]),
                                         ov[:1], ei[:1], ev[:1])), threads=4,
                                    per=3)
    assert torch.equal(fill, tbatch.unpack_nibble(
        *_t((dc[:1], np.zeros_like(e[:1]), ov[:1], ei[:1], ev[:1]))))


def test_nibble_wrapper_on_cpu_is_the_plain_version():
    args = _t(pixel_cases.nibble_group(8, 100))
    before = k6.unpack_nibble.launches
    assert torch.equal(k6.unpack_nibble(*args), tbatch.unpack_nibble(*args))
    assert k6.unpack_nibble.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        k6.unpack_nibble(*(a.to("meta") for a in args))


# -- K6b ----------------------------------------------------------------------

def _group(kind, seed=0, mcus=(5, 3), bucket=(8, 4), pad=4):
    hv, color, prec = KINDS[kind]
    return pixel_cases.bucket_group(
        seed, hv, color, prec, pixel_cases.odd_dims(hv, mcus), bucket,
        pad=pad)


@pytest.mark.parametrize("idct", IDCTS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_tile_model_equals_plain_route(kind, idct):
    """K6b's decomposition at whole-MCU tiles and at the kernel's tiles,
    under fancy and nn, equals the plain route over the whole tensor,
    padding rows and bucket padding included."""
    blocks, qt, geom, kw = _group(kind, seed=len(kind))
    hv = KINDS[kind][0]
    mcu = (8 * max(v for _, v in hv), 8 * max(h for h, _ in hv))
    args = _t((blocks, qt, geom))
    for up in ("fancy", "nn"):
        plain = tbatch.rgb_from_blocks_torch(*args, idct=idct, upsample=up,
                                             **kw)
        for tile in (mcu, None):
            got = k6.rgb_tiles_torch(*args, idct=idct, upsample=up,
                                     tile=tile, **kw)
            assert got.dtype == plain.dtype and got.shape == plain.shape
            assert torch.equal(got, plain), (up, tile)


@pytest.mark.parametrize("idct", IDCTS)
@pytest.mark.parametrize("kind", ["420", "444", "422", "440", "411", "gray",
                                  "adobe rgb", "cmyk", "ycck", "12-bit 420"])
def test_tile_model_equals_jax(kind, idct):
    """Each image's true region of the tile model against JAX's
    ``_rgb_one_dyn`` run eagerly on the same blocks."""
    blocks, qt, geom, kw = _group(kind, seed=100 + len(kind), pad=3)
    got = k6.rgb_tiles_torch(*_t((blocks, qt, geom)), idct=idct,
                             upsample="fancy", **kw).numpy()
    for k in range(3):
        ref = np.asarray(jbatch._rgb_one_dyn(
            jnp.asarray(blocks[k, :-1]), jnp.asarray(qt[k]),
            jnp.asarray(geom[k]), idct=idct, upsample="fancy", **kw))
        th, tw = geom[k, 2:]
        a = got[k, :th, :tw].astype(np.int64)
        d = np.abs(a - ref[:th, :tw])
        if idct == "fast":
            assert d.max() <= RGB_TOL and (d == 0).mean() >= MIN_EQUAL
        else:
            np.testing.assert_array_equal(a, ref[:th, :tw])


def test_plan_windows_cover_every_tile():
    """For every frame kind, tile and component the window K6b fills fits
    its capacity and stays inside the component's sample grid."""
    for kind, (hv, color, prec) in KINDS.items():
        _, _, _, kw = pixel_cases.bucket_group(0, hv, color, prec,
                                               [(8, 8)], (8, 4))
        for up in ("fancy", "nn"):
            plan = k6.rgb_plan(upsample=up, **kw)
            for ty in range(plan.tiles_y):
                for tx in range(plan.tiles_x):
                    y0, x0 = ty * plan.tile_h, tx * plan.tile_w
                    y1 = min(y0 + plan.tile_h, plan.out_h) - 1
                    x1 = min(x0 + plan.tile_w, plan.out_w) - 1
                    for c, wh in zip(plan.comps, plan.win_h):
                        _, _, _, n_r, n_c, vy, vx, kind_up, ww, _ = c
                        r0, r1 = k6._span(y0, y1, vy, kind_up, n_r)
                        c0, c1 = k6._span(x0, x1, vx, kind_up, n_c)
                        assert 0 <= r0 <= r1 < n_r and r1 - r0 < wh
                        assert 0 <= c0 <= c1 < n_c and c1 - c0 < ww


def test_blocks_wrapper_on_cpu_is_the_plain_version():
    blocks, qt, geom, kw = _group("420", seed=3)
    args = _t((blocks, qt, geom))
    before = k6.blocks_to_rgb.launches
    got = k6.blocks_to_rgb(*args, idct="pallas", upsample="fancy", **kw)
    assert torch.equal(got, tbatch.rgb_from_blocks_torch(
        *args, idct="pallas", upsample="fancy", **kw))
    assert torch.equal(got, tbatch.rgb_from_blocks_dyn(
        *args, idct="pallas", upsample="fancy", **kw))
    assert k6.blocks_to_rgb.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        k6.blocks_to_rgb(*(a.to("meta") for a in args), idct="pallas",
                         upsample="fancy", **kw)


def test_plan_refuses_what_the_route_refuses():
    base = dict(comp_shapes=((1, 1),) * 3, comp_hv=((1, 1),) * 3, height=8,
                width=8, samplings=((1, 1),) * 3, upsample="fancy")
    for bad in (dict(color="rgb", precision=12),
                dict(color="ycck", precision=8),      # three components
                dict(color="ycbcr", precision=8, upsample="bicubic")):
        with pytest.raises(ValueError):
            k6.rgb_plan(**{**base, **bad})


def test_pixels_cu_colour_constants_equal_numpy():
    """The float literals of K6b's colour transform are the float32 values
    of the reference's 1.402, 0.344, 0.714 and 1.772, bit for bit."""
    src = open(k6.LIB.src).read()
    lits = [float.fromhex(v) for v in re.findall(
        r"__fmul_rn\((0x[0-9a-f.]+p[+-]\d+)f", src)]
    assert [np.float32(v).tobytes() for v in lits] == [
        np.float32(v).tobytes() for v in (1.402, 0.344, 0.714, 1.772)]


# -- K6b's walk ---------------------------------------------------------------

def _close(got, ref, idct):
    """Byte-equal under exact, pallas and kron; the +-1 IDCT bound under
    fast (RGB_TOL, MIN_EQUAL)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if idct != "fast":
        return bool(torch.equal(got, ref))
    d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
    return int(d.max()) <= RGB_TOL and float((d == 0).float().mean()) >= \
        MIN_EQUAL


@pytest.mark.parametrize("idct", IDCTS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_kernel_model_equals_plain_route(kind, idct):
    """K6b's decomposition with the kernel's arithmetic, its tiles in the
    order of a persistent grid of 1, 3 and 7 CTAs, at its tile, at one MCU,
    at an odd tile (rounded to whole MCUs) and at a tile larger than the
    group (every image shorter than one tile), under fancy and nn, equals
    the plain route over the whole tensor, padding rows and bucket padding
    included (byte for byte but under fast: the +-1 IDCT bound)."""
    blocks, qt, geom, kw = _group(kind, seed=len(kind))
    hv = KINDS[kind][0]
    mcu = (8 * max(v for _, v in hv), 8 * max(h for h, _ in hv))
    args = _t((blocks, qt, geom))
    for up in ("fancy", "nn"):
        plain = tbatch.rgb_from_blocks_torch(*args, idct=idct, upsample=up,
                                             **kw)
        for tile, grid in ((None, 7), (mcu, 3), ((24, 40), 1),
                           ((64, 256), 7)):
            got = k6.rgb_tiles_torch(*args, idct=idct, upsample=up,
                                     tile=tile, grid=grid,
                                     arithmetic="kernel", **kw)
            assert _close(got, plain, idct), (up, tile, grid)


def test_kernel_layout_fits_the_card():
    """K6b's shared memory fits the card at its tile for every frame kind,
    both upsamplers and output types, with and without staged rows; its
    regions start on 16-byte boundaries; the grid is one CTA a tile at
    most."""
    for kind, (hv, color, prec) in KINDS.items():
        _, _, _, kw = pixel_cases.bucket_group(0, hv, color, prec,
                                               [(8, 8)], (40, 40))
        for up in ("fancy", "nn"):
            plan = k6.rgb_plan(upsample=up, tile=k6._whole_mcus(
                k6.TILE, kw["comp_hv"]), **kw)
            assert k6.grid_for(plan, 1, 132, 4) == min(plan.n_tiles, 528)
            assert k6.grid_for(plan, 1000, 132, 3) == 132 * 3
            for idct in IDCTS:
                for nbytes in (1, 2):
                    for staged in (False, True):
                        lay = plan.layout(idct, nbytes, staged)
                        assert lay["smem"] <= k6.SMEM_MAX
                        assert lay["window_ints"] % 4 == 0
                        assert all(lay[k] % 16 == 0 for k in (
                            "off_stage", "off_win", "off_rows", "off_rgb",
                            "rgb_pitch"))


def _fast_blocks(seed):
    """Seeded dequantised blocks: JPEG-like ones, and ones at the extremes
    of the int32 range (each coefficient anywhere in it, one coefficient
    at INT_MIN or INT_MAX, a block of INT_MAX)."""
    rng = np.random.default_rng(seed)
    jpeg = pixel_cases.random_blocks(rng, 4000, 0.3, spread=300, dc=900) \
        * rng.integers(1, 60, (1, 64)).astype(np.int32)
    wide = rng.integers(-2 ** 31, 2 ** 31, (200, 64)).astype(np.int32)
    ones = np.zeros((128, 64), np.int32)
    ones[np.arange(128), np.arange(128) % 64] = np.where(
        np.arange(128) < 64, 2 ** 31 - 1, -2 ** 31)
    full = np.full((1, 64), 2 ** 31 - 1, np.int32)
    return jpeg.astype(np.int32), np.concatenate([wide, ones, full])


def test_fast_separable_within_one_of_jax_idct_fast():
    """K6b's ``fast`` arithmetic (``fast_separable``) against the JAX
    package's ``idct_fast`` on the same int32 blocks: within +-1 on
    JPEG-like blocks (dequantised up to about 2^14); at the extremes of the int32 range the saturated
    samples equal, no other sample saturates, and the rest lie within the
    two 8-term float32 contractions' rounding (2^-22 of the block's
    sum|x|) plus the final +-1, as ``test_fast_and_kron_saturate_like_jax``
    bounds the port's einsum."""
    jpeg, extreme = _fast_blocks(0)
    ref = np.asarray(jpixel.idct_fast(jnp.asarray(jpeg.reshape(-1, 8, 8))))
    got = k6.fast_separable(torch.from_numpy(jpeg)).numpy()
    d = np.abs(got.astype(np.int64) - ref.reshape(-1, 64))
    assert got.dtype == np.int32 and d.max() <= 1
    # Another order flips a rounding only near a half: a rounding fault
    # (truncation, off by one) changes far more.
    assert (d == 0).mean() >= 0.999
    ref = np.asarray(jpixel.idct_fast(jnp.asarray(
        extreme.reshape(-1, 8, 8)))).reshape(-1, 64).astype(np.int64)
    got = k6.fast_separable(torch.from_numpy(extreme)).numpy()
    sat = (ref == 2 ** 31 - 1) | (ref == -2 ** 31)
    assert sat.any() and (~sat).any()
    np.testing.assert_array_equal(got[sat], ref[sat])
    assert ((got == 2 ** 31 - 1) | (got == -2 ** 31))[~sat].sum() == 0
    bound = 1 + 2.0 ** -22 * np.abs(extreme.astype(np.float64)).sum(1)
    assert (np.abs(got - ref) <= bound[:, None]).all()


def test_fast_kernel_constants_equal_idct_m():
    """The ``fast`` basis kM in ``csrc/idct_common.cuh`` is
    ``pixel.IDCT_M_F32`` bit for bit."""
    src = open(os.path.join(os.path.dirname(k6.LIB.src),
                            "idct_common.cuh")).read()
    body = src[src.index("kM[8][8] = {"):]
    body = body[:body.index("};")]
    lits = re.findall(r"(-?0x1(?:\.[0-9a-f]+)?p[+-]\d+)f", body)
    got = np.array([float.fromhex(v) for v in lits], np.float32)
    assert got.tobytes() == k6.pixel.IDCT_M_F32.reshape(-1).tobytes()


class _MockLib:
    """Records ``jd_blocks_to_rgb``'s arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def jd_blocks_to_rgb(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("kind", ["420", "12-bit gray", "cmyk"])
def test_cuda_route_launches_k6b_alone(kind, monkeypatch):
    """What ``blocks_to_rgb`` does on a CUDA tensor, run on CPU tensors with
    a mock library call: one K6b launch per call under every IDCT, with
    the IDCT's mode code (kron runs K1's arithmetic), the plan's grid and
    shared memory, and no ``scan_samples`` (its count stays; a call would
    raise); the CUDA branch names no ``scan_samples``."""
    blocks, qt, geom, kw = _group(kind, seed=5)
    args = _t((blocks, qt, geom))

    def no_product(*a, **k):
        raise AssertionError("scan_samples reached")

    monkeypatch.setattr(k6, "scan_samples", no_product)
    lib = _MockLib()
    before = k6.blocks_to_rgb.launches
    products = k6.scan_samples.launches if hasattr(
        k6.scan_samples, "launches") else None
    for idct, mode in (("pallas", 0), ("kron", 0), ("exact", 1),
                       ("fast", 3)):
        k6.check_rgb_args(*args, len(kw["comp_shapes"]), idct)
        plan = k6.rgb_plan(upsample="fancy", tile=k6._whole_mcus(
            k6.TILE, kw["comp_hv"]), **kw)
        out = torch.empty((blocks.shape[0], plan.out_h, plan.out_w, 3),
                          dtype=torch.uint16 if "12" in kind
                          else torch.uint8)
        grid = k6.grid_for(plan, blocks.shape[0], 2,
                           k6.CTAS_PER_SM[idct])
        k6.launch_rgb(lib, *args, idct_cuda._basis(torch.device("cpu"),
                                                   False),
                      out, plan, idct, grid, 0)
        call = lib.calls[-1]
        dims, smem = call[7], call[10]
        assert dims[11] == mode and dims[12] == out.element_size()
        assert call[9] == grid and smem == plan.layout(
            idct, out.element_size())["smem"]
    assert k6.blocks_to_rgb.launches == before + 4
    assert products is None
    src = inspect.getsource(k6.blocks_to_rgb)
    assert "scan_samples" not in src.split('"""')[-1]


def test_scan_samples_counts_card_calls_only():
    """``scan_samples`` counts its calls on CUDA tensors (chip_smoke.py and
    the card tests hold the main path's count at 0); on CPU tensors it
    counts nothing."""
    blocks, qt, _, kw = _group("420", seed=6)
    before = k6.scan_samples.launches
    k6.scan_samples(*_t((blocks, qt)), kw["comp_hv"], "kron")
    assert k6.scan_samples.launches == before


@pytest.mark.parametrize("bad,err", [
    (dict(dtype=torch.int64), TypeError), (dict(shape=(2, 9, 32)), ValueError),
    (dict(idct="dct"), ValueError), (dict(stride=True), ValueError),
    (dict(offset=True), ValueError)])
def test_cuda_route_checks_arguments(bad, err):
    """The CUDA route's checks, run on CPU tensors: dtype, shape, the IDCT's
    name, contiguity, 16-byte alignment."""
    blocks, qt, geom, kw = _group("444", seed=7)
    tb_, tq, tg = _t((blocks, qt, geom))
    if "dtype" in bad:
        tb_ = tb_.to(bad["dtype"])
    if "shape" in bad:
        tb_ = torch.zeros(bad["shape"], dtype=torch.int32)
    if "stride" in bad:
        tb_ = tb_[:, ::2]
    if "offset" in bad:
        tb_ = torch.zeros(tb_.numel() + 1, dtype=torch.int32)[1:].view(
            tb_.shape)
    with pytest.raises(err):
        k6.check_rgb_args(tb_, tq, tg, len(kw["comp_shapes"]),
                          bad.get("idct", "pallas"))


# -- the sharded route's header geometry -------------------------------------

def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 6.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _frames():
    """A baseline frame of every kind the K2 and K7 groups take, odd
    dims."""
    rgb = _rgb(0, 37, 53)
    planes = [rgb[..., k % 3].astype(np.float64) for k in range(4)]
    out = {name: encode(rgb, samplings=hv, quality=90)[0]
           for name, hv in (("420", ((2, 2), (1, 1), (1, 1))),
                            ("444", ((1, 1),) * 3),
                            ("422", ((2, 1), (1, 1), (1, 1))),
                            ("440", ((1, 2), (1, 1), (1, 1))),
                            ("411", ((4, 1), (1, 1), (1, 1))),
                            ("311", ((3, 1), (1, 1), (1, 1))))}
    out["gray"] = encode(rgb[..., 0], grayscale=True, samplings=((1, 1),),
                         quality=90)[0]
    out["adobe rgb"] = encode(rgb, samplings=((1, 1),) * 3,
                              app14_transform=0)[0]
    out["cmyk"] = encode(rgb, raw_planes=planes, samplings=((1, 1),) * 4,
                         app14_transform=0)[0]
    out["ycck"] = encode(rgb, raw_planes=planes,
                         samplings=((2, 2), (1, 1), (1, 1), (2, 2)),
                         app14_transform=2)[0]
    out["12-bit"] = encode(rgb, quality=90, precision=12)[0]
    out["dri"] = encode(rgb, quality=90, restart_interval=2)[0]
    return out


FRAMES = _frames()


def plane_sources(geom_row, comp_shapes, comp_hv) -> list:
    """The closed-form scan row of every plane cell of one image, per
    component a (rows, cols) int64 array, -1 where the cell lies outside
    the image's MCU grid: K6b's (and ``planes_from_blocks_dyn``'s)
    geometry (csrc/pixels.cu, phase 1)."""
    mcus_x, mcus_y = int(geom_row[0]), int(geom_row[1])
    bpm = sum(h * v for h, v in comp_hv)
    out, k0 = [], 0
    for (rows, cols), (h, v) in zip(comp_shapes, comp_hv):
        r = np.arange(rows).reshape(-1, 1)
        c = np.arange(cols).reshape(1, -1)
        src = ((r // v) * mcus_x + c // h) * bpm + k0 + (r % v) * h + c % h
        valid = (r < mcus_y * v) & (c < mcus_x * h)
        out.append(np.where(valid, src, -1).astype(np.int64))
        k0 += h * v
    return out


@pytest.mark.parametrize("name", list(FRAMES))
def test_header_geometry_equals_comp_src(name):
    hdr = parser.parse(FRAMES[name])
    lay = scan_layout(hdr)
    geom = sharded.header_geom(hdr, 2, "cpu")
    assert geom.dtype == torch.int32 and geom.shape == (2, 4)
    srcs = plane_sources(geom[0].numpy(), lay.comp_shapes,
                            tuple((c.h, c.v) for c in hdr.components))
    for src, ref, shape in zip(srcs, lay.comp_src, lay.comp_shapes):
        assert src.shape == shape
        np.testing.assert_array_equal(src.reshape(-1), ref)


@pytest.mark.parametrize("idct", IDCTS)
@pytest.mark.parametrize("name", ["420", "422", "gray", "cmyk", "ycck",
                                  "12-bit", "311"])
def test_header_geometry_pixels_equal_plain(name, idct):
    """``_pixels``' CPU route (the scan layout's gather) equals the plain
    bucket route and the tile model fed the header geometry, on blocks
    with a row of padding past the image's (as K2's segment rows)."""
    hdr = parser.parse(FRAMES[name])
    lay = scan_layout(hdr)
    rng = np.random.default_rng(len(name))
    n = lay.n_mcus * lay.blocks_per_mcu + 5
    blocks = torch.from_numpy(pixel_cases.random_blocks(
        rng, 2 * n, 0.2, spread=12, dc=60).reshape(2, n, 64))
    qt = torch.from_numpy(rng.integers(1, 30, (2, len(hdr.components), 64))
                          .astype(np.int32))
    kw = dict(idct=idct, upsample="fancy")
    ref = sharded._pixels(blocks, qt, tdecoder._comp_srcs(hdr, "cpu"), hdr,
                          **kw)
    dyn = dict(comp_shapes=tuple(lay.comp_shapes),
               comp_hv=tuple((c.h, c.v) for c in hdr.components),
               height=hdr.height, width=hdr.width,
               samplings=sharded._samplings(hdr), color=hdr.colorspace,
               precision=hdr.precision, **kw)
    geom = sharded.header_geom(hdr, 2, "cpu")
    # The plain bucket route reads a zero fill row last; K6b needs none.
    filled = torch.cat([blocks, torch.zeros((2, 1, 64), dtype=torch.int32)],
                       1)
    assert torch.equal(tbatch.rgb_from_blocks_torch(filled, qt, geom, **dyn),
                       ref)
    assert torch.equal(k6.rgb_tiles_torch(blocks, qt, geom, **dyn), ref)
