"""K6a, the nibble wire's unpack, as its kernel decomposes it, at small
sizes on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py); here its
decomposition runs as the plain model ``pixels_cuda.unpack_nibble_windowed``
(chunk totals and bases, windows of output positions, the run of chunks
whose entries land in a window, the escapes in it, the trim):

* it equals the port's plain ``unpack_nibble`` and the blocks the JAX
  package's ``_batched_from_nibble`` builds, on every element, at the
  kernel's chunk and window and at small ones, on padded groups with a row
  of traps and on cases made for the kernel's edges: a real gap-0 entry
  that opens a chunk, chunks of extenders only, rows of fillers only,
  escapes on DC slots, out of range and out of order, overflow values,
  12-bit values;
* with the trim (``n_img`` images, ``n_rows`` blocks) it equals the plain
  version on the cut wire, and on every encoder-made group of the batch
  route the whole output's ``[:n_img, :n_rows + 1]``, the whole output
  being zero on everything the trim drops;
* K6b's side of the trim: blocks of fewer images than the geometry give
  the RGB of the zero-padded blocks, and ``BatchDecoder``'s RGB with the
  trim equals its RGB without it under every IDCT.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from jpeg_decoder_tpu.models import batch as jbatch  # noqa: E402

from jpeg_decoder_tpu_torch.models import batch as tbatch  # noqa: E402
from jpeg_decoder_tpu_torch.ops import idct_cuda  # noqa: E402
from jpeg_decoder_tpu_torch.ops import pixels_cuda as k6  # noqa: E402
from jpeg_decoder_tpu_torch.testing import pixel_cases  # noqa: E402
from jpeg_decoder_tpu_torch.testing.encoder import encode  # noqa: E402
from jpeg_decoder_tpu_torch.testing.photo import synthetic_photo  # noqa: E402

KERNEL = (k6.UNPACK_THREADS * k6.PER_THREAD, k6.WINDOW)   # chunk, window
SMALL = ((3, 64), (7, 128), (1, 192))


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_blocks(arrays) -> np.ndarray:
    """JAX's ``_batched_from_nibble`` (its ``one`` body, unjitted, the pixel
    stage replaced by the identity) on a group's wire arrays."""
    saved = jbatch._rgb_one_dyn
    jbatch._rgb_one_dyn = lambda blocks, *a, **k: blocks
    try:
        b = arrays[0].shape[0]
        return np.asarray(jbatch._batched_from_nibble.__wrapped__(
            *(jnp.asarray(a) for a in arrays),
            jnp.zeros((b, 3, 64), jnp.int32), jnp.zeros((b, 4), jnp.int32),
            comp_shapes=(), comp_hv=(), height=8, width=8, samplings=(),
            idct="kron", upsample="fancy"))
    finally:
        jbatch._rgb_one_dyn = saved


@pytest.mark.parametrize("n_blk,seed,chunk,window", [
    (40, 0, *KERNEL), (300, 1, *KERNEL), (2000, 2, *KERNEL),
    (40, 3, 3, 64), (300, 4, 7, 128), (700, 5, 16, 192), (64, 7, 1, 64),
    (300, 8, 12, 64)])
def test_windowed_model_equals_plain_and_jax(n_blk, seed, chunk, window):
    """The model, the plain unpack and JAX's blocks agree on every element
    of a padded group whose last row is made of traps (its escapes fall:
    64, 70, -3, then the pads; the model looks at all of them).  JAX's
    ``.at[]`` wraps a negative index, which the port drops, so JAX gets
    the group with that escape past the end (the row still falls)."""
    arrays = pixel_cases.nibble_group(seed, n_blk)
    args = _t(arrays)
    plain = tbatch.unpack_nibble(*args)
    assert torch.equal(k6.unpack_nibble_windowed(
        *args, chunk=chunk, window=window), plain)
    arrays[3][arrays[3] < 0] = n_blk * 64 + 1
    args = _t(arrays)
    plain = tbatch.unpack_nibble(*args)
    assert torch.equal(k6.unpack_nibble_windowed(
        *args, chunk=chunk, window=window), plain)
    np.testing.assert_array_equal(plain[:, :-1].numpy(), _jax_blocks(arrays))


@pytest.mark.parametrize("chunk,window", [KERNEL, *SMALL])
@pytest.mark.parametrize("n_img,rows_cut", [(4, 0), (3, 9), (2, 250),
                                            (1, 300), (4, 300)])
def test_windowed_model_trim(n_img, rows_cut, chunk, window):
    """With ``n_img``/``n_rows`` the model equals the plain version on the
    cut wire (the trap row's values and escapes past ``n_rows`` dropped),
    and so does the wrapper on CPU tensors; both are the whole output's
    ``[:n_img, :n_rows + 1]`` on blocks below ``n_rows``."""
    n_blk = 300
    args = _t(pixel_cases.nibble_group(11, n_blk))
    n_rows = n_blk - rows_cut
    cut = tbatch.unpack_nibble(args[0][:n_img, :n_rows],
                               *(a[:n_img] for a in args[1:]))
    got = k6.unpack_nibble_windowed(*args, n_img=n_img, n_rows=n_rows,
                                    chunk=chunk, window=window)
    assert got.shape == (n_img, n_rows + 1, 64)
    assert torch.equal(got, cut)
    assert torch.equal(k6.unpack_nibble(*args, n_img=n_img, n_rows=n_rows),
                       cut)
    whole = tbatch.unpack_nibble(*args)
    assert torch.equal(got[:, :-1], whole[:n_img, :n_rows])
    assert not got[:, -1].any()


@pytest.mark.parametrize("chunk,window", [KERNEL, (4, 64), *SMALL])
@pytest.mark.parametrize("name", pixel_cases.NIBBLE_EDGES)
def test_windowed_model_edge_cases(name, chunk, window):
    """Each edge case: the plain output holds what the case says, and the
    model equals it, whole and trimmed; JAX agrees where no escape index
    is negative."""
    arrays, check = pixel_cases.nibble_edge(name)
    args = _t(arrays)
    plain = tbatch.unpack_nibble(*args)
    check(plain)
    assert torch.equal(k6.unpack_nibble_windowed(
        *args, chunk=chunk, window=window), plain)
    n_rows = arrays[0].shape[1] // 2
    cut = tbatch.unpack_nibble(args[0][:1, :n_rows],
                               *(a[:1] for a in args[1:]))
    assert torch.equal(k6.unpack_nibble_windowed(
        *args, n_img=1, n_rows=n_rows, chunk=chunk, window=window), cut)
    if (arrays[3] >= 0).all() and chunk == KERNEL[0]:
        np.testing.assert_array_equal(plain[:, :-1].numpy(),
                                      _jax_blocks(arrays))


def test_trim_and_wire_arguments_checked():
    args = _t(pixel_cases.nibble_group(12, 40))
    for kw in (dict(n_img=5), dict(n_img=-1), dict(n_rows=41),
               dict(n_rows=-1)):
        with pytest.raises(ValueError):
            k6.unpack_nibble(*args, **kw)
        with pytest.raises(ValueError):
            k6.unpack_nibble_windowed(*args, **kw)
    empty = k6.unpack_nibble(*args, n_img=0, n_rows=7)
    assert empty.shape == (0, 8, 64)
    # The wire checks a launch makes, on CPU tensors.
    k6.check_wire(*args, 4)
    with pytest.raises(ValueError, match="batch sizes"):
        k6.check_wire(args[0], args[1][:2], *args[2:], 4)
    with pytest.raises(TypeError):
        k6.check_wire(args[0].to(torch.int32), *args[1:], 4)
    with pytest.raises(ValueError, match="65535"):
        k6.check_wire(*args, 65536)


# -- the batch route's trim ----------------------------------------------------

def _blob(seed, h, w, **kw):
    rng = np.random.default_rng(seed)
    rgb = synthetic_photo(rng, h, w)
    if kw.get("grayscale"):
        rgb = rgb[..., 0]
    return encode(rgb, **kw)[0]


#: Encoder-made frames of several kinds and sizes: mixed sizes in one
#: 4:2:0 bucket (three images, a batch of 4 with a padding row), 4:4:4,
#: 4:2:2, gray, 12-bit and SOF9 frames (the last two ride the wire from
#: host planes).
BLOBS = ([_blob(1, 48, 80), _blob(2, 40, 72, quality=95),
          _blob(3, 60, 100, restart_interval=2)]
         + [_blob(4, 24, 40, samplings=((1, 1),) * 3),
            _blob(5, 24, 40, samplings=((2, 1), (1, 1), (1, 1)),
                  quality=60),
            _blob(6, 30, 20, grayscale=True),
            _blob(7, 32, 48, precision=12),
            _blob(8, 32, 48, arithmetic=True)])


def test_trim_drops_only_zeros_on_encoder_groups():
    """On every group the batch route makes of encoder-made frames, the
    trimmed unpack (``BatchDecoder.unpack``, the wrapper on CPU tensors) is
    the whole plain output's ``[:n_img, :n_rows + 1]``, the whole output
    is zero on everything the trim drops, and the model agrees."""
    with tbatch.BatchDecoder(device="cpu", wire="nibble") as bd:
        groups = bd.group(bd.host_stage(BLOBS))
        assert len(groups) >= 6
        for g in groups:
            t = bd.to_device(g)
            whole = tbatch.unpack_nibble(*t[:-2])
            got = bd.unpack(g, t)
            assert g.n_img == len(g.idxs)
            assert g.n_rows == max(h.mcus_x * h.mcus_y for h in g.headers) \
                * sum(h * v for h, v in g.comp_hv)
            assert got.shape == (g.n_img, g.n_rows + 1, 64)
            assert torch.equal(got, whole[:g.n_img, :g.n_rows + 1])
            rest = whole.clone()
            rest[:g.n_img, :g.n_rows + 1] = 0
            assert not rest.any()
            assert torch.equal(k6.unpack_nibble_windowed(
                *t[:-2], n_img=g.n_img, n_rows=g.n_rows), got)


@pytest.mark.parametrize("idct", ["pallas", "exact", "kron", "fast"])
def test_batch_rgb_with_trim_equals_without(idct):
    """``BatchDecoder``'s RGB (trimmed blocks: three images of a mixed-size
    bucket in a batch of 4, and the other groups) equals the RGB of the
    same groups from the whole unpack, padding rows included."""
    with tbatch.BatchDecoder(device="cpu", wire="nibble", idct=idct) as bd:
        items = bd.decode(BLOBS)
        assert all(it.ok for it in items)
        groups = bd.group(bd.host_stage(BLOBS))
        assert any(len(g.idxs) == 3 for g in groups)
        for g in groups:
            t = bd.to_device(g)
            assert t[0].shape[0] > g.n_img or len(g.idxs) != 3
            kw = dict(comp_shapes=g.comp_shapes, comp_hv=g.comp_hv,
                      height=g.height, width=g.width, samplings=g.samplings,
                      idct=idct, upsample="fancy", color=g.color,
                      precision=g.precision)
            whole = tbatch.rgb_from_blocks_dyn(
                tbatch.unpack_nibble(*t[:-2]), t[-2], t[-1], **kw)
            got = bd.pixels(g, t)
            assert torch.equal(got, whole)
            assert torch.equal(items[g.idxs[0]].rgb_batch, got)


@pytest.mark.parametrize("kind", ["420", "gray", "ycck", "12-bit 420"])
def test_short_blocks_are_padding(kind):
    """K6b's contract for blocks of fewer images than the geometry, on its
    plain version and its tile model: the RGB of the zero-padded blocks,
    the images past the blocks the colour of zeros, under every IDCT."""
    hv, color, prec = {k[0]: k[1:] for k in pixel_cases.FRAME_KINDS}[kind]
    blocks, qt, geom, kw = pixel_cases.bucket_group(
        3, hv, color, prec, pixel_cases.odd_dims(hv, (5, 3)), (8, 4), pad=5)
    padded = torch.from_numpy(blocks)
    padded[3:] = 0
    short = padded[:3].contiguous()
    qt, geom = torch.from_numpy(qt), torch.from_numpy(geom)
    for idct in ("exact", "pallas", "kron", "fast"):
        ref = tbatch.rgb_from_blocks_torch(padded, qt, geom, idct=idct,
                                           upsample="fancy", **kw)
        assert ref.shape[0] == 5
        assert torch.equal(tbatch.rgb_from_blocks_torch(
            short, qt, geom, idct=idct, upsample="fancy", **kw), ref)
        assert torch.equal(k6.rgb_tiles_torch(
            short, qt, geom, idct=idct, upsample="fancy", tile=(16, 16),
            grid=3, **kw), k6.rgb_tiles_torch(
            padded, qt, geom, idct=idct, upsample="fancy", tile=(16, 16),
            grid=3, **kw))
        assert torch.equal(k6.blocks_to_rgb(short, qt, geom, idct=idct,
                                            upsample="fancy", **kw), ref)
    assert (ref[3:] == ref[3, 0, 0]).all()


class _MockLib:
    """Records ``jd_blocks_to_rgb``'s arguments instead of launching."""

    def __init__(self):
        self.calls = []

    def jd_blocks_to_rgb(self, *args):
        self.calls.append(args)
        return 0


def test_short_blocks_launch_arguments():
    """What ``blocks_to_rgb`` hands the kernel for short blocks, on CPU
    tensors with a mock library: every image of the geometry as work, the
    blocks' images as ``n_coded`` (dims[19]); the checks take fewer block
    images and refuse more."""
    hv, color, prec = ((2, 2), (1, 1), (1, 1)), "ycbcr", 8
    blocks, qt, geom, kw = pixel_cases.bucket_group(
        4, hv, color, prec, pixel_cases.odd_dims(hv, (5, 3)), (8, 4), pad=4)
    tb_, tq, tg = _t((blocks, qt, geom))
    short = tb_[:3].contiguous()
    k6.check_rgb_args(short, tq, tg, 3, "pallas")
    with pytest.raises(ValueError):
        k6.check_rgb_args(torch.cat([tb_, tb_[:1]]), tq, tg, 3, "pallas")
    plan = k6.rgb_plan(upsample="fancy", tile=k6._whole_mcus(k6.TILE, hv),
                       **kw)
    out = torch.empty((4, plan.out_h, plan.out_w, 3), dtype=torch.uint8)
    lib = _MockLib()
    k6.launch_rgb(lib, short, tq, tg, idct_cuda._basis(torch.device("cpu"),
                                                       False),
                  out, plan, "pallas", 7, 0)
    call = lib.calls[-1]
    assert call[5] == 4 and call[6] == short.shape[1]
    assert len(call[7]) == 20 and call[7][19] == 3
