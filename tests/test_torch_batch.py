"""The batched serving slice of the PyTorch port against the JAX package.

The same blobs, made from a numpy seed by tools/encoder.py and PIL, go
through the JAX ``BatchDecoder(entropy="native", idct="pallas",
upsample="fancy")`` (which runs the Kronecker IDCT on the CPU) and the
port's ``BatchDecoder(device="cpu", idct="pallas")`` (which runs the
kernel's plain twin on a CPU tensor).  Tolerance: RGB max |diff| <= 2 with >= 99.99% of samples
equal — the IDCT may round +-1 differently (another summation order), and
the colour transform's x1.402 can turn that into 2.  The wire unpack and
the plane gather are integer code and must match exactly.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu.models import batch as jbatch  # noqa: E402

from jpeg_decoder_tpu_torch import JPEGError  # noqa: E402
from jpeg_decoder_tpu_torch.models import batch as tbatch  # noqa: E402

RGB_TOL = 2          # +-1 IDCT rounding times the x1.402 colour gain
MIN_EQUAL = 0.9999   # share of RGB samples that must match exactly


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 6.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _mixed_batch():
    """Two 4:2:0 buckets (one with two true sizes), 4:4:4 with DRI, an odd
    size, grayscale, a corrupt blob and a PIL progressive blob."""
    b = []
    b.append(encode(_rgb(0, 64, 96), quality=90)[0])              # 0: 420
    b.append(encode(_rgb(1, 48, 40), samplings=((1, 1),) * 3,     # 1: 444
                    quality=95, restart_interval=5)[0])
    b.append(encode(_rgb(2, 37, 53), quality=75,                  # 2: odd
                    restart_interval=2)[0])
    b.append(encode(_rgb(3, 60, 90), quality=85)[0])              # 3: 420
    b.append(b"\xff\xd8\xff\xdb\x00\x04garbage")                  # 4: bad
    buf = io.BytesIO()
    Image.fromarray(_rgb(5, 40, 56)).save(buf, "JPEG", quality=85,
                                          progressive=True)
    b.append(buf.getvalue())                                      # 5: prog
    b.append(encode(_rgb(6, 40, 40)[..., 1], grayscale=True,      # 6: gray
                    samplings=((1, 1),), quality=90)[0])
    b.append(b[0])                                                # 7: dup
    return b


@pytest.fixture(scope="module")
def mixed():
    blobs = _mixed_batch()
    ref = jbatch.BatchDecoder(entropy="native", idct="pallas",
                              upsample="fancy", wire="nibble").decode(blobs)
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        got = bd.decode(blobs)
    return blobs, ref, got


@pytest.mark.parametrize("k", [0, 1, 2, 3, 6, 7])
def test_slice_matches_jax(mixed, k):
    blobs, ref, got = mixed
    assert ref[k].ok and got[k].ok, (ref[k].error, got[k].error)
    assert got[k].index == k
    a = got[k].rgb.numpy()
    r = np.asarray(ref[k].rgb)
    assert a.shape == r.shape and a.dtype == r.dtype == np.uint8
    d = np.abs(a.astype(np.int64) - r)
    assert d.max() <= RGB_TOL
    assert (d == 0).mean() >= MIN_EQUAL


def test_slice_isolates_corrupt_blob(mixed):
    _, ref, got = mixed
    assert not ref[4].ok and not got[4].ok
    assert isinstance(got[4].error, JPEGError)
    assert got[4].header is None


def test_slice_returns_progressive_as_not_ported(mixed):
    """The progressive blob decodes through the host-plane fallback, as in
    the JAX package (the name predates the fallback): within the slice's
    tolerance of JAX, in a group of its own geometry."""
    _, ref, got = mixed
    assert ref[5].ok and got[5].ok, got[5].error
    d = np.abs(got[5].rgb.numpy().astype(np.int64) - np.asarray(ref[5].rgb))
    assert d.max() <= RGB_TOL
    assert (d == 0).mean() >= MIN_EQUAL
    assert got[5].header.progressive


def test_slice_groups_share_outputs(mixed):
    """Same bucket -> same group tensor; the padded batch row count is a
    power of two."""
    _, _, got = mixed
    assert got[0].rgb_batch is got[3].rgb_batch is got[7].rgb_batch
    assert got[0].rgb_batch.shape[0] == 4
    assert got[2].rgb_batch is not got[0].rgb_batch


def _wire(seed, n_blk, density):
    rng = np.random.default_rng(seed)
    blocks = np.zeros((n_blk, 64), np.int32)
    mask = rng.random(blocks.shape) < density
    blocks[mask] = rng.integers(-300, 300, mask.sum())
    blocks[:, 0] = rng.integers(-900, 900, n_blk)
    dc16, ac8, ei, ev = tbatch.pack_blocks(blocks)
    e, ov = tbatch.nibbleize_ac(ac8)
    return blocks, (dc16, e, ov, ei, ev)


@pytest.mark.parametrize("density", [0.0, 0.02, 0.3])
def test_unpack_nibble_exact(density):
    """Ragged streams padded as the batch path pads them (plus one image
    whose true blocks are a strict prefix of the bucket) rebuild the
    blocks exactly, escapes included, with the fill block zero."""
    n_blk = 40
    imgs = [_wire(10, n_blk, density), _wire(11, 23, density)]
    b = 2
    kmax = max(len(w[1]) for _, w in imgs) + 17
    omax = max(len(w[2]) for _, w in imgs) + 3
    emax = max(len(w[3]) for _, w in imgs) + 5
    dc = np.zeros((b, n_blk), np.int16)
    e = np.zeros((b, kmax), np.uint8)
    ov = np.zeros((b, omax), np.int8)
    ei = np.full((b, emax), n_blk * 64, np.int32)
    ev = np.zeros((b, emax), np.int16)
    for k, (_, (d, ee, o, i, v)) in enumerate(imgs):
        dc[k, :len(d)], e[k, :len(ee)], ov[k, :len(o)] = d, ee, o
        ei[k, :len(i)], ev[k, :len(v)] = i, v
    got = tbatch.unpack_nibble(*(torch.from_numpy(x)
                                 for x in (dc, e, ov, ei, ev)))
    assert got.shape == (b, n_blk + 1, 64) and got.dtype == torch.int32
    for k, (blocks, _) in enumerate(imgs):
        want = np.zeros((n_blk + 1, 64), np.int32)
        want[:len(blocks)] = blocks
        np.testing.assert_array_equal(got[k].numpy(), want)


@pytest.mark.parametrize("comp_hv", [((2, 2), (1, 1), (1, 1)),
                                     ((1, 1), (1, 1), (1, 1)),
                                     ((2, 1), (1, 1), (1, 1))])
def test_planes_from_blocks_dyn_exact(comp_hv):
    mxb, myb = 4, 2
    bpm = sum(h * v for h, v in comp_hv)
    n_blk = mxb * myb * bpm
    comp_shapes = tuple((myb * v, mxb * h) for h, v in comp_hv)
    geom = np.array([[4, 2, 32, 64], [3, 1, 9, 40]], np.int32)
    rng = np.random.default_rng(12)
    blocks = rng.integers(-99, 99, size=(2, n_blk + 1, 64)).astype(np.int32)
    blocks[:, n_blk] = 0
    got = tbatch.planes_from_blocks_dyn(
        torch.from_numpy(blocks), torch.from_numpy(geom),
        comp_shapes=comp_shapes, comp_hv=comp_hv)
    for k in range(2):
        ref = jbatch._planes_from_blocks_dyn(
            jnp.asarray(blocks[k, :n_blk]), jnp.asarray(geom[k]),
            comp_shapes=comp_shapes, comp_hv=comp_hv, bpm=bpm)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r))


# Options of the JAX BatchDecoder: the ported ones are accepted (jax and
# hybrid since the emit-lane port); unknown values raise ValueError.
ACCEPTED = [dict(wire="sparse"), dict(wire="packed"), dict(entropy="python"),
            dict(idct="exact"), dict(entropy="jax"), dict(entropy="hybrid")]


@pytest.mark.parametrize("kw", ACCEPTED[:4] + [
    dict(upsample="bicubic"), dict(entropy="jax"),
    dict(entropy="hybrid"), dict(wire="dense"), dict(bucket="pow3")])
def test_decoder_rejects_unported_options(kw):
    if kw in ACCEPTED:
        with tbatch.BatchDecoder(device="cpu", **kw) as bd:
            for name, value in kw.items():
                assert getattr(bd, name) == value
        return
    with pytest.raises(ValueError):
        tbatch.BatchDecoder(device="cpu", **kw)


def test_defaults_are_jax_signature():
    """BatchDecoder's keyword defaults equal the JAX package's, but for
    the device (the card here, the default JAX device there)."""
    import inspect

    def defaults(cls):
        return {k: p.default for k, p in
                inspect.signature(cls.__init__).parameters.items()
                if p.default is not inspect.Parameter.empty}

    got, ref = defaults(tbatch.BatchDecoder), defaults(jbatch.BatchDecoder)
    assert got.pop("device") == "cuda" and ref.pop("device") is None
    assert got == ref
    assert (got["entropy"], got["idct"]) == ("auto", "fast")


def test_decoder_needs_a_device(monkeypatch):
    """The default device is the card: without one the constructor raises
    and names the CPU option; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbatch.BatchDecoder()
