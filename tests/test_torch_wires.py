"""The four wire formats of the port's batch path against the JAX package.

Host side: the numpy encoders (``pack_blocks``, ``sparsify_ac``,
``nibbleize_ac``, ``slotify_ac``) and the native emitters equal JAX's byte
for byte.  Device side: each reconstruction (``unpack_<wire>``, on a CPU
tensor) equals the blocks JAX's ``_batched_from_<wire>`` builds from the
same padded group arrays — JAX's own function, run unjitted with its pixel
stage replaced by the identity — exactly, padding rows included.  End to
end: ``BatchDecoder(wire=w, device="cpu")`` is within +-2 of JAX's
``BatchDecoder(wire=w, idct="pallas")`` (the Kronecker IDCT on the CPU) and
equal on >= 99.99% of samples, and the four wires give bit-identical RGB.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu.entropy import native as jnative  # noqa: E402
from jpeg_decoder_tpu.io import parser as jparser  # noqa: E402
from jpeg_decoder_tpu.models import batch as jbatch  # noqa: E402

from jpeg_decoder_tpu_torch.entropy import native as tnative  # noqa: E402
from jpeg_decoder_tpu_torch.io import parser as tparser  # noqa: E402
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


def _blocks(seed, n, density, spread=300):
    """Random blocks: ``density`` of the AC terms nonzero in [-spread,
    spread) (|v| > 127 escapes, > 16 nonzeros per block at high density,
    gaps > 255 at low), DC in [-900, 900)."""
    rng = np.random.default_rng(seed)
    blocks = np.zeros((n, 64), np.int32)
    mask = rng.random(blocks.shape) < density
    blocks[mask] = rng.integers(-spread, spread, mask.sum())
    blocks[:, 0] = rng.integers(-900, 900, n)
    return blocks


@pytest.mark.parametrize("density", [0.0, 0.003, 0.05, 0.4, 0.95])
def test_wire_encoders_match_jax(density):
    blocks = _blocks(int(density * 1000), 211, density)
    got, ref = tbatch.pack_blocks(blocks), jbatch.pack_blocks(blocks)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ac8 = ref[1]
    for fn, args in (("sparsify_ac", ()), ("nibbleize_ac", ()),
                     ("slotify_ac", (16,)), ("slotify_ac", (5,))):
        for a, b in zip(getattr(tbatch, fn)(ac8, *args),
                        getattr(jbatch, fn)(ac8, *args)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if density == 0.003:
        assert (tbatch.sparsify_ac(ac8)[0] == 255).any()   # extenders
    if density >= 0.4:
        assert len(ref[2]) and len(tbatch.slotify_ac(ac8, 16)[2])


# Blobs for the emitters and the end-to-end runs: two 4:2:0 sizes of one
# pow-2 bucket, 4:4:4 with DRI, and a low-quality one (escapes, long runs).
def _wire_blobs():
    return [encode(_rgb(0, 64, 96), quality=90)[0],
            encode(_rgb(1, 60, 90), quality=85, restart_interval=3)[0],
            encode(_rgb(2, 48, 40), samplings=((1, 1),) * 3, quality=95,
                   restart_interval=5)[0],
            encode(_rgb(3, 56, 72), quality=100)[0]]


BLOBS = _wire_blobs()
EMITTERS = ("packed", "sparse", "slots", "nibble")


@pytest.mark.parametrize("k", range(len(BLOBS)))
@pytest.mark.parametrize("wire", EMITTERS)
def test_native_emitters_match_numpy_and_jax(wire, k):
    """Each native emitter equals the numpy encoder of the same blocks and
    the JAX package's binding."""
    got_hdr, ref_hdr = tparser.parse(BLOBS[k]), jparser.parse(BLOBS[k])
    name = f"decode_scan_{wire}"
    got = getattr(tnative, name)(got_hdr, got_hdr.scans[0])
    ref = getattr(jnative, name)(ref_hdr, ref_hdr.scans[0])
    pack = tbatch.pack_blocks(
        tnative.decode_scan_baseline(got_hdr, got_hdr.scans[0]))
    dc16, ac8, ei, ev = pack
    numpy_wire = {"packed": pack,
                  "sparse": (dc16, *tbatch.sparsify_ac(ac8), ei, ev),
                  "nibble": (dc16, *tbatch.nibbleize_ac(ac8), ei, ev),
                  "slots": (dc16, *tbatch.slotify_ac(ac8, 16), ei, ev)}[wire]
    assert len(got) == len(ref) == len(numpy_wire)
    for a, b, c in zip(got, ref, numpy_wire):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_native_slots_refuses_bad_capacity():
    hdr = tparser.parse(BLOBS[0])
    for cap in (0, 64):
        with pytest.raises(ValueError):
            tnative.decode_scan_slots(hdr, hdr.scans[0], cap)


@pytest.mark.parametrize("wire", tbatch.WIRES)
def test_reconstruction_matches_jax_blocks(wire, monkeypatch):
    """The port's padded group arrays of three images (one a strict prefix
    of the bucket, escapes and >16 nonzeros per block included; the batch
    padded to 4) rebuild exactly JAX's blocks, pad rows included, and the
    fill block is zero.  The nibble wire's unpack returns only the blocks
    the pixels read (the three images, the longest one's blocks, then the
    fill block): JAX's blocks there, and JAX's are zero on the rest."""
    big = tparser.parse(BLOBS[0])                 # 6 x 4 MCUs of 4:2:0
    small = tparser.parse(                        # 5 x 3, same 8 x 4 bucket
        encode(_rgb(5, 48, 80), quality=80)[0])
    n_big = big.mcus_x * big.mcus_y * 6
    n_small = small.mcus_x * small.mcus_y * 6
    host_out = []
    for seed, (hdr, n) in enumerate(((big, n_big), (small, n_small),
                                     (big, n_big))):
        blocks = _blocks(40 + seed, n, (0.02, 0.3, 0.9)[seed])
        dc16, ac8, ei, ev = tbatch.pack_blocks(blocks)
        wire_pack = {
            "packed": (dc16, ac8, ei, ev),
            "sparse": (dc16, *tbatch.sparsify_ac(ac8), ei, ev),
            "nibble": (dc16, *tbatch.nibbleize_ac(ac8), ei, ev),
            "slots": (dc16, *tbatch.slotify_ac(ac8, 16), ei, ev)}[wire]
        host_out.append((hdr, wire_pack))
    with tbatch.BatchDecoder(device="cpu", idct="pallas", wire=wire) as bd:
        (group,) = bd.group(host_out)
        got = bd.unpack(group, bd.to_device(group))
    b, n_fill = got.shape[:2]
    if wire == "nibble":
        assert (b, n_fill) == (3, n_big + 1) == (group.n_img,
                                                 group.n_rows + 1)
    else:
        assert b == 4 and n_fill == 8 * 4 * 6 + 1
    assert not got[:, -1].any()
    monkeypatch.setattr(jbatch, "_rgb_one_dyn",
                        lambda blocks, *a, **k: blocks)
    fn = getattr(jbatch, f"_batched_from_{wire}").__wrapped__
    ref = fn(*(jnp.asarray(x) for x in group.arrays),
             comp_shapes=group.comp_shapes, comp_hv=group.comp_hv,
             height=group.height, width=group.width,
             samplings=group.samplings, idct="kron", upsample="fancy",
             color=group.color)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(got[:, :-1].numpy(), ref[:b, :n_fill - 1])
    assert not ref[b:].any() and not ref[:, n_fill - 1:].any()
    for k, (_, p) in enumerate(host_out):
        np.testing.assert_array_equal(got[k, :len(p[0]), 0].numpy(), p[0])


@pytest.fixture(scope="module")
def decoded():
    """Every wire through both packages, on blobs of two pow-2 groups, a
    corrupt blob included."""
    blobs = BLOBS + [b"\xff\xd8\xff\xdb\x00\x04garbage"]
    out = {}
    for wire in tbatch.WIRES:
        ref = jbatch.BatchDecoder(entropy="native", idct="pallas",
                                  upsample="fancy", wire=wire).decode(blobs)
        with tbatch.BatchDecoder(device="cpu", idct="pallas", wire=wire) as bd:
            out[wire] = (ref, bd.decode(blobs))
    return out


@pytest.mark.parametrize("wire", tbatch.WIRES)
def test_batch_wire_matches_jax(decoded, wire):
    ref, got = decoded[wire]
    assert [g.ok for g in got] == [r.ok for r in ref] == [True] * 4 + [False]
    for g, r in zip(got[:4], ref[:4]):
        a, b = g.rgb.numpy(), np.asarray(r.rgb)
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        d = np.abs(a.astype(np.int64) - b)
        assert d.max() <= RGB_TOL
        assert (d == 0).mean() >= MIN_EQUAL


@pytest.mark.parametrize("wire", [w for w in tbatch.WIRES if w != "nibble"])
def test_wires_give_identical_rgb(decoded, wire):
    nib, got = decoded["nibble"][1], decoded[wire][1]
    for a, b in zip(nib[:4], got[:4]):
        assert torch.equal(a.rgb, b.rgb)
    assert got[0].rgb_batch is got[1].rgb_batch


@pytest.mark.parametrize("wire", tbatch.WIRES)
def test_wire_without_native_emitter_matches(wire):
    """entropy="python" takes blocks through pack_blocks and the numpy
    encoders: the same RGB as the native emitters."""
    blobs = BLOBS[:2]
    with tbatch.BatchDecoder(device="cpu", idct="pallas", wire=wire,
                             entropy="python") as bd:
        got = bd.decode(blobs)
    with tbatch.BatchDecoder(device="cpu", idct="pallas", wire=wire) as bd:
        ref = bd.decode(blobs)
    for a, b in zip(got, ref):
        assert torch.equal(a.rgb, b.rgb)
