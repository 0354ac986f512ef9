"""Pixel pipeline of the PyTorch port against the JAX package's.

The integer stages (plane assembly, upsampling) and the float32 colour
transform must match exactly: the port writes the same ops in the same
order, and both sides run op by op here (JAX eagerly, not under jit).  The
IDCT differs from JAX only by summation order, so the pipelines with the
Kronecker and einsum IDCTs are held to +-1 IDCT rounding, which the colour
transform's x1.402 can turn into +-2 in RGB.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_decoder_tpu.ops import pixel as jpixel

from jpeg_decoder_tpu_torch.ops import pixel as tpixel

RGB_TOL = 2          # +-1 IDCT rounding times the x1.402 colour gain
MIN_EQUAL = 0.9999   # share of RGB samples that must match exactly


def _planes(seed, b, h, w, lo=-300, hi=300):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(b, h, w)).astype(np.int32)


@pytest.mark.parametrize("vy,vx", [(2, 2), (2, 1), (1, 2), (1, 1), (4, 2),
                                   (3, 1)])
def test_upsample_fancy_exact_no_edge(vy, vx):
    p = _planes(0, 2, 7, 9, -128, 128)
    got = tpixel.upsample_fancy(torch.from_numpy(p), vy, vx).numpy()
    for b in range(2):
        ref = np.asarray(jpixel.upsample_fancy(jnp.asarray(p[b]), vy, vx))
        np.testing.assert_array_equal(got[b], ref)


@pytest.mark.parametrize("vy,vx", [(2, 2), (2, 1), (1, 2)])
def test_upsample_fancy_exact_with_edge(vy, vx):
    """Per-image true extents inside a padded plane: replication happens
    at each image's own edge."""
    p = _planes(1, 3, 8, 12, -128, 128)
    edges = [(8, 12), (5, 7), (1, 3)]
    er = torch.tensor([e[0] for e in edges])
    ec = torch.tensor([e[1] for e in edges])
    got = tpixel.upsample_fancy(torch.from_numpy(p), vy, vx,
                                edge=(er, ec)).numpy()
    for b, (r, c) in enumerate(edges):
        ref = np.asarray(jpixel.upsample_fancy(
            jnp.asarray(p[b]), vy, vx,
            edge=(jnp.int32(r), jnp.int32(c))))
        np.testing.assert_array_equal(got[b], ref)


def test_ycbcr_to_rgb_exact():
    y, cb, cr = (_planes(s, 2, 33, 47) for s in (2, 3, 4))
    got = tpixel.ycbcr_to_rgb(*(torch.from_numpy(x)
                                for x in (y, cb, cr))).numpy()
    for b in range(2):
        ref = np.asarray(jpixel.ycbcr_to_rgb(
            jnp.asarray(y[b]), jnp.asarray(cb[b]), jnp.asarray(cr[b])))
        assert got.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(got[b], ref)


def test_gray_blocks_nn_exact():
    p = _planes(5, 2, 6, 5, -200, 200)
    got = tpixel.gray_to_rgb(torch.from_numpy(p)).numpy()
    up = tpixel.upsample_nn(torch.from_numpy(p), 2, 3).numpy()
    blocks = np.random.default_rng(6).integers(
        -9, 9, size=(2, 3, 4, 64)).astype(np.int32)
    planes = tpixel.blocks_to_plane(torch.from_numpy(blocks)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(jpixel.gray_to_rgb(jnp.asarray(p[b]))))
        np.testing.assert_array_equal(
            up[b], np.asarray(jpixel.upsample_nn(jnp.asarray(p[b]), 2, 3)))
        np.testing.assert_array_equal(
            planes[b], np.asarray(jpixel.blocks_to_plane(
                jnp.asarray(blocks[b]))))


def test_idct_fast_and_dequantize_match_jax():
    rng = np.random.default_rng(7)
    coefs = rng.integers(-64, 64, size=(2, 5, 64)).astype(np.int32)
    q = rng.integers(1, 50, size=(2, 64)).astype(np.int32)
    deq = tpixel.dequantize(torch.from_numpy(coefs), torch.from_numpy(q))
    got = tpixel.idct_fast(deq.reshape(2, 5, 8, 8)).numpy()
    for b in range(2):
        jdeq = jpixel.dequantize(jnp.asarray(coefs[b]), jnp.asarray(q[b]))
        np.testing.assert_array_equal(deq[b].numpy(), np.asarray(jdeq))
        ref = np.asarray(jpixel.idct_fast(jdeq.reshape(5, 8, 8)))
        assert np.abs(got[b].astype(np.int64) - ref).max() <= 1


def _coef_planes(seed, b, comp_shapes):
    """Sparse, JPEG-like quantized coefficient planes."""
    rng = np.random.default_rng(seed)
    out = []
    for rows, cols in comp_shapes:
        p = np.zeros((b, rows, cols, 64), np.int32)
        p[..., 0] = rng.integers(-60, 60, size=(b, rows, cols))
        mask = rng.random((b, rows, cols, 63)) < 0.15
        p[..., 1:][mask] = rng.integers(-12, 12, size=mask.sum())
        out.append(p)
    return out


@pytest.mark.parametrize("idct", ["pallas", "kron", "fast"])
@pytest.mark.parametrize("layout", ["420", "444", "gray"])
def test_pixel_pipeline_matches_jax(idct, layout):
    """Bucket-padded planes with per-image true dims, as the batch path
    calls it."""
    if layout == "420":
        comp_shapes, samplings = ((6, 8), (3, 4), (3, 4)), ((1, 1), (2, 2),
                                                             (2, 2))
    elif layout == "444":
        comp_shapes, samplings = ((4, 5),) * 3, ((1, 1),) * 3
    else:
        comp_shapes, samplings = ((4, 6),), ((1, 1),)
    height, width = comp_shapes[0][0] * 8, comp_shapes[0][1] * 8
    b = 2
    planes = _coef_planes(8, b, comp_shapes)
    rng = np.random.default_rng(9)
    qts = [rng.integers(1, 30, size=(b, 64)).astype(np.int32)
           for _ in comp_shapes]
    true = np.array([[height, width], [height - 11, width - 5]], np.int32)
    got = tpixel.pixel_pipeline_impl(
        tuple(torch.from_numpy(p) for p in planes),
        tuple(torch.from_numpy(q) for q in qts),
        height=height, width=width, samplings=samplings, idct=idct,
        upsample="fancy",
        true_dims=(torch.from_numpy(true[:, 0]),
                   torch.from_numpy(true[:, 1]))).numpy()
    assert got.shape == (b, height, width, 3) and got.dtype == np.uint8
    for k in range(b):
        ref = np.asarray(jpixel.pixel_pipeline_impl(
            tuple(jnp.asarray(p[k]) for p in planes),
            tuple(jnp.asarray(q[k]) for q in qts),
            height=height, width=width, samplings=samplings, idct=idct,
            upsample="fancy",
            true_dims=(jnp.int32(true[k, 0]), jnp.int32(true[k, 1]))))
        th, tw = true[k]
        d = np.abs(got[k, :th, :tw].astype(np.int64) - ref[:th, :tw])
        assert d.max() <= RGB_TOL
        assert (d == 0).mean() >= MIN_EQUAL


def test_pixel_pipeline_rejects_unported():
    p = (torch.zeros((1, 1, 1, 64), dtype=torch.int32),) * 4
    q = (torch.ones((1, 64), dtype=torch.int32),) * 4
    with pytest.raises(ValueError):
        tpixel.pixel_pipeline_impl(p, q, height=8, width=8,
                                   samplings=((1, 1),) * 4)
    with pytest.raises(ValueError):
        tpixel.pixel_pipeline_impl(p[:3], q[:3], height=8, width=8,
                                   samplings=((1, 1),) * 3, idct="exact")
