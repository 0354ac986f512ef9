"""Seeded inputs of the pixel stage's kernels, K6a and K6b, for the CPU
tests, the card tests and ``chip_smoke.py``: padded nibble-wire groups
with the traps of its unpack, rows made for the edges of K6a's kernel, and
bucketed groups of scan-order blocks with
per-image geometry, for any sampling, colour space and precision.
"""

from __future__ import annotations

import numpy as np

from ..models import batch

#: (name, (h, v) per component, colour space, precision): every kind of
#: frame the batch routes group.  "411" has a ratio-4 chroma (nn under
#: fancy too), "odd" ratios that do not divide (a plane narrower than the
#: output, which the pipeline crops to).
FRAME_KINDS = (
    ("420", ((2, 2), (1, 1), (1, 1)), "ycbcr", 8),
    ("444", ((1, 1), (1, 1), (1, 1)), "ycbcr", 8),
    ("422", ((2, 1), (1, 1), (1, 1)), "ycbcr", 8),
    ("440", ((1, 2), (1, 1), (1, 1)), "ycbcr", 8),
    ("411", ((4, 1), (1, 1), (1, 1)), "ycbcr", 8),
    ("gray", ((1, 1),), "gray", 8),
    ("adobe rgb", ((1, 1), (1, 1), (1, 1)), "rgb", 8),
    ("cmyk", ((1, 1),) * 4, "cmyk", 8),
    ("ycck", ((2, 2), (1, 1), (1, 1), (2, 2)), "ycck", 8),
    ("12-bit 420", ((2, 2), (1, 1), (1, 1)), "ycbcr", 12),
    ("12-bit gray", ((1, 1),), "gray", 12),
    ("odd", ((3, 1), (2, 1), (1, 1)), "ycbcr", 8),
)


def random_blocks(rng, n: int, density: float, spread: int = 300,
                  dc: int = 900) -> np.ndarray:
    """(n, 64) int32 blocks: ``density`` of the AC terms nonzero in
    [-spread, spread) (escapes past 127, long gaps at low density), DC in
    [-dc, dc)."""
    blocks = np.zeros((n, 64), np.int32)
    mask = rng.random(blocks.shape) < density
    blocks[mask] = rng.integers(-spread, spread, mask.sum())
    blocks[:, 0] = rng.integers(-dc, dc, n)
    return blocks


def nibble_group(seed: int, n_blk: int, densities=(0.02, 0.3, 0.9),
                 pad: int = 4, traps: bool = True):
    """The padded nibble-wire arrays of a group (dc16, e, ov, esc_idx,
    esc_val), as ``BatchDecoder.group`` pads them: one image per density
    (each a prefix of the ``n_blk`` block capacity), the batch padded to
    ``pad`` rows of fillers.  With ``traps`` the last row is made up: random
    entry bytes after a first one that advances (fillers after a real
    value, gap-0 entries that land on a position twice, runs of overflow
    codes), an overflow stream of random values, escapes on DC slots, past
    the end and before the start.
    Returns the numpy arrays."""
    rng = np.random.default_rng(seed)
    packs = []
    for k, dens in enumerate(densities):
        blocks = random_blocks(rng, max(n_blk - 7 * k, 1), dens)
        dc16, ac8, ei, ev = batch.pack_blocks(blocks)
        packs.append((dc16, *batch.nibbleize_ac(ac8), ei, ev))
    k_len = max(len(p[1]) for p in packs) + 53
    o_len = max(len(p[2]) for p in packs) + 5
    e_len = max(len(p[3]) for p in packs) + 3
    dc = np.zeros((pad, n_blk), np.int16)
    e = np.zeros((pad, k_len), np.uint8)
    ov = np.zeros((pad, o_len), np.int8)
    ei = np.full((pad, e_len), n_blk * 64, np.int32)
    ev = np.zeros((pad, e_len), np.int16)
    for k, p in enumerate(packs):
        dc[k, :len(p[0])] = p[0]
        e[k, :len(p[1])] = p[1]
        ov[k, :len(p[2])] = p[2]
        ei[k, :len(p[3])] = p[3]
        ev[k, :len(p[4])] = p[4]
    if traps:
        t = pad - 1
        n = min(k_len, 4 * n_blk)
        e[t, :n] = rng.integers(0, 256, n)
        e[t, 0] = 0x31                          # no position before 0
        e[t, 10:16] = (0x05, 0x00, 0x00, 0x03, 0x08, 0x08)
        e[t, 20:30] = 0x18                      # a run of overflow codes
        ov[t] = rng.integers(-128, 128, o_len)
        dc[t] = rng.integers(-2000, 2000, n_blk)
        ei[t, :3] = (64, 70, -3)
        ev[t, :3] = (999, -500, 7)
    return dc, e, ov, ei, ev


def nibble_edge(name: str):
    """One edge case of K6a's kernel (:data:`NIBBLE_EDGES`): two rows of
    wire as numpy arrays (dc16, e, ov, esc_idx, esc_val) and a function
    that asserts what the plain output (a CPU tensor) must hold there."""
    n_blk = 800
    rng = np.random.default_rng(len(name))
    dc = rng.integers(-900, 900, (2, n_blk)).astype(np.int16)
    e = np.zeros((2, 200), np.uint8)
    ov = np.zeros((2, 16), np.int8)
    ei = np.full((2, 8), n_blk * 64, np.int32)
    ev = np.zeros((2, 8), np.int16)

    def check(out):
        return None

    if name == "gap-0 entry opens a chunk":
        # At chunks of 4 (and 3, 7: other edges), entry 4 is a real entry
        # that advances 0 after an extender: it adds at position 2 + 48 +
        # ... - 1, the position before its chunk's first one.
        e[0, :8] = (0x11, 0x21, 0x11, 0x30, 0x05, 0x13, 0x00, 0x1F)
        e[1, :6] = (0x20, 0x00, 0x03, 0x30, 0x0D, 0x11)

        def check(out):
            assert int(out[0].view(-1)[4 + 48 - 1]) == 5
            assert int(out[1].view(-1)[32 - 1]) == 3
            assert int(out[1].view(-1)[32 + 48 - 1]) == -3
    elif name == "chunks of extenders only":
        # 150 extenders of +240 (36,000 positions: windows and chunks with
        # no value at all), then values; the other row's run ends the row.
        e[0, 0] = 0x11
        e[0, 1:151] = 0xF0
        e[0, 151:155] = (0x13, 0x2A, 0xF0, 0x17)
        e[1, :100] = 0xF0

        def check(out):
            flat = out[0].view(-1)
            assert int(flat[1 + 36000 + 1 - 1]) == 3
            assert int(flat[1 + 36000 + 1 + 2 - 1]) == -6
    elif name == "rows of fillers only":
        ei[0, :2] = (70, 130)
        ev[0, :2] = (-999, 999)

        def check(out):
            assert int(out[1].view(-1).abs().sum()) == int(
                np.abs(dc[1].astype(np.int64)).sum())
            assert int(out[0].view(-1)[70]) == -999
    elif name == "escapes on DC slots and out of range":
        e[:, :40] = rng.integers(0, 256, (2, 40))
        e[:, 0] = 0x31
        ei[0] = (0, 64, 65, 127, 4 * 64 + 3, n_blk * 64 - 1, n_blk * 64,
                 n_blk * 64 + 7)
        ei[1, :5] = (65, 0, -5, 200, n_blk * 64 + 64)       # they fall
        ev[:] = rng.integers(-2000, 2000, (2, 8))

        def check(out):
            flat = out[0].view(-1)
            assert int(flat[0]) == int(dc[0, 0])             # DC wins
            assert int(flat[64]) == int(dc[0, 1])
            assert int(flat[65]) == int(ev[0, 2])
            assert int(flat[n_blk * 64 - 1]) == int(ev[0, 5])
            assert not out[:, -1].any()                      # fill block
            assert int(out[1].view(-1)[200]) == int(ev[1, 3])
    elif name == "overflow values":
        # Runs of overflow codes (0x?8), more of them than ov values (the
        # rank clamps to the last), some values 0, some cancelling.
        e[0, :30] = 0x18
        e[0, 30:34] = (0x08, 0x08, 0x0F, 0x01)
        ov[0] = (100, -100, 0, 127, -128, 5, 0, 0, 9, 1, 2, 3, 4, 5, 6, 77)
        e[1, :10] = (0x28, 0x08, 0x18, 0x00, 0x00, 0x08, 0x38, 0x30, 0x08,
                     0x11)
        ov[1, :4] = (-50, 50, 7, -7)

        def check(out):
            flat = out[0].view(-1)
            assert int(flat[29]) == 77 + 77 + 77 - 1 + 1
    elif name == "12-bit values":
        blocks = random_blocks(rng, n_blk, 0.3, spread=30000, dc=16000)
        dc16, ac8, i, v = batch.pack_blocks(blocks)
        ent, o = batch.nibbleize_ac(ac8)
        dc[0] = dc16
        e = np.zeros((2, len(ent) + 20), np.uint8)
        e[0, :len(ent)] = ent
        ov = np.zeros((2, len(o) + 3), np.int8)
        ov[0, :len(o)] = o
        ei = np.full((2, len(i) + 5), n_blk * 64, np.int32)
        ev = np.zeros((2, len(i) + 5), np.int16)
        ei[0, :len(i)], ev[0, :len(i)] = i, v

        def check(out):
            np.testing.assert_array_equal(out[0, :-1].numpy(), blocks)
    else:
        raise KeyError(name)
    return [dc, e, ov, ei, ev], check


#: K6a's edge cases, the names :func:`nibble_edge` takes.
NIBBLE_EDGES = ["gap-0 entry opens a chunk", "chunks of extenders only",
                "rows of fillers only",
                "escapes on DC slots and out of range", "overflow values",
                "12-bit values"]


def bucket_group(seed: int, comp_hv, color: str, precision: int, dims,
                 bucket, pad: int | None = None):
    """A bucketed group of scan-order blocks as the batch routes hand it to
    the pixel stage: per image of true (height, width) ``dims`` its MCU
    grid's JPEG-like blocks as a prefix of the bucket's block capacity,
    zeros after, the zero fill row last; images past ``len(dims)`` up to
    ``pad`` are zero rows with the last image's tables and geometry.
    ``bucket`` = (MCUs across, MCUs down).  Returns (blocks (B, n_blk + 1,
    64) int32, qtables (B, n_comps, 64) int32, geom (B, 4) int32, the
    keyword arguments of ``rgb_from_blocks_dyn`` but ``idct`` and
    ``upsample``) as numpy arrays and a dict."""
    rng = np.random.default_rng(seed)
    h_max = max(h for h, _ in comp_hv)
    v_max = max(v for _, v in comp_hv)
    bpm = sum(h * v for h, v in comp_hv)
    mxb, myb = bucket
    n_blk = mxb * myb * bpm
    b = pad or len(dims)
    blocks = np.zeros((b, n_blk + 1, 64), np.int32)
    geom = np.zeros((b, 4), np.int32)
    scale = 16 if precision == 12 else 1
    for k, (th, tw) in enumerate(dims):
        gx = -(-(-(-tw // 8)) // h_max)
        gy = -(-(-(-th // 8)) // v_max)
        assert gx <= mxb and gy <= myb
        nt = gx * gy * bpm
        blk = random_blocks(rng, nt, 0.2, spread=12, dc=60)
        blk[:, 0] *= scale
        blocks[k, :nt] = blk
        geom[k] = (gx, gy, th, tw)
    geom[len(dims):] = geom[len(dims) - 1]
    qt = rng.integers(1, 30, (b, len(comp_hv), 64)).astype(np.int32)
    qt[len(dims):] = qt[len(dims) - 1]
    kw = dict(comp_shapes=tuple((myb * v, mxb * h) for h, v in comp_hv),
              comp_hv=tuple(comp_hv), height=myb * 8 * v_max,
              width=mxb * 8 * h_max,
              samplings=tuple((v_max // v, h_max // h) for h, v in comp_hv),
              color=color, precision=precision)
    return blocks, qt, geom, kw


def odd_dims(comp_hv, mcus) -> list:
    """True (height, width) of three images in a bucket of ``mcus`` (MCUs
    across, down): the whole bucket, odd dims inside it, and a tiny one."""
    h_max = max(h for h, _ in comp_hv)
    v_max = max(v for _, v in comp_hv)
    mx, my = mcus
    return [(my * 8 * v_max, mx * 8 * h_max),
            (my * 8 * v_max - 11, mx * 8 * h_max - 5), (9, 13)]


def frame_blob(kind: str, seed: int, height: int, width: int,
               **kw) -> bytes:
    """A JPEG frame of :data:`FRAME_KINDS`' ``kind``, ``height`` x ``width``,
    from a seeded gradient with noise (one interleaved scan; ``kw`` goes to
    ``testing.encoder.encode``, such as ``restart_interval``)."""
    from .encoder import encode

    hv, color, precision = {k[0]: k[1:] for k in FRAME_KINDS}[kind]
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    base = np.stack([x * 255.0 / width, y * 255.0 / height,
                     (x + y) * 127.0 / (width + height) + 60], axis=-1)
    rgb = np.clip(base + rng.normal(0.0, 6.0, base.shape), 0,
                  255).astype(np.uint8)
    kw = dict(samplings=hv, precision=precision, **kw)
    if color == "gray":
        return encode(rgb[..., 0], grayscale=True, **kw)[0]
    if color == "ycbcr":
        return encode(rgb, **kw)[0]
    planes = [rgb[..., k % 3].astype(np.float64) for k in range(len(hv))]
    return encode(rgb, raw_planes=planes,
                  app14_transform=2 if color == "ycck" else 0, **kw)[0]
