"""Seeded camera frames and their baseline JPEG bytes.

The benchmark's frozen copy of the port's test photo
(``testing/photo.synthetic_photo``: smooth random colour fields plus
Gaussian luma noise) and of the baseline Huffman path of its encoder
(``testing/encoder.encode``: Annex K tables, libjpeg quality scaling, any
sampling, any restart interval).  It imports nothing of the program, so
that the yardstick stays put when the program changes.

Two changes make it fast enough to run in every benchmark run's set-up:

* the photo, colour conversion, downsampling, FDCT and quantisation run as
  torch float64 operations on the device the caller names (the card in a
  run, the CPU in tests), drawing from a ``torch.Generator`` there;
* the entropy coder is vectorised in torch, on the same device: every
  symbol of the frame is built at once, expanded to bits and packed, then
  stuffed and cut into restart segments.

For the same RGB, samplings, quality and restart interval the bytes equal
``jpeg_decoder_tpu_torch.testing.encoder.encode``'s
(``portbench/tests/test_corpus.py``).  :class:`Frame` keeps the quantised
coefficient planes the bytes code: the entropy layer is lossless, so they
are what a decoder must reconstruct, and the plain reference
(``portbench/reference.py``) starts from them.
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np
import torch

#: Zig-zag order: ZIGZAG[i] is the natural (row-major) index of the i-th
#: coefficient in zig-zag order (T.81 Figure A.6).
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# Annex K.3 Huffman tables: (counts of codes of length 1..16, symbols).
DC_LUMA = (np.array([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
           np.arange(12))
DC_CHROMA = (np.array([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
             np.arange(12))
AC_LUMA = (np.array([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
           np.array([
               0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31,
               0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
               0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
               0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
               0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A,
               0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
               0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
               0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
               0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
               0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94,
               0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
               0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
               0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
               0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
               0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
               0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
               0xF9, 0xFA]))
AC_CHROMA = (np.array([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
             np.array([
                 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06,
                 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81,
                 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
                 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
                 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28,
                 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
                 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56,
                 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
                 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
                 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
                 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
                 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
                 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
                 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6,
                 0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
                 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
                 0xF9, 0xFA]))

# Annex K.1 luminance and K.2 chrominance quantisation tables, zig-zag order.
_Q_LUMA_ZZ = np.array([
    16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101,
    103, 99], np.int64)
_Q_CHROMA_ZZ = np.array([17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56,
                         66] + [99] * 50, np.int64)


def qtable(quality: int, chroma: bool = False) -> np.ndarray:
    """The Annex K table at ``quality`` (libjpeg scaling), natural order
    (64,) int64."""
    quality = max(1, min(100, quality))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    base = _Q_CHROMA_ZZ if chroma else _Q_LUMA_ZZ
    q = np.clip((base * scale + 50) // 100, 1, 255)
    nat = np.empty(64, np.int64)
    nat[ZIGZAG] = q
    return nat


def _dct_matrix() -> np.ndarray:
    """Orthonormal DCT-II matrix, rows are frequencies, float64."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.cos((2 * n + 1) * k * np.pi / 16)
    return c * np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))


DCT = _dct_matrix()


@dataclasses.dataclass
class Frame:
    """One coded frame: its bytes and what they code."""

    blob: bytes
    height: int
    width: int
    #: (h, v) sampling factors of Y, Cb, Cr.
    samplings: tuple
    #: Per component, the (rows, cols, 64) int32 quantised coefficients in
    #: natural order, padded to the MCU grid, on the device they were made.
    planes: list
    #: Per component, its (64,) natural-order quantisation table.
    qtables: list
    restart_interval: int
    #: Bytes of the scan's entropy-coded data (RST markers included).
    scan_bytes: int
    #: Restart segments of the scan (1 without a restart interval).
    segments: int

    @property
    def pixels(self) -> int:
        return self.height * self.width


def photo(gen: torch.Generator, h: int, w: int) -> torch.Tensor:
    """Smooth random colour field (four low-frequency cosines per channel)
    plus Gaussian luma noise of sigma 3: (h, w, 3) uint8 on the
    generator's device.  ``testing/photo.synthetic_photo``'s picture, drawn
    from a torch generator in two calls."""
    dev = gen.device
    f64 = torch.float64
    u = torch.rand((3, 17), generator=gen, device=dev, dtype=f64)
    y = torch.linspace(0.0, 1.0, h, device=dev, dtype=f64)[:, None]
    x = torch.linspace(0.0, 1.0, w, device=dev, dtype=f64)[None, :]
    chans = []
    for c in range(3):
        acc = torch.full((h, w), 60.0, device=dev, dtype=f64) \
            + 130.0 * u[c, 0]
        for k in range(4):
            fy, fx, ph, amp = u[c, 1 + 4 * k: 5 + 4 * k]
            acc = acc + (10.0 + 25.0 * amp) * torch.cos(
                2 * np.pi * ((0.3 + 3.7 * fy) * y + (0.3 + 3.7 * fx) * x)
                + 2 * np.pi * ph)
        chans.append(acc)
    noise = torch.randn((h, w, 1), generator=gen, device=dev, dtype=f64)
    img = torch.stack(chans, dim=-1) + 3.0 * noise
    return torch.clamp(torch.round(img), 0, 255).to(torch.uint8)


def quantise(rgb: torch.Tensor, samplings, quality: int):
    """(H, W, 3) uint8 RGB -> (planes, qtables): the encoder's colour
    conversion, box downsampling, edge padding to the MCU grid, FDCT and
    quantisation, in float64 on ``rgb``'s device."""
    dev = rgb.device
    f64 = torch.float64
    rgbf = rgb.to(f64)
    r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
           0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    hs = [s[0] for s in samplings]
    vs = [s[1] for s in samplings]
    h_max, v_max = max(hs), max(vs)
    H, W = ycc[0].shape
    mcus_x = -(-W // (8 * h_max))
    mcus_y = -(-H // (8 * v_max))
    dct = torch.from_numpy(DCT).to(dev)
    planes, qts = [], []
    for ci, src in enumerate(ycc):
        h, v = hs[ci], vs[ci]
        cw, ch = -(-W * h // h_max), -(-H * v // v_max)
        fx, fy = h_max // h, v_max // v
        py, px = -(-H // fy) * fy, -(-W // fx) * fx
        src = _pad_edge(src, py, px)
        sub = src.reshape(py // fy, fy, px // fx, fx).mean(dim=(1, 3))
        sub = sub[:ch, :cw]
        rows, cols = mcus_y * v, mcus_x * h
        sub = _pad_edge(sub, rows * 8, cols * 8) - 128.0
        blocks = sub.reshape(rows, 8, cols, 8).permute(0, 2, 1, 3)
        f = dct @ blocks @ dct.T
        qt = qtable(quality, chroma=ci > 0)
        q = torch.round(f / torch.from_numpy(qt.astype(np.float64))
                        .to(dev).reshape(8, 8))
        planes.append(q.to(torch.int32).reshape(rows, cols, 64))
        qts.append(qt)
    return planes, qts


def _pad_edge(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(h0, w0) -> (h, w), the last row and column repeated."""
    if x.shape[0] < h:
        x = torch.cat([x, x[-1:].expand(h - x.shape[0], -1)], 0)
    if x.shape[1] < w:
        x = torch.cat([x, x[:, -1:].expand(-1, w - x.shape[1])], 1)
    return x


def _code_table(spec) -> tuple[np.ndarray, np.ndarray]:
    """Canonical codes of a table: (code, length) arrays indexed by
    symbol (T.81 Annex C), length 0 for symbols the table lacks."""
    counts, symbols = spec
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for bitlen in range(1, 17):
        for _ in range(int(counts[bitlen - 1])):
            codes[symbols[k]] = code
            lengths[symbols[k]] = bitlen
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


_TABLES = {False: (_code_table(DC_LUMA), _code_table(AC_LUMA)),
           True: (_code_table(DC_CHROMA), _code_table(AC_CHROMA))}


def _size(v: torch.Tensor) -> torch.Tensor:
    """Magnitude category (bit length of |v|), int64."""
    return torch.frexp(v.abs().to(torch.float64)).exponent.to(torch.int64)


def _scan_blocks(planes, samplings, mcus_x: int, mcus_y: int):
    """The interleaved scan's blocks in coding order: (N, 64) int64, the
    component of each, and its MCU."""
    dev = planes[0].device
    parts, comps = [], []
    for ci, ((h, v), p) in enumerate(zip(samplings, planes)):
        b = p.reshape(mcus_y, v, mcus_x, h, 64).permute(0, 2, 1, 3, 4)
        parts.append(b.reshape(mcus_y * mcus_x, v * h, 64))
        comps += [ci] * (v * h)
    blocks = torch.cat(parts, dim=1)
    bpm = blocks.shape[1]
    n_mcus = mcus_x * mcus_y
    comp = torch.tensor(comps, dtype=torch.int64, device=dev).repeat(n_mcus)
    mcu = torch.arange(n_mcus, device=dev).repeat_interleave(bpm)
    return blocks.reshape(-1, 64).to(torch.int64), comp, mcu


def _lookup(table: np.ndarray, chroma: torch.Tensor, luma_tab: np.ndarray,
            idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` where ``chroma``, else ``luma_tab[idx]``."""
    dev = idx.device
    return torch.where(chroma, torch.from_numpy(table).to(dev)[idx],
                       torch.from_numpy(luma_tab).to(dev)[idx])


def entropy_code(planes, samplings, mcus_x: int, mcus_y: int,
                 restart_interval: int) -> bytes:
    """The interleaved baseline scan's entropy-coded bytes, RST markers
    included, from natural-order (rows, cols, 64) integer planes (tensors;
    the work runs on their device)."""
    blocks, comp, mcu = _scan_blocks(planes, samplings, mcus_x, mcus_y)
    dev = blocks.device
    n = blocks.shape[0]
    seg = (mcu // restart_interval if restart_interval
           else torch.zeros_like(mcu))
    chroma = comp > 0
    zz = blocks[:, torch.from_numpy(ZIGZAG).to(dev)]
    (dcl, dll), (acl, all_) = _TABLES[False]
    (dcc, dlc), (acc, alc) = _TABLES[True]

    # DC: the difference from the previous block of the component in the
    # same restart segment (T.81 F.1.1.5.1, reset at each RSTn).
    dc = zz[:, 0]
    pred = torch.zeros_like(dc)
    for c in range(len(planes)):
        idx = torch.nonzero(comp == c).flatten()
        prev = torch.cat([torch.zeros_like(idx[:1]), idx[:-1]])
        same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                          seg[idx[1:]] == seg[idx[:-1]]])
        pred[idx] = torch.where(same, dc[prev], 0)
    diff = dc - pred
    dsize = _size(diff)
    dbits = torch.where(diff >= 0, diff, diff + (1 << dsize) - 1)
    dc_val = (_lookup(dcc, chroma, dcl, dsize) << dsize) | dbits
    dc_len = _lookup(dlc, chroma, dll, dsize) + dsize

    # AC: each nonzero coefficient after its run of zeros (a ZRL per 16).
    ac = zz[:, 1:]
    blk, pos = torch.nonzero(ac, as_tuple=True)
    pos = pos + 1
    v = ac[blk, pos - 1]
    first = torch.ones_like(blk, dtype=torch.bool)
    first[1:] = blk[1:] != blk[:-1]
    prev_pos = torch.zeros_like(pos)
    prev_pos[1:] = pos[:-1]
    run = pos - torch.where(first, 0, prev_pos) - 1
    asize = _size(v)
    sym = ((run & 15) << 4) | asize
    abits = torch.where(v >= 0, v, v + (1 << asize) - 1)
    ch = chroma[blk]
    ac_val = (_lookup(acc, ch, acl, sym) << asize) | abits
    ac_len = _lookup(alc, ch, all_, sym) + asize
    zsym = torch.full_like(sym, 0xF0)
    zcode = _lookup(acc, ch, acl, zsym)
    zlen = _lookup(alc, ch, all_, zsym)
    zrl = run >> 4
    for k in range(1, 4):   # a run of at most 62 zeros: up to 3 ZRLs
        has = zrl >= k
        ac_val = torch.where(has, ac_val | (zcode << ac_len), ac_val)
        ac_len = torch.where(has, ac_len + zlen, ac_len)

    # EOB after the last nonzero coefficient unless that is the 63rd.
    nnz = torch.bincount(blk, minlength=n)
    eob = zz[:, 63] == 0
    zero = torch.zeros_like(dsize)
    e_val = _lookup(acc, chroma, acl, zero)
    e_len = _lookup(alc, chroma, all_, zero)

    # Items in coding order: per block its DC, its ACs, its EOB.
    per = 1 + nnz + eob.to(torch.int64)
    start = torch.cumsum(per, 0) - per
    n_items = int(per.sum())
    val = torch.zeros(n_items, dtype=torch.int64, device=dev)
    ln = torch.zeros(n_items, dtype=torch.int64, device=dev)
    val[start] = dc_val
    ln[start] = dc_len
    blk_first = torch.cumsum(nnz, 0) - nnz
    at = start[blk] + 1 + torch.arange(blk.numel(), device=dev) \
        - blk_first[blk]
    val[at] = ac_val
    ln[at] = ac_len
    at = (start + 1 + nnz)[eob]
    val[at] = e_val[eob]
    ln[at] = e_len[eob]
    n_seg = int(seg[-1]) + 1 if n else 1
    return _pack(val, ln, torch.repeat_interleave(seg, per), n_seg)


def _pack(val: torch.Tensor, ln: torch.Tensor, item_seg: torch.Tensor,
          n_seg: int) -> bytes:
    """Pack (value, bit length) items MSB first; each segment padded with
    1-bits to a byte, 0xFF stuffed with 0x00, RST0..7 between segments."""
    dev = val.device
    seg_bits = torch.zeros(n_seg, dtype=torch.int64, device=dev) \
        .index_add_(0, item_seg, ln)
    pad = (-seg_bits) % 8
    pad_before = torch.cumsum(pad, 0) - pad
    cum = torch.cumsum(ln, 0) - ln
    item_off = cum + pad_before[item_seg]
    total = int((seg_bits + pad).sum())
    owner = torch.repeat_interleave(torch.arange(ln.numel(), device=dev), ln)
    within = torch.arange(owner.numel(), device=dev) - cum[owner]
    bits = torch.ones(total, dtype=torch.int64, device=dev)
    bits[item_off[owner] + within] = (val[owner] >> (ln[owner] - 1 - within)) \
        & 1
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=dev)
    raw = (bits.view(-1, 8) * weights).sum(1)
    # Each byte moves past the stuffed zeros and markers before it.
    seg_bytes = (seg_bits + pad) // 8
    byte_seg = torch.repeat_interleave(torch.arange(n_seg, device=dev),
                                       seg_bytes)
    ff = (raw == 0xFF).to(torch.int64)
    where = torch.arange(raw.numel(), device=dev) \
        + torch.cumsum(ff, 0) - ff + 2 * byte_seg
    out = torch.zeros(raw.numel() + int(ff.sum()) + 2 * (n_seg - 1),
                      dtype=torch.int64, device=dev)
    out[where] = raw
    first = where[torch.cumsum(seg_bytes, 0)[:-1]]
    out[first - 2] = 0xFF
    out[first - 1] = 0xD0 + torch.arange(n_seg - 1, device=dev) % 8
    return out.to(torch.uint8).cpu().numpy().tobytes()


def headers(height: int, width: int, samplings, qtables,
            restart_interval: int) -> tuple[bytes, bytes]:
    """The bytes before the scan's entropy-coded data (SOI, JFIF APP0, DQT,
    SOF0, DHT, DRI, SOS) and after it (EOI), as the encoder writes them."""
    out = io.BytesIO()
    out.write(b"\xff\xd8")
    out.write(b"\xff\xe0" + struct.pack(">H", 16)
              + b"JFIF\x00\x01\x01\x00" + struct.pack(">HH", 1, 1)
              + b"\x00\x00")
    for tid, nat in enumerate(qtables[:2]):
        raw = np.asarray(nat)[ZIGZAG].astype(np.uint8)
        out.write(b"\xff\xdb" + struct.pack(">H", 67) + bytes([tid])
                  + raw.tobytes())
    ncomp = len(samplings)
    sof = struct.pack(">BHHB", 8, height, width, ncomp)
    for ci, (h, v) in enumerate(samplings):
        sof += bytes([ci + 1, (h << 4) | v, 0 if ci == 0 else 1])
    out.write(b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof)
    for tc, tid, (counts, symbols) in ((0, 0, DC_LUMA), (1, 0, AC_LUMA),
                                       (0, 1, DC_CHROMA), (1, 1, AC_CHROMA)):
        payload = bytes([(tc << 4) | tid]) + bytes(
            np.asarray(counts, np.uint8)) + bytes(
            np.asarray(symbols, np.uint8))
        out.write(b"\xff\xc4" + struct.pack(">H", 2 + len(payload))
                  + payload)
    if restart_interval:
        out.write(b"\xff\xdd" + struct.pack(">HH", 4, restart_interval))
    sos = bytes([ncomp])
    for ci in range(ncomp):
        sos += bytes([ci + 1, 0 if ci == 0 else 0x11])
    sos += bytes([0, 63, 0])
    out.write(b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos)
    return out.getvalue(), b"\xff\xd9"


def encode(rgb: torch.Tensor, samplings=((2, 2), (1, 1), (1, 1)),
           quality: int = 90, restart_interval: int = 0) -> Frame:
    """Encode (H, W, 3) uint8 RGB (a tensor on any device) as a baseline
    YCbCr JPEG, made on ``rgb``'s device."""
    samplings = tuple(tuple(s) for s in samplings)
    planes, qts = quantise(rgb, samplings, quality)
    H, W = rgb.shape[:2]
    h_max = max(s[0] for s in samplings)
    v_max = max(s[1] for s in samplings)
    mcus_x, mcus_y = -(-W // (8 * h_max)), -(-H // (8 * v_max))
    data = entropy_code(planes, samplings, mcus_x, mcus_y, restart_interval)
    head, tail = headers(H, W, samplings, qts, restart_interval)
    n_mcus = mcus_x * mcus_y
    return Frame(blob=head + data + tail, height=H, width=W,
                 samplings=samplings, planes=planes, qtables=qts,
                 restart_interval=restart_interval, scan_bytes=len(data),
                 segments=-(-n_mcus // restart_interval)
                 if restart_interval else 1)


def make_frames(recipe: dict, seed: int, count: int, device,
                salt: int = 0) -> list[Frame]:
    """``count`` distinct frames of a configuration's ``frame`` recipe
    (width, height, samplings, quality, restart interval) from ``seed``:
    frame k draws from a generator seeded with (seed, salt, k)."""
    frames = []
    for k in range(count):
        gen = torch.Generator(device=device)
        gen.manual_seed(_mix(seed, salt, k))
        rgb = photo(gen, recipe["height"], recipe["width"])
        frames.append(encode(rgb, recipe["samplings"], recipe["quality"],
                             recipe["restart_interval"]))
    return frames


def _mix(*parts: int) -> int:
    """One 63-bit generator seed from several whole numbers."""
    ss = np.random.SeedSequence([int(p) % (1 << 64) for p in parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
