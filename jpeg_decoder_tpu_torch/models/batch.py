"""Batched decode: the throughput/serving path, in PyTorch.

Counterpart of ``jpeg_decoder_tpu/models/batch.py``.  Decodes many JPEGs by
(1) running host entropy decode in a thread pool straight to the nibble
wire (the native C++ decoder releases the GIL), (2) grouping images by
pow-2 geometry bucket, and (3) per group, one copy to the device and one
pass of unpack -> plane gather -> dequant+IDCT -> upsample -> colour, with
the batch as the leading dimension of every tensor.

Decoded RGB stays on the device: the use case is feeding decoded images
straight into a training or inference input pipeline on the same card.

Frames the JAX package routes to host-decoded planes (progressive,
arithmetic, non-8-bit, multi-scan, restart-count mismatch) and colour
spaces other than gray/YCbCr are not ported yet: each comes back as that
image's own :class:`JPEGError`, without failing the batch.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..entropy import native
from ..io import parser
from ..ops import pixel as pixel_ops
from ..types import FrameHeader, JPEGError
from . import routing


def pack_blocks(blocks: np.ndarray):
    """Compact lossless wire format for quantized coefficients: DC plane as
    int16, AC as int8 with a sparse escape list for |AC| > 127.

    Returns (dc16 (N,), ac8 (N, 64) with [:,0]=0, esc_idx (E,), esc_val (E,)).
    """
    dc16 = blocks[:, 0].astype(np.int16)
    ac = blocks.copy()
    ac[:, 0] = 0
    flat = ac.reshape(-1)
    esc_idx = np.flatnonzero((flat < -128) | (flat > 127)).astype(np.int32)
    esc_val = flat[esc_idx].astype(np.int16)
    ac8 = np.clip(ac, -128, 127).astype(np.int8)
    return dc16, ac8, esc_idx, esc_val


def nibbleize_ac(ac8: np.ndarray):
    """Nibble wire encoding: one byte per entry, (gap<<4)|val-code.

    Val codes: 0x1-0x7 = +1..+7, 0x9-0xF = -7..-1 (two's-complement low
    nibble), 0x8 = value overflows 4 bits and comes from the next slot of
    the side `ov` int8 stream, 0x0 = extender (no value written).  Gap
    semantics: a real entry advances by its gap nibble (0-15); an extender
    entry advances by gap*16 (so one extender + one entry cover gaps up to
    255; chains of (15,0) extenders cover more).

    Returns (entries (K,) uint8, ov (O,) int8).  |val| > 127 still goes
    through the separate escape list (the int8 ov slot holds the clipped
    value).  The native emitter writes the same bytes
    (``native.decode_scan_nibble``).
    """
    flat = ac8.reshape(-1)
    nz = np.flatnonzero(flat)
    vals = flat[nz].astype(np.int32)
    gaps = np.diff(nz, prepend=-1)
    n240 = np.maximum(0, -(-(gaps - 255) // 240))
    rem = gaps - 240 * n240          # in [1, 255] (>= 16 when n240 > 0)
    n16 = rem > 15
    reps = n240 + n16 + 1
    total = int(reps.sum())
    e = np.full(total, 0xF0, np.uint8)     # default: chain extender (+240)
    last = np.cumsum(reps) - 1
    lo = np.where(n16, rem & 15, rem)
    vc = np.where(np.abs(vals) <= 7, vals & 15, 8).astype(np.uint8)
    e[last] = (lo.astype(np.uint8) << 4) | vc
    scaled = last[n16] - 1
    e[scaled] = (rem[n16] >> 4).astype(np.uint8) << 4
    ov = np.clip(vals[np.abs(vals) > 7], -128, 127).astype(np.int8)
    return e, ov


def _bucket(n: int, min_size: int = 256) -> int:
    """Round up keeping 4 significant bits (max 6.25% padding waste)."""
    n = max(n, min_size)
    step = 1 << max((n - 1).bit_length() - 4, 0)
    return -(-n // step) * step


def _bucket_pow2(n: int) -> int:
    """Next power of two (geometry buckets: MCU grid dims round up, so a
    corpus of arbitrary image sizes falls into O(log sizes) groups)."""
    return 1 << max(0, (n - 1).bit_length())


def unpack_nibble(dc16, e, ov, esc_idx, esc_val) -> torch.Tensor:
    """Nibble wire -> (B, n_blk + 1, 64) int32 scan-order blocks, where
    ``dc16`` is (B, n_blk): the bucket's block capacity.

    Decodes each entry byte, cumsums the advances, ranks the overflow
    values, scatter-adds the values and scatter-sets the escapes into one
    flat int32 buffer, then sets DC.  Indices outside an image's
    ``[0, n_blk*64)`` are dropped (JAX's ``mode="drop"``, which torch lacks):
    they are sent to one dump slot past the end of the buffer.  Block
    ``n_blk`` of every image is left zero: it is the fill block that
    :func:`planes_from_blocks_dyn` reads for cells beyond the image.

    Padding: 0x00 filler entries advance 0 and write 0; all-filler rows
    cumsum to -1 (dropped); ov pads are never ranked; escape pads carry the
    out-of-range index n_blk*64 (dropped).
    """
    b, n_blk = dc16.shape
    dev = e.device
    n_coef = n_blk * 64
    stride = n_coef + 64                     # one extra (fill) block
    dump = b * stride
    ei = e.to(torch.int32)
    g, vcode = ei >> 4, ei & 15
    adv = torch.where(vcode == 0, g * 16, g)
    idx = torch.cumsum(adv, dim=1) - 1
    v4 = ((vcode + 8) & 15) - 8              # 0x8 -> -8, replaced below
    is_ov = vcode == 8
    rank = torch.cumsum(is_ov.to(torch.int32), dim=1) - 1
    ovv = torch.gather(ov.to(torch.int32), 1,
                       rank.clamp(0, max(ov.shape[1] - 1, 0)))
    vals = torch.where(is_ov, ovv, v4)
    base = torch.arange(b, device=dev, dtype=torch.int64).view(-1, 1) * stride
    flat = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    keep = (idx >= 0) & (idx < n_coef)
    flat.index_add_(0, torch.where(keep, idx + base, dump).reshape(-1),
                    vals.reshape(-1))
    ej = esc_idx.to(torch.int64)
    keep = (ej >= 0) & (ej < n_coef)
    flat.index_put_((torch.where(keep, ej + base, dump).reshape(-1),),
                    esc_val.to(torch.int32).reshape(-1))
    blocks = flat[:dump].view(b, n_blk + 1, 64)
    blocks[:, :n_blk, 0] = dc16.to(torch.int32)
    return blocks


def planes_from_blocks_dyn(blocks, geom, *, comp_shapes, comp_hv):
    """Per-component plane assembly with the gather map built on the
    device from each image's dynamic geometry (geometry bucketing: one
    pass serves every image size in the bucket).

    ``blocks``: (B, n_blk + 1, 64) scan-order blocks, true blocks a prefix
    and block ``n_blk`` zero (see :func:`unpack_nibble`).
    ``geom``: (B, 4) int = (mcus_x, mcus_y, height, width).
    ``comp_shapes``: BUCKET plane dims per component;
    ``comp_hv``: (h, v) sampling factors per component.
    Cells beyond an image's true plane extent read the zero fill block,
    reproducing layout.scan_layout's comp_src maps inside the true region.
    Returns a tuple of (B, R, C, 64) planes.
    """
    b, n_fill = blocks.shape[0], blocks.shape[1] - 1
    dev = blocks.device
    bpm = sum(h * v for h, v in comp_hv)
    mcus_x = geom[:, 0].to(torch.int64).view(-1, 1, 1)
    mcus_y = geom[:, 1].to(torch.int64).view(-1, 1, 1)
    base = torch.arange(b, device=dev).view(-1, 1, 1) * (n_fill + 1)
    flat = blocks.reshape(-1, 64)
    planes = []
    k0 = 0
    for (R, C_), (h, v) in zip(comp_shapes, comp_hv):
        r = torch.arange(R, device=dev).view(1, -1, 1)
        c = torch.arange(C_, device=dev).view(1, 1, -1)
        src = ((r // v) * mcus_x + (c // h)) * bpm \
            + (k0 + (r % v) * h + (c % h))
        valid = (r < mcus_y * v) & (c < mcus_x * h)
        src = torch.where(valid, src, n_fill) + base
        planes.append(flat[src.reshape(-1)].view(b, R, C_, 64))
        k0 += h * v
    return tuple(planes)


def rgb_from_nibble(dc16, e, ov, esc_idx, esc_val, qtables, geom, *,
                    comp_shapes, comp_hv, height, width, samplings, idct,
                    upsample, color) -> torch.Tensor:
    """Nibble-wire group -> (B, height, width, 3) uint8 bucket-size RGB.

    The counterpart of JAX's ``_batched_from_nibble`` (unpack, then
    ``_rgb_one_dyn`` under ``vmap``).  Pixels inside each image's
    (geom height, width) are exact; the rest is padding that
    :attr:`BatchItem.rgb` crops."""
    blocks = unpack_nibble(dc16, e, ov, esc_idx, esc_val)
    planes = planes_from_blocks_dyn(blocks, geom, comp_shapes=comp_shapes,
                                    comp_hv=comp_hv)
    qts = tuple(qtables[:, i].contiguous() for i in range(len(comp_shapes)))
    return pixel_ops.pixel_pipeline_impl(
        planes, qts, height=height, width=width, samplings=samplings,
        idct=idct, upsample=upsample, color=color,
        true_dims=(geom[:, 2], geom[:, 3]))


@dataclasses.dataclass
class BatchItem:
    index: int              # position in the input list
    header: FrameHeader | None
    rgb_batch: torch.Tensor | None  # (B, H, W, 3) uint8 group output
    batch_index: int        # this image's row in rgb_batch
    error: Exception | None = None  # per-image failure isolation

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def rgb(self) -> torch.Tensor:
        """This image's (H, W, 3) RGB: its row of ``rgb_batch`` cropped
        to the image (rows carry geometry-bucket padding)."""
        row = self.rgb_batch[self.batch_index]
        return row[: self.header.height, : self.header.width]


@dataclasses.dataclass
class Group:
    """One geometry bucket's host arrays, padded and ready to copy."""

    idxs: list[int]                    # positions in the host-stage output
    headers: list[FrameHeader]
    arrays: tuple                      # dc, e, ov, esc_idx, esc_val, qt, geom
    comp_shapes: tuple
    comp_hv: tuple
    height: int
    width: int
    samplings: tuple
    color: str


def _not_ported(hdr: FrameHeader) -> str | None:
    """Why the batch path cannot take this frame yet, or None."""
    if hdr.progressive:
        return "progressive"
    if hdr.arithmetic:
        return "arithmetic-coded"
    if hdr.precision != 8:
        return f"{hdr.precision}-bit"
    if routing.needs_scan_loop(hdr):
        return "multi-scan or non-interleaved"
    if routing.segment_mismatch(hdr, hdr.scans[0]):
        return "restart-count-mismatched"
    if hdr.colorspace not in ("gray", "ycbcr"):
        return hdr.colorspace
    return None


class BatchDecoder:
    """Reusable batched decoder; RGB comes back on ``device``.

    ``device`` is the CUDA card by default; without one the constructor
    raises (pass ``device="cpu"`` to decode on the CPU).  On a CUDA device
    the dequant+IDCT step is the hand-written kernel; on the CPU it is its
    plain twin.  Only ``entropy="native"`` and ``wire="nibble"`` are ported.
    Host entropy runs on a pool of ``host_threads`` threads (2 by default,
    as in the JAX package).  A failed build of the native entropy library
    raises here.
    """

    def __init__(self, *, device="cuda", entropy: str = "native",
                 idct: str = "pallas", upsample: str = "fancy",
                 wire: str = "nibble", host_threads: int | None = None):
        if entropy != "native":
            raise ValueError(f"entropy={entropy!r} is not ported")
        if wire != "nibble":
            raise ValueError(f"wire={wire!r} is not ported")
        if idct not in ("pallas", "kron", "fast"):
            raise ValueError(f"idct={idct!r} is not ported")
        if upsample not in ("fancy", "nn"):
            raise ValueError(f"unknown upsample {upsample!r}")
        self.device = routing.resolve_device(device)
        self.idct = idct
        self.upsample = upsample
        native._load()
        self.host_threads = host_threads or 2
        self._pool = ThreadPoolExecutor(self.host_threads)

    def close(self) -> None:
        self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _host_one(self, blob):
        """Host stage with per-image failure isolation: one malformed or
        unsupported image must not fail the batch."""
        try:
            hdr = parser.parse(blob)
            why = _not_ported(hdr)
            if why is not None:
                raise JPEGError(f"{why} frames are not yet ported to the "
                                "torch batch path")
            return hdr, native.decode_scan_nibble(hdr, hdr.scans[0])
        except Exception as e:  # noqa: BLE001 — isolated per image
            return e, None

    def host_stage(self, blobs: list[bytes]) -> list:
        """Parse + native entropy decode of every blob, on the thread pool.
        Returns (header, nibble pack) or (exception, None) per blob."""
        return list(self._pool.map(self._host_one, blobs))

    def group(self, host_out: list) -> list[Group]:
        """Group by pow-2 geometry bucket and pad every ragged stream and
        the batch itself (to a power of two), as the JAX package does."""
        keyed: dict[tuple, list[int]] = {}
        for i, (hdr, _) in enumerate(host_out):
            if isinstance(hdr, Exception):
                continue
            key = (_bucket_pow2(hdr.mcus_x), _bucket_pow2(hdr.mcus_y),
                   tuple((c.h, c.v) for c in hdr.components),
                   hdr.colorspace)
            keyed.setdefault(key, []).append(i)
        return [self._pad_group(key, idxs, host_out)
                for key, idxs in keyed.items()]

    @staticmethod
    def _pad_group(key, idxs, host_out) -> Group:
        mxb, myb, comp_hv, color = key
        headers = [host_out[i][0] for i in idxs]
        packs = [host_out[i][1] for i in idxs]
        h_max = max(h for h, _ in comp_hv)
        v_max = max(v for _, v in comp_hv)
        bpm = sum(h * v for h, v in comp_hv)
        n_blk = mxb * myb * bpm            # bucket block capacity
        n_coef = n_blk * 64
        b = len(packs)
        geom_b = np.array([[h.mcus_x, h.mcus_y, h.height, h.width]
                           for h in headers], np.int32)
        # True blocks are a prefix of the bucket block range, so every
        # wire stream's flat indices stay valid after row padding.
        dc_b = np.zeros((b, n_blk), np.int16)
        # Entry and overflow streams are ragged with independent lengths:
        # pad each to its own bucketed group max (0x00 entries / 0 values
        # are no-ops); escape lists pad with the out-of-range index n_coef.
        kmax = _bucket(max(len(p[1]) for p in packs))
        omax = _bucket(max(len(p[2]) for p in packs), min_size=64)
        emax = _bucket(max(len(p[3]) for p in packs), min_size=64)
        e_b = np.zeros((b, kmax), np.uint8)
        o_b = np.zeros((b, omax), np.int8)
        ei_b = np.full((b, emax), n_coef, np.int32)
        ev_b = np.zeros((b, emax), np.int16)
        for k, p in enumerate(packs):
            dc_b[k, :len(p[0])] = p[0]
            e_b[k, :len(p[1])] = p[1]
            o_b[k, :len(p[2])] = p[2]
            ei_b[k, :len(p[3])] = p[3]
            ev_b[k, :len(p[4])] = p[4]
        qt_b = np.stack([np.stack([h.quant_tables[c.tq].values
                                   for c in h.components])
                         for h in headers]).astype(np.int32)
        # Pad the batch to the next power of two, as the JAX package does
        # to bound its compiled-program count.
        bp = 1 << (b - 1).bit_length()
        if bp != b:
            def padb(x, **kw):
                return np.pad(x, [(0, bp - b)] + [(0, 0)] * (x.ndim - 1), **kw)
            dc_b, e_b, o_b, ev_b = (padb(x) for x in (dc_b, e_b, o_b, ev_b))
            ei_b = padb(ei_b, constant_values=n_coef)
            qt_b, geom_b = padb(qt_b, mode="edge"), padb(geom_b, mode="edge")
        return Group(
            idxs=idxs, headers=headers,
            arrays=(dc_b, e_b, o_b, ei_b, ev_b, qt_b, geom_b),
            comp_shapes=tuple((myb * v, mxb * h) for h, v in comp_hv),
            comp_hv=comp_hv, height=myb * 8 * v_max, width=mxb * 8 * h_max,
            samplings=tuple((v_max // v, h_max // h) for h, v in comp_hv),
            color=color)

    def to_device(self, group: Group) -> list[torch.Tensor]:
        """One host-to-device copy per array of the group."""
        return [torch.from_numpy(x).to(self.device) for x in group.arrays]

    def pixels(self, group: Group, tensors) -> torch.Tensor:
        """Device stage of one group: (B, H_bucket, W_bucket, 3) uint8."""
        return rgb_from_nibble(
            *tensors, comp_shapes=group.comp_shapes, comp_hv=group.comp_hv,
            height=group.height, width=group.width,
            samplings=group.samplings, idct=self.idct,
            upsample=self.upsample, color=group.color)

    def decode(self, blobs: list[bytes]) -> list[BatchItem]:
        """Decode a list of JPEG byte strings; returns device-resident RGB
        in input order, with per-image errors isolated."""
        host_out = self.host_stage(blobs)
        results: list[BatchItem | None] = [None] * len(blobs)
        for i, (hdr, _) in enumerate(host_out):
            if isinstance(hdr, Exception):
                results[i] = BatchItem(index=i, header=None, rgb_batch=None,
                                       batch_index=-1, error=hdr)
        for group in self.group(host_out):
            rgb_b = self.pixels(group, self.to_device(group))
            for k, (i, hdr) in enumerate(zip(group.idxs, group.headers)):
                results[i] = BatchItem(index=i, header=hdr, rgb_batch=rgb_b,
                                       batch_index=k)
        return results  # type: ignore[return-value]


def decode_batch(blobs: list[bytes], **kw) -> list[BatchItem]:
    with BatchDecoder(**kw) as bd:
        return bd.decode(blobs)
