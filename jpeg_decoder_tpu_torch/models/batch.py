"""Batched decode: the throughput/serving path, in PyTorch.

Counterpart of ``jpeg_decoder_tpu/models/batch.py``.  Decodes many JPEGs by
(1) running host entropy decode in a thread pool straight to one of four
wire formats (the native C++ decoder releases the GIL), (2) grouping images
by geometry bucket, and (3) per group, one copy to the device and one pass
of wire unpack -> plane gather -> dequant+IDCT -> upsample -> colour, with
the batch as the leading dimension of every tensor.

Wires (host emitter -> device reconstruction, each giving exactly the
blocks of the JAX package's):

* ``nibble`` — (gap<<4)|value-code bytes + int8 overflow stream;
* ``sparse`` — (gap uint8, value int8) pairs;
* ``packed`` — a dense int8 AC plane;
* ``slots`` — per block, the first :data:`_SLOT_CAP` nonzeros as
  (position, value) slots plus an overflow list.

Every wire carries the int16 DC plane and an escape list for |AC| > 127.

Frames the fast path cannot take — progressive, arithmetic, multi-scan or
non-interleaved, restart-count-mismatched, 12-bit — decode to host planes
through ``models.decoder.decode_to_planes`` and then ride the chosen wire
like any other image; under ``entropy="pallas"``, ``"jax"`` or
``"hybrid"`` a progressive Huffman frame's planes come from the device
progressive lanes (``ops/entropy_prog.py``, kernels K8a-K8d), as in JAX.
Groups are keyed by geometry bucket, sampling, colour space and precision,
so gray, YCbCr, Adobe RGB, CMYK and YCCK sources and 12-bit frames (uint16
RGB) each get their own pixel pass.  A malformed blob, or a progressive
scan the lanes flag, comes back as that image's own :class:`JPEGError`; it
does not fail the batch.

Large inputs run in *waves*: host entropy of wave k+1 overlaps the device
work of wave k, which one worker thread runs on its own CUDA stream from
pinned staging buffers.  Decoded RGB stays on the device: the use case is
feeding decoded images straight into a training or inference input
pipeline on the same card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import layout as layout_mod
from ..entropy import native
from ..io import parser
from ..ops import pixel as pixel_ops
from ..ops import pixels_cuda
from ..types import FrameHeader
from . import decoder as decoder_mod
from . import routing

WIRES = ("nibble", "sparse", "packed", "slots")
#: Images per wave when ``decode`` is not told (the JAX package's).
DEFAULT_WAVE = 96
#: Fixed slot capacity: covers ~p90 of corpus blocks; the tail goes to
#: the overflow scatter.
_SLOT_CAP = 16
#: Byte alignment of each array inside a group's staging buffer (any
#: element size divides it, so a device view can take the array's dtype).
_ALIGN = 64
#: Pinned staging buffers kept for reuse (a wave holds one per group).
_PINNED_KEEP = 8
_TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32}


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


def sparsify_ac(ac8: np.ndarray):
    """Sparse AC wire encoding: (gap uint8, value int8) pairs.

    Encode the flat (N*64) AC stream (DC slots zeroed) as successive-nonzero
    gaps: entry i means "advance gap_i positions, write val_i".  Gaps > 255
    emit extender entries (gap=255, val=0) — val 0 writes are no-ops on the
    zero-initialized device plane, so reconstruction is a plain cumsum +
    scatter-add.
    """
    flat = ac8.reshape(-1)
    nz = np.flatnonzero(flat)
    gaps = np.diff(nz, prepend=-1)
    n_ext = (gaps - 1) // 255
    total = nz.size + int(n_ext.sum())
    g = np.full(total, 255, np.uint8)
    v = np.zeros(total, np.int8)
    last = np.cumsum(n_ext + 1) - 1
    g[last] = (gaps - 255 * n_ext).astype(np.uint8)
    v[last] = flat[nz]
    return g, v


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


def slotify_ac(ac8: np.ndarray, cap: int):
    """Per-block slot wire encoding: (N, C) position/value slot arrays.

    The first ``cap`` nonzeros of each block fill its slots (position =
    natural-order index 1..63; 0 marks an empty slot — the DC slot is
    never an AC position); the tail spills to an overflow list of (flat
    index, value) pairs.

    Returns (pos (N, C) uint8, val (N, C) int8, ov_idx (O,) int32,
    ov_val (O,) int16).
    """
    n = ac8.shape[0]
    rows, cols0 = np.nonzero(ac8[:, 1:])
    cols = cols0 + 1
    counts = np.bincount(rows, minlength=n)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(rows)) - first[rows]
    in_slot = rank < cap
    pos = np.zeros((n, cap), np.uint8)
    val = np.zeros((n, cap), np.int8)
    pos[rows[in_slot], rank[in_slot]] = cols[in_slot]
    val[rows[in_slot], rank[in_slot]] = ac8[rows[in_slot], cols[in_slot]]
    ov_rows, ov_cols = rows[~in_slot], cols[~in_slot]
    ov_idx = (ov_rows.astype(np.int64) * 64 + ov_cols).astype(np.int32)
    ov_val = ac8[ov_rows, ov_cols].astype(np.int16)
    return pos, val, ov_idx, ov_val


def _bucket(n: int, min_size: int = 256) -> int:
    """Round up keeping 4 significant bits (max 6.25% padding waste)."""
    n = max(n, min_size)
    step = 1 << max((n - 1).bit_length() - 4, 0)
    return -(-n // step) * step


def _bucket_pow2(n: int) -> int:
    """Next power of two (geometry buckets: MCU grid dims round up, so a
    corpus of arbitrary image sizes falls into O(log sizes) groups)."""
    return 1 << max(0, (n - 1).bit_length())


# -- device reconstructions ---------------------------------------------------
#
# Each takes a group's (B, ...) wire tensors and returns (B, n_blk + 1, 64)
# int32 scan-order blocks, ``n_blk`` the bucket's block capacity: exactly the
# blocks of the JAX package's ``_batched_from_<wire>``, plus block ``n_blk``
# of every image left zero, the fill block :func:`planes_from_blocks_dyn`
# reads for cells beyond the image.  Torch has no ``mode="drop"``: an index
# outside an image's ``[0, n_blk*64)`` is sent to one dump slot past the end
# of the flat buffer, the only index that may repeat.


class _Blocks:
    """A zero (B, n_blk + 1, 64) int32 block buffer, flat, with one dump
    slot past its end."""

    def __init__(self, b: int, n_blk: int, dev: torch.device):
        self.b, self.n_blk, self.n_coef = b, n_blk, n_blk * 64
        stride = self.n_coef + 64                # one extra (fill) block
        self.dump = b * stride
        self.flat = torch.zeros(self.dump + 1, dtype=torch.int32, device=dev)
        self.base = torch.arange(b, device=dev,
                                 dtype=torch.int64).view(-1, 1) * stride

    def put(self, idx: torch.Tensor, vals: torch.Tensor, *,
            add: bool) -> None:
        """Scatter ``vals`` at the per-image flat indices ``idx`` (both
        (B, K)); ``add`` sums (``.at[].add``), else sets (``.at[].set``).
        Integer indices widen by their own signedness: uint8 without sign
        extension, int8/int16/int32 with it."""
        idx = idx.reshape(self.b, -1).to(torch.int64)
        keep = (idx >= 0) & (idx < self.n_coef)
        dst = torch.where(keep, idx + self.base, self.dump).reshape(-1)
        v = vals.to(torch.int32).reshape(-1)
        if add:
            self.flat.index_add_(0, dst, v)
        else:
            self.flat.index_put_((dst,), v)

    def view(self) -> torch.Tensor:
        return self.flat[:self.dump].view(self.b, self.n_blk + 1, 64)

    def set_dc(self, dc16: torch.Tensor) -> torch.Tensor:
        blocks = self.view()
        blocks[:, :self.n_blk, 0] = dc16.to(torch.int32)
        return blocks


def unpack_nibble(dc16, e, ov, esc_idx, esc_val) -> torch.Tensor:
    """Nibble wire -> blocks: decode each entry byte, cumsum the advances,
    rank the overflow values, scatter-add the values and scatter-set the
    escapes, then set DC.

    Padding: 0x00 filler entries advance 0 and write 0; all-filler rows
    cumsum to -1 (dropped); ov pads are never ranked; escape pads carry the
    out-of-range index n_blk*64 (dropped).
    """
    out = _Blocks(*dc16.shape, e.device)
    ei = e.to(torch.int32)
    g, vcode = ei >> 4, ei & 15
    adv = torch.where(vcode == 0, g * 16, g)
    idx = torch.cumsum(adv, dim=1) - 1
    v4 = ((vcode + 8) & 15) - 8              # 0x8 -> -8, replaced below
    is_ov = vcode == 8
    rank = torch.cumsum(is_ov.to(torch.int32), dim=1) - 1
    ovv = torch.gather(ov.to(torch.int32), 1,
                       rank.clamp(0, max(ov.shape[1] - 1, 0)))
    out.put(idx, torch.where(is_ov, ovv, v4), add=True)
    out.put(esc_idx, esc_val, add=False)
    return out.set_dc(dc16)


def unpack_sparse(dc16, gaps, vals, esc_idx, esc_val) -> torch.Tensor:
    """Sparse wire -> blocks: cumsum the (unsigned) gaps, scatter-add the
    values, scatter-set the escapes, then set DC.

    Padding: (0, 0) fillers re-add 0 at the last real position (indices of
    real entries strictly increase, so scatter-add is scatter-set for
    them); an all-filler row cumsums to index -1 (dropped); escape pads use
    index n_blk*64 (dropped)."""
    out = _Blocks(*dc16.shape, gaps.device)
    idx = torch.cumsum(gaps.to(torch.int64), dim=1) - 1
    out.put(idx, vals, add=True)
    out.put(esc_idx, esc_val, add=False)
    return out.set_dc(dc16)


def unpack_packed(dc16, ac8, esc_idx, esc_val) -> torch.Tensor:
    """Packed wire -> blocks: the int8 AC plane, escapes set over it, then
    DC.  Escape pads use out-of-range indices (dropped)."""
    out = _Blocks(*dc16.shape, ac8.device)
    out.view()[:, :out.n_blk] = ac8.to(torch.int32)
    out.put(esc_idx, esc_val, add=False)
    return out.set_dc(dc16)


def unpack_slots(dc16, pos, val, ov_idx, ov_val, esc_idx,
                 esc_val) -> torch.Tensor:
    """Slot wire -> blocks: DC, then every slot's value added at its
    (unsigned) position, then the overflow list set, then the escapes set —
    JAX's order.  JAX sums a per-block one-hot compare over lanes 1..63;
    adding each slot at its own position gives that sum without the
    (B, N, C, 63) one-hot tensor.  Empty slots (position 0) and positions
    past 63 match no lane: they add 0 to their own block's DC (not to the
    shared dump slot, whose atomics would serialise millions of empty
    slots); overflow/escape pads use out-of-range indices (dropped)."""
    out = _Blocks(*dc16.shape, pos.device)
    out.set_dc(dc16)
    p = pos.to(torch.int64)
    lane = (p >= 1) & (p <= 63)
    n = torch.arange(pos.shape[1], device=pos.device,
                     dtype=torch.int64).view(1, -1, 1)
    out.put(n * 64 + torch.where(lane, p, 0),
            torch.where(lane, val.to(torch.int32), 0), add=True)
    out.put(ov_idx, ov_val, add=False)
    out.put(esc_idx, esc_val, add=False)
    return out.view()


UNPACK = {"nibble": unpack_nibble, "sparse": unpack_sparse,
          "packed": unpack_packed, "slots": unpack_slots}


def planes_from_blocks_dyn(blocks, geom, *, comp_shapes, comp_hv):
    """Per-component plane assembly with the gather map built on the
    device from each image's dynamic geometry (geometry bucketing: one
    pass serves every image size in the bucket).

    ``blocks``: (B, n_blk + 1, 64) scan-order blocks, true blocks a prefix
    and block ``n_blk`` zero (see :class:`_Blocks`).
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


def rgb_from_blocks_dyn(blocks, qtables, geom, *, comp_shapes, comp_hv,
                        height, width, samplings, idct, upsample, color,
                        precision) -> torch.Tensor:
    """Pixels of a geometry bucket (the JAX package's ``_rgb_one_dyn``,
    batched).  ``blocks``: (B', N, 64) int32 scan-order blocks of the first
    B' <= B images (the rest are padding, the colour of zero blocks);
    ``qtables``: (B, n_comps, 64) int32; ``geom``: (B, 4) int32 (mcus_x,
    mcus_y, height, width).  On a CUDA tensor one launch of the kernel K6b
    (``ops/pixels_cuda.blocks_to_rgb``, every IDCT inside it), which raises
    if it cannot launch; on
    a CPU tensor the plain route :func:`rgb_from_blocks_torch`.  Returns
    (B, height, width, 3) RGB whose pixels inside each image's (geom
    height, width) are exact; the rest is padding that
    :attr:`BatchItem.rgb` crops."""
    return pixels_cuda.blocks_to_rgb(
        blocks, qtables, geom, comp_shapes=comp_shapes, comp_hv=comp_hv,
        height=height, width=width, samplings=samplings, idct=idct,
        upsample=upsample, color=color, precision=precision)


def rgb_from_blocks_torch(blocks, qtables, geom, *, comp_shapes, comp_hv,
                          height, width, samplings, idct, upsample, color,
                          precision) -> torch.Tensor:
    """The plain route K6b replaces: :func:`planes_from_blocks_dyn`, then
    the pixel pipeline at the bucket's dims with each image's true edge
    (K1 or K5 and torch ops on a CUDA tensor, their twins on the CPU).
    ``blocks`` must hold a zero fill row last (:class:`_Blocks`); arguments
    and result as :func:`rgb_from_blocks_dyn`.  Blocks of fewer images than
    ``geom`` are padded with zero images first."""
    short = geom.shape[0] - blocks.shape[0]
    if short > 0:
        blocks = torch.cat([blocks, blocks.new_zeros(
            (short,) + tuple(blocks.shape[1:]))])
    planes = planes_from_blocks_dyn(blocks, geom, comp_shapes=comp_shapes,
                                    comp_hv=comp_hv)
    qts = tuple(qtables[:, i].contiguous() for i in range(len(comp_shapes)))
    return pixel_ops.pixel_pipeline_impl(
        planes, qts, height=height, width=width, samplings=samplings,
        idct=idct, upsample=upsample, color=color, precision=precision,
        true_dims=(geom[:, 2], geom[:, 3]))


@dataclasses.dataclass
class BatchItem:
    index: int              # position in the input list
    header: FrameHeader | None
    # (B, H, W, 3) group output: uint8, or uint16 for 12-bit frames.
    rgb_batch: torch.Tensor | None
    batch_index: int        # this image's row in the (whole) batch
    error: Exception | None = None  # per-image failure isolation
    # On a mesh, the rows [lo, hi) of a 'data'-sharded batch that
    # rgb_batch holds on this rank (rgb_batch[0] is row lo); None when it
    # holds the whole batch.
    rows: tuple[int, int] | None = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def rgb(self) -> torch.Tensor:
        """This image's (H, W, 3) RGB: its row of ``rgb_batch`` cropped
        to the image (rows carry geometry-bucket padding).  Raises
        IndexError when the row lies on another rank of a mesh
        (``parallel/multihost.process_allgather`` rebuilds the batch)."""
        row = self.batch_index
        if self.rows is not None:
            lo, hi = self.rows
            if not lo <= row < hi:
                raise IndexError(
                    f"image {self.index} is row {row} of a batch sharded "
                    f"over 'data'; this rank holds rows {lo}..{hi - 1} "
                    "(gather the batch with multihost.process_allgather)")
            row -= lo
        return self.rgb_batch[row][: self.header.height, : self.header.width]


@dataclasses.dataclass
class Group:
    """One geometry bucket's host arrays, padded and ready to copy: the
    wire's arrays in the order its unpack function takes them, then the
    (B, n_comps, 64) quantisation tables and the (B, 4) geometry; the
    images the batch holds before its padding rows (``n_img``) and the
    blocks of the longest of them (``n_rows``: the most any image's
    pixels read)."""

    idxs: list[int]                    # positions in the host-stage output
    headers: list[FrameHeader]
    wire: str
    arrays: tuple
    comp_shapes: tuple
    comp_hv: tuple
    height: int
    width: int
    samplings: tuple
    color: str
    precision: int
    n_img: int
    n_rows: int
    # Pinned host buffer the arrays are views of (CUDA devices), handed
    # back to the decoder's pool once ``to_device`` has queued the copy.
    staging: torch.Tensor | None = None


class _PinnedPool:
    """Pinned host buffers reused across groups and waves.  A buffer goes
    back with the event recorded after its copy was queued, and is handed
    out again only once that event has completed, so a copy in flight never
    sees its source refilled."""

    def __init__(self):
        self._free: list[tuple[torch.Tensor, torch.cuda.Event]] = []
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            fits = [k for k, (buf, _) in enumerate(self._free)
                    if buf.numel() >= nbytes]
            hit = (self._free.pop(min(
                fits, key=lambda k: self._free[k][0].numel()))
                if fits else None)
        if hit is None:
            return torch.empty(_bucket_pow2(max(nbytes, 1 << 20)),
                               dtype=torch.uint8, pin_memory=True)
        buf, done = hit
        done.synchronize()
        return buf

    def give(self, buf: torch.Tensor, done: torch.cuda.Event) -> None:
        with self._lock:
            self._free.append((buf, done))
            if len(self._free) > _PINNED_KEEP:   # drop the smallest
                self._free.remove(min(self._free,
                                      key=lambda x: x[0].numel()))


class BatchDecoder:
    """Reusable batched decoder; RGB comes back on ``device``.

    ``device`` is the CUDA card by default; without one the constructor
    raises (pass ``device="cpu"`` to decode on the CPU).  The other defaults
    are the JAX package's: ``entropy="auto"`` (the native host decoder,
    ``python`` where the native library does not build) and ``idct="fast"``
    (a separable form).  On a CUDA device the nibble wire's unpack is the
    hand-written kernel K6a (only the blocks of the group's true images
    that their pixels read) and each group's pixels one launch of K6b
    (``ops/pixels_cuda.py``), which carries every IDCT: K1's arithmetic
    under ``idct="pallas"`` and ``"kron"``, K5's under ``"exact"``, the
    separable form under ``"fast"``; under
    ``entropy="pallas"`` and ``"jax"`` each image's Huffman decode is K2,
    under ``"hybrid"`` K7 for a DRI=0 stream and K2 otherwise (the blocks
    come back to the host and ride the wire, as in the JAX package); on the
    CPU all are their plain twins.

    ``entropy``: ``auto``, ``native``, ``python``, ``speculative``,
    ``pallas``, ``jax`` or ``hybrid``;
    ``wire``: one of :data:`WIRES`;
    ``bucket``: ``"pow2"`` groups images by power-of-two MCU grid, ``None``
    by exact MCU grid.  Host entropy runs on a pool of ``host_threads``
    threads (2 by default, as in the JAX package).  A failed build of the
    native entropy library raises here under ``entropy="native"``.

    After each :meth:`decode`, ``last_timing`` holds the host-clock seconds
    of every wave's host stage (``host_s``) and of the device worker's pass
    over it (``worker_s``: grouping, staging, the queued copy and the
    queued pixel stage).
    """

    def __init__(self, *, device="cuda", entropy: str = "auto",
                 idct: str = "fast", upsample: str = "fancy",
                 wire: str = "nibble", bucket: str | None = "pow2",
                 host_threads: int | None = None):
        if wire not in WIRES:
            raise ValueError(f"unknown wire format {wire!r}")
        if bucket not in (None, "pow2"):
            raise ValueError(f"unknown bucket mode {bucket!r}")
        if idct not in ("exact", "pallas", "kron", "fast"):
            raise ValueError(f"unknown idct {idct!r}")
        if upsample not in ("fancy", "nn"):
            raise ValueError(f"unknown upsample {upsample!r}")
        self.device = routing.resolve_device(device)
        # Raises ValueError for an unknown name.
        self._decode_scan = decoder_mod._entropy_backend(entropy,
                                                         self.device)
        if entropy == "native":
            native._load()
        # The native decoder emits the wire directly (no dense blocks).
        self._emit = entropy in ("native", "auto") and native.available()
        self.entropy = entropy
        self.idct = idct
        self.upsample = upsample
        self.wire = wire
        self.bucket = bucket
        self.host_threads = host_threads or 2
        self._pool = ThreadPoolExecutor(self.host_threads)
        self._worker = ThreadPoolExecutor(1)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._pinned = _PinnedPool() if cuda else None
        self.last_timing: dict[str, list[float]] = {"host_s": [],
                                                    "worker_s": []}

    def close(self) -> None:
        self._pool.shutdown()
        self._worker.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _host_one(self, blob):
        """Host stage with per-image failure isolation: one malformed or
        unsupported image must not fail the batch."""
        try:
            return self._host_one_inner(blob)
        except Exception as e:  # noqa: BLE001 — isolated per image
            return e, None

    def _host_one_inner(self, blob):
        hdr = parser.parse(blob)
        scan = hdr.scans[0]
        if (hdr.progressive or hdr.arithmetic or hdr.precision != 8
                or routing.needs_scan_loop(hdr)
                or routing.segment_mismatch(hdr, scan)):
            planes = decoder_mod.decode_to_planes(
                hdr, entropy=self.entropy, device=self.device)
            # Flatten planes back to scan order so batching is uniform.
            lay = layout_mod.scan_layout(hdr)
            blocks = np.zeros((lay.total_blocks, 64), np.int32)
            for ci, p in enumerate(planes):
                blocks[lay.comp_src[ci]] = p.reshape(-1, 64)
            pack = pack_blocks(blocks)
        elif self._emit and self.wire == "slots":
            return hdr, native.decode_scan_slots(hdr, scan, _SLOT_CAP)
        elif self._emit and self.wire == "nibble":
            return hdr, native.decode_scan_nibble(hdr, scan)
        elif self._emit and self.wire == "sparse":
            return hdr, native.decode_scan_sparse(hdr, scan)
        elif self._emit:
            return hdr, native.decode_scan_packed(hdr, scan)
        else:
            blocks = self._decode_scan(hdr, scan)
            if isinstance(blocks, torch.Tensor):
                blocks = blocks.cpu().numpy()
            pack = pack_blocks(np.asarray(blocks))
        dc16, ac8, esc_idx, esc_val = pack
        if self.wire == "slots":
            pos, val, ov_idx, ov_val = slotify_ac(ac8, _SLOT_CAP)
            return hdr, (dc16, pos, val, ov_idx, ov_val, esc_idx, esc_val)
        if self.wire == "nibble":
            return hdr, (dc16, *nibbleize_ac(ac8), esc_idx, esc_val)
        if self.wire == "sparse":
            return hdr, (dc16, *sparsify_ac(ac8), esc_idx, esc_val)
        return hdr, pack

    def host_stage(self, blobs: list[bytes]) -> list:
        """Parse + entropy decode of every blob to the wire, on the thread
        pool.  Returns (header, wire pack) or (exception, None) per blob."""
        return list(self._pool.map(self._host_one, blobs))

    def _key(self, hdr: FrameHeader) -> tuple:
        if self.bucket == "pow2":
            mxb, myb = _bucket_pow2(hdr.mcus_x), _bucket_pow2(hdr.mcus_y)
        else:
            mxb, myb = hdr.mcus_x, hdr.mcus_y
        return (mxb, myb, tuple((c.h, c.v) for c in hdr.components),
                hdr.colorspace, hdr.precision)

    def group(self, host_out: list) -> list[Group]:
        """Group by geometry bucket and pad every ragged stream and the
        batch itself (to a power of two), as the JAX package does.  On a
        CUDA device each group's arrays are written straight into one
        pinned staging buffer."""
        keyed: dict[tuple, list[int]] = {}
        for i, (hdr, _) in enumerate(host_out):
            if not isinstance(hdr, Exception):
                keyed.setdefault(self._key(hdr), []).append(i)
        return [self._pad_group(key, idxs, host_out)
                for key, idxs in keyed.items()]

    def _pad_group(self, key, idxs, host_out) -> Group:
        mxb, myb, comp_hv, color, precision = key
        wire = self.wire
        headers = [host_out[i][0] for i in idxs]
        packs = [host_out[i][1] for i in idxs]
        h_max = max(h for h, _ in comp_hv)
        v_max = max(v for _, v in comp_hv)
        bpm = sum(h * v for h, v in comp_hv)
        n_blk = mxb * myb * bpm                             # block capacity
        n_coef = n_blk * 64
        b = len(packs)
        n_rows = max(h.mcus_x * h.mcus_y for h in headers) * bpm
        # Pad the batch to the next power of two, as the JAX package does to
        # bound its compiled-program count.  Wire rows past b stay as their
        # fill (no-op entries); tables and geometry repeat the last image.
        bp = 1 << (b - 1).bit_length()

        def longest(k):
            return max(len(p[k]) for p in packs)

        # (shape, dtype, fill) of the wire arrays after dc16, and the pack
        # positions of the escape list.  True blocks are a prefix of the
        # bucket block range, so every stream's flat indices stay valid.
        if wire == "slots":
            # Slot arrays pad to the group's largest capacity with (0, 0)
            # empties; overflow lists pad with out-of-range indices.
            cmax = max(p[1].shape[1] for p in packs)
            omax = _bucket(longest(3), min_size=64)
            ac = [((bp, n_blk, cmax), np.uint8, 0),
                  ((bp, n_blk, cmax), np.int8, 0),
                  ((bp, omax), np.int32, n_coef), ((bp, omax), np.int16, 0)]
            ei_at = 5
        elif wire == "nibble":
            # Entry and overflow streams are ragged with independent lengths:
            # pad each to its own bucketed group max (0x00 entries / 0
            # values are no-ops).
            ac = [((bp, _bucket(longest(1))), np.uint8, 0),
                  ((bp, _bucket(longest(2), min_size=64)), np.int8, 0)]
            ei_at = 3
        elif wire == "sparse":
            # (gap, val) streams pad to the bucketed group max with (0, 0)
            # no-op fillers.
            kmax = _bucket(longest(1))
            ac = [((bp, kmax), np.uint8, 0), ((bp, kmax), np.int8, 0)]
            ei_at = 3
        else:
            ac = [((bp, n_blk, 64), np.int8, 0)]
            ei_at = 2
        # Escape lists pad with out-of-range indices, dropped on the device.
        emax = _bucket(longest(ei_at), min_size=64)
        specs = ([((bp, n_blk), np.int16, 0)] + ac
                 + [((bp, emax), np.int32, n_coef), ((bp, emax), np.int16, 0),
                    ((bp, len(comp_hv), 64), np.int32, 0),
                    ((bp, 4), np.int32, 0)])
        staging, arrays = self._stage(specs)
        for k, p in enumerate(packs):
            arrays[0][k, :len(p[0])] = p[0]
            for j in range(1, len(ac) + 1):
                x = p[j]
                arrays[j][k][tuple(slice(0, n) for n in x.shape)] = x
            arrays[-4][k, :len(p[ei_at])] = p[ei_at]
            arrays[-3][k, :len(p[ei_at + 1])] = p[ei_at + 1]
            arrays[-2][k] = [headers[k].quant_tables[c.tq].values
                             for c in headers[k].components]
            arrays[-1][k] = (headers[k].mcus_x, headers[k].mcus_y,
                             headers[k].height, headers[k].width)
        arrays[-2][b:] = arrays[-2][b - 1]
        arrays[-1][b:] = arrays[-1][b - 1]
        return Group(
            idxs=idxs, headers=headers, wire=wire, arrays=tuple(arrays),
            comp_shapes=tuple((myb * v, mxb * h) for h, v in comp_hv),
            comp_hv=comp_hv, height=myb * 8 * v_max, width=mxb * 8 * h_max,
            samplings=tuple((v_max // v, h_max // h) for h, v in comp_hv),
            color=color, precision=precision, n_img=b, n_rows=n_rows,
            staging=staging)

    def _stage(self, specs):
        """Host arrays of the given (shape, dtype, fill): on a CUDA device
        views of one pinned buffer from the pool (each at a multiple of
        ``_ALIGN`` bytes), else plain numpy arrays."""
        if self._pinned is None:
            return None, [np.full(s, f, d) for s, d, f in specs]
        offs, n = [], 0
        for s, d, _ in specs:
            offs.append(n)
            n += -(-int(np.prod(s)) * np.dtype(d).itemsize // _ALIGN) * _ALIGN
        staging = self._pinned.take(n)
        raw = staging.numpy()
        arrays = []
        for (s, d, f), off in zip(specs, offs):
            nbytes = int(np.prod(s)) * np.dtype(d).itemsize
            x = raw[off:off + nbytes].view(d).reshape(s)
            x.fill(f)
            arrays.append(x)
        return staging, arrays

    def to_device(self, group: Group) -> list[torch.Tensor]:
        """The group's arrays on the device.  On a CUDA device: one
        non-blocking copy of the pinned staging buffer on the current
        stream, then views of it; the buffer goes back to the pool with the
        copy's event (the group's host arrays may be refilled after)."""
        if self._pinned is None:
            return [torch.from_numpy(x).to(self.device)
                    for x in group.arrays]
        if group.staging is None:
            raise ValueError("this group was copied already: its staging "
                             "buffer is back in the pool")
        base = group.staging.numpy().ctypes.data
        end = max(x.ctypes.data - base + x.nbytes for x in group.arrays)
        dev = group.staging[:end].to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self._pinned.give(group.staging, done)
        group.staging = None
        out = []
        for x in group.arrays:
            off = x.ctypes.data - base
            out.append(dev[off:off + x.nbytes].view(
                _TORCH_DTYPE[x.dtype]).view(x.shape))
        return out

    def unpack(self, group: Group, tensors) -> torch.Tensor:
        """The group's int32 blocks from its wire: the nibble wire through
        ``ops/pixels_cuda.unpack_nibble`` (the kernel K6a on the card, the
        plain :func:`unpack_nibble` on the CPU), only the (n_img, n_rows +
        1, 64) that the pixels read; the other wires through their torch
        unpack, the whole (B, n_blk + 1, 64)."""
        if group.wire == "nibble":
            return pixels_cuda.unpack_nibble(*tensors[:-2],
                                             n_img=group.n_img,
                                             n_rows=group.n_rows)
        return UNPACK[group.wire](*tensors[:-2])

    def pixels(self, group: Group, tensors) -> torch.Tensor:
        """Device stage of one group: (B, H_bucket, W_bucket, 3) uint8
        (uint16 for 12-bit groups).
        Pixels inside each image's (geom height, width) are exact; the rest
        is padding that :attr:`BatchItem.rgb` crops."""
        return rgb_from_blocks_dyn(
            self.unpack(group, tensors), tensors[-2], tensors[-1],
            comp_shapes=group.comp_shapes, comp_hv=group.comp_hv,
            height=group.height, width=group.width,
            samplings=group.samplings, idct=self.idct,
            upsample=self.upsample, color=group.color,
            precision=group.precision)

    def _decode_wave(self, host_out, results, base) -> None:
        """Device stage of one wave (on a CUDA device, on the decoder's own
        stream): errors, then per group padding, the copy and the pixel
        stage; fills ``results[base:base + len(host_out)]``."""
        t0 = time.perf_counter()
        on_stream = (contextlib.nullcontext() if self._stream is None
                     else torch.cuda.stream(self._stream))
        with on_stream:
            for i, (hdr, _) in enumerate(host_out):
                if isinstance(hdr, Exception):
                    results[base + i] = BatchItem(
                        index=base + i, header=None, rgb_batch=None,
                        batch_index=-1, error=hdr)
            for group in self.group(host_out):
                rgb_b = self.pixels(group, self.to_device(group))
                for k, (i, hdr) in enumerate(zip(group.idxs,
                                                 group.headers)):
                    results[base + i] = BatchItem(
                        index=base + i, header=hdr, rgb_batch=rgb_b,
                        batch_index=k)
        self.last_timing["worker_s"].append(time.perf_counter() - t0)

    def _host_wave(self, blobs) -> list:
        t0 = time.perf_counter()
        out = self.host_stage(blobs)
        self.last_timing["host_s"].append(time.perf_counter() - t0)
        return out

    def decode(self, blobs: list[bytes],
               wave: int | None = None) -> list[BatchItem]:
        """Decode a list of JPEG byte strings; returns device-resident RGB
        in input order, with per-image errors isolated.

        More than ``wave`` blobs (default :data:`DEFAULT_WAVE`) run in
        waves: host entropy of wave k+1 overlaps the device worker's pass
        over wave k (a 2-stage pipeline, as in the JAX package); an
        exception in the worker reaches the caller.  On a CUDA device the
        caller's current stream waits for the decoder's stream before this
        returns, and every output is recorded as used on it."""
        wave = DEFAULT_WAVE if wave is None else wave
        if wave < 1:
            raise ValueError(f"wave must be >= 1, got {wave}")
        self.last_timing = {"host_s": [], "worker_s": []}
        results: list[BatchItem | None] = [None] * len(blobs)
        if len(blobs) <= wave:
            self._decode_wave(self._host_wave(blobs), results, 0)
        else:
            pending = None
            for start in range(0, len(blobs), wave):
                host_out = self._host_wave(blobs[start:start + wave])
                if pending is not None:
                    pending.result()
                pending = self._worker.submit(self._decode_wave, host_out,
                                              results, start)
            pending.result()
        if self._stream is not None:
            caller = torch.cuda.current_stream(self.device)
            caller.wait_stream(self._stream)
            for t in {id(it.rgb_batch): it.rgb_batch for it in results
                      if it.rgb_batch is not None}.values():
                t.record_stream(caller)
        return results  # type: ignore[return-value]


def decode_batch(blobs: list[bytes], **kw) -> list[BatchItem]:
    with BatchDecoder(**kw) as bd:
        return bd.decode(blobs)
