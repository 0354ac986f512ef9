"""The batch routes' device pixel stage: K6a and K6b, hand-written CUDA
kernels (``csrc/pixels.cu``), and the plain versions they are held to.

* K6a, :func:`unpack_nibble`: the nibble wire to (B, n_blk + 1, 64) int32
  scan-order blocks, or with ``n_img``/``n_rows`` only the (n_img, n_rows
  + 1, 64) that the pixel stage reads.  It replaces the XLA code of the
  JAX package's ``models/batch.py:256 _batched_from_nibble``.  On a CUDA
  tensor it launches the kernel (three launches: chunk totals, each
  chunk's base, then one CTA a window of output positions that builds the
  window in shared memory and stores it once: no zero-fill pass, no adds
  in device memory) and counts ``unpack_nibble.launches``; on a CPU tensor
  it runs the plain version ``models.batch.unpack_nibble``.  Its first
  form (zeros and DC over the whole output, then 32-bit atomic adds in
  device memory) stays in the build as ``jd_unpack_nibble_v1``
  (``testing/pixel_v1.unpack_nibble_v1``), the same-card baseline; no path
  reaches it.
* K6b, :func:`blocks_to_rgb`: scan-order blocks to the group's whole
  (B, H, W, 3) RGB in one pass, padding included; the blocks may hold
  fewer images than the geometry (the rest are padding).  It replaces the JAX
  package's ``models/batch.py:52 _planes_from_blocks_dyn`` and ``:82
  _rgb_one_dyn`` (dequantise, IDCT, upsample, colour).  The kernel carries
  every IDCT: K1's arithmetic under ``pallas`` and ``kron`` (the Pallas
  kernel and its XLA twin), K5's under ``exact``, and under ``fast`` the
  separable ``(M @ X) @ M^T`` of ``pixel.idct_fast`` (``csrc/idct_common.cuh``;
  plain model :func:`fast_separable`).  Persistent CTAs walk the group's
  output tiles; under ``exact`` and ``fast`` each warp's blocks reach
  shared memory through its own two-stage ring of asynchronous copies, the
  next round in flight while it transforms this one (under ``pallas`` and
  ``kron`` K1's registers leave no room for the ring: the blocks are
  loaded as K1 loads them); a tile of bucket padding takes the colour of
  zeros without an IDCT.  On a CUDA tensor it launches the kernel or
  raises and counts ``blocks_to_rgb.launches``; on a CPU tensor it runs the
  plain version ``models.batch.rgb_from_blocks_torch``.  Its first form
  (one CTA per tile, the torch product :func:`scan_samples` before it under
  ``kron`` and ``fast``) stays in the build as ``jd_blocks_to_rgb_v1``
  (``testing/pixel_v1.py``), the same-card baseline; no path reaches it.

The kernels' decompositions have plain models here, for the CPU tests:
:func:`unpack_nibble_windowed` (K6a's: chunk totals and bases, windows of
output positions, the run of chunks whose entries land in each, the
escapes in each, the trim), :func:`unpack_nibble_chunked` (its first
form's: zeros and DC first, chunk totals, the prefix over chunks, the
threads' scan, each thread's walk, adds of nonzero values off the DC
slots, escapes off the DC slots) and
:func:`rgb_tiles_torch` (K6b's: the tiles in each persistent CTA's order,
each component's window of samples with the fancy filter's halo, blocks
from the closed-form geometry, zero blocks outside it, tiles of padding,
the per-pixel upsampling).  No path runs them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from .._build import CudaLib, launch_check
from . import idct_cuda, pixel

__all__ = ["blocks_to_rgb", "build", "fast_separable", "kernel_plan",
           "rgb_plan", "rgb_tiles_torch", "scan_samples", "unpack_nibble",
           "unpack_nibble_chunked", "unpack_nibble_windowed"]

LIB = CudaLib("pixels.cu", "jd_pixels", {
    "jd_unpack_nibble": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dc16, e, ov
        ctypes.c_void_p, ctypes.c_void_p,                   # esc idx, val
        ctypes.c_void_p, ctypes.c_void_p,                   # out, rec
        ctypes.c_void_p, ctypes.c_void_p,                   # base, flags
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,     # n_img, n_blk,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,     # n_keep, K, O,
        ctypes.c_void_p],                                   # E, stream
    "jd_unpack_nibble_v1": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dc16, e, ov
        ctypes.c_void_p, ctypes.c_void_p,                   # esc idx, val
        ctypes.c_void_p, ctypes.c_void_p,                   # out, agg
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,     # B, n_blk, K
        ctypes.c_int64, ctypes.c_int64,                     # O, E
        ctypes.c_void_p],                                   # stream
    "jd_blocks_to_rgb": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # blocks, qt, geom
        ctypes.c_void_p, ctypes.c_void_p,                   # kron, out
        ctypes.c_int64, ctypes.c_int64,                     # B, n_rows
        ctypes.c_void_p, ctypes.c_void_p,                   # dims, geo
        ctypes.c_int64, ctypes.c_int64,                     # grid, smem
        ctypes.c_void_p],                                   # stream
    "jd_blocks_to_rgb_v1": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # blocks, qt, geom
        ctypes.c_void_p, ctypes.c_void_p,                   # kron, out
        ctypes.c_int64, ctypes.c_int64,                     # B, n_rows
        ctypes.c_void_p, ctypes.c_void_p,                   # dims, geo
        ctypes.c_int64, ctypes.c_int64,                     # tiles, smem
        ctypes.c_void_p]})                                  # stream

#: K6a: threads of a CTA and entries a thread takes (one 16-byte load); a
#: chunk of a row is their product.
UNPACK_THREADS = 256
PER_THREAD = 16
#: K6a's output window: the positions a CTA builds in shared memory
#: (``csrc/pixels.cu:kWindow``).
WINDOW = 8192
#: K6b: threads of a CTA, blocks a round of IDCTs (eight threads each).
PIX_THREADS = 256
OCTETS = PIX_THREADS // 8
#: K6b's output tile (pixels, rounded down to whole MCUs).
TILE = (64, 64)
#: K6b's persistent CTAs a multiprocessor, per IDCT (``csrc/pixels.cu:kCtas``,
#: ``kK1Ctas`` and ``kFastCtas`` cap the registers for as many).
CTAS_PER_SM = {"pallas": 3, "kron": 3, "exact": 4, "fast": 3}
#: The first form's tile (whole MCUs: 64 x 64 took 1.8765 ms on the batch
#: of 32 against 2.1525 at 32 x 64, the fastest of six in chip_smoke.py's
#: sweep on an H100 80GB HBM3 at 700 W).
TILE_V1 = (64, 64)
#: Bytes of the first form's octets' scratch, all octets: K1's two padded
#: blocks under ``pallas``, K5's padded tile under ``exact``, none for the
#: samples made before it (``samples``).
SCRATCH = {"pallas": OCTETS * 2 * 72 * 4, "exact": OCTETS * 72 * 4,
           "samples": 0}
#: Bytes of K6b's scratch, all octets: K1's two padded blocks under
#: ``pallas`` and ``kron``, one padded block of 4-byte words under ``fast``
#: and ``exact`` (fast's transposes, K5's tile).
K6B_SCRATCH = {"pallas": OCTETS * 2 * 72 * 4, "kron": OCTETS * 2 * 72 * 4,
               "exact": OCTETS * 72 * 4, "fast": OCTETS * 72 * 4}
#: Bytes of K6b's rings, all warps (two stages of four blocks a warp), under
#: the IDCTs that take their blocks through them.
K6B_STAGES = {"pallas": 0, "kron": 0, "exact": 2 * OCTETS * 256,
              "fast": 2 * OCTETS * 256}
#: The kernels' mode codes (``kron`` runs K1's arithmetic).
MODES = {"pallas": 0, "kron": 0, "exact": 1, "samples": 2, "fast": 3}
#: Dynamic shared memory a CTA may have (H100).
SMEM_MAX = 232448
COLOURS = {"gray": 0, "ycbcr": 1, "rgb": 2, "ycck": 3, "cmyk": 4}
UP_NONE, UP_NN, UP_FANCY = 0, 1, 2

_count_lock = threading.Lock()


def build():
    """Compile ``csrc/pixels.cu`` (once per source, header and flag set,
    into ``.cache/torch/kernels/``) and load it."""
    return LIB.load()


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _need(t: torch.Tensor, name: str, dtype, dim: int, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# -- K6a ----------------------------------------------------------------------

def _trim(dc16, n_img, n_rows) -> tuple[int, int]:
    """``(n_img, n_rows)`` of a call, the whole wire's where not given."""
    b, n_blk = dc16.shape
    n_img = b if n_img is None else int(n_img)
    n_rows = n_blk if n_rows is None else int(n_rows)
    if not 0 <= n_img <= b:
        raise ValueError(f"n_img {n_img} outside [0, {b}]")
    if not 0 <= n_rows <= n_blk:
        raise ValueError(f"n_rows {n_rows} outside [0, {n_blk}]")
    return n_img, n_rows


def unpack_nibble(dc16, e, ov, esc_idx, esc_val, *, n_img=None,
                  n_rows=None) -> torch.Tensor:
    """Nibble wire -> (B, n_blk + 1, 64) int32 blocks, equal to
    ``models.batch.unpack_nibble`` on every element.

    With ``n_img`` (images, the wire's first rows) and ``n_rows`` (blocks
    of the longest of them) it returns only the (n_img, n_rows + 1, 64)
    that K6b reads: the plain version on the wire cut to them
    (``dc16[:n_img, :n_rows]`` and the first ``n_img`` rows of the rest:
    values and escapes at block ``n_rows`` or later are dropped, and block
    ``n_rows`` is the zero fill block).  That is the whole output's
    ``[:n_img, :n_rows + 1]`` wherever the whole output is zero at block
    ``n_rows``, as it is when ``n_rows`` covers every image's blocks.

    On a CUDA tensor this launches K6a or raises; on a CPU tensor it runs
    the plain version."""
    n_img, n_rows = _trim(dc16, n_img, n_rows)
    if n_img == 0:
        return torch.zeros((0, n_rows + 1, 64), dtype=torch.int32,
                           device=dc16.device)
    if dc16.device.type == "cpu":
        from ..models import batch
        return batch.unpack_nibble(dc16[:n_img, :n_rows], e[:n_img],
                                   ov[:n_img], esc_idx[:n_img],
                                   esc_val[:n_img])
    if dc16.device.type != "cuda":
        raise ValueError(f"no kernel for device {dc16.device}")
    return launch_unpack(build(), dc16, e, ov, esc_idx, esc_val, n_img,
                         n_rows)


def check_wire(dc16, e, ov, esc_idx, esc_val, n_img: int) -> None:
    """The checks a launch of K6a (or its first form) makes on the wire:
    dtypes, ranks, one device, contiguity, one batch size, at most 65,535
    images a launch."""
    dev = dc16.device
    for t, name, dtype in ((dc16, "dc16", torch.int16), (e, "e", torch.uint8),
                           (ov, "ov", torch.int8),
                           (esc_idx, "esc_idx", torch.int32),
                           (esc_val, "esc_val", torch.int16)):
        _need(t, name, dtype, 2, dev)
    b = dc16.shape[0]
    if (e.shape[0], ov.shape[0], esc_idx.shape[0]) != (b, b, b) or \
            esc_val.shape != esc_idx.shape:
        raise ValueError("wire arrays of different batch sizes")
    if n_img > 65535:
        raise ValueError("at most 65535 images per launch")


def launch_unpack(lib, dc16, e, ov, esc_idx, esc_val, n_img: int,
                  n_rows: int) -> torch.Tensor:
    """One launch of K6a (``jd_unpack_nibble`` of ``lib``) on CUDA tensors
    with a checked trim, on the current stream: checks the wire, allocates
    the (n_img, n_rows + 1, 64) output and the kernel's scratch, counts
    ``unpack_nibble.launches``; raises if the launch failed."""
    check_wire(dc16, e, ov, esc_idx, esc_val, n_img)
    dev = dc16.device
    n_blk = dc16.shape[1]
    k, n_esc = e.shape[1], esc_idx.shape[1]
    n_chunks = -(-k // (UNPACK_THREADS * PER_THREAD))
    out = torch.empty((n_img, n_rows + 1, 64), dtype=torch.int32, device=dev)
    rec = torch.empty((n_img, max(n_chunks, 1), 4), dtype=torch.int32,
                      device=dev)
    base = torch.empty((n_img, n_chunks + 1, 2), dtype=torch.int64,
                       device=dev)
    flags = torch.empty((n_img, -(-n_esc // UNPACK_THREADS) + 1),
                        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.jd_unpack_nibble(
            dc16.data_ptr(), e.data_ptr(), ov.data_ptr(), esc_idx.data_ptr(),
            esc_val.data_ptr(), out.data_ptr(), rec.data_ptr(),
            base.data_ptr(), flags.data_ptr(), n_img, n_blk, n_rows, k,
            ov.shape[1], n_esc, _stream(dc16))
    launch_check(rc, "unpack_nibble")
    _count(unpack_nibble)
    return out


#: Launches of K6a since the count was last set to 0.
unpack_nibble.launches = 0


def unpack_nibble_windowed(dc16, e, ov, esc_idx, esc_val, *, n_img=None,
                           n_rows=None, chunk: int = UNPACK_THREADS
                           * PER_THREAD,
                           window: int = WINDOW) -> torch.Tensor:
    """Plain model of K6a's decomposition (numpy, CPU tensors in and out):
    rows cut into chunks of ``chunk`` entries (entries past the row's end
    are 0x00 fillers); each chunk's advance and overflow totals and whether
    an entry carries a value; each chunk's base, the totals before it, and
    the row's totals after the last; whether the row's escapes fall (keys
    ``max(idx, -1)``); then each window of ``window`` output positions
    (a multiple of 64; the last one ragged) built on its own: zeros and DC
    of the blocks below ``n_rows``; the run of chunks whose entries land in
    ``[w0, lim)`` (``lim``: the window's end, at most ``n_rows * 64``),
    found by lower bounds on the bases, less those that advance nowhere and
    carry no value; their values added off the DC slots; the escapes in the
    window (a lower bound on the keys, or all of them where they fall) set
    off the DC slots.  Trim as :func:`unpack_nibble`.  Equal to
    :func:`unpack_nibble` on every element (tests hold it there at small
    chunks and windows)."""
    n_img, n_rows = _trim(dc16, n_img, n_rows)
    if window % 64 or window <= 0 or chunk <= 0:
        raise ValueError("window: a positive multiple of 64; chunk > 0")
    dc = dc16.numpy()[:n_img].astype(np.int32)
    ent = e.numpy()[:n_img].astype(np.int64)
    ovs = ov.numpy()[:n_img].astype(np.int32)
    ei = esc_idx.numpy()[:n_img].astype(np.int64)
    ev = esc_val.numpy()[:n_img].astype(np.int32)
    k, o = ent.shape[1], ovs.shape[1]
    n_chunks = -(-k // chunk)
    pad = np.zeros((n_img, n_chunks * chunk), np.int64)
    pad[:, :k] = ent
    g, vc = pad >> 4, pad & 15
    adv = np.where(vc == 0, g * 16, g).reshape(n_img, n_chunks, chunk)
    is_ov = (vc == 8).astype(np.int64).reshape(n_img, n_chunks, chunk)
    vc = vc.reshape(n_img, n_chunks, chunk)
    tot_adv, tot_ov = adv.sum(2), is_ov.sum(2)
    live = (vc != 0).any(2)
    zero = np.zeros((n_img, 1), np.int64)
    base_pos = np.concatenate([zero, np.cumsum(tot_adv, 1)], 1)
    base_rank = np.concatenate([zero, np.cumsum(tot_ov, 1)], 1)
    keys = np.maximum(ei, -1)
    falls = (np.diff(keys, axis=1) < 0).any(1)
    row = (n_rows + 1) * 64
    out = np.zeros((n_img, row), np.int32)
    for b in range(n_img):
        for w0 in range(0, row, window):
            w1 = min(w0 + window, row)
            lim = min(w1, n_rows * 64)
            win = np.zeros(w1 - w0, np.int64)
            p = np.arange(w0, w1)
            dc_slot = (p % 64 == 0) & (p < n_rows * 64)
            win[dc_slot] = dc[b, p[dc_slot] // 64]
            if w0 < lim:
                # Chunk c's entries land on [base[c] - 1, base[c + 1] - 1].
                first = np.searchsorted(base_pos[b], w0 + 1) - 1
                end = min(np.searchsorted(base_pos[b], lim + 1), n_chunks)
                for c in range(first, end):
                    if tot_adv[b, c] == 0 and not live[b, c]:
                        continue
                    pos = base_pos[b, c] + np.cumsum(adv[b, c])
                    rank = (base_rank[b, c] + np.cumsum(is_ov[b, c])
                            - is_ov[b, c])
                    val = ((vc[b, c] + 8) & 15) - 8
                    if o:
                        val = np.where(is_ov[b, c] == 1,
                                       ovs[b, np.clip(rank, 0, o - 1)], val)
                    else:
                        val = np.where(is_ov[b, c] == 1, 0, val)
                    idx = pos - 1
                    keep = ((idx >= w0) & (idx < lim) & (idx % 64 != 0)
                            & (val != 0))
                    np.add.at(win, idx[keep] - w0, val[keep])
                lo, hi = ((0, keys.shape[1]) if falls[b] else
                          (np.searchsorted(keys[b], w0),
                           np.searchsorted(keys[b], lim)))
                i = ei[b, lo:hi]
                keep = (i >= w0) & (i < lim) & (i % 64 != 0)
                win[i[keep] - w0] = ev[b, lo:hi][keep]
            out[b, w0:w1] = win.astype(np.int32)
    return torch.from_numpy(out.reshape(n_img, n_rows + 1, 64))


def unpack_nibble_chunked(dc16, e, ov, esc_idx, esc_val, *,
                          threads: int = UNPACK_THREADS,
                          per: int = PER_THREAD) -> torch.Tensor:
    """Plain model of K6a's decomposition: the output zero with each
    block's DC in its slot; rows cut into chunks of ``threads * per``
    entries; each chunk's advance and overflow totals; each chunk's base
    from the totals of the chunks before it; the threads' exclusive scan
    inside the chunk; each thread's walk over its ``per`` entries (entries
    past the row's end are 0x00 fillers); every nonzero value added at its
    position inside ``[0, n_blk * 64)`` off the DC slots; the escapes set
    off the DC slots (DC is set last in the reference, so nothing else may
    change a DC slot).  Equal to ``unpack_nibble`` on every element (tests
    hold it there at small chunks)."""
    b, n_blk = dc16.shape
    k = e.shape[1]
    chunk = threads * per
    n_chunks = max(-(-k // chunk), 1)
    ent = torch.zeros((b, n_chunks * chunk), dtype=torch.int64)
    ent[:, :k] = e.to(torch.int64)
    ent = ent.view(b, n_chunks, threads, per)
    g, vc = ent >> 4, ent & 15
    adv = torch.where(vc == 0, g * 16, g)
    is_ov = (vc == 8).to(torch.int64)
    # Chunk totals, then each chunk's base (the totals before it).
    tot_adv, tot_ov = adv.sum((2, 3)), is_ov.sum((2, 3))
    base_adv = torch.cumsum(tot_adv, 1) - tot_adv
    base_ov = torch.cumsum(tot_ov, 1) - tot_ov
    # The threads' exclusive scan inside the chunk.
    th_adv, th_ov = adv.sum(3), is_ov.sum(3)
    ex_adv = torch.cumsum(th_adv, 2) - th_adv
    ex_ov = torch.cumsum(th_ov, 2) - th_ov
    # Each thread's walk: positions after each entry, ranks before it.
    pos = (base_adv[:, :, None, None] + ex_adv[..., None]
           + torch.cumsum(adv, 3))
    rank = (base_ov[:, :, None, None] + ex_ov[..., None]
            + torch.cumsum(is_ov, 3) - is_ov)
    o = ov.shape[1]
    if o:
        ovv = torch.gather(ov.to(torch.int64), 1,
                           rank.reshape(b, -1).clamp(0, o - 1)
                           ).view(rank.shape)
    else:
        ovv = torch.zeros_like(rank)
    val = torch.where(is_ov.bool(), ovv, ((vc + 8) & 15) - 8)
    idx = pos - 1
    stride = (n_blk + 1) * 64
    flat = torch.zeros(b * stride, dtype=torch.int32)
    flat.view(b, n_blk + 1, 64)[:, :n_blk, 0] = dc16.to(torch.int32)
    keep = (val != 0) & (idx >= 0) & (idx < n_blk * 64) & ((idx & 63) != 0)
    rows = torch.arange(b).view(-1, 1, 1, 1).expand_as(idx)
    flat.index_add_(0, (rows * stride + idx)[keep],
                    val[keep].to(torch.int32))
    ei = esc_idx.to(torch.int64)
    keep = (ei >= 0) & (ei < n_blk * 64) & ((ei & 63) != 0)
    rows = torch.arange(b).view(-1, 1).expand_as(ei)
    flat[(rows * stride + ei)[keep]] = esc_val.to(torch.int32)[keep]
    return flat.view(b, n_blk + 1, 64)


# -- K6b ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RgbPlan:
    """K6b's launch geometry for a group: the output dims, the tiles, the
    colour and per component (h, v, k0, n_r, n_c, vy, vx, up, win_w, off):
    sampling factors, first block in an MCU, the sample rows and columns
    the upsampler sees (cropped to the unpadded grid at the bucket's dims),
    upsampling factors, the upsampling kind, the window's columns and its
    first int in the sample area (windows of ``win_h`` rows)."""

    out_h: int
    out_w: int
    tile_h: int
    tile_w: int
    tiles_x: int
    tiles_y: int
    bpm: int
    colour: int
    center: int
    maxv: int
    comps: tuple
    win_h: tuple
    window_ints: int

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    def smem(self, mode: str) -> int:
        """The first form's dynamic shared memory under ``mode``."""
        return SCRATCH[mode] + 4 * self.window_ints

    def layout(self, idct: str, out_bytes: int, staged: bool = False) -> dict:
        """K6b's dynamic shared memory under ``idct`` for output elements of
        ``out_bytes``: byte offsets of the rings and the windows after the
        octets' scratch, the windows' ints (a multiple of 4), the row table
        (an int2 a component and tile row) and the staged rows after them,
        their pitch and (``staged``) their room; ``smem`` the total."""
        win = -(-self.window_ints // 4) * 4
        pitch = -(-(self.tile_w * 3 * out_bytes + 15) // 16) * 16
        lay = {"off_stage": K6B_SCRATCH[idct],
               "off_win": K6B_SCRATCH[idct] + K6B_STAGES[idct],
               "window_ints": win, "rgb_pitch": pitch}
        lay["off_rows"] = lay["off_win"] + 4 * win
        lay["off_rgb"] = lay["off_rows"] + -(-8 * len(self.comps)
                                             * self.tile_h // 16) * 16
        lay["smem"] = lay["off_rgb"] + (self.tile_h * pitch if staged else 0)
        return lay


def _colour(color: str, n_comps: int, precision: int) -> int:
    """The kernel's colour code, as pixel_pipeline_impl picks its branch."""
    if color == "auto":
        color = {1: "gray", 3: "ycbcr", 4: "cmyk"}.get(n_comps, "ycbcr")
    if precision != 8 and color in ("rgb", "ycck", "cmyk"):
        raise ValueError(
            "12-bit decode is supported for gray/YCbCr frames only")
    if n_comps == 1:
        return COLOURS["gray"]
    if color == "rgb":
        need, code = 3, COLOURS["rgb"]
    elif color in ("ycck", "cmyk"):
        need, code = 4, COLOURS[color]
    else:
        need, code = 3, COLOURS["ycbcr"]
    if n_comps < need:
        raise ValueError(f"{color} needs {need} components, got {n_comps}")
    return code


def rgb_plan(*, comp_shapes, comp_hv, height: int, width: int, samplings,
             upsample: str, color: str, precision: int,
             tile=None) -> RgbPlan:
    """K6b's geometry for a group (pure Python), its first form's too.
    ``tile`` (rows, cols) of output pixels, whole MCUs by default
    (:data:`TILE_V1` rounded down to MCUs, at least one)."""
    if upsample not in ("fancy", "nn"):
        raise ValueError(f"unknown upsample {upsample!r}")
    n = len(comp_shapes)
    if not 1 <= n <= 4:
        raise ValueError(f"1 to 4 components, got {n}")
    colour = _colour(color, n, precision)
    h_max = max(h for h, _ in comp_hv)
    v_max = max(v for _, v in comp_hv)
    if tile is None:
        tile = _whole_mcus(TILE_V1, comp_hv)
    tile_h, tile_w = tile
    comps, hs, ws, k0 = [], [], [], 0
    for (rows, cols), (h, v), (vy, vx) in zip(comp_shapes, comp_hv,
                                              samplings):
        n_r, n_c = rows * 8, cols * 8
        if (vy, vx) == (1, 1):
            up, up_r, up_c = UP_NONE, n_r, n_c
        else:
            n_r = min(n_r, -(-height // vy))
            n_c = min(n_c, -(-width // vx))
            fancy = upsample == "fancy" and vy in (1, 2) and vx in (1, 2)
            up = UP_FANCY if fancy else UP_NN
            up_r, up_c = n_r * vy, n_c * vx
        comps.append([h, v, k0, n_r, n_c, vy, vx, up])
        hs.append(up_r)
        ws.append(up_c)
        k0 += h * v
    out_h, out_w = min(min(hs), height), min(min(ws), width)
    off, win_h = 0, []
    for c in comps:
        vy, vx = c[5], c[6]
        wh, ww = -(-tile_h // vy) + 2, -(-tile_w // vx) + 2
        c += [ww, off]
        win_h.append(wh)
        off += wh * ww
    return RgbPlan(
        out_h=out_h, out_w=out_w, tile_h=tile_h, tile_w=tile_w,
        tiles_x=-(-out_w // tile_w), tiles_y=-(-out_h // tile_h), bpm=k0,
        colour=colour, center=1 << (precision - 1),
        maxv=(1 << precision) - 1, comps=tuple(tuple(c) for c in comps),
        win_h=tuple(win_h), window_ints=off)


def _whole_mcus(tile, comp_hv) -> tuple[int, int]:
    """``tile`` (rows, cols) of pixels rounded down to whole MCUs, at least
    one."""
    mh = 8 * max(v for _, v in comp_hv)
    mw = 8 * max(h for h, _ in comp_hv)
    return mh * max(1, tile[0] // mh), mw * max(1, tile[1] // mw)


def scan_samples(blocks, qtables, comp_hv, idct: str) -> torch.Tensor:
    """The ``kron`` or ``fast`` product on scan-order blocks: (B, N, 64)
    int32 blocks, each dequantised by its component's table of
    ``qtables`` (B, n_comps, 64), then ``torch.matmul`` by the Kronecker
    basis (``idct_cuda.idct_kron``'s arithmetic) or the einsum
    (``pixel.idct_fast``).  Returns (B, M, 64) int32 samples of the first
    M = (N // blocks per MCU) MCUs' rows: the rows past them are the fill
    row, which K6b's first form never reads.  K6b's first form takes it
    before its launch (``testing/pixel_v1.py``); K6b does not.  Calls on a
    CUDA tensor count ``scan_samples.launches``."""
    if idct not in ("kron", "fast"):
        raise ValueError(f"scan_samples takes kron or fast, got {idct!r}")
    b, n = blocks.shape[:2]
    block_comp = [c for c, (h, v) in enumerate(comp_hv) for _ in range(h * v)]
    bpm = len(block_comp)
    m = n // bpm
    if blocks.is_cuda:
        _count(scan_samples)
    q = qtables[:, block_comp].to(torch.int32)             # (B, bpm, 64)
    deq = blocks[:, :m * bpm].reshape(b, m, bpm, 64) * q[:, None]
    if idct == "fast":
        return pixel.idct_fast(deq.reshape(b, m * bpm, 8, 8)).reshape(
            b, m * bpm, 64)
    if blocks.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the kron product needs full float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    out = torch.matmul(deq.reshape(b, m * bpm, 64).to(torch.float32),
                       idct_cuda._basis_t(blocks.device))
    return pixel.trunc_int32(torch.round(out))


#: Calls of :func:`scan_samples` on a CUDA tensor since the count was last
#: set to 0 (the batch routes' main path makes none).
scan_samples.launches = 0


def fast_separable(deq: torch.Tensor) -> torch.Tensor:
    """Plain model of K6b's ``fast`` arithmetic (``csrc/idct_common.cuh``
    ``fast_col_pass``/``fast_row_pass``) on dequantised int32 blocks
    (..., 64), associated as torch's einsum contracts ``pixel.idct_fast``:
    a column pass t[p][v] = sum_u M[p][u] x[u][v], then a row pass
    o[p][q] = sum_v t[p][v] M[q][v], each a float32 FMA chain in index
    order with M = ``pixel.IDCT_M_F32``; rint half to even, saturating at
    the int32 range.  Within +-1 of ``pixel.idct_fast`` and of the JAX
    package's (another order of the same float32 sums)."""
    shape = deq.shape
    x = deq.reshape(-1, 8, 8).to(torch.float32)            # [n, u, v]
    m = torch.from_numpy(pixel.IDCT_M_F32).to(deq.device)  # [p, u]
    t = m[:, 0, None] * x[:, None, 0, :]                    # [n, p, v]
    for u in range(1, 8):
        t = idct_cuda._fma(m[:, u, None], x[:, None, u, :], t)
    o = t[:, :, None, 0] * m[:, 0]                          # [n, p, q]
    for v in range(1, 8):
        o = idct_cuda._fma(t[:, :, None, v], m[:, v], o)
    return pixel.trunc_int32(torch.round(o)).reshape(shape)


_sms_cache: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms_cache:
        _sms_cache[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sms_cache[idx]


def check_rgb_args(blocks, qtables, geom, n_comps: int, idct: str) -> None:
    """The checks K6b's wrapper makes before a launch: dtype, rank, device,
    contiguity, shapes (``blocks`` may hold fewer images than ``qtables``
    and ``geom``), batch size, 16-byte alignment, the IDCT's name."""
    if idct not in ("exact", "pallas", "kron", "fast"):
        raise ValueError(f"unknown idct {idct!r}")
    dev = blocks.device
    _need(blocks, "blocks", torch.int32, 3, dev)
    _need(qtables, "qtables", torch.int32, 3, dev)
    _need(geom, "geom", torch.int32, 2, dev)
    b = geom.shape[0]
    if blocks.shape[2] != 64 or blocks.shape[0] > b \
            or tuple(qtables.shape) != (b, n_comps, 64) \
            or tuple(geom.shape) != (b, 4):
        raise ValueError(f"shapes: blocks {tuple(blocks.shape)}, qtables "
                         f"{tuple(qtables.shape)}, geom {tuple(geom.shape)}")
    if b > 65535:
        raise ValueError("at most 65535 images per launch")
    if blocks.shape[1] >= 2 ** 31:
        raise ValueError("at most 2^31 - 1 blocks an image")
    for t, name in ((blocks, "blocks"), (qtables, "qtables")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def launch_rgb(lib, blocks, qtables, geom, kron, out, plan: RgbPlan,
               idct: str, grid: int, stream: int, *,
               staged: bool = False) -> None:
    """One launch of K6b (``jd_blocks_to_rgb`` of ``lib``) on ``stream``
    from checked arguments: ``out`` the (B, H, W, 3) output (B the images
    of ``geom``; those past ``blocks``' are padding), ``kron`` K1's
    basis rows (``idct_cuda._basis``), ``grid`` persistent CTAs;
    ``staged``: room for the staged RGB rows of the variant that stores
    them 16 bytes at a time.  Counts ``blocks_to_rgb.launches``; raises if
    the launch failed."""
    lay = plan.layout(idct, out.element_size(), staged=staged)
    if lay["smem"] > SMEM_MAX:
        raise ValueError(f"K6b needs {lay['smem']} bytes of shared memory "
                         f"(tile {plan.tile_h}x{plan.tile_w}); at most "
                         f"{SMEM_MAX}")
    n_comps = len(plan.comps)
    dims = (ctypes.c_int32 * 20)(
        n_comps, plan.bpm, plan.out_h, plan.out_w, plan.tile_h, plan.tile_w,
        plan.tiles_x, plan.n_tiles, plan.colour, plan.center, plan.maxv,
        MODES[idct], out.element_size(), lay["off_stage"], lay["off_win"],
        lay["window_ints"], lay["off_rows"], lay["off_rgb"],
        lay["rgb_pitch"], blocks.shape[0])
    geo = (ctypes.c_int32 * (10 * n_comps))(
        *(x for c in plan.comps for x in c))
    rc = lib.jd_blocks_to_rgb(
        blocks.data_ptr(), qtables.data_ptr(), geom.data_ptr(),
        kron.data_ptr(), out.data_ptr(), out.shape[0], blocks.shape[1],
        dims, geo, grid, lay["smem"], stream)
    launch_check(rc, "blocks_to_rgb")
    _count(blocks_to_rgb)


def grid_for(plan: RgbPlan, n_img: int, sms: int, ctas_per_sm: int) -> int:
    """K6b's persistent grid: ``ctas_per_sm`` CTAs on each of ``sms``
    multiprocessors, at most one a tile."""
    return max(1, min(n_img * plan.n_tiles, sms * ctas_per_sm))


def kernel_plan(*, comp_shapes, comp_hv, height: int, width: int, samplings,
                upsample: str, color: str, precision: int) -> RgbPlan:
    """K6b's plan for a group: :func:`rgb_plan` at tiles of :data:`TILE`
    rounded down to whole MCUs."""
    return rgb_plan(comp_shapes=comp_shapes, comp_hv=comp_hv, height=height,
                    width=width, samplings=samplings, upsample=upsample,
                    color=color, precision=precision,
                    tile=_whole_mcus(TILE, comp_hv))


def blocks_to_rgb(blocks, qtables, geom, *, comp_shapes, comp_hv, height,
                  width, samplings, idct, upsample, color,
                  precision, plan=None) -> torch.Tensor:
    """(B', N, 64) int32 scan-order blocks, (B, n_comps, 64) int32 tables
    and (B, 4) int32 geometry (mcus_x, mcus_y, height, width), B' <= B ->
    the group's (B, H, W, 3) uint8 RGB (uint16 for 12-bit), padding
    included, as ``models.batch.rgb_from_blocks_torch`` computes it: the
    images past the blocks' B' are padding, the colour of zero blocks.

    On a CUDA tensor this launches K6b (every IDCT inside the kernel, tiles
    of :data:`TILE`, a grid of :data:`CTAS_PER_SM` CTAs a multiprocessor)
    or raises; on a CPU tensor it runs the plain version.  ``plan``: the
    group's :func:`kernel_plan`, made here when None."""
    if blocks.device.type == "cpu":
        from ..models import batch
        return batch.rgb_from_blocks_torch(
            blocks, qtables, geom, comp_shapes=comp_shapes, comp_hv=comp_hv,
            height=height, width=width, samplings=samplings, idct=idct,
            upsample=upsample, color=color, precision=precision)
    if blocks.device.type != "cuda":
        raise ValueError(f"no kernel for device {blocks.device}")
    check_rgb_args(blocks, qtables, geom, len(comp_shapes), idct)
    dev = blocks.device
    if plan is None:
        plan = kernel_plan(comp_shapes=comp_shapes, comp_hv=comp_hv,
                           height=height, width=width, samplings=samplings,
                           upsample=upsample, color=color,
                           precision=precision)
    out = torch.empty((geom.shape[0], plan.out_h, plan.out_w, 3),
                      dtype=pixel._sample_dtype(precision), device=dev)
    lib = build()
    with torch.cuda.device(dev):
        launch_rgb(lib, blocks, qtables, geom, idct_cuda._basis(dev, False),
                   out, plan, idct,
                   grid_for(plan, geom.shape[0], _sm_count(dev),
                            CTAS_PER_SM[idct]), _stream(blocks))
    return out


#: Launches of K6b since the count was last set to 0.
blocks_to_rgb.launches = 0


def _span(lo_out: int, hi_out: int, f: int, up: int, n: int):
    """The window of samples rows (or columns) lo_out..hi_out reach."""
    if up == UP_NONE:
        return lo_out, hi_out
    if up == UP_NN or f == 1:
        return lo_out // f, hi_out // f
    return max(lo_out // 2 - 1, 0), min(hi_out // 2 + 1, n - 1)


def _scan_idct(blocks, qtables, comp_hv, idct: str) -> torch.Tensor:
    """Per-block samples of scan-order blocks with the plain route's
    arithmetic for ``idct`` (the CPU twins: ``exact_twin``'s op-by-op AAN,
    ``idct_kron``'s product under ``pallas`` and ``kron``, ``idct_fast``)."""
    if idct == "fast":
        return scan_samples(blocks, qtables, comp_hv, "fast")
    if idct in ("pallas", "kron"):
        return scan_samples(blocks, qtables, comp_hv, "kron")
    if idct != "exact":
        raise ValueError(f"unknown idct {idct!r}")
    b, n = blocks.shape[:2]
    block_comp = [c for c, (h, v) in enumerate(comp_hv) for _ in range(h * v)]
    bpm = len(block_comp)
    m = n // bpm
    q = qtables[:, block_comp].to(torch.int32)
    deq = blocks[:, :m * bpm].reshape(b, m, bpm, 64) * q[:, None]
    return pixel.idct_exact(deq.reshape(b, m * bpm, 8, 8)).reshape(
        b, m * bpm, 64)


def rgb_tiles_torch(blocks, qtables, geom, *, comp_shapes, comp_hv, height,
                    width, samplings, idct, upsample, color, precision,
                    tile=None, grid=None,
                    arithmetic: str = "route") -> torch.Tensor:
    """Plain model of K6b's decomposition on CPU tensors: the output tiles
    of the group's images in the order ``grid`` persistent CTAs take them
    (CTA i: tiles i, i + grid, ...; image by image when None); for each
    tile each component's window of samples (the rows and columns the
    tile's pixels reach, the fancy filter's halo included), filled block by
    block from the closed-form geometry (a cell outside it a zero block);
    a tile whose windows reach no block of the geometry takes the colour of
    zeros, and so does every tile of an image past the blocks' first
    dimension; else each pixel's upsampled samples from the windows and the
    colour transform.  The samples come from the plain route's per-block
    IDCT (:func:`_scan_idct`), or with ``arithmetic="kernel"`` from the
    kernel's own ``fast`` (:func:`fast_separable`).  Equal to
    ``rgb_from_blocks_torch`` (tests hold it there at small tiles)."""
    plan = rgb_plan(comp_shapes=comp_shapes, comp_hv=comp_hv, height=height,
                    width=width, samplings=samplings, upsample=upsample,
                    color=color, precision=precision, tile=tile)
    qtables = qtables[:blocks.shape[0]]
    if arithmetic == "kernel" and idct == "fast":
        block_comp = [c for c, (h, v) in enumerate(comp_hv)
                      for _ in range(h * v)]
        bpm = len(block_comp)
        m = blocks.shape[1] // bpm
        deq = (blocks[:, :m * bpm].reshape(blocks.shape[0], m, bpm, 64)
               * qtables[:, block_comp].to(torch.int32)[:, None])
        samples = fast_separable(deq.reshape(blocks.shape[0], m * bpm, 64))
    else:
        samples = _scan_idct(blocks, qtables, comp_hv, idct)
    n_coded, n_rows = samples.shape[:2]
    b = geom.shape[0]
    out = torch.empty((b, plan.out_h, plan.out_w, 3),
                      dtype=pixel._sample_dtype(precision))
    n_work = b * plan.n_tiles
    grid = grid or n_work
    for work in (w for cta in range(grid) for w in range(cta, n_work, grid)):
        k, tile_i = divmod(work, plan.n_tiles)
        ty, tx = divmod(tile_i, plan.tiles_x)
        mcus_x, mcus_y, true_h, true_w = (int(x) for x in geom[k])
        y0, x0 = ty * plan.tile_h, tx * plan.tile_w
        y1 = min(y0 + plan.tile_h, plan.out_h) - 1
        x1 = min(x0 + plan.tile_w, plan.out_w) - 1
        live = k < n_coded and any(
            (_span(y0, y1, vy, up, n_r)[0] >> 3) < mcus_y * v
            and (_span(x0, x1, vx, up, n_c)[0] >> 3) < mcus_x * h
            for (h, v, _, n_r, n_c, vy, vx, up, _, _) in plan.comps)
        vals = []
        for (h, v, k0, n_r, n_c, vy, vx, up, _, _) in plan.comps:
            if not live:
                vals.append(torch.zeros((y1 - y0 + 1, x1 - x0 + 1),
                                        dtype=torch.int64))
                continue
            r0, r1 = _span(y0, y1, vy, up, n_r)
            c0, c1 = _span(x0, x1, vx, up, n_c)
            sr = torch.arange(r0, r1 + 1).view(-1, 1)
            sc = torch.arange(c0, c1 + 1).view(1, -1)
            br, bc = sr // 8, sc // 8
            src = (((br // v) * mcus_x + bc // h) * plan.bpm + k0
                   + (br % v) * h + bc % h)
            valid = ((br < mcus_y * v) & (bc < mcus_x * h)
                     & (src < n_rows))
            win = samples[k, src.clamp(0, n_rows - 1),
                          (sr % 8) * 8 + sc % 8]
            win = torch.where(valid, win, 0)
            vals.append(_upsampled(
                win, r0, c0, y0, y1, x0, x1, vy, vx, up, n_r, n_c,
                -(-true_h // vy), -(-true_w // vx)))
        out[k, y0:y1 + 1, x0:x1 + 1] = _colour_pixels(
            vals, plan.colour, precision)
    return out


def _upsampled(win, r0, c0, y0, y1, x0, x1, vy, vx, up, n_r, n_c, e_r, e_c):
    """The kernel's per-pixel upsampling of one component over the tile's
    pixels (y0..y1, x0..x1), from its window ``win`` (first sample r0, c0):
    the torch ops of ``pixel.upsample_fancy``/``upsample_nn`` written per
    output pixel, int32 wrapping."""
    y = torch.arange(y0, y1 + 1).view(-1, 1)
    x = torch.arange(x0, x1 + 1).view(1, -1)

    def s(i, j):
        return win[i - r0, j - c0].to(torch.int64)

    def wrap(t):   # int32 wraparound of an int64 sum
        return ((t + 2 ** 31) % 2 ** 32 - 2 ** 31)

    if up == UP_NONE:
        return s(y, x)
    if up == UP_NN:
        return s(y // vy, x // vx)

    def down(i, e, n):
        return torch.where(i + 1 >= e, i, torch.clamp(i + 1, max=n - 1))

    def prev(i):
        return torch.clamp(i - 1, min=0)

    if vy == 2 and vx == 2:
        i, j = y >> 1, x >> 1
        ni = torch.where((y & 1) == 1, down(i, e_r, n_r), prev(i))
        nj = torch.where((x & 1) == 1, down(j, e_c, n_c), prev(j))
        col_j = wrap(3 * s(i, j) + s(ni, j))
        col_n = wrap(3 * s(i, nj) + s(ni, nj))
        return wrap(3 * col_j + col_n + torch.where((x & 1) == 1, 7, 8)) >> 4
    if vy == 2:
        i = y >> 1
        ni = torch.where((y & 1) == 1, down(i, e_r, n_r), prev(i))
        return wrap(3 * s(i, x) + s(ni, x)
                    + torch.where((y & 1) == 1, 2, 1)) >> 2
    j = x >> 1
    nj = torch.where((x & 1) == 1, down(j, e_c, n_c), prev(j))
    return wrap(3 * s(y, j) + s(y, nj) + torch.where((x & 1) == 1, 2, 1)) >> 2


def _colour_pixels(vals, colour: int, precision: int) -> torch.Tensor:
    """(h, w, 3) RGB of one tile from its components' upsampled samples, by
    the colour functions of ``ops/pixel.py``."""
    v = [t.to(torch.int32) for t in vals]
    if colour == COLOURS["gray"]:
        return pixel.gray_to_rgb(v[0], precision)
    if colour == COLOURS["rgb"]:
        return torch.stack([pixel._level_shift_u8(p) for p in v[:3]],
                           dim=-1).to(torch.uint8)
    if colour in (COLOURS["ycck"], COLOURS["cmyk"]):
        name = "ycck" if colour == COLOURS["ycck"] else "cmyk"
        return pixel.cmyk_to_rgb(pixel.decoded_to_cmyk(v[:4], name))
    return pixel.ycbcr_to_rgb(v[0], v[1], v[2], precision)

