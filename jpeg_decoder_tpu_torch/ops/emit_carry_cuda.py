"""Cross-rank DC carry of the emit-lane decode (K7c): the CUDA kernels and
their plain versions.

On a mesh each rank runs K7 (``ops/entropy_emit_cuda.decode_lanes`` with
``lanes=``) on its share of every image's lanes; K7's DC carry starts from
0 at the share's first lane, so the blocks of the restart segment open at
the share's start lack the DC sums of the ranks before it (a DRI-0 image is
one segment: every block of every rank but the first).  ``parallel/
sharded.py`` all-gathers each rank's per-(image, component) DC total of the
segment open at its last MCU; the carry adds to each rank's first segment
the totals of the ranks before it in that segment (see
``csrc/emit_carry.cu``): the cross-device half of JAX's psum and segmented
prefix sum (jax sharded.py:630, :641-646).  Then the ranks all-gather the
rows each owns.

* :func:`carry_pack`, the mesh route's form, launches ``jd_carry_pack``:
  one pass over the rows this rank owns that carries their DC, writes the
  carried DC back in place and packs the rows into the send buffer of the
  'seg' all-gather (``max(counts)`` rows, the pad zeroed).  Its plan
  (:func:`pack_plan`, a :class:`PackPlan`) is built before K7's launch: up
  to :data:`INLINE_IMAGES` images it rides in the kernel's parameters, a
  larger one goes to the card then in one non-blocking copy from a reused
  pinned buffer.  Launches count in ``carry_pack.launches``.  Its plain
  version :func:`carry_pack_torch` is :func:`add_carry_torch`, the gather
  of the owned rows and the pad.
* :func:`add_carry`, the first form, launches ``jd_emit_carry_v1``: the
  carry alone, in place, after one copy of the host plan (rank mask and
  row ranges) to the card; plain version :func:`add_carry_torch`.  It is on
  no path: chip_smoke.py and the card tests hold the new form to it.

Both wrappers launch on CUDA tensors, on the current stream (built with
nvcc for sm_90a at first use, bound with ctypes; a failed build or launch
raises), and run the plain version on CPU tensors; that is the only way
the plain versions are reached.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .._build import CudaLib, launch_check
from .entropy_emit_cuda import _n_sms
from .staging import PinnedStage, upload

_P, _I32, _I64, _U64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                        ctypes.c_uint64)
LIB = CudaLib("emit_carry.cu", "jd_emit_carry", {
    "jd_emit_carry_v1": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32,
                         _U64, _I64, _P],
    "jd_carry_pack": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32,
                      _I32, _U64, _I64, _P]})
_count_lock = threading.Lock()

#: One image of :func:`carry_pack`'s plan as the kernel reads it (``PackImg``
#: in ``csrc/emit_carry.cu``): its first owned row in the blocks seen as
#: (B * rows, 64), that row's place in the send buffer, its owned rows, its
#: carried rows [c_lo, c_hi) counted from the first owned one, and the mask
#: of the ranks whose totals carry in.
PLAN_DTYPE = np.dtype([("src", "<i8"), ("dst", "<i4"), ("n", "<i4"),
                       ("c_lo", "<i4"), ("c_hi", "<i4"), ("w", "<u8")])
#: Images whose plan rides in the kernel's parameters (``kInline``: the
#: parameters hold 4 KB); a larger plan is copied to the card.
INLINE_IMAGES = 120
#: Ranks a plan's mask holds; images x components of the carry table the
#: kernel keeps in shared memory.
MAX_RANKS = 64
MAX_CELLS = 32768
#: Send rows a CTA moves a step (``kTileRows``), and CTAs of 256 threads
#: an SM holds (``kPackCtasPerSm``).
TILE_ROWS = 64
CTAS_PER_SM = 4
_stage = PinnedStage()


def build():
    """Compile ``csrc/emit_carry.cu`` (once per source and flag set) and
    load it."""
    return LIB.load()


def _check(out, tot, w, lo, hi, block_comp) -> None:
    if tot.device != out.device or not tot.is_contiguous():
        raise ValueError(f"tot must be contiguous on {out.device}")
    if out.dtype != torch.int32 or out.dim() != 3 or out.shape[2] != 64 \
            or not out.is_contiguous():
        raise TypeError(f"out must be contiguous (B, rows, 64) int32, got "
                        f"{out.dtype} {tuple(out.shape)}")
    b = out.shape[0]
    n_comps = max(block_comp) + 1
    if tot.dtype != torch.int32 or tot.dim() != 3 or tot.shape[1] != b \
            or tot.shape[2] != n_comps or w.shape != tuple(tot.shape[:2]):
        raise TypeError(f"tot must be (R, {b}, {n_comps}) int32 and w "
                        f"(R, {b}), got {tuple(tot.shape)} {w.shape}")
    if lo.shape != (b,) or hi.shape != (b,) or (lo < 0).any():
        raise ValueError(f"lo and hi must be ({b},) with 0 <= lo")
    if not 1 <= len(block_comp) <= 16 or not 1 <= n_comps <= 4:
        raise ValueError(f"bad block_comp {block_comp}")


def add_carry(out: torch.Tensor, tot: torch.Tensor, w, lo, hi, *,
              block_comp: tuple[int, ...]) -> torch.Tensor:
    """The first form.  Add to coefficient 0 of image b's rows ``lo[b] ..
    hi[b]-1`` of ``out`` (B, rows, 64) int32, in place, ``sum_q w[q, b] *
    tot[q, b, c]`` for the block's component c (``block_comp[row %
    bpm]``), wrapping as int32.  ``tot``: (R, B, n_comps) int32 DC totals
    of R ranks on ``out``'s device; ``w`` (R, B) 0/1 and ``lo``/``hi``
    (B,) with 0 <= lo: the host plan (a ``PackPlan``'s ``w``, ``lo`` and
    ``hi``), which goes to the device with the launch.  Where no range
    holds a row, nothing is launched.  Returns ``out``."""
    w, lo, hi = (np.asarray(a, np.int64) for a in (w, lo, hi))
    _check(out, tot, w, lo, hi, block_comp)
    dev = out.device
    max_span = int(np.maximum(hi - lo, 0).max(initial=0))
    if max_span == 0:
        return out
    if dev.type == "cpu":
        return add_carry_torch(out, tot, w, lo, hi, block_comp=block_comp)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    with torch.cuda.device(dev):
        _launch_v1(out, tot, *upload([w.astype(np.int32), lo, hi], dev),
                   block_comp, max_span)
    with _count_lock:
        add_carry.launches += 1
    return out


def _launch_v1(out, tot, w_t, lo_t, hi_t, block_comp, max_span) -> None:
    """One launch of the first form with its plan already on the card
    (chip_smoke.py times the kernel alone this way)."""
    comp_code = sum(c << (4 * k) for k, c in enumerate(block_comp))
    rc = build().jd_emit_carry_v1(
        out.data_ptr(), tot.data_ptr(), w_t.data_ptr(), lo_t.data_ptr(),
        hi_t.data_ptr(), out.shape[0], out.shape[1], tot.shape[0],
        tot.shape[2], len(block_comp), comp_code, max_span,
        torch.cuda.current_stream(out.device).cuda_stream)
    launch_check(rc, "jd_emit_carry_v1")


#: Launches of the CUDA kernel since the count was last set to 0.
add_carry.launches = 0


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def add_carry_torch(out: torch.Tensor, tot: torch.Tensor, w, lo, hi, *,
                    block_comp: tuple[int, ...]) -> torch.Tensor:
    """Plain PyTorch version of :func:`add_carry`, the same contract: the
    carry by a masked sum over ranks, then one indexed add per row range."""
    dev = out.device
    b, rows, _ = out.shape
    w, lo, hi = (torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                 for a in (w, lo, hi))
    carry = _wrap32((w[:, :, None] * tot.to(torch.int64)).sum(0))
    hi = hi.clamp(max=rows)
    span = (hi - lo).clamp(min=0)
    img = torch.repeat_interleave(torch.arange(b, device=dev), span)
    row = torch.arange(int(span.sum()), device=dev) - torch.repeat_interleave(
        span.cumsum(0) - span, span) + lo[img]
    comp = torch.tensor(block_comp, dtype=torch.int64, device=dev)
    flat = out.view(-1, 64)
    at = img * rows + row
    flat[at, 0] = _wrap32(flat[at, 0].to(torch.int64)
                          + carry[img, comp[row % len(block_comp)]]
                          ).to(torch.int32)
    return out


@dataclass(frozen=True)
class PackPlan:
    """:func:`carry_pack`'s plan for B images (:func:`pack_plan`): ``w``
    (R, B) 0/1, the carried rows ``lo``/``hi`` and the owned rows
    ``own_lo``/``own_hi`` (B,) of each image, ``offset`` (B,) each image's
    first row in the send buffer of ``n_send`` rows; ``table`` the same as
    the kernel's records, and ``on_card`` those records on the card when
    they do not fit in the kernel's parameters."""

    w: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    own_lo: np.ndarray
    own_hi: np.ndarray
    offset: np.ndarray
    rows: int
    bpm: int
    n_send: int
    table: np.ndarray
    on_card: torch.Tensor | None = None

    @property
    def n_own(self) -> int:
        """Owned rows of every image: the send buffer's rows before the
        pad."""
        return int((self.own_hi - self.own_lo).sum())


def pack_plan(w, lo, hi, own_lo, own_hi, *, rows: int, bpm: int,
              n_send: int | None = None, device=None) -> PackPlan:
    """The plan of :func:`carry_pack` for B images of ``rows`` block rows:
    ``w`` (R, B) 0/1, R <= 64; each image's owned rows [own_lo, own_hi),
    whole MCUs of ``bpm`` blocks, and the rows [lo, hi) it carries (none
    where hi <= lo), inside the owned ones; ``n_send`` (at least the owned
    rows of all images, their count by default) the send buffer's rows.
    On a CUDA ``device`` a plan of more than :data:`INLINE_IMAGES` images
    goes to the card here, in one non-blocking copy on the current stream:
    build it before the launches it should overlap.  Raises ValueError on
    a plan the kernel does not take."""
    w = np.asarray(w, np.int64)
    lo, hi, own_lo, own_hi = (np.asarray(a, np.int64)
                              for a in (lo, hi, own_lo, own_hi))
    if w.ndim != 2 or not 1 <= w.shape[0] <= MAX_RANKS or \
            ((w != 0) & (w != 1)).any():
        raise ValueError(f"w must be (R, B) 0/1 with 1 <= R <= {MAX_RANKS}")
    b = w.shape[1]
    if b < 1 or any(a.shape != (b,) for a in (lo, hi, own_lo, own_hi)):
        raise ValueError(f"lo, hi, own_lo and own_hi must be ({b},)")
    span = own_hi - own_lo
    if (own_lo < 0).any() or (span < 0).any() or (own_hi > rows).any() or \
            (own_lo % bpm).any() or (span % bpm).any():
        raise ValueError(f"owned rows must be whole MCUs of {bpm} blocks "
                         f"in 0..{rows}")
    carried = hi > lo
    if (carried & ((lo < own_lo) | (hi > own_hi))).any():
        raise ValueError("carried rows must lie inside the owned rows")
    offset = np.cumsum(span) - span
    n_own = int(span.sum())
    n_send = max(n_own, 1) if n_send is None else int(n_send)
    if not n_own <= n_send < 2 ** 31 or n_send < 1:
        raise ValueError(f"n_send {n_send}: at least the {n_own} owned "
                         "rows, below 2^31")
    table = np.zeros(b, PLAN_DTYPE)
    table["src"] = np.arange(b, dtype=np.int64) * rows + own_lo
    table["dst"] = offset
    table["n"] = span
    table["c_lo"] = np.where(carried, lo - own_lo, 0)
    table["c_hi"] = np.where(carried, hi - own_lo, 0)
    table["w"] = (w.astype(np.uint64)
                  << np.arange(w.shape[0], dtype=np.uint64)[:, None]).sum(0)
    on_card = None
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda" and b > INLINE_IMAGES:
        on_card = _stage.upload(table, dev)
    return PackPlan(w.astype(np.int32), lo, hi, own_lo, own_hi, offset,
                    int(rows), int(bpm), n_send, table, on_card)


def pack_grid(n_send: int, n_sms: int) -> int:
    """CTAs of ``jd_carry_pack``: one for every 64-row tile of the send
    buffer, at most :data:`CTAS_PER_SM` a SM; each takes one contiguous run
    of tiles."""
    return max(1, min(-(-n_send // TILE_ROWS), CTAS_PER_SM * n_sms))


def _check_pack(blocks, tot, plan: PackPlan, block_comp) -> None:
    b = plan.table.shape[0]
    if blocks.dtype != torch.int32 or blocks.dim() != 3 or \
            blocks.shape[0] != b or blocks.shape[1] != plan.rows or \
            blocks.shape[2] != 64 or not blocks.is_contiguous():
        raise TypeError(f"blocks must be contiguous ({b}, {plan.rows}, 64) "
                        f"int32, got {blocks.dtype} {tuple(blocks.shape)}")
    # The kernel moves rows as 16-byte vectors.
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must start on a 16-byte boundary")
    n_comps = max(block_comp) + 1
    if len(block_comp) != plan.bpm or not 1 <= n_comps <= 4 or \
            b * n_comps > MAX_CELLS:
        raise ValueError(f"bad block_comp {block_comp} for bpm {plan.bpm} "
                         f"and {b} images")
    if tot.device != blocks.device or tot.dtype != torch.int32 or \
            tot.shape != (plan.w.shape[0], b, n_comps) or \
            not tot.is_contiguous():
        raise TypeError(f"tot must be contiguous ({plan.w.shape[0]}, {b}, "
                        f"{n_comps}) int32 on {blocks.device}, got "
                        f"{tot.dtype} {tuple(tot.shape)} on {tot.device}")


def carry_pack(blocks: torch.Tensor, tot: torch.Tensor, plan: PackPlan, *,
               block_comp: tuple[int, ...]) -> torch.Tensor:
    """Carry the DC of this rank's rows and pack them for the all-gather:
    adds to coefficient 0 of each carried row of image b (``plan.lo[b] ..
    plan.hi[b]-1``) ``sum_q plan.w[q, b] * tot[q, b, c]`` for the block's
    component c (``block_comp[row % bpm]``), wrapping as int32, in place in
    ``blocks`` (B, rows, 64) int32, and returns the send buffer
    (``plan.n_send``, 64) int32: every image's owned rows in order, then
    zero rows.  ``tot``: (R, B, n_comps) int32 DC totals of R ranks on
    ``blocks``' device.  Launches one kernel on a CUDA tensor (or raises);
    runs :func:`carry_pack_torch` on a CPU one."""
    _check_pack(blocks, tot, plan, block_comp)
    dev = blocks.device
    if dev.type == "cpu":
        return carry_pack_torch(blocks, tot, plan, block_comp=block_comp)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    b = plan.table.shape[0]
    if b > INLINE_IMAGES and (plan.on_card is None
                              or plan.on_card.device != dev):
        raise ValueError(f"a plan of {b} images must be on {dev}: "
                         f"pack_plan(..., device={dev})")
    comp_code = sum(c << (4 * k) for k, c in enumerate(block_comp))
    with torch.cuda.device(dev):
        send = torch.empty((plan.n_send, 64), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = build().jd_carry_pack(
            blocks.data_ptr(), send.data_ptr(), tot.data_ptr(),
            plan.table.ctypes.data,
            0 if plan.on_card is None else plan.on_card.data_ptr(),
            b, plan.n_own, plan.n_send, tot.shape[0], tot.shape[2],
            plan.bpm, comp_code, pack_grid(plan.n_send, _n_sms(dev)), stream)
    launch_check(rc, "jd_carry_pack")
    with _count_lock:
        carry_pack.launches += 1
    return send


#: Launches of the CUDA kernel since the count was last set to 0.
carry_pack.launches = 0


def owned_rows(plan: PackPlan) -> np.ndarray:
    """(n_own,) int64 rows of the blocks seen as (B * rows, 64) that the
    send buffer's first rows hold, in order."""
    span = plan.own_hi - plan.own_lo
    return (np.repeat(plan.table["src"] - plan.offset, span)
            + np.arange(plan.n_own, dtype=np.int64))


def carry_pack_torch(blocks: torch.Tensor, tot: torch.Tensor,
                     plan: PackPlan, *,
                     block_comp: tuple[int, ...]) -> torch.Tensor:
    """Plain PyTorch version of :func:`carry_pack`, the same contract:
    :func:`add_carry_torch`, then the gather of the owned rows and the
    pad."""
    add_carry_torch(blocks, tot, plan.w, plan.lo, plan.hi,
                    block_comp=block_comp)
    idx = torch.from_numpy(owned_rows(plan)).to(blocks.device)
    mine = blocks.view(-1, 64)[idx]
    return torch.cat([mine, mine.new_zeros(plan.n_send - plan.n_own, 64)])
