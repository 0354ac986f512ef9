"""Progressive Huffman scan kernels K8a-K8d: the CUDA kernels and their plain
versions.

Counterparts of the JAX package's device loops in
``jpeg_decoder_tpu/ops/entropy_prog.py`` (see ``csrc/entropy_prog.cu`` for
the mapping): each wrapper applies one scan of one kind to device-resident
coefficient planes, in place, and returns the scan's (S,) int32 lane flags.

* :func:`dc_first` (K8a), :func:`dc_refine` (K8b), :func:`ac_first` (K8c)
  and :func:`ac_refine` (K8d) launch ``csrc/entropy_prog.cu`` (built with
  nvcc for sm_90a at first use into ``.cache/torch/kernels/``, bound with
  ctypes) on CUDA tensors, on the current stream, and count their launches
  in ``<wrapper>.launches``.  A failed build or launch raises.  On CPU
  tensors they run the plain versions; that is the only way those are
  reached.  K8a runs one warp per lane up to :data:`DC_WARP_LANES_MAX`
  lanes and one thread per lane beyond, with the DC tables'
  :func:`dc_tables` and the lanes' words staged in shared memory; K8b one
  thread per block of the scan.  K8d runs one warp per lane, K8c too up to
  :data:`WARP_LANES_MAX` lanes and one thread per lane beyond, with the AC
  table's :func:`compact_table` and the lane's words staged in shared
  memory, and K8d's history as bit masks (the design is in the source's
  header); ``dc_first.last_stats``, ``ac_first.last_stats`` and
  ``ac_refine.last_stats`` hold the last launch's counters.  Their first
  forms stay in the same build for the same-card comparison
  (``testing/prog_v1.py``).
* :func:`dc_first_torch`, :func:`dc_refine_torch`, :func:`ac_first_torch`
  and :func:`ac_refine_torch` are the plain PyTorch versions the kernels are
  held to, vectorised over lanes: one Python step per block slot (DC), per
  symbol or skipped EOB run (AC first) or per symbol or band position (AC
  refine), with masks.  They run on any device.  :func:`history_masks_torch`
  is the plain version of K8d's mask build.

Planes are ``(n_rows + 1, 64)`` int32 in natural coefficient order, the last
row the drop row, as in the JAX package.  A scan's lanes come as a
:class:`LaneTable` (:func:`lane_table` checks on the host that the lanes
tile the scan's units in order and lie inside the scan), its block rows as a
:class:`Geometry`.  A lane is flagged for a bad code, a size or run out of
range, a position past its end bit and, when the lanes are ``chained``
(records of one host walk), for an end state other than the next lane's
start; a flagged lane's blocks are unspecified.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import NamedTuple

import numpy as np
import torch

from .._build import CudaLib, launch_check
from ..types import JPEGError, ZIGZAG
from .staging import upload

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_LANES = [_P, _I64, _P, _P, _P, _P]   # words, n_words, base, end, n_per, first
LIB = CudaLib("entropy_prog.cu", "jd_entropy_prog", {
    "jd_prog_dc_first": _LANES + [_P, _I32, _P, _P, _I32, _I32, _P, _P, _P,
                                  _P, _P, _I32, _I32, _I64, _I32, _I32, _I64,
                                  _P, _P],
    "jd_prog_dc_resident": [_I32, _I32, _I32, _I32, _P],
    "jd_prog_dc_refine": _LANES + [_P, _P, _P, _P, _P, _I32, _I64, _I64,
                                   _I64, _P, _P],
    "jd_prog_dc_v1": [_I32] + _LANES + [_P, _I32, _P, _P, _P, _P, _P, _P,
                                        _I32, _I32, _I64, _I64, _P, _P],
    "jd_prog_ac": [_I32] + _LANES + [_P, _P, _P, _I32, _I32, _P, _P, _I32,
                                     _I32, _I32, _I32, _I64, _I32, _I32, _P,
                                     _P],
    "jd_prog_ac_v1": [_I32] + _LANES + [_P, _P, _P, _P, _I32, _I32, _I32,
                                        _I32, _I64, _P, _P],
    "jd_prog_ac_grid": [_I32, _I32, _I32, _I32, _I64, _P],
    "jd_prog_ac_l1_bits": [], "jd_prog_ac_l2_slots": [],
    "jd_prog_ac_max_budget": [], "jd_prog_dc_lookahead": [],
    "jd_prog_geo_len": []})

#: Blocks per MCU of an interleaved scan and planes per scan (T.81 B.2.3).
MAX_SLOTS = 10
MAX_PLANES = 4
#: Zero words past the end of a scan's data that its word pool must hold.
PAD_WORDS = 8
#: Length of :meth:`Geometry.pack` (the kernel's ``kGeoLen``).
GEO_LEN = 2 + 6 * MAX_SLOTS + 2 * MAX_PLANES
#: K8c/K8d's compact AC table (:func:`compact_table`): first-level index
#: bits and the most second-level tables (``kAcL1Bits``, ``kAcL2Slots``).
AC_L1_BITS = 11
AC_L2_SLOTS = 64
#: Most words K8a/K8c/K8d stage in shared memory per lane in their warp
#: form, per 32 lanes in their thread form (``kMaxBudget``).
AC_MAX_BUDGET = 4096
#: Words past a lane's end word that K8c/K8d's reader may take
#: (``kLookahead``), and K8a's (``kDcLookahead``: its walker runs four
#: symbols before it checks the end bit).
LOOKAHEAD = 3
DC_LOOKAHEAD = 7
#: Most lanes a scan gives K8c's warp form (one warp per lane); more take
#: its thread form (one thread per lane).  K8d always runs its warp form.
WARP_LANES_MAX = 1024
#: Most lanes a DC first scan gives K8a's warp form; more take its thread
#: form (the numbers that set it are in ``csrc/entropy_prog.cu``'s header).
DC_WARP_LANES_MAX = 1024

_ZZ = torch.from_numpy(ZIGZAG.astype(np.int64))
_count_lock = threading.Lock()


def build():
    """Compile ``csrc/entropy_prog.cu`` (once per source and flag set) and
    load it."""
    lib = LIB.load()
    got = (lib.jd_prog_geo_len(), lib.jd_prog_ac_l1_bits(),
           lib.jd_prog_ac_l2_slots(), lib.jd_prog_ac_max_budget(),
           lib.jd_prog_dc_lookahead())
    want = (GEO_LEN, AC_L1_BITS, AC_L2_SLOTS, AC_MAX_BUDGET, DC_LOOKAHEAD)
    if got != want:
        raise RuntimeError(f"entropy_prog.cu constants {got} != {want}")
    return lib


class AcTable(NamedTuple):
    """An AC table's compact form for K8c/K8d (:func:`compact_table`):
    ``tab`` (2048 + 32 * n_slots,) int16, on the host or the device."""

    tab: object
    n_slots: int
    l2_full: bool


_compact_cache: dict = {}


def compact_table(lut: np.ndarray) -> AcTable:
    """The compact form of a (65536,) int32 Huffman LUT (``huffman.
    build_lut``: entry = symbol << 5 | length): entry p of the first level
    is the LUT's entry for every window whose top 11 bits are p when that
    code is at most 11 bits long, -(slot + 1) when longer codes start with
    p (their 32 entries are second-level table ``slot``), 0 when no code
    does.  Entries keep their low 13 bits (length and symbol).  At most
    :data:`AC_L2_SLOTS` second levels; with more, ``l2_full`` is set and
    the prefixes left out read the LUT on the device.  Memoised per LUT
    array (``build_lut`` returns one cached array per table)."""
    key = id(lut)
    hit = _compact_cache.get(key)
    if hit is not None and hit[0] is lut:
        return hit[1]
    t = np.asarray(lut, np.int32).reshape(1 << AC_L1_BITS, -1)
    head = t[:, 0]
    short = ((head & 31) > 0) & ((head & 31) <= AC_L1_BITS)
    longer = np.flatnonzero(~short & (t != 0).any(1))
    used = longer[:AC_L2_SLOTS]
    l1 = np.where(short, head & 0x1FFF, 0).astype(np.int16)
    l1[used] = -(np.arange(len(used)) + 1)
    tab = np.concatenate([l1, (t[used] & 0x1FFF).astype(np.int16).ravel()])
    out = AcTable(tab, len(used), len(longer) > AC_L2_SLOTS)
    if len(_compact_cache) > 64:
        _compact_cache.clear()
    _compact_cache[key] = (lut, out)
    return out


class DcTables(NamedTuple):
    """A DC first scan's tables in compact form for K8a (:func:`dc_tables`):
    ``tab`` (nsc * 2048 + 32 * n_slots,) int16 on the host or the device,
    each component's first level and then the second levels of all;
    ``l2_full`` has bit c set where component c's table left prefixes out
    (their probes read its LUT in device memory)."""

    tab: object
    n_slots: int
    l2_full: int


_dc_cache: dict = {}


def dc_tables(luts: list) -> DcTables:
    """The compact forms of a DC scan's (65536,) int32 LUTs, one per
    component in scan order (:func:`compact_table` each), in one array:
    component c's first level at c * 2048, its second-level references moved
    past the earlier components' second levels.  At most
    :data:`AC_L2_SLOTS` second levels in all: a table whose second levels
    do not fit leaves them all out (``l2_full``).  Memoised per tuple of
    LUT arrays."""
    key = tuple(id(t) for t in luts)
    hit = _dc_cache.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], luts)):
        return hit[1]
    l1s, l2s, used, full = [], [], 0, 0
    for c, lut in enumerate(luts):
        one = compact_table(lut)
        l1 = one.tab[:1 << AC_L1_BITS].copy()
        if used + one.n_slots <= AC_L2_SLOTS:
            l1[l1 < 0] -= used
            l2s.append(one.tab[1 << AC_L1_BITS:])
            used += one.n_slots
            full |= int(one.l2_full) << c
        else:
            l1[l1 < 0] = 0
            full |= 1 << c
        l1s.append(l1)
    out = DcTables(np.concatenate(l1s + l2s), used, full)
    if len(_dc_cache) > 64:
        _dc_cache.clear()
    _dc_cache[key] = (tuple(luts), out)
    return out


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Where block t of a lane whose first unit is m0 goes: unit
    m = m0 + t // bpm, slot j = t % bpm; slot j's plane ``slots[j][0]``, row
    (my * v + jv) * pcols + mx * h + jh with my, mx = divmod(m, mx_div) and
    (plane, v, jv, h, jh, comp) = ``slots[j]`` (comp: the slot's component
    in scan order, its DC table).  ``pcols`` and ``n_rows`` are each plane's
    block columns and rows without the drop row.  A single-component scan
    has one slot (0, 1, 0, 1, 0, 0) and ``mx_div`` its unpadded block
    columns: it walks the unpadded grid and writes into the padded plane."""

    mx_div: int
    slots: tuple
    pcols: tuple
    n_rows: tuple

    @property
    def bpm(self) -> int:
        return len(self.slots)

    def pack(self) -> np.ndarray:
        """The (GEO_LEN,) int64 host array the C entry points read."""
        out = np.zeros(GEO_LEN, np.int64)
        out[:2] = self.bpm, self.mx_div
        for f in range(6):
            for j, slot in enumerate(self.slots):
                out[2 + f * MAX_SLOTS + j] = slot[f]
        out[2 + 6 * MAX_SLOTS:2 + 6 * MAX_SLOTS + len(self.pcols)] = \
            self.pcols
        base = 2 + 6 * MAX_SLOTS + MAX_PLANES
        out[base:base + len(self.n_rows)] = self.n_rows
        return out

    def check(self, n_units: int) -> None:
        """Raises unless every unit below ``n_units`` maps inside its
        plane."""
        if not 1 <= self.bpm <= MAX_SLOTS or not 1 <= len(self.pcols) \
                <= MAX_PLANES or len(self.n_rows) != len(self.pcols) \
                or self.mx_div < 1:
            raise ValueError(f"bad geometry {self}")
        my_max = (n_units - 1) // self.mx_div
        mx_max = min(n_units, self.mx_div) - 1
        for p, v, jv, h, jh, _c in self.slots:
            if not 0 <= p < len(self.pcols):
                raise ValueError(f"slot plane {p} outside {self}")
            hi = (my_max * v + jv) * self.pcols[p] + mx_max * h + jh
            if min(v, jv, h, jh) < 0 or jh >= self.pcols[p] \
                    or mx_max * h + jh >= self.pcols[p] \
                    or hi >= self.n_rows[p]:
                raise ValueError(f"{n_units} units do not fit {self}")

    def rows(self, m0: torch.Tensor, t) -> tuple[int, torch.Tensor]:
        """(plane, rows) of block ``t`` of lanes starting at units ``m0``:
        ``t`` an int (one slot for all lanes) or, with one slot, a tensor;
        rows outside the plane are -1."""
        j = t % self.bpm if isinstance(t, int) else 0
        p, v, jv, h, jh, _c = self.slots[j]
        m = m0 + t // self.bpm
        my, mx = m // self.mx_div, m % self.mx_div
        row = (my * v + jv) * self.pcols[p] + mx * h + jh
        return p, torch.where((row >= 0) & (row < self.n_rows[p]), row, -1)


@dataclasses.dataclass
class LaneTable:
    """One scan's lanes on a device (see :func:`lane_table`): (S,) int64
    ``base`` and ``end`` bits, int32 ``n_per`` units, int64 ``first`` unit,
    int32 ``eob0`` pending EOB runs, (S, nsc) int32 ``pred0`` predictors;
    ``chained`` lanes must each end at the next one's start."""

    base: torch.Tensor
    end: torch.Tensor
    n_per: torch.Tensor
    first: torch.Tensor
    eob0: torch.Tensor
    pred0: torch.Tensor
    chained: bool
    n_units: int
    scan_bits: int
    max_units: int
    #: The units the lanes tile, (0, n_units) but for a mesh rank's share.
    units: tuple = (0, 0)
    #: The longest lane's bits, end - base, and the most bits of 32
    #: consecutive lanes (size K8a/K8c/K8d's word staging).
    max_bits: int = 0
    max_group_bits: int = 0
    #: The units of every lane when all but the last have the same count
    #: (lane s then starts at unit s * stride: K8b finds a block's lane by
    #: a division), else 0.
    stride: int = 0

    @property
    def n(self) -> int:
        return self.base.shape[0]


def lane_table(base, n_per, first, *, n_units: int, scan_bits: int,
               chained: bool, end=None, eob0=None, pred0=None,
               device="cpu", words: np.ndarray | None = None,
               units: tuple[int, int] | None = None):
    """Check a scan's lanes on the host and copy them to ``device``.

    ``base``: (S,) start bits in the scan's data; ``n_per``: units (MCUs of
    a DC scan, blocks of an AC scan) per lane; ``first``: each lane's first
    unit; ``end``: each lane's last allowed bit (segment lanes: their
    segment's end; ``chained`` lanes: the next lane's start, the scan's end
    for the last, the default); ``eob0``, ``pred0``: pending EOB runs and
    (S, nsc) predictors entering each lane (zeros by default).  With
    ``words`` (the scan's word pool) the pool and the tables go in one
    copy, and the pool comes back first.  ``units`` = (lo, hi): the lanes
    tile units lo .. hi-1 of the scan's ``n_units`` (a mesh rank's share
    of a scan's lanes, K8a, K8c and K8d; all of them by default); the last
    lane of a chained share that is not the scan's last is the next share's
    first lane with no units, so that the share's last real lane is held to
    the next one's start state as every inner lane is.

    Raises :class:`JPEGError` for a scan of 2^31 bits or more, and
    ValueError unless the lanes tile their units in order and their bits
    lie in order inside the scan."""
    if scan_bits >= 1 << 31:
        raise JPEGError(f"progressive lanes take scans under 2^31 bits, got "
                        f"{scan_bits}")
    base = np.ascontiguousarray(base, np.int64)
    n_per = np.ascontiguousarray(n_per, np.int32)
    first = np.ascontiguousarray(first, np.int64)
    s = len(base)
    eob0 = np.zeros(s, np.int32) if eob0 is None else \
        np.ascontiguousarray(eob0, np.int32)
    pred0 = np.zeros((s, 1), np.int32) if pred0 is None else \
        np.ascontiguousarray(pred0, np.int32)
    if end is None:
        if not chained:
            raise ValueError("segment lanes need their end bits")
        end = np.append(base[1:], scan_bits)
    end = np.ascontiguousarray(end, np.int64)
    if s < 1 or any(len(a) != s for a in (n_per, first, eob0, end)) or \
            pred0.ndim != 2 or pred0.shape[0] != s or not \
            1 <= pred0.shape[1] <= MAX_PLANES:
        raise ValueError(f"lane tables of {s} lanes disagree in shape")
    lo, hi = (0, n_units) if units is None else units
    if not 0 <= lo <= hi <= n_units or (n_per < 0).any() or \
            first[0] != lo or (first[1:] != first[:-1] + n_per[:-1]).any() \
            or first[-1] + n_per[-1] != hi:
        raise ValueError(f"lanes do not tile units {lo}..{hi - 1} of the "
                         f"scan's {n_units} in order")
    if (base < 0).any() or (np.diff(base) < 0).any() or \
            (end < base).any() or (end > scan_bits).any() or \
            (eob0 < 0).any():
        raise ValueError("lane bits out of order or outside the scan")
    if chained and (end[:-1] != base[1:]).any():
        raise ValueError("chained lanes must end at the next lane's start")
    arrays = [base, end, n_per, first, eob0, pred0]
    if words is not None:
        arrays = [words] + arrays
    got = upload(arrays, device)
    lanes = LaneTable(*got[-6:], chained=chained, n_units=n_units,
                      scan_bits=scan_bits, max_units=int(n_per.max()),
                      units=(lo, hi),
                      max_bits=int((end - base).max()),
                      max_group_bits=int((end[np.minimum(np.arange(0, s, 32)
                                                         + 31, s - 1)]
                                          - base[::32]).max()),
                      stride=int(n_per[0]) if n_per[0] > 0 and (
                          n_per[:-1] == n_per[0]).all() and
                      n_per[-1] <= n_per[0] else 0)
    return (got[0], lanes) if words is not None else lanes


def _check(words, lanes: LaneTable, tables, planes, geom: Geometry,
           al: int, band=None) -> torch.device:
    dev = words.device
    if words.dtype != torch.uint32 or words.dim() != 1 or \
            not words.is_contiguous():
        raise TypeError(f"words must be contiguous (W,) uint32, got "
                        f"{words.dtype} {tuple(words.shape)}")
    need = -(-lanes.scan_bits // 32) + PAD_WORDS
    if words.numel() < need:
        raise ValueError(f"word pool of {words.numel()} words < {need} (the "
                         f"scan's words and {PAD_WORDS} of padding)")
    for name, t in (("base", lanes.base), ("end", lanes.end),
                    ("n_per", lanes.n_per), ("first", lanes.first),
                    ("eob0", lanes.eob0), ("pred0", lanes.pred0),
                    *(("tables", t) for t in tables),
                    *((f"plane {p}", t) for p, t in enumerate(planes))):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, words on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for t in tables:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 1 << 16:
            raise TypeError(f"tables must be (n, 65536) int32, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if len(planes) != len(geom.pcols):
        raise ValueError(f"{len(planes)} planes for a geometry of "
                         f"{len(geom.pcols)}")
    for p, t in enumerate(planes):
        if t.dtype != torch.int32 or tuple(t.shape) != (geom.n_rows[p] + 1,
                                                        64):
            raise TypeError(f"plane {p} must be ({geom.n_rows[p] + 1}, 64) "
                            f"int32, got {t.dtype} {tuple(t.shape)}")
    geom.check(lanes.n_units)
    if not 0 <= al <= 13:
        raise ValueError(f"al must be 0..13, got {al}")
    if band is not None and not 1 <= band[0] <= band[1] <= 63:
        raise ValueError(f"bad AC band {band}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _plane_ptrs(planes) -> list:
    return [p.data_ptr() for p in planes] + [None] * (MAX_PLANES - len(planes))


def _lane_ptrs(words, lanes: LaneTable) -> tuple:
    return (words.data_ptr(), words.numel(), lanes.base.data_ptr(),
            lanes.end.data_ptr(), lanes.n_per.data_ptr(),
            lanes.first.data_ptr())


def dc_use_threads(lanes: LaneTable, form: str | None = None) -> bool:
    """Whether K8a runs ``lanes`` in its thread form (one thread per lane):
    beyond :data:`DC_WARP_LANES_MAX` lanes, else the warp form (one warp
    per lane); ``form`` ("warp" or "thread") overrides the choice."""
    if form not in (None, "warp", "thread"):
        raise ValueError(f"no {form!r} form of K8a")
    return lanes.n > DC_WARP_LANES_MAX if form is None else form == "thread"


def dc_grid(lanes: LaneTable, threads: bool, resident: int) -> int:
    """K8a's CTAs: one per 32 lanes in the thread form; in the warp form
    one per lane, at most ``resident`` (what fits on the card at once: the
    CTAs then walk the lanes in turn)."""
    return -(-lanes.n // 32) if threads else max(1, min(lanes.n, resident))


def dc_resident(threads: bool, nsc: int, n_slots: int, budget: int) -> int:
    """CTAs of K8a's form that fit on the current CUDA device at once with
    ``nsc`` first levels, ``n_slots`` second levels and ``budget`` staged
    words (cached per device and shared-memory size in the library)."""
    out = ctypes.c_int64(0)
    launch_check(build().jd_prog_dc_resident(
        int(threads), nsc, n_slots, budget, ctypes.byref(out)),
        "jd_prog_dc_resident")
    return out.value


def _dc_first(words, lanes: LaneTable, luts, planes: list, geom: Geometry,
              al: int, table: DcTables | None = None, *, form=None,
              budget=None):
    """K8a; ``form`` ("warp" or "thread") and ``budget`` (staged words)
    override the launch's own choice, for the card tests and
    chip_smoke.py."""
    dev = _check(words, lanes, [luts], planes, geom, al)
    nsc = luts.shape[0]
    if lanes.pred0.shape[1] != nsc or any(
            not 0 <= s[5] < nsc for s in geom.slots):
        raise ValueError("pred0, luts and the slots' components disagree")
    if lanes.n_units * geom.bpm >= 1 << 31:
        raise ValueError("K8a takes scans of fewer than 2^31 blocks")
    threads = dc_use_threads(lanes, form)
    if dev.type == "cpu":
        return dc_first_torch(words, lanes, luts, planes, geom, al=al)
    if table is None:
        raise ValueError("K8a on the card takes the LUTs' dc_tables "
                         "(entropy_prog.scan_inputs builds them)")
    tab = torch.as_tensor(table.tab)
    if tab.dtype != torch.int16 or tab.dim() != 1 or \
            tab.numel() != nsc * (1 << AC_L1_BITS) + 32 * table.n_slots or \
            not 0 <= table.n_slots <= AC_L2_SLOTS:
        raise ValueError(f"bad DC tables: {tab.dtype} {tuple(tab.shape)}, "
                         f"{table.n_slots} slots for {nsc} components")
    tab = tab.to(dev).contiguous()
    geo = geom.pack()
    budget = dc_budget_words(lanes, threads) if budget is None else budget
    if not 4 <= budget <= AC_MAX_BUDGET or budget % 4:
        raise ValueError(f"budget must be a multiple of 4 in 4.."
                         f"{AC_MAX_BUDGET}, got {budget}")
    with torch.cuda.device(dev):
        grid = dc_grid(lanes, threads,
                       dc_resident(threads, nsc, table.n_slots, budget))
        # The lane flags and, after them, the launch's counters.
        buf = torch.zeros(lanes.n + 3, dtype=torch.int32, device=dev)
        rc = build().jd_prog_dc_first(
            *_lane_ptrs(words, lanes), lanes.pred0.data_ptr(), nsc,
            luts.data_ptr(), tab.data_ptr(), table.n_slots,
            table.l2_full, *_plane_ptrs(planes), geo.ctypes.data, al,
            int(lanes.chained), lanes.n, int(threads), budget, grid,
            buf.data_ptr(), _stream(dev))
    launch_check(rc, "jd_prog_dc_first")
    dc_first.last_stats = buf[lanes.n:]
    _count(dc_first)
    return buf[:lanes.n]


def dc_first(words, lanes: LaneTable, luts, planes: list, geom: Geometry,
             *, al: int, table: DcTables | None = None) -> torch.Tensor:
    """K8a: a DC first scan (Ss = 0, Ah = 0) over ``lanes`` into ``planes``
    (coefficient 0, which must be zero entering the scan; one plane per
    component of the scan, in the order of ``geom``'s planes).  ``luts``:
    (nsc, 65536) int32 DC tables in scan component order; ``table``: their
    :func:`dc_tables` (``tab`` on the host or the device), which CUDA
    tensors need and the plain version ignores.  The launch runs the warp
    or the thread form by :func:`dc_use_threads`.  Returns the (S,) int32
    lane flags."""
    return _dc_first(words, lanes, luts, planes, geom, al, table)


def dc_refine(words, lanes: LaneTable, planes: list, geom: Geometry, *,
              al: int) -> torch.Tensor:
    """K8b: a DC refinement scan (Ss = 0, Ah > 0): block t of a lane adds
    ``bit(base + t) << al`` to coefficient 0, one thread per block of the
    scan.  Returns the lane flags."""
    dev = _check(words, lanes, [], planes, geom, al)
    if lanes.units != (0, lanes.n_units):
        raise ValueError("K8b takes lanes that tile the whole scan (a mesh "
                         "rank's share is a scan of its own rows)")
    if dev.type == "cpu":
        return dc_refine_torch(words, lanes, planes, geom, al=al)
    if lanes.n_units * geom.bpm >= 1 << 31:
        raise ValueError("K8b takes scans of fewer than 2^31 blocks")
    err = torch.zeros(lanes.n, dtype=torch.int32, device=dev)
    geo = geom.pack()
    with torch.cuda.device(dev):
        rc = build().jd_prog_dc_refine(
            *_lane_ptrs(words, lanes), *_plane_ptrs(planes), geo.ctypes.data,
            al, lanes.n, lanes.n_units, lanes.stride, err.data_ptr(),
            _stream(dev))
    launch_check(rc, "jd_prog_dc_refine")
    _count(dc_refine)
    return err


def use_threads(refine: bool, lanes: LaneTable) -> bool:
    """Whether a launch runs ``lanes`` in the thread form: K8c beyond
    :data:`WARP_LANES_MAX` lanes; K8d never (its thread form was slower or
    equal in every measured workload, so it has the warp form only)."""
    return not refine and lanes.n > WARP_LANES_MAX


def budget_words(lanes: LaneTable, threads: bool = False,
                 lookahead: int = LOOKAHEAD) -> int:
    """Words K8a/K8c/K8d stage: the longest lane's words (warp form) or 32
    consecutive lanes' (thread form), its start rounded down to 4 words and
    the reader's ``lookahead`` (:data:`DC_LOOKAHEAD` for K8a), as a
    multiple of 4, at most :data:`AC_MAX_BUDGET`."""
    bits = lanes.max_group_bits if threads else lanes.max_bits
    need = -(-(bits // 32 + 5 + lookahead) // 4) * 4
    return max(4, min(AC_MAX_BUDGET, need))


def dc_budget_words(lanes: LaneTable, threads: bool) -> int:
    """Words K8a stages (:func:`budget_words` with its lookahead)."""
    return budget_words(lanes, threads, DC_LOOKAHEAD)


def _ac(refine: bool, words, lanes, lut, plane, geom, ss, se, al,
        table=None, *, form=None, budget=None):
    """K8c or K8d; ``form`` ("warp" or "thread", K8c only) and ``budget``
    (staged words) override the launch's own choice, for the card tests and
    chip_smoke.py."""
    dev = _check(words, lanes, [lut], [plane], geom, al, band=(ss, se))
    if geom.bpm != 1 or lut.shape[0] != 1:
        raise ValueError("AC scans have one component and one table")
    # K8d's warp form loads plane rows 8 bytes at a time.
    if plane.data_ptr() % 16:
        raise ValueError("the plane must start on a 16-byte boundary")
    if form not in (None, "warp", "thread") or (refine and form == "thread"):
        raise ValueError(f"no {form!r} form of K8{'d' if refine else 'c'}")
    threads = use_threads(refine, lanes) if form is None else \
        form == "thread"
    if dev.type == "cpu":
        fn = ac_refine_torch if refine else ac_first_torch
        return fn(words, lanes, lut, plane, geom, ss=ss, se=se, al=al)
    budget = budget_words(lanes, threads) if budget is None else budget
    if not 4 <= budget <= AC_MAX_BUDGET or budget % 4:
        raise ValueError(f"budget must be a multiple of 4 in 4.."
                         f"{AC_MAX_BUDGET}, got {budget}")
    if table is None:
        raise ValueError("K8c/K8d on the card take the LUT's compact_table "
                         "(entropy_prog.scan_inputs builds it)")
    tab = torch.as_tensor(table.tab)
    if tab.dtype != torch.int16 or tab.dim() != 1 or \
            tab.numel() != (1 << AC_L1_BITS) + 32 * table.n_slots or \
            not 0 <= table.n_slots <= AC_L2_SLOTS:
        raise ValueError(f"bad compact table: {tab.dtype} "
                         f"{tuple(tab.shape)}, {table.n_slots} slots")
    tab = tab.to(dev).contiguous()
    # The lane flags and, after them, the launch's counters: one zero fill.
    buf = torch.zeros(lanes.n + 3, dtype=torch.int32, device=dev)
    geo = geom.pack()
    with torch.cuda.device(dev):
        rc = build().jd_prog_ac(
            int(refine), *_lane_ptrs(words, lanes), lanes.eob0.data_ptr(),
            lut.data_ptr(), tab.data_ptr(), table.n_slots,
            int(table.l2_full), plane.data_ptr(), geo.ctypes.data, ss, se,
            al, int(lanes.chained), lanes.n, int(threads), budget,
            buf.data_ptr(), _stream(dev))
    launch_check(rc, "jd_prog_ac")
    fn = ac_refine if refine else ac_first
    fn.last_stats = buf[lanes.n:]
    _count(fn)
    return buf[:lanes.n]


def ac_first(words, lanes: LaneTable, lut, plane, geom: Geometry, *,
             ss: int, se: int, al: int,
             table: AcTable | None = None) -> torch.Tensor:
    """K8c: an AC first scan (Ss >= 1, Ah = 0) of one component into
    ``plane`` (``lut``: (1, 65536) int32; the plane on a 16-byte boundary).
    ``table``: the LUT's :func:`compact_table` (its ``tab`` on the host or
    the device), which CUDA tensors need and the plain version ignores.
    The launch runs the warp or the thread form by :func:`use_threads`.
    Returns the lane flags."""
    return _ac(False, words, lanes, lut, plane, geom, ss, se, al, table)


def ac_refine(words, lanes: LaneTable, lut, plane, geom: Geometry, *,
              ss: int, se: int, al: int,
              table: AcTable | None = None) -> torch.Tensor:
    """K8d: an AC refinement scan (Ss >= 1, Ah > 0) of one component; the
    plane's band values are the history.  ``table`` as for
    :func:`ac_first`.  Returns the lane flags."""
    return _ac(True, words, lanes, lut, plane, geom, ss, se, al, table)


def ac_grid(refine: bool, lanes: LaneTable, n_slots: int) -> int:
    """The CTAs K8c or K8d launches for ``lanes`` with a table of
    ``n_slots`` second levels on the current CUDA device (one warp
    each)."""
    out = ctypes.c_int64(0)
    threads = use_threads(refine, lanes)
    launch_check(build().jd_prog_ac_grid(
        int(refine), int(threads), n_slots, budget_words(lanes, threads),
        lanes.n, ctypes.byref(out)), "jd_prog_ac_grid")
    return out.value


#: Launches of each kernel since its count was last set to 0.
dc_first.launches = dc_refine.launches = 0
ac_first.launches = ac_refine.launches = 0
#: The last launch's (second-level tables used, lanes that read a word
#: outside their staged range, table probes that read device memory): an
#: int32 device tensor.
dc_first.last_stats = ac_first.last_stats = ac_refine.last_stats = None
KERNELS = {"K8a": dc_first, "K8b": dc_refine, "K8c": ac_first,
           "K8d": ac_refine}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 modulo 2^32, as the kernels' uint32
    sums wrap."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _window(w64: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    i = (pos >> 5).clamp(max=w64.numel() - 2)
    off = pos & 31
    return ((w64[i] << off) | (w64[i + 1] >> (32 - off))) & 0xFFFFFFFF


def _bit(w64: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    i = (pos >> 5).clamp(max=w64.numel() - 1)
    return (w64[i] >> (31 - (pos & 31))) & 1


def _take(w, length, n):
    """The top ``n`` bits of ``w << length`` (0 where n is 0)."""
    got = ((w << length) & 0xFFFFFFFF) >> (32 - n.clamp(min=1))
    return torch.where(n > 0, got, 0)


def _extend(raw, size):
    half = 1 << (size - 1).clamp(min=0)
    return torch.where(size == 0, 0, torch.where(
        raw < half, raw - ((1 << size) - 1), raw))


def _add_at(plane, idx, val) -> None:
    """plane.view(-1)[idx] += val (distinct idx), wrapped to int32; only the
    indexed elements are read and written."""
    flat = plane.view(-1)
    flat[idx] = _wrap32(flat[idx].to(torch.int64) + val).to(torch.int32)


def _ends(err, lanes: LaneTable, pos, state, state0):
    """The lane flags after the walk: a position past the end bit, and for
    chained lanes other than the last an end state other than the next
    lane's start (``state`` (S, ...) against ``state0``)."""
    err = err | (pos > lanes.end)
    if lanes.chained and lanes.n > 1:
        nxt = (pos[:-1] != lanes.end[:-1]) | (
            state[:-1] != state0[1:]).reshape(lanes.n - 1, -1).any(1)
        err[:-1] |= nxt
    return err.to(torch.int32)


def dc_first_torch(words, lanes: LaneTable, luts, planes: list,
                   geom: Geometry, *, al: int) -> torch.Tensor:
    """Plain version of :func:`dc_first`: one step per block slot, every
    lane at once."""
    w64 = words.to(torch.int64)
    lut = luts.to(torch.int64)
    pos = lanes.base.clone()
    pred = lanes.pred0.to(torch.int64).clone()
    nb = lanes.n_per.to(torch.int64) * geom.bpm
    err = torch.zeros(lanes.n, dtype=torch.bool, device=words.device)
    for t in range(lanes.max_units * geom.bpm):
        act = ~err & (t < nb)
        over = act & (pos > lanes.end)
        err |= over
        act &= ~over
        p, row = geom.rows(lanes.first, t)
        c = geom.slots[t % geom.bpm][5]
        w = _window(w64, pos)
        e = lut[c][w >> 16]
        length, size = e & 31, e >> 5
        bad = act & ((e == 0) | (size > 11) | (row < 0))
        err |= bad
        ok = act & ~bad
        new = _wrap32(pred[:, c] + _extend(_take(w, length, size), size))
        pred[:, c] = torch.where(ok, new, pred[:, c])
        _add_at(planes[p], row[ok] * 64, _wrap32(new[ok] << al))
        pos = torch.where(ok, pos + length + size, pos)
    return _ends(err, lanes, pos, _wrap32(pred), lanes.pred0.to(torch.int64))


def dc_refine_torch(words, lanes: LaneTable, planes: list, geom: Geometry,
                    *, al: int) -> torch.Tensor:
    """Plain version of :func:`dc_refine`: every (lane, slot) at once."""
    w64 = words.to(torch.int64)
    nb = lanes.n_per.to(torch.int64) * geom.bpm
    err = lanes.base + nb > lanes.end
    for j in range(geom.bpm):
        t = torch.arange(j, max(lanes.max_units * geom.bpm, 1), geom.bpm,
                         device=words.device)
        p, v, jv, h, jh, _c = geom.slots[j]
        m = lanes.first[:, None] + t[None, :] // geom.bpm
        my, mx = m // geom.mx_div, m % geom.mx_div
        row = (my * v + jv) * geom.pcols[p] + mx * h + jh
        valid = t[None, :] < nb[:, None]
        inside = (row >= 0) & (row < geom.n_rows[p])
        err |= (valid & ~inside).any(1)
        on = valid & inside & (_bit(w64, lanes.base[:, None] + t[None, :])
                               == 1)
        _add_at(planes[p], row[on] * 64,
                torch.full((int(on.sum()),), 1 << al, dtype=torch.int64,
                           device=words.device))
    return err.to(torch.int32)


def _ac_lanes(words, lanes, lut, ss):
    dev = words.device
    s = lanes.n
    return (words.to(torch.int64), lut[0].to(torch.int64),
            lanes.base.clone(), torch.zeros(s, dtype=torch.int64, device=dev),
            torch.full((s,), ss, dtype=torch.int64, device=dev),
            lanes.eob0.to(torch.int64).clone(),
            torch.zeros(s, dtype=torch.bool, device=dev),
            lanes.n_per.to(torch.int64))


def ac_first_torch(words, lanes: LaneTable, lut, plane, geom: Geometry, *,
                   ss: int, se: int, al: int) -> torch.Tensor:
    """Plain version of :func:`ac_first`: one step decodes one symbol of
    every lane inside a block, or skips the blocks of a pending EOB run of
    every lane at a block's start."""
    w64, lut64, pos, blk, k, eob, err, n = _ac_lanes(words, lanes, lut, ss)
    zz = _ZZ.to(words.device)
    while True:
        act = ~err & (blk < n)
        if not bool(act.any()):
            break
        skip = act & (k == ss) & (eob > 0)
        adv = torch.minimum(eob, n - blk)
        blk = torch.where(skip, blk + adv, blk)
        eob = torch.where(skip, eob - adv, eob)
        dec = act & ~skip
        over = dec & (pos > lanes.end)
        _, row = geom.rows(lanes.first, blk)
        w = _window(w64, pos)
        e = lut64[w >> 16]
        length, sym = e & 31, (e >> 5) & 0xFF
        r, sz = sym >> 4, sym & 15
        is_eob = (sz == 0) & (r < 15)
        coef = sz > 0
        k2 = k + r
        bad = dec & (over | (row < 0) | (e == 0) | (coef & (k2 > se)))
        err |= bad
        ok = dec & ~bad
        put = ok & coef
        val = _extend(_take(w, length, sz), sz) << al
        _add_at(plane, row[put] * 64 + zz[k2[put]], _wrap32(val[put]))
        pos = torch.where(ok, pos + length + torch.where(
            is_eob, r, torch.where(coef, sz, 0)), pos)
        eob = torch.where(ok & is_eob,
                          (1 << r) - 1 + _take(w, length, r), eob)
        k_new = torch.where(coef, k2 + 1, k + 16)
        done = ok & (is_eob | (k_new > se))
        k = torch.where(done, ss, torch.where(ok, k_new, k))
        blk = blk + done
    return _ends(err, lanes, pos, eob, lanes.eob0.to(torch.int64))


def ac_refine_torch(words, lanes: LaneTable, lut, plane, geom: Geometry, *,
                    ss: int, se: int, al: int) -> torch.Tensor:
    """Plain version of :func:`ac_refine` (entropy/progressive.py's
    ``_ac_refine_scan``).  One step per symbol of every lane: a lane at the
    start of a block under an EOB run walks the block's band; any other
    decodes one symbol and walks the band positions it covers, all at once
    over the 64 positions: the nonzero-history positions before the run's
    stop (the r+1-th zero-history position, or the band's end for an EOB
    run) each take the next correction bit in order, and the new value goes
    to the stop."""
    w64, lut64, pos, blk, k, eob, err, n = _ac_lanes(words, lanes, lut, ss)
    dev = words.device
    zz = _ZZ.to(dev)
    kk = torch.arange(64, device=dev)
    p1 = 1 << al
    flat = plane.view(-1)
    while True:
        act = ~err & (blk < n)
        if not bool(act.any()):
            break
        _, row = geom.rows(lanes.first, blk)
        err |= act & (row < 0)
        act &= row >= 0
        covered = act & (k == ss) & (eob > 0)
        sym_on = act & ~covered
        w = _window(w64, pos)
        e = lut64[w >> 16]
        length, sym = e & 31, (e >> 5) & 0xFF
        r_s, sz = sym >> 4, sym & 15
        is_eob = (sz == 0) & (r_s < 15)
        bad = sym_on & ((pos > lanes.end) | (e == 0)
                        | ((sz != 0) & (sz != 1)))
        err |= bad
        sym_ok = sym_on & ~bad
        newval = torch.where(
            sz == 1, torch.where(_take(w, length, torch.ones_like(sz)) == 1,
                                 p1, -p1), 0)
        eob = torch.where(sym_ok & is_eob,
                          (1 << r_s) + _take(w, length, r_s), eob)
        pos = torch.where(sym_ok, pos + length + torch.where(
            is_eob, r_s, sz), pos)
        # The band walk of the covered blocks and of the decoded symbols.
        walk = covered | sym_ok
        run = sym_ok & ~is_eob
        at = row.clamp(min=0)[:, None] * 64 + zz[None, :]
        vals = flat[at].to(torch.int64)
        band = walk[:, None] & (kk[None, :] >= k[:, None]) & (kk <= se)
        zeros = band & (vals == 0)
        stops = zeros & (zeros.cumsum(1) == r_s[:, None] + 1) & run[:, None]
        has_stop = stops.any(1)
        p_stop = torch.where(has_stop, stops.to(torch.int8).argmax(1), 64)
        crossed = band & (vals != 0) & (kk[None, :] < p_stop[:, None])
        rank = crossed.cumsum(1) - crossed.to(torch.int64)
        bits = _bit(w64, pos[:, None] + rank)
        fix = crossed & (bits == 1) & ((vals & p1) == 0)
        flat[at[fix]] = torch.where(vals[fix] > 0, vals[fix] + p1,
                                    vals[fix] - p1).to(torch.int32)
        pos = pos + crossed.sum(1)
        place = has_stop & (newval != 0)
        flat[at[place, p_stop[place]]] = newval[place].to(torch.int32)
        # Block ends: a tail (covered or after an EOB symbol; the run loses
        # this block), a run past the band end, or a stop at the band end.
        tail = covered | (sym_ok & is_eob)
        eob = torch.where(tail, eob - 1, eob)
        k_next = torch.where(has_stop, p_stop + 1, 64)
        done = tail | (run & (k_next > se))
        blk = blk + done
        k = torch.where(done, ss, torch.where(run, k_next, k))
    return _ends(err, lanes, pos, eob, lanes.eob0.to(torch.int64))


def history_masks_torch(plane, geom: Geometry, n_units: int, *, ss: int,
                        se: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8d's mask build: per block m of the scan (flat
    order, the rows of ``geom``), the int64 mask of its band positions
    ``ss..se`` whose value is nonzero (bit k for zigzag index k, bit 63 as
    the sign bit), and ``nextp``: (n_units + 1,) int64, nextp[m] the first
    block at or after m with a nonzero mask (n_units when none), the
    ``nextp`` of the JAX package's ``_refine_emit_prep``.  The kernel builds
    the masks per chunk of 32 blocks and keeps of ``nextp`` the chunk's
    part, a 32-bit map of the blocks with history."""
    dev = plane.device
    m = torch.arange(n_units, device=dev)
    _, rows = geom.rows(m, 0)
    zz = _ZZ.to(dev)
    vals = plane[rows.clamp(min=0)][:, zz]
    k = torch.arange(64, device=dev)
    band = (k >= ss) & (k <= se)
    on = (vals != 0) & band & (rows >= 0)[:, None]
    weights = torch.where(k == 63, torch.tensor(-(1 << 63), device=dev),
                          torch.ones(64, dtype=torch.int64, device=dev) << k)
    masks = (on.to(torch.int64) * weights).sum(1)
    idx = torch.where(masks != 0, m, n_units)
    nextp = torch.cat([idx, torch.tensor([n_units], device=dev)])
    nextp = torch.flip(torch.cummin(torch.flip(nextp, [0]), 0).values, [0])
    return masks, nextp
