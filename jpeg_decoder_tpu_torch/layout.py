"""Scan-order <-> per-component coefficient-plane layout maps.

The entropy decoder (host or device) emits 8x8 blocks in *scan order*: MCUs
row-major, and within each MCU component-by-component, v-by-h (parity with the
reference scan loop, jpeg.cpp:415-443).  The pixel pipeline wants dense
per-component planes ``(rows_c, cols_c, 64)``.  This module precomputes the
gather indices connecting the two.

A numpy-only copy of ``jpeg_decoder_tpu/layout.py`` (see types.py for why
the port keeps copies).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .types import FrameHeader


@dataclasses.dataclass(frozen=True)
class ScanLayout:
    """Precomputed layout for one interleaved full-frame scan."""

    # Per scan-order block: which component it belongs to. Shape (B,), int32.
    comp_of_block: np.ndarray
    # Per scan-order block: flat destination cell in its component plane.
    dest_in_comp: np.ndarray
    # Per component: scan index of each plane cell (rows*cols,), int32 —
    # the inverse map used for gathering planes out of scan-order output.
    comp_src: list[np.ndarray]
    # Per component plane shape (rows, cols).
    comp_shapes: list[tuple[int, int]]
    # Blocks per MCU and totals.
    blocks_per_mcu: int
    n_mcus: int

    @property
    def total_blocks(self) -> int:
        return self.blocks_per_mcu * self.n_mcus


_LAYOUT_CACHE: dict[tuple, ScanLayout] = {}


def scan_layout(hdr: FrameHeader,
                comp_indices: tuple | None = None) -> ScanLayout:
    """Build the layout for an interleaved scan's geometry.

    ``comp_indices=None`` means the canonical full-frame scan; a tuple
    selects the component subset of a partial interleaved scan (T.81
    A.2.3 — MCUs still traverse the frame grid, blocks cycle through the
    subset only).  ``comp_of_block``/``comp_src`` then index the SUBSET
    positions, and ``comp_shapes`` are the subset components' padded
    grids.

    Cached per geometry: the index-map construction is O(total blocks) on
    host and identical for every image with the same dims/sampling."""
    key = (hdr.mcus_x, hdr.mcus_y, comp_indices,
           tuple((c.h, c.v) for c in hdr.components))
    cached = _LAYOUT_CACHE.get(key)
    if cached is not None:
        return cached
    out = _build_scan_layout(hdr, comp_indices)
    if len(_LAYOUT_CACHE) > 256:  # bound memory on pathological workloads
        _LAYOUT_CACHE.clear()
    _LAYOUT_CACHE[key] = out
    return out


def _build_scan_layout(hdr: FrameHeader,
                       comp_indices: tuple | None = None) -> ScanLayout:
    if comp_indices is None:
        comp_indices = tuple(range(len(hdr.components)))
    comps = [hdr.components[ci] for ci in comp_indices]
    mcus_x, mcus_y = hdr.mcus_x, hdr.mcus_y
    n_mcus = mcus_x * mcus_y

    # Within-MCU block descriptors in scan order: (subset pos, v, h).
    per_mcu: list[tuple[int, int, int]] = []
    for k_c, c in enumerate(comps):
        for v in range(c.v):
            for h in range(c.h):
                per_mcu.append((k_c, v, h))
    bpm = len(per_mcu)

    my = np.repeat(np.arange(mcus_y, dtype=np.int64), mcus_x)  # (n_mcus,)
    mx = np.tile(np.arange(mcus_x, dtype=np.int64), mcus_y)

    comp_of_block = np.empty(n_mcus * bpm, dtype=np.int32)
    dest_in_comp = np.empty(n_mcus * bpm, dtype=np.int32)
    for k, (k_c, v, h) in enumerate(per_mcu):
        c = comps[k_c]
        cols = mcus_x * c.h
        flat = (my * c.v + v) * cols + (mx * c.h + h)
        comp_of_block[k::bpm] = k_c
        dest_in_comp[k::bpm] = flat

    comp_src = []
    comp_shapes = []
    for k_c, ci in enumerate(comp_indices):
        rows, cols = hdr.comp_block_grid(ci)
        inv = np.empty(rows * cols, dtype=np.int32)
        mask = comp_of_block == k_c
        inv[dest_in_comp[mask]] = np.flatnonzero(mask).astype(np.int32)
        comp_src.append(inv)
        comp_shapes.append((rows, cols))

    return ScanLayout(
        comp_of_block=comp_of_block,
        dest_in_comp=dest_in_comp,
        comp_src=comp_src,
        comp_shapes=comp_shapes,
        blocks_per_mcu=bpm,
        n_mcus=n_mcus,
    )


def comp_dims_unpadded(hdr: FrameHeader, ci: int) -> tuple[int, int]:
    """Unpadded per-component block dimensions (T.81 A.1.1): used by
    non-interleaved progressive scans, which do NOT pad to MCU boundaries."""
    c = hdr.components[ci]
    w = -(-(hdr.width * c.h) // hdr.h_max)   # ceil(W * h / h_max)
    h = -(-(hdr.height * c.v) // hdr.v_max)
    return (-(-h // 8), -(-w // 8))          # block rows, cols
