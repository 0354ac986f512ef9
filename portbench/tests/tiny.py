"""Cells cut to a size the CPU runs in seconds, for the harness's tests."""

from __future__ import annotations

import os
import time

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Per cell: the frame recipe's changes and the mix's.  The batch cell's
#: frames keep 1,024 restart segments a call (8 x 128 one-MCU segments),
#: so that decode_batch_sharded takes route k2 as at full size.
CUTS = {
    "cam4k_b8": ({"width": 256, "height": 128, "restart_interval": 1}, {}),
    "rtp1080_open": ({"width": 128, "height": 64, "restart_interval": 8},
                     {"cameras": 2, "fps": 2}),
}


#: Cells whose files the benchmark keeps but BENCHMARK.json does not hold
#: (PERF.md, Open questions), as its entries would give them.
HELD = {
    "cam4k_b8": {"name": "cam4k_b8", "config": "cam4k_ingest",
                 "traffic": "closed_b8_x1", "chips": 1},
}


def cell(name: str, root: str = ROOT) -> harness.Cell:
    try:
        c = harness.load_cell(root, name)
    except KeyError:
        c = harness.load_cell(root, name, HELD[name])
    frame, mix = CUTS.get(name, ({}, {}))
    c.config["frame"].update(frame)
    c.mix.update(mix)
    c.config["check"]["every"] = 1
    return c


def run(name: str, seed: int = 2**31 + 77, seconds: float = 1.0,
        traced: bool = False, c: harness.Cell | None = None):
    """One CPU run of the cut cell: (result, compared)."""
    c = c or cell(name)
    return harness.run(ROOT, name, seed, seconds, traced, "cpu",
                       time.perf_counter(), log=lambda s: None, cell=c)
