"""The control, the plain reference computed in TF32 and put in the
program's place, comes out not correct; the reference itself, exact.

At the cut cells' size; ``portbench/control.py`` reads it on the card at
the cells' own size."""

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.mark.parametrize("cell", ["cam4k_b8", "rtp1080_open"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2])
def test_tf32_control_fails_and_reference_passes(cell, seed):
    c = tiny.cell(cell)
    frames = harness.make_frames(c, seed, "cpu")
    for precision, correct in (("tf32", False), ("float64", True)):
        kept = [((i,), [harness.reference_rgb(c.config, f, precision)])
                for i, f in enumerate(frames)]
        compared = harness.check(c.config, frames, kept, 0, 0,
                                 log=lambda s: None)
        assert all(v <= lim for _, v, lim in compared) is correct, compared
