"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card (the cut cell runs on the
CPU, the program's plain kernels in place of the CUDA ones), plants one
fault in the program where its answer is produced, and drives the rest of
a run: the window, the sampled outputs, the check.  The faults a decoder
cell can have: a call that returns without writing its answer (its state
left unchanged), half of a batch left out, an answer altered where it is
produced.  One card runs each cell, so no exchange between cards can be
left out; a single-image call has no half batch."""

import pytest
import torch

from jpeg_decoder_tpu_torch.ops import entropy_cuda
from jpeg_decoder_tpu_torch.ops import pixel as pixel_ops
from jpeg_decoder_tpu_torch.parallel import sharded
from portbench.tests import tiny


def _wrap(monkeypatch, mod, name, fn):
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: fn(orig(*a, **k)))


def _zeros(rgb):
    return torch.zeros_like(rgb)


def _half(rgb):
    rgb = rgb.clone()
    rgb[rgb.shape[0] // 2:] = 0
    return rgb


def _altered(out):
    """K2's answer with every block of the first image's first segments
    given another DC value."""
    blocks, err = out
    blocks = blocks.clone()
    blocks[:8, :, 0] += 5
    return blocks, err


FAULTS = {
    "cam4k_b8": {
        "unchanged": (sharded, "_pixels", _zeros),
        "half_batch": (sharded, "_pixels", _half),
        "altered": (entropy_cuda, "decode_segments", _altered),
    },
    "rtp1080_open": {
        "unchanged": (pixel_ops, "pixel_pipeline_from_scan", _zeros),
        "altered": (entropy_cuda, "decode_segments", _altered),
    },
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(cell):
    result, compared = tiny.run(cell)
    assert result["correct"], compared
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in sorted(FAULTS[c])])
def test_fault_comes_out_not_correct(monkeypatch, cell, fault):
    mod, name, fn = FAULTS[cell][fault]
    _wrap(monkeypatch, mod, name, fn)
    result, compared = tiny.run(cell)
    assert result["correct"] is False, compared
    assert any(v > lim for _, v, lim in compared)


def test_batch_cell_takes_route_k2():
    tiny.run("cam4k_b8", seconds=0.3)
    routes = [g["route"] for g in
              sharded.decode_batch_sharded.last_timing["groups"]]
    assert routes == ["k2"]
