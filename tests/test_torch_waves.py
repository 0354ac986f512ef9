"""Wave pipelining of the port's ``BatchDecoder.decode`` on the CPU.

More blobs than ``wave`` run in waves: host entropy of wave k+1 on the host
pool while the device worker thread groups, copies and decodes wave k.  The
result must equal a single pass bit for bit and in input order, with each
wave's errors isolated, and an exception in the worker must reach the
caller.  (The card's half — pinned staging on the decoder's own CUDA stream
— is in tests/test_torch_cuda.py.)
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from encoder import encode  # noqa: E402

from jpeg_decoder_tpu_torch import JPEGError  # noqa: E402
from jpeg_decoder_tpu_torch.models import batch as tbatch  # noqa: E402


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 6.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _blobs():
    """Ten blobs: two geometry groups (4:2:0 of two sizes in one pow-2
    bucket, 4:4:4 with DRI), arithmetic and multi-scan fallback frames, and
    two corrupt blobs in different waves of 3."""
    bad = b"\xff\xd8\xff\xdb\x00\x04garbage"
    return [encode(_rgb(0, 64, 96), quality=90)[0],
            encode(_rgb(1, 48, 40), samplings=((1, 1),) * 3, quality=95,
                   restart_interval=5)[0],
            bad,
            encode(_rgb(2, 48, 80), quality=85)[0],
            encode(_rgb(3, 40, 56), arithmetic=True)[0],
            encode(_rgb(4, 48, 40), samplings=((1, 1),) * 3, quality=80,
                   restart_interval=2)[0],
            encode(_rgb(5, 40, 56), scans=[(0,), (1, 2)])[0],
            bad[:-3],
            encode(_rgb(6, 64, 96), quality=70)[0],
            encode(_rgb(7, 37, 53), quality=75, restart_interval=2)[0]]


BLOBS = _blobs()


@pytest.fixture(scope="module")
def single():
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        return bd.decode(BLOBS)


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert a.index == b.index == k
        assert a.ok == b.ok
        if a.ok:
            assert a.header.width == b.header.width
            assert torch.equal(a.rgb, b.rgb)
        else:
            assert type(a.error) is type(b.error)
            assert isinstance(a.error, JPEGError)


@pytest.mark.parametrize("wave", [1, 3, 4, 9, 10, 96])
def test_waves_equal_single_pass(single, wave):
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        got = bd.decode(BLOBS, wave=wave)
        n_waves = -(-len(BLOBS) // wave)
        assert len(bd.last_timing["host_s"]) == n_waves
        assert len(bd.last_timing["worker_s"]) == n_waves
    assert [it.ok for it in single] == [True, True, False] + [True] * 4 \
        + [False] + [True] * 2
    _assert_same(got, single)


@pytest.mark.parametrize("wire", ["sparse", "slots"])
def test_waves_on_other_wires(single, wire):
    with tbatch.BatchDecoder(device="cpu", idct="pallas", wire=wire) as bd:
        got = bd.decode(BLOBS, wave=3)
    _assert_same(got, single)


def test_wave_groups_stay_within_their_wave():
    """Images of one geometry in different waves land in different group
    outputs; images of one wave and one geometry share one."""
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        got = bd.decode(BLOBS, wave=4)
    assert got[0].rgb_batch is got[3].rgb_batch            # wave 0
    assert got[0].rgb_batch is not got[8].rgb_batch        # waves 0 and 2


def test_worker_exception_reaches_caller(monkeypatch):
    """A failure in the device worker's pass over the second wave is raised
    by decode(), not swallowed."""
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        real = bd.pixels
        calls = []

        def flaky(group, tensors):
            calls.append(group)
            if len(calls) == 3:
                raise RuntimeError("device worker failed")
            return real(group, tensors)

        monkeypatch.setattr(bd, "pixels", flaky)
        with pytest.raises(RuntimeError, match="device worker failed"):
            bd.decode(BLOBS, wave=3)
        monkeypatch.setattr(bd, "pixels", real)
        assert all(it.ok for it in bd.decode(BLOBS[:2], wave=1))


def test_wave_must_be_positive():
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        with pytest.raises(ValueError):
            bd.decode(BLOBS, wave=0)


def test_bucket_none_groups_by_exact_grid(single):
    """bucket=None: the two 4:2:0 sizes that share a pow-2 bucket get
    their own groups, at their exact MCU grids, with the same pixels."""
    with tbatch.BatchDecoder(device="cpu", idct="pallas", bucket=None) as bd:
        got = bd.decode(BLOBS, wave=5)
    assert got[0].rgb_batch is not got[3].rgb_batch
    assert tuple(got[0].rgb_batch.shape[1:3]) == (64, 96)
    _assert_same(got, single)


def test_group_arrays_pad_the_batch_to_a_power_of_two():
    with tbatch.BatchDecoder(device="cpu", idct="pallas") as bd:
        host_out = bd.host_stage(BLOBS[:1] + BLOBS[3:4] + BLOBS[8:9])
        (group,) = bd.group(host_out)
    dc, e, ov, ei, ev, qt, geom = group.arrays
    assert dc.shape[0] == e.shape[0] == qt.shape[0] == geom.shape[0] == 4
    np.testing.assert_array_equal(geom[3], geom[2])
    np.testing.assert_array_equal(qt[3], qt[2])
    assert not e[3].any() and (ei[3] == dc.shape[1] * 64).all()


def test_waves_under_thread_stress(single):
    """More host threads than cores, one-image waves and a short switch
    interval: every result still lands in its own slot, equal to the
    single pass (a lost or misplaced write would break it)."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tbatch.BatchDecoder(device="cpu", idct="pallas",
                                 host_threads=16) as bd:
            got = bd.decode(BLOBS * 3, wave=1)
    finally:
        sys.setswitchinterval(interval)
    for k in range(3):
        chunk = got[k * len(BLOBS):(k + 1) * len(BLOBS)]
        for i, (a, b) in enumerate(zip(chunk, single)):
            assert a.index == k * len(BLOBS) + i and a.ok == b.ok
            if a.ok:
                assert torch.equal(a.rgb, b.rgb)
