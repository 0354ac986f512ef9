"""The open mix's schedule: the same load from every seed."""

import numpy as np
import pytest

from portbench import traffic


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 3 * 10**9])
def test_even_phases_give_every_seed_the_same_arrivals(seed):
    mix = {"cameras": 5, "fps": 30, "jitter_ms": 1.0, "phase": "even"}
    sched = traffic.schedule(mix, seed, 2.0)
    assert [d for d, _ in sched] == sorted(d for d, _ in sched)
    assert abs(len(sched) - 5 * 30 * 2) <= 5
    slot = 1 / 30 / 5
    due = np.array([d for d, _ in sched])
    assert np.all(np.abs(due - np.round(due / slot) * slot) <= 0.001 + 1e-12)
    first = {}
    for d, cam in sched:
        first.setdefault(cam, round(d / slot))
    assert sorted(first.values())[:5] == [0, 1, 2, 3, 4] or \
        len(set(first.values())) == 5


def test_locked_cameras_arrive_together():
    mix = {"cameras": 4, "fps": 30, "jitter_ms": 1.0, "phase": "locked"}
    sched = traffic.schedule(mix, 7, 1.0)
    due = np.array([d for d, _ in sched])
    assert np.all(np.abs(due - np.round(due * 30) / 30) <= 0.001 + 1e-12)


def test_sampling_follows_the_seed():
    a = [i for i in range(200) if traffic.sampled(i, 11, 20)]
    b = [i for i in range(200) if traffic.sampled(i, 11, 20)]
    assert a == b and len(a) == 10
