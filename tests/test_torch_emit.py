"""The host side of K7's schedule (``ops/entropy_emit_cuda.py``) on the CPU.

The kernel (``csrc/entropy_emit.cu``) stages each lane group's stream words
in shared memory and carries DC across groups by a decoupled look-back;
both rest on host-side pieces that are plain numpy and are tested here:

* :func:`windows`, the kernel's ``window`` in numpy: every lane's bits,
  plus the words its reader loads ahead, lie inside its group's staged range
  under :func:`entropy_emit_cuda.schedule`'s budget, on 8- and 12-bit
  frames with DRI 0, 2, 7 and 37;
* :func:`carry_model`, the kernel's look-back in Python: equal to the plain
  version's segmented scan (``lane_carry``) for any order in which the
  groups finish;
* ``entropy_spec.device_plan`` at ``LANE_STEPS``: it tiles the MCUs, is
  refused on no frame the longer lanes are accepted on, and decodes equal to
  the native decoder through ``decode_lanes_torch``.

The kernel itself is held to ``decode_lanes_torch`` on the card in
tests/test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu_torch.entropy import native
from jpeg_decoder_tpu_torch.io import parser
from jpeg_decoder_tpu_torch.ops import (entropy_cuda, entropy_emit_cuda,
                                        entropy_spec)
from jpeg_decoder_tpu_torch.testing.encoder import encode

E = entropy_emit_cuda


def windows(starts: np.ndarray, nm: np.ndarray, n_words: int,
            group_lanes: int, budget_words: int):
    """The row words [s_lo, s_hi) each lane group stages, (B, G) int64 each
    (the kernel's ``window``): from the group's first lane's start word to
    the next group's first start word plus ``LOOKAHEAD_WORDS`` (the pool's
    end for an image's last group), clipped to the pool and cut at
    ``budget_words``; empty for a group whose first lane has no MCUs."""
    b, c = starts.shape
    g = -(-c // group_lanes)
    first = np.arange(g) * group_lanes
    s_lo = np.clip(starts[:, first].astype(np.int64) >> 5, 0, n_words)
    nxt = first + group_lanes
    has_next = np.zeros((b, g), bool)
    hi = np.full((b, g), n_words, np.int64)
    inside = nxt < c
    if inside.any():
        cols = nxt[inside]
        has_next[:, inside] = nm[:, cols] > 0
        hi[:, inside] = np.where(
            has_next[:, inside],
            (starts[:, cols].astype(np.int64) >> 5) + E.LOOKAHEAD_WORDS,
            n_words)
    hi = np.maximum(np.minimum(hi, n_words), s_lo)
    s_hi = np.minimum(hi, s_lo + budget_words)
    s_hi = np.where(nm[:, first] > 0, s_hi, s_lo)
    return s_lo, s_hi


def lane_heads(key: np.ndarray) -> np.ndarray:
    """Whether each lane starts a carry run: its image's first lane, a lane
    without a run key (-1), or a key other than the lane before's."""
    head = np.ones(key.shape, bool)
    head[:, 1:] = (key[:, 1:] < 0) | (key[:, 1:] != key[:, :-1])
    return head


def carry_model(key: np.ndarray, tot: np.ndarray, group_lanes: int,
                finish_order) -> np.ndarray:
    """Python model of the kernel's DC carry for groups that finish their
    decode in ``finish_order`` (any order of the tickets 0..n-1, ticket t =
    group t % G of image t // G).

    key (B, C): each lane's run key (-1: no run); tot (B, C, 4) uint32 lane
    DC sums.  A finished group publishes the sum of the run that ends it
    (final when that run starts inside the group, else an aggregate); a
    group whose first lane continues a run looks back over earlier tickets,
    summing aggregates until it meets a final sum, and may have to wait for
    groups not finished yet; once it has its carry-in it publishes its own
    final sum.  Returns each lane's carry-in, (B, C, 4) uint32, and raises
    if a look-back could never finish."""
    b, c = key.shape
    g = -(-c // group_lanes)
    head = lane_heads(key)
    tot = np.where((key >= 0)[..., None], tot, 0).astype(np.uint64)
    flag = np.zeros(b * g, np.int8)       # 0 none, 1 aggregate, 2 final
    agg = np.zeros((b * g, 4), np.uint64)
    fin = np.zeros((b * g, 4), np.uint64)
    cin = np.zeros((b * g, 4), np.uint64)
    local = np.zeros((b, c, 4), np.uint64)   # inclusive within the group
    open_ = np.zeros((b, c), bool)           # run reaches the group start
    pending = []

    def lanes(t):
        img, x = divmod(t, g)
        return img, slice(x * group_lanes, min(c, (x + 1) * group_lanes))

    def finish(t):
        img, sl = lanes(t)
        acc = np.zeros(4, np.uint64)
        is_open = True
        for jj in range(sl.start, sl.stop):
            if head[img, jj]:
                acc[:] = 0
                is_open = False
            acc = (acc + tot[img, jj]) & 0xFFFFFFFF
            local[img, jj] = acc
            open_[img, jj] = is_open
        if sl.stop - sl.start < group_lanes:     # padding lanes are heads
            acc[:] = 0
            is_open = False
        if is_open:
            agg[t], flag[t] = acc, 1
        else:
            fin[t], flag[t] = acc, 2
        if head[img, sl.start]:
            return
        pending.append(t)

    def look_back(t):
        acc = np.zeros(4, np.uint64)
        u = t - 1
        while True:
            if flag[u] == 0:
                return False
            if flag[u] == 2:
                acc = (acc + fin[u]) & 0xFFFFFFFF
                break
            acc = (acc + agg[u]) & 0xFFFFFFFF
            u -= 1
        cin[t] = acc
        if flag[t] == 1:
            fin[t], flag[t] = (agg[t] + acc) & 0xFFFFFFFF, 2
        return True

    for t in finish_order:
        finish(t)
        progress = True
        while progress:
            progress = False
            for q in list(pending):
                if look_back(q):
                    pending.remove(q)
                    progress = True
    if pending:
        raise RuntimeError(f"look-back of groups {pending} never finished")
    out = np.zeros((b, c, 4), np.uint64)
    for t in range(b * g):
        img, sl = lanes(t)
        excl = (local[img, sl] - tot[img, sl]) & 0xFFFFFFFF
        out[img, sl] = (excl + np.where(open_[img, sl, None], cin[t], 0)
                        ) & 0xFFFFFFFF
    return out.astype(np.uint32)


def _rgb(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 6.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


FRAMES = [(p, ri) for p in (8, 12) for ri in (0, 2, 7, 37)]


def _frame(precision, ri, h=96, w=160, seed=0):
    blob = encode(_rgb(seed + precision + ri, h, w), quality=90,
                  restart_interval=ri, precision=precision)[0]
    hdr = parser.parse(blob)
    return hdr, hdr.scans[0]


def _lane_ends(starts, nm, nbytes):
    """End bit of every lane: the next lane's start, the stream's end for
    an image's last lane (-1 for lanes without MCUs)."""
    ends = np.full(starts.shape, -1, np.int64)
    for b in range(starts.shape[0]):
        k = int((nm[b] > 0).sum())
        ends[b, :k - 1] = starts[b, 1:k]
        ends[b, k - 1] = nbytes[b] * 8
    return ends


@pytest.mark.parametrize("precision,ri", FRAMES)
def test_windows_cover_every_lane(precision, ri):
    """Every lane's words, from its start word to two words past its end
    word (the reader's lookahead), lie inside its group's staged range,
    for each group size and a few SM counts; so no read leaves shared
    memory on a valid plan."""
    hdr, scan = _frame(precision, ri)
    pools, starts, nm, _, _, _, c, _, ok = entropy_spec.device_plan(
        hdr, [scan], threads=1)
    assert ok.all()
    w = pools.shape[1]
    ends = _lane_ends(starts, nm, [len(scan.data)])
    for n_sms in (1, 4, 132):
        n_tables = 2 * len(hdr.components)
        lanes, budget = E.schedule(1, w, c, n_tables, n_sms)
        assert lanes in E.GROUP_LANES and budget % 4 == 0
        assert E.smem_bytes(lanes, budget, n_tables) <= E.SMEM_LIMIT
        for group_lanes in E.GROUP_LANES:
            s_lo, s_hi = windows(starts, nm, w, group_lanes, budget)
            for j in np.flatnonzero(nm[0] > 0):
                gi = j // group_lanes
                first = int(starts[0, j]) >> 5
                last = min((int(ends[0, j]) >> 5) + E.LOOKAHEAD_WORDS - 1,
                           w - 1)
                assert s_lo[0, gi] <= first and last < s_hi[0, gi], (
                    group_lanes, j)


def test_windows_cut_at_the_budget_and_skip_empty_groups():
    hdr, scan = _frame(8, 0)
    pools, starts, nm, *_ = entropy_spec.device_plan(hdr, [scan], threads=1)
    nm2 = np.concatenate([nm, np.zeros_like(nm)])
    st2 = np.concatenate([starts, np.zeros_like(starts)])
    s_lo, s_hi = windows(st2, nm2, pools.shape[1], 32, 8)
    assert (s_hi[0] - s_lo[0] <= 8).all() and (s_hi[0] > s_lo[0]).all()
    assert (s_hi[1] == s_lo[1]).all()          # an image without lanes


def _runs(rng, b, c):
    """Random run keys (-1 for lanes without a run, runs of 1..40 lanes)
    and uint32 lane sums, per image."""
    key = np.empty((b, c), np.int64)
    for i in range(b):
        j, k = 0, 0
        while j < c:
            n = int(rng.integers(1, 41))
            key[i, j:j + n] = k
            j, k = j + n, k + 1
        key[i, rng.random(c) < 0.05] = -1
        tail = int(rng.integers(0, c // 3))
        key[i, c - tail:] = -1                  # padding lanes
    tot = rng.integers(0, 1 << 32, (b, c, 4), dtype=np.uint64)
    return key, tot.astype(np.uint32)


@pytest.mark.parametrize("group_lanes", E.GROUP_LANES)
@pytest.mark.parametrize("seed", range(4))
def test_carry_model_equals_segmented_scan(seed, group_lanes):
    """The look-back gives each lane the carry-in the plain version's
    segmented scan gives it, whatever order the groups finish in: in ticket
    order, reversed, and shuffled."""
    rng = np.random.default_rng(seed)
    b, c = 3, int(rng.integers(40, 700))
    key, tot = _runs(rng, b, c)
    # The plain version's form: keys unique across images, -1 unique.
    lane = np.arange(b * c).reshape(b, c)
    flat = np.where(key >= 0, np.arange(b)[:, None] * (c + 1) + key,
                    -1 - lane).reshape(-1)
    on = (key >= 0).reshape(-1, 1)
    want = E.lane_carry(torch.from_numpy(flat),
                        torch.from_numpy(np.where(on, tot.reshape(-1, 4),
                                                  0).astype(np.int64)))
    want = (want.numpy() & 0xFFFFFFFF).astype(np.uint32).reshape(b, c, 4)
    n = b * -(-c // group_lanes)
    orders = [range(n), range(n - 1, -1, -1)] + [rng.permutation(n)
                                                 for _ in range(3)]
    for order in orders:
        got = carry_model(key, tot, group_lanes, order)
        mask = key >= 0
        np.testing.assert_array_equal(got[mask], want[mask])


def test_lane_heads():
    key = np.array([[3, 3, -1, 4, 4, 4, 5, -1, -1]])
    assert lane_heads(key).tolist() == [[True, False, True, True, False,
                                           False, True, True, True]]


def test_schedule_fills_the_card_then_fits_the_budget():
    # Many lanes: the largest group; few: smaller ones, to reach half the
    # SMs.
    assert E.schedule(1, 90_000, 17_000, 6, 132)[0] == 128
    assert E.schedule(24, 90_000, 2_200, 6, 132)[0] == 128
    assert E.schedule(1, 90_000, 2_200, 6, 132)[0] == 32
    assert E.schedule(1, 90_000, 4_400, 6, 132)[0] == 64
    # Long lanes: the budget grows; past the CTA's shared memory it is cut.
    lanes, budget = E.schedule(1, 400_000, 300, 6, 4)
    assert budget > 4096 and E.smem_bytes(lanes, budget, 6) <= E.SMEM_LIMIT
    lanes, budget = E.schedule(1, 10_000_000, 100, 8, 1)
    assert lanes == 32 and E.smem_bytes(lanes, budget, 8) <= E.SMEM_LIMIT


@pytest.mark.parametrize("precision,ri", FRAMES)
def test_device_plan_tiles_and_decodes(precision, ri):
    """device_plan at LANE_STEPS: lanes tile the MCUs in order inside their
    segments, the plan is accepted wherever 128 paired steps (the earlier
    lane size) are, and decode_lanes_torch gives the native decoder's
    blocks."""
    hdr, scan = _frame(precision, ri, seed=3)
    n_mcus = hdr.mcus_x * hdr.mcus_y
    old = entropy_spec.prepare_hybrid_batch_emit(
        hdr, [scan], threads=1, max_chunks=n_mcus, target_steps=128)
    (pools, starts, nm, lane_off, t_sym, _, c, seg_first,
     ok) = entropy_spec.device_plan(hdr, [scan], threads=1)
    assert old[-1].all() and ok.all()
    assert c >= old[6]
    k = int((nm[0] > 0).sum())
    bpm = len(entropy_spec._block_comp(hdr))
    m_lo = lane_off[0, :k] // (64 * bpm)
    assert m_lo[0] == 0 and (lane_off[0, :k] % (64 * bpm) == 0).all()
    np.testing.assert_array_equal(m_lo[1:], m_lo[:-1] + nm[0, :k - 1])
    assert m_lo[-1] + nm[0, k - 1] == n_mcus
    last = m_lo + nm[0, :k] - 1
    np.testing.assert_array_equal(seg_first[m_lo], seg_first[last])
    luts = entropy_cuda.device_tables(hdr, scan, "cpu")[0]
    blocks, err = E.decode_lanes_torch(
        *(torch.from_numpy(a) for a in (pools, starts, nm, lane_off,
                                        seg_first)), luts,
        block_comp=entropy_spec._block_comp(hdr),
        n_comps=len(hdr.components), n_mcus=n_mcus, trips=t_sym,
        precision=precision)
    assert not err.any()
    np.testing.assert_array_equal(blocks[0].numpy(),
                                  native.decode_scan_baseline(hdr, scan))


def test_first_form_is_reached_only_from_testing():
    """decode() and BatchDecoder never import the first-form kernel's
    module (testing/emit_v1.py): no module outside testing/ imports from
    testing/ or names it."""
    import re

    root = os.path.join(os.path.dirname(__file__), "..",
                        "jpeg_decoder_tpu_torch")
    for dirpath, _, names in os.walk(root):
        if os.path.basename(dirpath) == "testing":
            continue
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                assert "emit_v1" not in src, name
                assert not re.search(r"^\s*(from|import)\s+\S*testing",
                                     src, re.M), name
