"""K7c's carry-and-pack form (``ops/emit_carry_cuda.carry_pack``) on the CPU.

* Its plain version ``carry_pack_torch`` equals the first form's composite,
  ``add_carry_torch`` followed by the gather of the owned rows and the pad,
  bit for bit, on seeded K7 lane plans split over 2-4 ranks
  (``sharded.share_mcus``/``carry_plan``): DRI 0, DRI > 0 with a rank cut
  inside a restart segment, a rank with no lanes, an image with ``m_b = 0``,
  int32 wrap, 1, 3, 4 and 6 blocks per MCU.
* The same ranks' carried DC equals the JAX package's segmented DC prefix
  sum over the whole image (``jax ops/entropy_spec._dc_prefix_sum_seg``,
  what jax sharded.py:641-646 takes after the 'seg' psum), bit for bit.
* A numpy model of the kernel's walk (its grid, the within-MCU position a
  thread keeps, the binary search of the plan) reads the plan's records
  and equals the plain version: the CUDA kernel itself runs only on the
  card (tests/test_torch_cuda.py).

Run: ``python -m pytest tests/test_torch_carry.py -q`` (a few seconds).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jpeg_decoder_tpu.ops import entropy_spec as jspec

from jpeg_decoder_tpu_torch import collectives
from jpeg_decoder_tpu_torch.ops import emit_carry_cuda as k7c
from jpeg_decoder_tpu_torch.parallel import sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPS = {1: (0,), 3: (0, 1, 2), 4: (0, 0, 1, 2), 6: (0, 0, 0, 0, 1, 2)}


def _lane_plan(rng, n_img, n_mcus, n_lanes, bpm, empty=(1,)):
    """A K7 lane plan (nm_lane, lane_off) (B, C): image 0 one lane an MCU
    (``n_lanes`` >= ``n_mcus``), every other image's MCUs cut into up to
    ``n_lanes`` lanes at random MCUs (lanes past the last of an image hold
    nothing); the images in ``empty`` have no lanes at all."""
    nm = np.zeros((n_img, n_lanes), np.int64)
    off = np.zeros((n_img, n_lanes), np.int64)
    for b in range(n_img):
        if b in empty:
            continue
        k = n_mcus if b == 0 else \
            int(rng.integers(1, min(n_lanes, n_mcus) + 1))
        cuts = np.sort(rng.choice(np.arange(1, n_mcus), k - 1, replace=False))
        edges = np.concatenate([[0], cuts, [n_mcus]])
        nm[b, :k] = np.diff(edges)
        off[b, :k] = edges[:-1] * 64 * bpm
    return nm, off


def _first_form(blocks, tot, plan, block_comp):
    """The first form's composite: the carry in place, then every image's
    owned rows in order and zero rows to ``n_send``."""
    out = k7c.add_carry_torch(blocks, tot, plan.w, plan.lo, plan.hi,
                              block_comp=block_comp)
    mine = torch.cat([out[b, lo:hi] for b, (lo, hi) in
                      enumerate(zip(plan.own_lo, plan.own_hi))])
    return torch.cat([mine, mine.new_zeros(plan.n_send - len(mine), 64)])


def _case(seed, bpm, ranks, ri):
    """Seeded blocks (full int32 range), totals and the K7 split of four
    images of 11 MCUs over ``ranks`` ranks (image 1 empty).  Image 0's
    ranks start at MCUs 6 (2 ranks), 4 and 8 (3), 3, 6 and 9 (4): inside
    a restart segment of 5 MCUs."""
    rng = np.random.default_rng(seed)
    n_mcus = 11
    nm, off = _lane_plan(rng, 4, n_mcus, n_mcus, bpm)
    cuts, m_a, m_b = sharded.share_mcus(nm, off, bpm, ranks)
    rows = n_mcus * bpm + 1          # the bucketed route's fill row
    blocks = torch.from_numpy(rng.integers(-2**31, 2**31, (4, rows, 64),
                                           dtype=np.int64).astype(np.int32))
    tot = torch.from_numpy(rng.integers(
        -2**31, 2**31, (ranks, 4, max(COMPS[bpm]) + 1),
        dtype=np.int64).astype(np.int32))
    return rng, m_a, m_b, rows, blocks, tot, [ri] * 4, [n_mcus] * 4


@pytest.mark.parametrize("ri", [0, 5])
@pytest.mark.parametrize("ranks", [2, 3, 4])
@pytest.mark.parametrize("bpm", sorted(COMPS))
def test_plain_is_the_first_form_composite(bpm, ranks, ri):
    bc = COMPS[bpm]
    _, m_a, m_b, rows, blocks, tot, ris, mcus = _case(bpm * 10 + ranks + ri,
                                                      bpm, ranks, ri)
    assert (m_b[:, 1] == 0).all()                    # the empty image
    carried = 0
    for s in range(ranks):
        plan = sharded.carry_plan(m_a, m_b, s, ris, mcus, bpm, rows)
        want_blocks = blocks.clone()
        want = _first_form(want_blocks, tot, plan, bc)
        for fn in (k7c.carry_pack_torch, k7c.carry_pack):
            got_blocks = blocks.clone()
            got = fn(got_blocks, tot, plan, block_comp=bc)
            assert got.shape == (plan.n_send, 64)
            assert torch.equal(got, want)
            assert torch.equal(got_blocks, want_blocks)
        carried += int(plan.hi[0] > plan.lo[0])
        # The send buffer holds the most rows any rank owns.
        assert plan.n_send == max(int(((m_b - m_a) * bpm).sum(1).max()), 1)
    assert carried == ranks - 1     # image 0: every rank but the first


def test_rank_without_lanes():
    """One lane an image on three ranks: ranks 1 and 2 own nothing, send a
    buffer of zeros as long as rank 0's rows, and carry nothing."""
    bpm, bc = 3, COMPS[3]
    nm = np.array([[5], [7]])
    off = np.zeros((2, 1), np.int64)
    cuts, m_a, m_b = sharded.share_mcus(nm, off, bpm, 3)
    assert cuts == [(0, 1), (1, 1), (1, 1)]
    assert m_a.tolist() == [[0, 0]] * 3
    assert m_b.tolist() == [[5, 7], [0, 0], [0, 0]]
    blocks = torch.arange(2 * 21 * 64, dtype=torch.int32).view(2, 21, 64)
    tot = torch.ones((3, 2, 3), dtype=torch.int32)
    for s in (1, 2):
        plan = sharded.carry_plan(m_a, m_b, s, [0, 0], [5, 7], bpm, 21)
        assert not plan.w.any() and plan.n_own == 0 and plan.n_send == 36
        got = k7c.carry_pack(blocks.clone(), tot, plan, block_comp=bc)
        assert torch.equal(got, torch.zeros((36, 64), dtype=torch.int32))


def _share_prefix(diffs, m_a, m_b, seg_first, bc):
    """What K7 gives a rank on MCUs [m_a, m_b) of one image from its DC
    differences (n_mcus, bpm): each component's running sum, from 0 at the
    share's first MCU and at every restart segment's."""
    dc = np.zeros_like(diffs)
    run = {}
    for m in range(m_a, m_b):
        if m == m_a or seg_first[m] == m:
            run = {c: np.int32(0) for c in bc}
        for k, c in enumerate(bc):
            with np.errstate(over="ignore"):
                run[c] = np.int32(run[c] + diffs[m, k])
            dc[m, k] = run[c]
    return dc


@pytest.mark.parametrize("ri", [0, 2, 5])
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("bpm", [1, 6])
def test_carried_dc_equals_jax_prefix(bpm, ranks, ri):
    """Each rank's K7 share (modelled), its DC totals all-gathered, then
    the carry and pack: the owned rows equal the JAX package's segmented
    DC prefix sum of the whole image, AC untouched."""
    bc = COMPS[bpm]
    n_comps = max(bc) + 1
    rng = np.random.default_rng(100 * bpm + 10 * ranks + ri)
    n_img, n_mcus = 3, 13
    nm, off = _lane_plan(rng, n_img, n_mcus, n_mcus, bpm, empty=(2,))
    cuts, m_a, m_b = sharded.share_mcus(nm, off, bpm, ranks)
    diffs = rng.integers(-2**31, 2**31, (n_img, n_mcus, bpm, 64),
                         dtype=np.int64).astype(np.int32)
    seg_first = (np.arange(n_mcus) // ri * ri if ri else
                 np.zeros(n_mcus, np.int64)).astype(np.int32)
    want = np.stack([np.asarray(jspec._dc_prefix_sum_seg(
        jnp.asarray(d), jnp.asarray(seg_first), bc, n_comps)) for d in diffs])
    rows = n_mcus * bpm
    shares = []
    for q in range(ranks):
        out = np.zeros((n_img, n_mcus, bpm, 64), np.int32)
        for b in range(n_img):
            a, e = int(m_a[q, b]), int(m_b[q, b])
            out[b, a:e] = diffs[b, a:e]
            out[b, a:e, :, 0] = _share_prefix(diffs[b, :, :, 0], a, e,
                                              seg_first, bc)[a:e]
        shares.append(torch.from_numpy(out.reshape(n_img, rows, 64)))
    tot = torch.stack([sharded.dc_totals(shares[q], m_b[q], bc)
                       for q in range(ranks)])
    for s in range(ranks):
        plan = sharded.carry_plan(m_a, m_b, s, [ri] * n_img,
                                  [n_mcus] * n_img, bpm, rows)
        send = k7c.carry_pack(shares[s].clone(), tot, plan, block_comp=bc)
        at = 0
        for b in range(n_img):
            lo, hi = int(plan.own_lo[b]), int(plan.own_hi[b])
            ref = want[b].reshape(rows, 64)[lo:hi]
            np.testing.assert_array_equal(send[at:at + hi - lo].numpy(), ref)
            at += hi - lo
        assert not send[at:].any()


def _kernel_model(blocks, tot, plan, block_comp, n_sms):
    """``jd_carry_pack`` in numpy, as its CTAs and threads walk the send
    buffer: CTA j takes the j-th contiguous run of 64-row tiles, thread t
    vector t % 16 of rows t // 16 + 16u (u < 4) of each tile, the image of
    a row by a binary search of the records, the component of a row from
    a within-MCU position kept by additions.  Returns (send, blocks after
    the write-back); send rows no thread wrote keep 0x5A5A5A5A."""
    t = plan.table
    bpm, tile = plan.bpm, k7c.TILE_ROWS
    carry = np.zeros((len(t), max(block_comp) + 1), np.uint32)
    for q in range(tot.shape[0]):
        on = ((t["w"] >> np.uint64(q)) & np.uint64(1)).astype(bool)
        carry += np.where(on[:, None], tot[q].numpy().view(np.uint32), 0) \
            .astype(np.uint32)
    flat = blocks.view(-1, 16, 4).numpy().copy()
    send = np.full((plan.n_send, 16, 4), 0x5A5A5A5A, np.int32)
    grid = k7c.pack_grid(plan.n_send, n_sms)
    n_tiles = -(-plan.n_send // tile)
    per = -(-n_tiles // grid)
    th = np.arange(256)
    v, r16 = th % 16, th // 16
    for cta in range(grid):
        t_lo, t_hi = cta * per, min(cta * per + per, n_tiles)
        pos = [(t_lo * tile + r16) % bpm]
        for _ in range(3):
            p = pos[-1] + 16 % bpm
            pos.append(np.where(p >= bpm, p - bpm, p))
        for tt in range(t_lo, t_hi):
            for u in range(4):
                i = tt * tile + r16 + 16 * u
                own = i < plan.n_own
                b = np.searchsorted(t["dst"], i, side="right") - 1
                r = i - t["dst"][b]
                row = t["src"][b] + r
                x = np.where(own[:, None], flat[np.where(own, row, 0), v], 0)
                car = own & (v == 0) & (r >= t["c_lo"][b]) & \
                    (r < t["c_hi"][b])
                add = carry[b, np.asarray(block_comp)[pos[u]]]
                x[car, 0] = (x[car, 0].view(np.uint32)
                             + add[car]).view(np.int32)
                flat[row[car], 0, 0] = x[car, 0]
                keep = i < plan.n_send
                send[i[keep], v[keep]] = x[keep]
                p = pos[u] + tile % bpm
                pos[u] = np.where(p >= bpm, p - bpm, p)
    return send.reshape(-1, 64), flat.reshape(-1, 64)


@pytest.mark.parametrize("n_sms", [1, 3, 132])
@pytest.mark.parametrize("bpm", sorted(COMPS))
def test_kernel_model_equals_plain(bpm, n_sms):
    bc = COMPS[bpm]
    rng, m_a, m_b, rows, blocks, tot, ris, mcus = _case(7 + bpm, bpm, 3, 5)
    for s in range(3):
        plan = sharded.carry_plan(m_a, m_b, s, ris, mcus, bpm, rows)
        # Random masks and carried rows too, the pad made longer.
        w = rng.integers(0, 2, plan.w.shape)
        hi = plan.own_lo + ((plan.own_hi - plan.own_lo)
                            * rng.random(4)).astype(np.int64)
        for p in (plan, k7c.pack_plan(w, plan.own_lo, hi, plan.own_lo,
                                      plan.own_hi, rows=rows, bpm=bpm,
                                      n_send=plan.n_send + 77)):
            want_blocks = blocks.clone()
            want = k7c.carry_pack_torch(want_blocks, tot, p, block_comp=bc)
            send, flat = _kernel_model(blocks, tot, p, bc, n_sms)
            np.testing.assert_array_equal(send, want.numpy())
            np.testing.assert_array_equal(flat,
                                          want_blocks.view(-1, 64).numpy())


@pytest.mark.parametrize("n_send", [1, 63, 64, 65, 1000, 33_792, 585_696])
def test_grid_covers_every_tile_once(n_send):
    """The CTAs' runs of tiles cover the send buffer's tiles once, and the
    grid is at most what the card holds at once."""
    for n_sms in (1, 132):
        grid = k7c.pack_grid(n_send, n_sms)
        n_tiles = -(-n_send // k7c.TILE_ROWS)
        assert 1 <= grid <= min(n_tiles, k7c.CTAS_PER_SM * n_sms)
        per = -(-n_tiles // grid)
        runs = [range(j * per, min(j * per + per, n_tiles))
                for j in range(grid)]
        assert sorted(t for run in runs for t in run) == list(range(n_tiles))


def test_plan_records_are_the_kernels():
    """PLAN_DTYPE is ``PackImg`` field for field, and the limits are the
    kernel's."""
    with open(os.path.join(REPO, "jpeg_decoder_tpu_torch", "csrc",
                           "emit_carry.cu")) as f:
        src = f.read()
    body = re.search(r"struct PackImg \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(u?int(?:32|64))_t (\w+)(?:, (\w+))?;", body)
    names = [n for _, *ns in fields for n in ns if n]
    assert names == list(k7c.PLAN_DTYPE.names)
    sizes = [int(t[-2:]) // 8 for t, *ns in fields for n in ns if n]
    assert sizes == [k7c.PLAN_DTYPE[n].itemsize for n in names]
    assert k7c.PLAN_DTYPE.itemsize == 32
    assert k7c.TILE_ROWS == 16 * int(
        re.search(r"constexpr int kUnroll = (\d+);", src)[1])
    for name, value in (("kInline", k7c.INLINE_IMAGES),
                        ("kMaxRanks", k7c.MAX_RANKS),
                        ("kMaxCells", k7c.MAX_CELLS),
                        ("kPackCtasPerSm", k7c.CTAS_PER_SM)):
        assert re.search(rf"constexpr int {name} = (\d+);", src)[1] == \
            str(value)


@pytest.mark.parametrize("bad", ["mcu", "outside", "ranks", "short",
                                 "mask"])
def test_pack_plan_refuses(bad):
    kw = dict(w=np.ones((2, 1)), lo=[6], hi=[9], own_lo=[6], own_hi=[12],
              rows=12, bpm=3)
    if bad == "mcu":
        kw["own_lo"] = [5]
        kw["lo"] = [5]
    elif bad == "outside":
        kw["hi"] = [13]
    elif bad == "ranks":
        kw["w"] = np.zeros((65, 1))
    elif bad == "short":
        kw["n_send"] = 5
    else:
        kw["w"] = np.full((2, 1), 2)
    with pytest.raises(ValueError):
        k7c.pack_plan(**kw)


def test_carry_pack_refuses_misaligned_blocks():
    plan = k7c.pack_plan(np.ones((2, 1)), [0], [3], [0], [3], rows=3, bpm=3)
    raw = torch.zeros(3 * 64 + 1, dtype=torch.int32)
    blocks = raw[1:].view(1, 3, 64)
    assert blocks.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        k7c.carry_pack(blocks, torch.zeros((2, 1, 3), dtype=torch.int32),
                       plan, block_comp=COMPS[3])


def test_all_gather_rows_sends_a_full_buffer_as_is(monkeypatch):
    """A tensor that holds max(counts) rows reaches the collective itself
    (no copy); a shorter one is padded."""
    sent = []

    def fake(t, mesh, axes):
        sent.append(t)
        return [t, t.clone()]

    monkeypatch.setattr(collectives, "all_gather", fake)
    full = torch.arange(5 * 64, dtype=torch.int32).view(5, 64)
    parts = collectives.all_gather_rows(full, None, "seg", [5, 3])
    assert sent[-1] is full
    assert parts[0].data_ptr() == full.data_ptr() and len(parts[1]) == 3
    collectives.all_gather_rows(full[:3], None, "seg", [3, 5])
    assert sent[-1].shape == (5, 64) and not sent[-1][3:].any()
