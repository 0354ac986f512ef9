"""Variants of K7c's carry-and-pack kernel timed on one card.

    python -m jpeg_decoder_tpu_torch.testing.carry_variants

Builds copies of ``csrc/emit_carry.cu`` with one design choice changed
(how the carried DC goes back in place, the rows a thread keeps in flight
and the CTAs an SM holds, the streaming cache hints), each with nvcc into
``.cache/torch/variants/``, and times ``jd_carry_pack`` in each at the mesh
route's shape: the (1, 2) grid's rank 1 on 24 1080p 4:2:0 images (48,960
block rows each, its rows 24,540..48,960 owned and carried, a pad of 2,928
rows), seeded random blocks and totals.  Device time: 20 launches back to
back after a warm-up, CUDA events, the median of 3 rounds taken in turns.
Beside them ``Tensor.copy_`` of the same bytes (contiguous) and
``index_select`` of the owned rows.  Each variant's send buffer and blocks
are held to the committed kernel's ("no write-back" leaves the blocks'
DC uncarried: it is a yardstick, not a kernel).  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import _build
from ..ops import emit_carry_cuda as k7c

_WB = ("        __stcs(reinterpret_cast<int4*>(a.blocks) + row[u] * 16 + v, "
       "x[u]);\n")
_CARRIED = "carried[u] = v < 2 && r >= c_lo && r < c_hi;"
_LOAD = "__ldcs(in + row[u] * 16 + v)"
_STORE = "__stcs(a.send + i * 16 + v, x[u])"

#: name -> (substitutions of the committed source, kUnroll, CTAs an SM).
VARIANTS = {
    "committed (32-byte sector back)": ([], 4, 4),
    "DC back as 4 bytes": ([(_CARRIED, _CARRIED.replace("v < 2", "v == 0")),
                            (_WB, "        a.blocks[row[u] * 64] = "
                                  "x[u].x;\n")], 4, 4),
    "64 bytes back": ([(_CARRIED, _CARRIED.replace("v < 2", "v < 4"))],
                      4, 4),
    "whole row back": ([(_CARRIED, _CARRIED.replace("v < 2", "v < 16"))],
                       4, 4),
    "no write-back": ([(_WB, "")], 4, 4),
    "plain loads and stores": ([(_LOAD, "in[row[u] * 16 + v]"),
                                (_STORE, "a.send[i * 16 + v] = x[u]")],
                               4, 4),
    "1 row a thread, 8 CTAs": ([], 1, 8),
    "2 rows a thread, 8 CTAs": ([], 2, 8),
    "8 rows a thread, 2 CTAs": ([], 8, 2),
}

B, ROWS, OWN_LO, PAD = 24, 48960, 24540, 2928
BLOCK_COMP = (0, 0, 0, 0, 1, 2)


def _source(subs, unroll: int, ctas: int) -> str:
    with open(k7c.LIB.src) as f:
        src = f.read()
    for old, new in subs:
        assert old in src, old
        src = src.replace(old, new)
    for const, value in (("kUnroll", unroll), ("kPackCtasPerSm", ctas)):
        src, n = re.subn(rf"(constexpr int {const} = )\d+;",
                         rf"\g<1>{value};", src)
        assert n == 1, const
    return src


def _build_variant(name: str, spec):
    subs, unroll, ctas = spec
    tag = re.sub(r"\W+", "_", name)
    src_path = os.path.join(_build.CACHE, "variants", f"carry_{tag}.cu")
    os.makedirs(os.path.dirname(src_path), exist_ok=True)
    with open(src_path, "w") as f:
        f.write(_source(subs, unroll, ctas))
    path, log = _build.shared_lib(_build.nvcc(), _build.NVCC_FLAGS, src_path,
                                  "variants", f"carry_{tag}", RuntimeError)
    fn = ctypes.CDLL(path).jd_carry_pack
    fn.restype = ctypes.c_int
    fn.argtypes = k7c.LIB.signatures["jd_carry_pack"]
    regs = [ln.strip() for ln in (log or "").splitlines()
            if "registers" in ln]
    return name, fn, 16 * unroll, ctas, regs


def _ms(fn, n: int = 20) -> float:
    """Device milliseconds a call: ``n`` calls back to back after a
    warm-up (each queues in microseconds, far less than it runs)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("carry_variants: needs a CUDA card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda kv: _build_variant(*kv),
                              VARIANTS.items()))
    for name, _, _, _, regs in built:
        print(f"{name}: {'; '.join(regs)}")
    dev = torch.device("cuda")
    bpm = len(BLOCK_COMP)
    own_lo, own_hi = np.full(B, OWN_LO), np.full(B, ROWS)
    plan = k7c.pack_plan(np.stack([np.ones(B), np.zeros(B)]), own_lo, own_hi,
                         own_lo, own_hi, rows=ROWS, bpm=bpm,
                         n_send=B * (ROWS - OWN_LO) + PAD)
    rng = np.random.default_rng(13)
    blocks = torch.from_numpy(rng.integers(-2**31, 2**31, (B, ROWS, 64),
                                           dtype=np.int64)
                              .astype(np.int32)).to(dev)
    tot = torch.from_numpy(rng.integers(-2**31, 2**31, (2, B, 3),
                                        dtype=np.int64)
                           .astype(np.int32)).to(dev)
    want_blocks = blocks.clone()
    want = k7c.carry_pack(want_blocks, tot, plan, block_comp=BLOCK_COMP)
    comp_code = sum(c << (4 * k) for k, c in enumerate(BLOCK_COMP))
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(fn, tile, ctas, work, send):
        grid = max(1, min(-(-plan.n_send // tile), ctas * n_sms))

        def run():
            rc = fn(work.data_ptr(), send.data_ptr(), tot.data_ptr(),
                    plan.table.ctypes.data, None, B, plan.n_own,
                    plan.n_send, 2, 3, bpm, comp_code, grid, stream)
            _build.launch_check(rc, "carry variant")
        return run

    runs = {}
    for name, fn, tile, ctas, _ in built:
        work, send = blocks.clone(), torch.empty_like(want)
        launcher(fn, tile, ctas, work, send)()
        same = torch.equal(send, want) and torch.equal(work, want_blocks)
        print(f"{name}: send buffer and blocks equal to the committed "
              f"kernel's: {same}")
        runs[name] = launcher(fn, tile, ctas, work, send)
    src = blocks.view(-1, 64)[:plan.n_own].clone()
    dst = torch.empty_like(src)
    runs["Tensor.copy_ of the same bytes"] = lambda: dst.copy_(src)
    owned = torch.from_numpy(k7c.owned_rows(plan)).to(dev)
    flat = blocks.view(-1, 64)
    runs["index_select of the owned rows"] = \
        lambda: flat.index_select(0, owned)
    times = {name: [] for name in runs}
    for turn in range(3):
        names = list(runs) if turn % 2 == 0 else list(runs)[::-1]
        for name in names:
            times[name].append(_ms(runs[name]))
    nbytes = 256 * (plan.n_own + plan.n_send)
    for name, ts in times.items():
        ms = statistics.median(ts)
        print(f"{name:34s} {ms:.4f} ms ({', '.join(f'{t:.4f}' for t in ts)}"
              f"), {nbytes / ms / 1e9:.2f} TB/s of the rows read and sent")


if __name__ == "__main__":
    main()
