"""Variants of the dequant+IDCT kernel (K1) timed on one card.

    python -m jpeg_decoder_tpu_torch.testing.idct_variants

Builds copies of ``csrc/idct.cu`` (with ``csrc/idct_common.cuh`` written
in) with one design constant changed (the
depth of the shared-memory ring, the near-a-half threshold of the Kronecker
recheck, the CTAs per SM asked of ptxas, batched loads in the recheck
chain), each with nvcc into ``.cache/torch/variants/``, and times each at
the batch path's largest launch (B=32, N=65,536) on two inputs: uniformly
random coefficients (as ``chip_smoke.py``'s kernel phase) and sparse
JPEG-like ones, with the samples that differ from the twin ``idct_kron``.
Prints one line per variant and input, beside ``torch.matmul`` of the
dequantised blocks by the basis.  Needs a CUDA card.
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
from ..ops import idct_cuda
from ..types import ZIGZAG
from .encoder import qtable

#: name -> substitutions; "stages"/"eps" set kStages/kEpsScale, "lb" the
#: CTAs per SM in __launch_bounds__, "batch" loads the recheck chain's
#: operands four float4 at a time.
VARIANTS = {
    "committed": {},
    "stages=3": {"stages": "3"}, "stages=4": {"stages": "4"},
    "stages=6": {"stages": "6"},
    "eps=2^-22": {"eps": "0x1p-22f"}, "eps=2^-23": {"eps": "0x1p-23f"},
    "eps=2^-24": {"eps": "0x1p-24f"}, "no recheck": {"eps": "0x1p-100f"},
    "lb=5": {"lb": "5"}, "batched chain": {"batch": True},
}

_CHAIN = """#pragma unroll
  for (int k4 = 0; k4 < 16; ++k4) {
    const float4 d = d4[k4];
    const float4 w = __ldg(w4 + k4);
    acc = fmaf(d.x, w.x, acc);
    acc = fmaf(d.y, w.y, acc);
    acc = fmaf(d.z, w.z, acc);
    acc = fmaf(d.w, w.w, acc);
  }"""
_BATCHED = """#pragma unroll
  for (int k16 = 0; k16 < 4; ++k16) {
    float4 d[4], w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d[j] = d4[4 * k16 + j];
      w[j] = __ldg(w4 + 4 * k16 + j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(d[j].x, w[j].x, acc);
      acc = fmaf(d[j].y, w[j].y, acc);
      acc = fmaf(d[j].z, w[j].z, acc);
      acc = fmaf(d[j].w, w[j].w, acc);
    }
  }"""


def _source(subs: dict) -> str:
    """csrc/idct.cu with csrc/idct_common.cuh written in place of its
    include (the constants and the recheck chain live there), then the
    substitutions."""
    with open(idct_cuda.LIB.src) as f:
        src = f.read()
    include = '#include "idct_common.cuh"'
    with open(os.path.join(_build.CSRC, "idct_common.cuh")) as f:
        header = f.read()
    assert src.count(include) == 1
    src = src.replace(include, header)
    for key, const in (("stages", "kStages"), ("eps", "kEpsScale")):
        if key in subs:
            src, n = re.subn(rf"(constexpr \w+ {const} = )[^;]+;",
                             rf"\g<1>{subs[key]};", src)
            assert n == 1, const
    if "lb" in subs:
        old = "__global__ void __launch_bounds__(kThreads)"
        assert old in src
        src = src.replace(old, old[:-1] + f", {subs['lb']})")
    if subs.get("batch"):
        assert _CHAIN in src
        src = src.replace(_CHAIN, _BATCHED)
    return src


def _build_variant(name: str, subs: dict):
    tag = re.sub(r"\W+", "_", name)
    src_path = os.path.join(_build.CACHE, "variants", f"idct_{tag}.cu")
    os.makedirs(os.path.dirname(src_path), exist_ok=True)
    with open(src_path, "w") as f:
        f.write(_source(subs))
    path, log = _build.shared_lib(_build.nvcc(), _build.NVCC_FLAGS, src_path,
                                  "variants", f"idct_{tag}", RuntimeError)
    lib = ctypes.CDLL(path)
    fn = lib.jd_fused_dequant_idct
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p]
    regs = [ln.strip() for ln in (log or "").splitlines()
            if "registers" in ln or "spill" in ln]
    return name, fn, regs


def _ms(fn, n: int = 30) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("idct_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda kv: _build_variant(*kv),
                              VARIANTS.items()))
    for name, _, regs in built:
        print(f"{name}: {'; '.join(regs)}")
    dev = torch.device("cuda")
    kron = idct_cuda._basis(dev, False)
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn, blocks, q):
        out = torch.empty_like(blocks)
        rc = fn(blocks.data_ptr(), q.data_ptr(), kron.data_ptr(),
                out.data_ptr(), blocks.shape[0], blocks.shape[1], stream)
        _build.launch_check(rc, "idct variant")
        return out

    rng = np.random.default_rng(1234)
    b, n = 32, 256 * 256
    qt = torch.from_numpy(np.tile(qtable(90).astype(np.int32), (b, 1))).to(dev)
    uniform = torch.from_numpy(rng.integers(-256, 256, size=(b, n, 64),
                                            dtype=np.int32)).to(dev)
    keep = np.empty(64)
    keep[ZIGZAG] = np.exp(-np.arange(64) / 6.0)   # zero more often late
    sparse = torch.from_numpy(
        (rng.integers(-40, 40, size=(b, n, 64))
         * (rng.random((b, n, 64)) < keep)).astype(np.int32)).to(dev)
    deq = (uniform * qt[:, None, :]).to(torch.float32).view(-1, 64)
    print(f"torch.matmul (product only): "
          f"{_ms(lambda: torch.matmul(deq, idct_cuda._basis_t(dev))):.4f} ms")
    del deq
    for label, blocks in (("uniform", uniform), ("sparse", sparse)):
        twin = idct_cuda.idct_kron(blocks, qt)
        for name, fn, _ in built:
            n_diff = int((run(fn, blocks, qt) != twin).sum())
            t = _ms(lambda: run(fn, blocks, qt))
            print(f"{label:8s} {name:14s} {t:.4f} ms "
                  f"{8 * blocks.numel() / t / 1e6:.0f} GB/s, "
                  f"{n_diff} samples differ from the twin")


if __name__ == "__main__":
    main()
