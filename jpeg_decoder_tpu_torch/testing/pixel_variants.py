"""K6a's and K6b's forms and design variants timed on one card, in turns.

    python -m jpeg_decoder_tpu_torch.testing.pixel_variants [--quick] [--k6a]

Builds copies of ``csrc/pixels.cu`` with one design constant changed, each
with nvcc into ``.cache/torch/variants/``, and times each on the three
geometry groups of a batch of 32 seeded photos as ``BatchDecoder`` pads
them (24 x 1920x1080 4:2:0, 4 x 1920x1080 4:4:4, 4 x 1000x750 4:2:0; the
batch of ``chip_smoke.py``, photos drawn anew), under ``pallas``, ``exact``,
``kron`` and ``fast``:

* the first form (``jd_blocks_to_rgb_v1``, ``testing/pixel_v1.py``) whole;
  its phase 1 alone (``kV1Variant`` = 1: the windows' IDCTs, no pixel);
  its phase 2 alone from zeroed windows (2: no IDCT, every pixel); the
  first form with its RGB staged in shared memory and stored 16 bytes at a
  time (3); under ``kron`` and ``fast`` the torch product before it
  (``scan_samples``) timed on its own;
* K6b (``jd_blocks_to_rgb``) as committed (``kVariant`` = 0), its copies
  and IDCTs alone (1), its pixels alone from zeroed windows (2), its RGB
  staged in shared memory and stored 16 bytes at a time (3), built for 2,
  3 and 4 CTAs a multiprocessor (``kCtas``, ``kK1Ctas``, ``kFastCtas``, with
  the grid to match), and at other tiles;
* K6a (``jd_unpack_nibble``) as committed, with the route's trim and
  whole, beside its first form (``jd_unpack_nibble_v1``); its window pass
  capped for 2 and 4 CTAs a multiprocessor (``kUnpackCtas``); windows of
  8,192, 12,288, 20,480 and 24,576 positions (``kWindow``, the last two
  at 2 CTAs); passes 1 and 2 alone
  (``kUnpackVariant`` = 1); the window pass's zeros and DC alone (2: no
  search, add or escape); the window pass without its stores (3).

Device time of each: the three groups' launches queued behind a spin
kernel, CUDA events, summed over the groups, the median of turns in one
order and the reverse.  Prints each build's ``-Xptxas -v`` registers,
stack and spills, the card's name and power limit, and checks that every
form that writes pixels gives the committed K6b's bytes (the first form
under ``kron``/``fast`` within the +-1 IDCT bound) and that every K6a
build that writes its output gives the committed K6a's.  ``--quick``: one
turn each way, the committed tile only; ``--k6a``: K6a alone.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import _build
from ..ops import pixels_cuda as k6
from . import pixel_v1

IDCTS = ("pallas", "exact", "kron", "fast")
#: Builds: name -> (design constant, value).  The first form's variants
#: (kV1Variant): whole, phase 1 alone, phase 2 alone from zeroed windows,
#: 16-byte stores from staged rows; K6b's (kVariant, the CTAs): as
#: committed, capped for 2, 3 and 4 CTAs a multiprocessor under every IDCT,
#: its copies and IDCTs alone, its pixels alone from zeroed windows, 16-byte
#: stores from staged rows.
BUILDS = {"v1 whole": ("kV1Variant", 0), "v1 phase 1": ("kV1Variant", 1),
          "v1 phase 2": ("kV1Variant", 2),
          "v1 vector stores": ("kV1Variant", 3),
          "K6b": ("kVariant", 0), "K6b ctas=2": ("Ctas", 2),
          "K6b ctas=3": ("Ctas", 3), "K6b ctas=4": ("Ctas", 4),
          "K6b IDCT only": ("kVariant", 1),
          "K6b pixels only": ("kVariant", 2),
          "K6b vector stores": ("kVariant", 3)}
#: K6a's builds beside the committed source: other windows, passes 1 and 2
#: alone, the window pass's zeros and DC alone, the window pass without
#: its stores.
K6A_BUILDS = {"K6a ctas=2": (("kUnpackCtas", 2),),
              "K6a ctas=4": (("kUnpackCtas", 4),),
              "K6a window 8192": (("kWindow", 8192),),
              "K6a window 12288": (("kWindow", 12288),),
              "K6a window 20480 ctas=2": (("kWindow", 20480),
                                          ("kUnpackCtas", 2)),
              "K6a window 24576 ctas=2": (("kWindow", 24576),
                                          ("kUnpackCtas", 2)),
              "K6a chunks always listed": (("kDirect", 0),),
              "K6a passes 1-2": (("kUnpackVariant", 1),),
              "K6a zeros and DC": (("kUnpackVariant", 2),),
              "K6a no stores": (("kUnpackVariant", 3),)}
#: The K6a builds whose output is whole (checked against the committed).
K6A_WHOLE = ("K6a ctas=2", "K6a ctas=4", "K6a window 8192",
             "K6a window 12288", "K6a window 20480 ctas=2",
             "K6a window 24576 ctas=2", "K6a chunks always listed")
#: The grid's CTAs a multiprocessor of each K6b build.
CTAS = {"K6b ctas=2": 2, "K6b ctas=3": 3, "K6b ctas=4": 4}
#: Tiles of the committed K6b also timed.
TILES = ((32, 64), (64, 128), (32, 128), (128, 64))


def _source(pairs) -> str:
    """csrc/pixels.cu with each (constant, value) of ``pairs`` set ("Ctas":
    every K6b mode's CTAs a multiprocessor, kCtas, kK1Ctas and
    kFastCtas)."""
    with open(k6.LIB.src) as f:
        src = f.read()
    for const, value in pairs:
        for name in (("kCtas", "kK1Ctas", "kFastCtas") if const == "Ctas"
                     else (const,)):
            src, n = re.subn(rf"(constexpr int {name} = )\d+;",
                             rf"\g<1>{value};", src)
            assert n == 1, name
    return src


def _lib(*pairs):
    """A build of csrc/pixels.cu with each (constant, value) of ``pairs``
    set, and ptxas's output for it; one pair may come as two arguments."""
    if len(pairs) == 2 and isinstance(pairs[0], str):
        pairs = (pairs,)
    tag = "pixels_" + "_".join(f"{c}_{v}" for c, v in pairs)
    path = os.path.join(_build.CACHE, "variants", f"{tag}.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(_source(pairs))
    so, log = _build.shared_lib(_build.nvcc(), _build.NVCC_FLAGS, path,
                                "variants", tag, RuntimeError)
    lib = ctypes.CDLL(so)
    for fn, argtypes in k6.LIB.signatures.items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = argtypes
    return lib, log or ""


def _ptxas(log: str, kernel: str) -> list[str]:
    """ptxas's resource lines of the kernels whose names hold ``kernel``."""
    out, take = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            take = kernel in line
            name = re.search(r"'(\w+)'", line)
            if take and name:
                out.append(name.group(1)[-40:])
        elif take and ("registers" in line or "spill" in line):
            out.append("  " + line.strip())
    return out


def _queued_ms(fn, n: int = 5) -> float:
    """Device ms a call: ``n`` calls queued behind a spin kernel, CUDA
    events around them (as chip_smoke.py's ``_queued_ms``)."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / n
        cycles *= 4
    raise RuntimeError("the host queued slower than the spin")


def _event_ms(fn, n: int = 3) -> float:
    """Median ms of ``n`` calls, CUDA events around each, after one."""
    fn()
    times = []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(times)


def batch_groups(dev, seed: int = 0):
    """The batch of 32's groups as ``BatchDecoder`` pads them: (group,
    device tensors, K6a's blocks) each."""
    from ..models.batch import BatchDecoder
    from .encoder import encode
    from .photo import synthetic_photo

    rng = np.random.default_rng(seed)
    specs = ([(1080, 1920, ((2, 2), (1, 1), (1, 1)), 90, 0)] * 6
             + [(1080, 1920, ((1, 1),) * 3, 95, 8),
                (750, 1000, ((2, 2), (1, 1), (1, 1)), 90, 0)])
    blobs = [encode(synthetic_photo(rng, h, w), samplings=s, quality=q,
                    restart_interval=ri)[0] for h, w, s, q, ri in specs]
    with BatchDecoder(device=dev, idct="pallas") as bd:
        groups = bd.group(bd.host_stage(blobs * 4))
        tensors = [bd.to_device(g) for g in groups]
    blocks = [k6.unpack_nibble(*t[:-2]) for t in tensors]
    return list(zip(groups, tensors, blocks))


def _k6a_turns(libs, work, turns: int) -> None:
    """K6a's builds, trimmed as the route calls it and whole, and its first
    form, on the batch of 32's groups: device ms (queued behind a spin,
    groups summed, median of the turns in one order and the reverse);
    the builds that write their output must give the committed build's."""
    committed = libs["K6b"][0]

    def calls(lib, trim):
        return [lambda t=t, g=g: k6.launch_unpack(
            lib, *t[:-2], g.n_img if trim else t[0].shape[0],
            g.n_rows if trim else t[0].shape[1]) for g, t, _ in work]

    fns = {"K6a v1": [lambda t=t: pixel_v1.unpack_nibble_v1(
        *t[:-2], lib=committed) for _, t, _ in work]}
    for name in ("K6a", *K6A_BUILDS):
        lib = committed if name == "K6a" else libs[name][0]
        fns[f"{name} trim"] = calls(lib, True)
        fns[f"{name} whole"] = calls(lib, False)
        if name in K6A_WHOLE:
            for mode in ("trim", "whole"):
                for f, r in zip(fns[f"{name} {mode}"], fns[f"K6a {mode}"]):
                    if not torch.equal(f(), r()):
                        raise AssertionError(f"{name} {mode} differs")
    ms = {n: [] for n in fns}
    order = list(fns)
    for _ in range(turns):
        for turn in (order, order[::-1]):
            for n in turn:
                ms[n].append(sum(_queued_ms(c) for c in fns[n]))
    print(f"K6a device ms on the batch of 32 (3 groups summed, median of "
          f"{2 * turns} turns, queued behind a spin): " + ", ".join(
              f"{n} {statistics.median(v):.4f}" for n, v in ms.items()))
    torch.cuda.empty_cache()


def _kw(g, idct: str) -> dict:
    return dict(comp_shapes=g.comp_shapes, comp_hv=g.comp_hv,
                height=g.height, width=g.width, samplings=g.samplings,
                idct=idct, upsample="fancy", color=g.color,
                precision=g.precision)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--k6a", action="store_true", help="K6a alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pixel_variants needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}")
    builds = ({"K6b": BUILDS["K6b"]} if args.k6a else dict(BUILDS))
    builds.update(K6A_BUILDS)
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each
        futs = {n: pool.submit(_lib, *b) for n, b in builds.items()}
        libs = {n: f.result() for n, f in futs.items()}
    for name, (_, log) in libs.items():
        kern = "blocks_to_rgb_v1" if name.startswith("v1") else \
            "unpack_" if name.startswith("K6a") else "blocks_to_rgb_kernel"
        print(f"ptxas {name}: " + "; ".join(_ptxas(log, kern)))
    print("ptxas K6a: " + "; ".join(_ptxas(libs["K6b"][1], "unpack_")))
    work = batch_groups(dev)
    _k6a_turns(libs, work, 1 if args.quick else 2)
    if args.k6a:
        return
    print("groups: " + "; ".join(
        f"{len(g.idxs)} x {g.width}x{g.height} "
        f"{''.join(map(str, g.comp_hv))}" for g, _, _ in work))

    def form(name, idct, tile=None):
        lib = libs[name][0] if name in libs else libs["K6b"][0]
        if name.startswith("v1"):
            return [lambda t=t, a=a, g=g: pixel_v1.blocks_to_rgb_v1(
                a, t[-2], t[-1], lib=lib, staged=name == "v1 vector stores",
                **_kw(g, idct)) for g, t, a in work]
        if name == "scan_samples":
            return [lambda t=t, a=a, g=g: k6.scan_samples(
                a, t[-2], g.comp_hv, idct) for g, t, a in work]
        ctas = CTAS.get(name, k6.CTAS_PER_SM[idct])
        staged = name == "K6b vector stores"

        def k6b(t, a, g):
            plan = k6.rgb_plan(
                comp_shapes=g.comp_shapes, comp_hv=g.comp_hv,
                height=g.height, width=g.width, samplings=g.samplings,
                upsample="fancy", color=g.color, precision=g.precision,
                tile=k6._whole_mcus(tile or k6.TILE, g.comp_hv))
            out = torch.empty((a.shape[0], plan.out_h, plan.out_w, 3),
                              dtype=torch.uint16 if g.precision == 12
                              else torch.uint8, device=dev)
            k6.launch_rgb(lib, a, t[-2], t[-1],
                          k6.idct_cuda._basis(dev, False), out, plan, idct,
                          k6.grid_for(plan, a.shape[0], k6._sm_count(dev),
                                      ctas), k6._stream(a), staged=staged)
            return out
        return [lambda t=t, a=a, g=g: k6b(t, a, g) for g, t, a in work]

    names = list(BUILDS) + ([] if args.quick else
                            [f"K6b {h}x{w}" for h, w in TILES])
    turns = 1 if args.quick else 2
    for idct in IDCTS:
        fns = {n: form(n, idct, tile=tuple(map(int, n[4:].split("x")))
                       if re.fullmatch(r"K6b \d+x\d+", n) else None)
               for n in names}
        if idct in ("kron", "fast"):
            fns["scan_samples"] = form("scan_samples", idct)
        # Bytes: the committed K6b's output against each form that writes
        # every pixel.
        ref = [f() for f in fns["K6b"]]
        for n, f in fns.items():
            if n in ("v1 phase 1", "v1 phase 2", "scan_samples", "K6b",
                     "K6b IDCT only", "K6b pixels only"):
                continue
            # The first form's kron/fast product is a torch GEMM: the +-1
            # IDCT bound; every other pair shares its arithmetic.
            bound = n.startswith("v1") and idct in ("kron", "fast")
            for r, g in zip(ref, f):
                d = (g().to(torch.int32) - r.to(torch.int32)).abs()
                n_d = int((d != 0).sum())
                if (int(d.max()) > 2 or n_d > 1e-4 * d.numel()) if bound \
                        else n_d:
                    raise AssertionError(f"{n} {idct}: {n_d} bytes differ")
        del ref
        # Forms with torch ops (the product before the first form) queue
        # slower than the card runs them: CUDA events around one call.
        events = {n for n in fns if n == "scan_samples" or
                  (n.startswith("v1") and idct in ("kron", "fast"))}
        ms = {n: [] for n in fns}
        order = list(fns)
        for _ in range(turns):
            for turn in (order, order[::-1]):
                for n in turn:
                    ms[n].append(sum(
                        _event_ms(c) if n in events else _queued_ms(c)
                        for c in fns[n]))
        print(f"K6b {idct} device ms on the batch of 32 (3 groups summed, "
              f"median of {2 * turns} turns; queued behind a spin, by "
              f"events around a call for {sorted(events)}): " + ", ".join(
                  f"{n} {statistics.median(v):.4f}" for n, v in ms.items()))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
