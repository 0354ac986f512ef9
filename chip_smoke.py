#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, ``jpeg_decoder_tpu_torch.BatchDecoder`` (native
entropy to the nibble wire, pow-2 geometry groups, unpack, plane gather,
the hand-written dequant+IDCT kernel, fancy upsample, YCbCr->RGB), once on
a batch of 32 seeded 1920x1080-class images, and checks it:

1. prints the card's name and power limit and the torch/CUDA versions;
2. builds the native entropy library and the CUDA kernel (set-up, timed);
3. kernel phase, at the main path's largest launch shape (B=32, N=65,536
   blocks: the luma plane of one 1080p 4:2:0 pow-2 bucket):
   ``fused_dequant_idct`` on DC-only blocks, whose samples are exactly
   dc*q/8, must equal round-half-to-even of that everywhere; on random
   blocks it must agree with its plain twin ``idct_kron`` within +-1 (the
   Kronecker form's rounding bound against the JAX reference) on at least
   99.99% of the samples exactly; both timed with CUDA events, median of
   50 runs in two alternating rounds after warm-up;
4. slice phase: decodes the batch on the card with the kernel's launch
   count set to 0 just before and read just after; checks every item, the
   launch count, one image of each group against the port's CPU decode
   (plain twins: max |diff| <= 2, since a +-1 IDCT rounding difference can
   reach the colour transform x1.402, and >= 99.99% of samples equal) and
   PSNR >= 30 dB against the source pixels; prints end-to-end MP/s (best
   of 3 after warm-up) and per-stage times;
5. a torch.profiler breakdown of the device pixel stage and of one whole
   decode, and host entropy against the host thread pool's size;
6. prints the kernel table as one JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero without the last
line.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 1234
TOL_KERNEL = 1      # Kronecker IDCT vs its twin: +-1 rounding
TOL_SLICE = 2       # +-1 IDCT rounding through the x1.402 colour transform
# Kernel and twin compute the same float32 dots in other summation orders,
# which flips a rounding only where a sum lies within an ulp of a half.  A
# rounding fault (truncation, an off-by-one) changes far more samples.
MIN_EQUAL = 0.9999
MIN_PSNR_DB = 30.0
CPU_CHECKED = (0, 6, 7)   # one image of each geometry group


def _image(rng, h: int, w: int) -> np.ndarray:
    """Smooth random colour field (a few low-frequency cosines per
    channel) plus Gaussian luma noise of sigma 3: (h, w, 3) uint8."""
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    chans = []
    for _ in range(3):
        acc = np.full((h, w), rng.uniform(60, 190))
        for _ in range(4):
            fy, fx = rng.uniform(0.3, 4.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            acc += rng.uniform(10, 35) * np.cos(2 * np.pi * (fy * y + fx * x)
                                                + ph)
        chans.append(acc)
    img = np.stack(chans, axis=-1) + rng.normal(0.0, 3.0, (h, w, 1))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _cuda_ms(fn, n: int, warmup: int = 3) -> list[float]:
    """Milliseconds of ``n`` runs of ``fn()`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
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
    return times


def _profile(bd, batch: list[bytes], dev) -> None:
    """Breakdown of the smoke batch, after the checked run.

    Window 1 is the device pixel stage of one batch (every group, inputs
    already on the card); window 2 is one whole ``decode``.  For each it
    prints the sum of device kernel time, the wall time of the window under
    the profiler and their ratio (one stream, so kernels do not overlap),
    then the ops by device time.  Last, host entropy against the size of
    the host thread pool."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jpeg_decoder_tpu_torch import BatchDecoder

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    groups = bd.group(bd.host_stage(batch))
    tensors = [bd.to_device(g) for g in groups]
    windows = {
        f"device pixel stage, {len(groups)} groups":
            lambda: [bd.pixels(g, t) for g, t in zip(groups, tensors)],
        "whole decode": lambda: bd.decode(batch),
    }
    for name, fn in windows.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        avgs = prof.key_averages()
        kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"profile [{name}]: {dev_ms:.3f} ms of device kernel time in "
              f"{wall_ms:.3f} ms of wall under the profiler (busy share "
              f"{dev_ms / wall_ms:.3f})")
        ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
        ours = [e for e in kernels if "fused_dequant_idct" in e.key]
        for e in ops[:12] + ours:
            ms = e.self_device_time_total / 1e3
            print(f"  {e.key[:60]:<60} x{e.count:<5} {ms:9.3f} ms "
                  f"{100 * ms / dev_ms:5.1f}%")
    for k in (1, 2, 4, 8):
        with BatchDecoder(device=dev, host_threads=k) as pool_bd:
            pool_bd.host_stage(batch)
            best = min(_wall(lambda: pool_bd.host_stage(batch))
                       for _ in range(3))
        print(f"profile [host entropy, {k} pool threads]: best of 3 "
              f"{best * 1e3:.1f} ms")


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from jpeg_decoder_tpu_torch import BatchDecoder
    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.ops import idct_cuda
    from jpeg_decoder_tpu_torch.testing.encoder import encode, qtable

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])  # the card's name and power limit
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- build (set-up) -------------------------------------------------
    t0 = time.perf_counter()
    native._load()
    t1 = time.perf_counter()
    idct_cuda.build()
    t2 = time.perf_counter()
    print(f"build: native entropy {t1 - t0:.2f} s, idct.cu (nvcc sm_90a) "
          f"{t2 - t1:.2f} s")
    for line in idct_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)

    # ---- kernel phase ---------------------------------------------------
    B, N = 32, 256 * 256
    qt = torch.from_numpy(
        np.tile(qtable(90).astype(np.int32), (B, 1))).to(dev)
    # Ties: DC-only blocks.  KRON[:, 0] is exactly 1/8 in float32, so every
    # sample is exactly dc*q/8 and a quarter of them are halves; they must
    # equal round-half-to-even of that, computed apart from both versions.
    dc = torch.from_numpy(
        rng.integers(-1024, 1024, size=(B, N), dtype=np.int32)).to(dev)
    blocks = torch.zeros((B, N, 64), dtype=torch.int32, device=dev)
    blocks[:, :, 0] = dc
    exact = torch.round((dc * qt[:, :1]).double() / 8).to(torch.int32)
    got = idct_cuda.fused_dequant_idct(blocks, qt)
    tie_diff = int((got != exact[:, :, None]).sum().item())
    tie_err = int((got - exact[:, :, None]).abs().max().item())
    print(f"kernel phase: B={B} N={N} DC-only ties: {tie_diff} of "
          f"{got.numel()} samples differ from round-half-to-even of dc*q/8")
    if tie_diff:
        raise AssertionError(f"kernel rounds ties wrongly: {tie_diff}")
    del dc, exact, got
    blocks = torch.from_numpy(
        rng.integers(-256, 256, size=(B, N, 64), dtype=np.int32)).to(dev)
    got = idct_cuda.fused_dequant_idct(blocks, qt)
    ref = idct_cuda.idct_kron(blocks, qt)
    torch.cuda.synchronize()
    kern_err = max(tie_err, int((got - ref).abs().max().item()))
    n_diff = int((got != ref).sum().item())
    print(f"kernel phase: B={B} N={N} random: max |kernel - twin| = "
          f"{kern_err}, {n_diff} of {got.numel()} samples differ")
    if kern_err > TOL_KERNEL or n_diff > (1 - MIN_EQUAL) * got.numel():
        raise AssertionError(f"kernel disagrees with twin: max {kern_err}, "
                             f"{n_diff} samples differ")
    del got, ref
    ms_plain, ms_kern = [], []
    for _ in range(2):  # plain, kernel, plain, kernel
        ms_plain += _cuda_ms(lambda: idct_cuda.idct_kron(blocks, qt), 25)
        ms_kern += _cuda_ms(
            lambda: idct_cuda.fused_dequant_idct(blocks, qt), 25)
    ms_kern_med = statistics.median(ms_kern)
    ms_plain_med = statistics.median(ms_plain)
    gbytes = blocks.numel() * 8 / 1e9
    print(f"kernel phase: fused_dequant_idct median {ms_kern_med:.4f} ms "
          f"(min {min(ms_kern):.4f}, max {max(ms_kern):.4f}; "
          f"{gbytes / ms_kern_med * 1e3:.0f} GB/s of 4 B in + 4 B out per "
          f"coefficient), idct_kron median {ms_plain_med:.4f} ms "
          f"(min {min(ms_plain):.4f}, max {max(ms_plain):.4f}); "
          "50 runs each in two alternating rounds")
    del blocks, qt
    torch.cuda.empty_cache()

    # ---- slice phase: inputs ------------------------------------------
    t0 = time.perf_counter()
    specs = ([dict(h=1080, w=1920, samplings=((2, 2), (1, 1), (1, 1)),
                   quality=90, restart_interval=0)] * 6
             + [dict(h=1080, w=1920, samplings=((1, 1), (1, 1), (1, 1)),
                     quality=95, restart_interval=8),
                dict(h=750, w=1000, samplings=((2, 2), (1, 1), (1, 1)),
                     quality=90, restart_interval=0)])
    sources, blobs = [], []
    for s in specs:
        img = _image(rng, s["h"], s["w"])
        blob, _ = encode(img, samplings=s["samplings"], quality=s["quality"],
                         restart_interval=s["restart_interval"])
        sources.append(img)
        blobs.append(blob)
    batch = blobs * 4
    batch_src = sources * 4
    mp = sum(im.shape[0] * im.shape[1] for im in batch_src) / 1e6
    print(f"slice inputs: {len(batch)} images, {mp:.2f} MP, "
          f"{sum(map(len, batch)) / 1e6:.2f} MB of JPEG; encoded in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")

    # ---- slice phase: the checked run on the card ----------------------
    torch.cuda.reset_peak_memory_stats()
    with BatchDecoder(device=dev) as bd:
        idct_cuda.fused_dequant_idct.launches = 0
        items = bd.decode(batch)
        torch.cuda.synchronize()
        launches = idct_cuda.fused_dequant_idct.launches
        bad = [(it.index, it.error) for it in items if not it.ok]
        if bad:
            raise AssertionError(f"items failed: {bad}")
        n_groups = len({id(it.rgb_batch) for it in items})
        print(f"slice: {n_groups} groups, fused_dequant_idct launched "
              f"{launches} times in the run")
        if launches < 3 * n_groups:
            raise AssertionError(
                f"kernel launched {launches} < {3 * n_groups} times")
        psnrs = []
        for it, src in zip(items, batch_src):
            rgb = it.rgb
            if rgb.device.type != "cuda" or tuple(rgb.shape) != src.shape:
                raise AssertionError(
                    f"item {it.index}: {rgb.device} {tuple(rgb.shape)}")
            diff = rgb.float() - torch.from_numpy(src).to(dev).float()
            mse = float((diff * diff).mean().item())
            psnrs.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
        print(f"slice: PSNR vs source min {min(psnrs):.2f} dB, "
              f"max {max(psnrs):.2f} dB")
        if min(psnrs) < MIN_PSNR_DB:
            raise AssertionError(f"PSNR {min(psnrs):.2f} < {MIN_PSNR_DB}")

        # One image of each group against the port's own CPU decode (plain
        # twins): 1080p 4:2:0, 1080p 4:4:4 DRI 8, 1000x750 4:2:0 (edge).
        with BatchDecoder(device="cpu") as cpu_bd:
            cpu_items = cpu_bd.decode([blobs[k] for k in CPU_CHECKED])
        for k, ci in zip(CPU_CHECKED, cpu_items):
            gpu = items[k].rgb.cpu().to(torch.int32)
            diff = gpu - ci.rgb.to(torch.int32)
            d = int(diff.abs().max().item())
            n_diff = int((diff != 0).sum().item())
            print(f"slice: image {k} GPU vs CPU twin max |diff| = {d}, "
                  f"{n_diff} of {diff.numel()} samples differ")
            if d > TOL_SLICE or n_diff > (1 - MIN_EQUAL) * diff.numel():
                raise AssertionError(f"image {k}: GPU vs CPU max {d}, "
                                     f"{n_diff} samples differ")
        del items

        # End to end: best of 3 after the warm-up above.
        e2e = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = bd.decode(batch)
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - t0)
            del out
        print(f"slice: end to end {[round(t, 4) for t in e2e]} s -> "
              f"{mp / min(e2e):.1f} MP/s (best of 3) to device-resident RGB")

        # Per stage (best of 3 each).
        host_s, group_s, copy_s, pix_ms = [], [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            host_out = bd.host_stage(batch)
            t1 = time.perf_counter()
            groups = bd.group(host_out)
            t2 = time.perf_counter()
            tensors = [bd.to_device(g) for g in groups]
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rgbs = [bd.pixels(g, t) for g, t in zip(groups, tensors)]
            end.record()
            end.synchronize()
            host_s.append(t1 - t0)
            group_s.append(t2 - t1)
            copy_s.append(t3 - t2)
            pix_ms.append(start.elapsed_time(end))
            del rgbs, tensors
        wire_mb = sum(x.nbytes for g in groups for x in g.arrays) / 1e6
        print(f"stages (best of 3): host entropy {min(host_s) * 1e3:.1f} ms "
              f"({mp / min(host_s):.1f} MP/s), group+pad "
              f"{min(group_s) * 1e3:.1f} ms, copy to device "
              f"{min(copy_s) * 1e3:.1f} ms ({wire_mb:.1f} MB), device pixel "
              f"{min(pix_ms):.1f} ms ({mp / min(pix_ms) * 1e3:.1f} MP/s), "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"host pool of {bd.host_threads} threads on "
              f"{os.cpu_count()} host cores")
        _profile(bd, batch, dev)

    print(json.dumps({"kernels": [{
        "name": "fused_dequant_idct",
        "route": "cuda",
        "source": "jpeg_decoder_tpu_torch/csrc/idct.cu",
        "replaces": "jpeg_decoder_tpu/ops/idct_pallas.py:55",
        "launches": launches,
        "max_abs_err": kern_err,
        "ms": ms_kern_med,
        "plain_ms": ms_plain_med,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
