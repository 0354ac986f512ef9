#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives both entry points of the port once on the card and holds every
kernel against its plain version:

1. prints the card's name and power limit and the torch/CUDA versions;
2. builds the native entropy library and the CUDA sources (K7's first form
   ``csrc/entropy_emit_v1.cu``, the baseline of its comparison, included),
   all at once, printing ptxas's registers, shared memory and spills (set-up,
   timed); then starts a pool of spawned processes that encodes the
   8192x6144 frame of phase 10b'' (first) and the frames of phase 8 while
   the phases before them run;
3. IDCT kernel phase (K1, ``csrc/idct.cu``), at the batch path's largest
   launch shape (B=32, N=65,536 blocks: the luma plane of one 1080p 4:2:0
   pow-2 bucket): ``fused_dequant_idct`` on DC-only blocks, whose samples
   are exactly dc*q/8, must equal round-half-to-even of that everywhere; on
   random blocks it must agree with its plain twin ``idct_kron`` within +-1
   (the Kronecker form's rounding bound against the JAX reference) on at
   least 99.99% of the samples exactly; both timed with CUDA events, median
   of 50 runs in two alternating rounds after warm-up, beside
   ``torch.matmul`` of the dequantised blocks by the basis (product only),
   with GB/s and the share of HBM bandwidth; then once more on JPEG
   coefficients (the native decoder's blocks of image (d) below);
4. batch path (``BatchDecoder``: native entropy to the nibble wire, pow-2
   geometry groups, K6a's unpack, K6b's pass from blocks to RGB: closed-form
   plane geometry, K1's arithmetic, fancy upsample, YCbCr->RGB) on
   32 seeded 1920x1080-class images, with every kernel count set to 0 just
   before and read just after; checks every item, K6a and K6b once per
   group and K1 never, one image
   of each group against the port's CPU decode (plain twins: max |diff| <=
   2, since a +-1 IDCT rounding difference can reach the colour transform
   x1.402, and >= 99.99% of samples equal) and PSNR >= 30 dB against the
   source pixels; prints end-to-end MP/s (best of 3 after warm-up) and
   per-stage times;
5. wires: the same 32 images through ``BatchDecoder(wire=w)`` for each of
   ``nibble``, ``sparse``, ``packed`` and ``slots``: every wire's unpacked
   blocks (the nibble wire's trimmed to the true images' blocks, the
   others zero past them) and RGB must equal the nibble wire's bit for
   bit, K6b must
   launch 3 times (one a group), K6a 3 times on the nibble wire (0 on the
   others), K1 never; per wire the MB copied, host
   entropy, group+pad, copy, the device unpack (profiler), the pixel stage
   (CUDA events) and end-to-end MP/s;
6. the batch under ``entropy="pallas"``: K2 once per image (32), RGB
   bit-identical to ``entropy="native"``'s; end-to-end MP/s;
6b. the batch under ``entropy="hybrid"`` (K7, ``csrc/entropy_emit.cu``, on
   the 28 DRI-0 images, K2 on the 4 DRI-8 ones) and ``entropy="jax"`` (K2 on
   all 32), ``idct="pallas"``: RGB bit-identical to ``entropy="native"``'s,
   K6b 3 times and K1 never;
   each distinct DRI-0 image's K7 launch staging every lane group;
   launches, host stage ms and end-to-end MP/s;
7. waves: 192 images (the batch six times), ``decode(blobs, wave=64)``
   against three back-to-back ``decode(blobs[i:i+64])`` calls, in turns:
   bit-identical and in input order, K6a and K6b 9 times, K1 never; both MP/s, host entropy and device
   worker ms, the busy share under the profiler, peak device memory;
8. mixed frames: 32 frames of 1920x1080 (8 baseline DRI 0, 8 progressive
   Huffman from the committed PIL fixtures, 4 SOF9 and 4 SOF10 arithmetic,
   4 multi-scan, 2 restart-mismatched 4:4:4 DRI 8 with the last RSTn cut
   out, one 12-bit, one CMYK; the arithmetic and other frames encoded in a
   pool of spawned processes, with the YCCK, Adobe RGB and gray frames of
   phase 12): all 32 must decode (the 12-bit one as uint16), each within
   the batch tolerance of the port's CPU ``decode()`` and at PSNR >= 30 dB
   against its source (a 12-bit decode at 1/16 scale; a CMYK one against
   Pillow's cmyk2rgb of the stored planes); host ms per frame kind; then on
   a 512x512 frame of each kind the native planes must equal the
   pure-Python oracle's;
8b. the 32-image batch through ``BatchDecoder(idct="exact")``: K6b (with
   K5's strict AAN dequant+IDCT, ``csrc/idct_common.cuh``) 3 times, K5 and
   K1 never,
   one image of each group equal to the port's CPU ``decode(idct="exact",
   upsample="fancy")`` byte for byte; MP/s beside the nibble wire's
   ``idct="pallas"`` figure;
9. entropy kernel phase (K2, ``csrc/entropy.cu``) on four images:
   (a) 3840x2160 4:2:0 q90 with DRI = one MCU row (135 segments of 240
   MCUs, the hardware-camera pattern), (b) 1920x1080 4:4:4 q95 DRI 8 (4,050
   segments; the batch's restart image), (c) 1920x1080 4:2:0 q90 DRI 0 (one
   segment, the common web photo) and (d) 3840x2160 4:2:0 q90 DRI 0 (one
   segment, the phone photo).  ``decode_segments`` must equal the native
   host decoder on every coefficient of each, and its twin
   ``decode_segments_torch`` on (b); on a corrupt copy of (b) it must flag
   exactly the twin's segments.  Kernel timed with CUDA events (median of
   20 runs) beside the native host decoder at 1 thread and at all threads
   (no single PyTorch call computes a Huffman decode), the twin on (b);
   per image the kernel's device time per phase (tables, sync, scan, write;
   torch.profiler), its synchronisation rounds, and a sweep of the chunk
   size C (each C must give the same output).  K2's in-place form
   (``decode_scan_bytes``, the form ``decode()`` runs on the card) on the
   same four and on the two benchmark cells' frames (a 1080p DRI-120
   RTP/JPEG frame, a 4032x3024 DRI-0 q95 photo): its plain reader
   ``segment_words_torch`` must give the packed rows of ``prepare_scan``,
   and its blocks, flags, chunk counts and statistics must equal the row
   form's (``decode_segments``, which the batch routes run), its blocks
   the native decoder's, and on (b) and the DRI-120 frame the twin's
   (``decode_segments_torch`` on ``segment_words_torch``'s rows); on the
   corrupt copy of (b) its flags the twin's.  Both forms timed with CUDA
   events (median of 20), each with its bound (the in-place form's bytes:
   the scan bytes and offset table in, blocks out) and device time per
   phase;
9b. K5 phase at the batch path's largest launch (B=32, N=65,536): on
   random blocks in the JPEG range, DC-only blocks and image (d)'s JPEG
   coefficients, ``dequant_idct_exact`` must equal its op-by-op twin
   ``exact_twin`` run on the card on every sample; K5 timed with CUDA
   events (median of 50) beside K1 on the same input, the twin and
   ``torch.matmul`` of the dequantised blocks by the Kronecker basis
   (product only), with GB/s and the share of HBM;
10. single-image path (``decode(entropy="pallas", idct="pallas",
   upsample="fancy")``) on (a)-(d), with every kernel count set to 0 just
   before and read just after: K2 once and K6b once per image, RGB on
   the card, PSNR >= 30 dB, and the CPU decode (``entropy="native"``, plain
   twins) within the batch path's tolerance; prints end-to-end ms and MP/s
   (best of 3 after warm-up) and the stages as ``decode()`` runs them on
   the card (parse, scan prep (``segment_table``), the copy of the scan
   bytes and offset table with a cold and with a warm table cache, K2 in
   place, pixel pipeline);
10b. strict single-image phase: ``decode(idct="exact", strict=True)`` with
   ``upsample`` nn and fancy on (a)-(d) and on one 1920x1080 frame of each
   kind (CMYK, YCCK, Adobe RGB, 12-bit 4:2:0, gray), every count set to 0
   just before each decode: K6b once, K5 and K1 never, K2 once under
   ``entropy="pallas"`` (the 8-bit frames; the 12-bit one takes the native
   decoder, as ``pallas`` refuses 12-bit frames); the RGB on the card equal
   to the port's CPU decode byte for byte; end-to-end ms and MP/s (best of 3
   after warm-up) with the torch pixel route's share; then
   ``decode(entropy="pallas", idct="pallas")`` on the CMYK frame, whose K2
   planes must equal the native decoder's on every coefficient;
10b'. entropy jax/hybrid phase on (a)-(d), the 12-bit 4:2:0 frame and a
   12-bit 4:2:0 DRI 8 one, every count set to 0 just before each decode:
   the scan blocks of ``entropy="hybrid"`` (K7 on a DRI-0 stream, K2 on a
   restart stream) and ``"jax"`` (K2) equal to the native decoder's on
   every coefficient (K2 at 12 bits included), with no K7 lane group over
   the staging budget; ``decode()`` under both at ``idct="exact"``
   byte-equal to the CPU decode and at ``"pallas"`` equal to
   ``entropy="native"``'s on the card (K7 staging every group again); K7
   equal to its plain version ``decode_lanes_torch`` on (c), flags
   included; a corrupt copy of (c) raising JPEGError under hybrid; per
   frame the host ``emit_prep`` ms and the lane count C / trips T; K7 and
   its first form (``testing/emit_v1.py``) on the same plan, both equal to
   the native decoder and to ``decode_lanes_torch``, no lane group over the
   staging budget, timed in turns by device time (launches queued behind a
   spin kernel, timed by CUDA events; the first form's emit and carry
   launches also apart; one call queued alone) and by CUDA events around
   one wrapper call, with the kernels each wrapper call launches (their
   names from torch.profiler), the byte bound, each one's share of it,
   the group size, budget, CTAs per SM and the kernel's counters (groups
   staged / over budget, LUT misses); the new kernel also with every
   group over a 4-word staging budget and at the other group sizes; K2 by
   CUDA events;
   ``decode(idct="pallas")`` end to end under hybrid, jax and pallas (best
   of 3); on the DRI-0 frames a lane-size sweep (16 to 1,300 paired steps:
   emit_prep ms, lanes, T, K7 device ms, the staging counters, none over
   budget);
10b''. K7 as one B = 24 launch over the batch's 24 DRI-0 1080p images
   (their tables asserted identical), against its first form as above;
   then the 8192x6144 4:2:0 q90 DRI-0 frame (50.3 MP) through
   ``decode(entropy="hybrid")`` (K7) and ``decode(entropy="pallas")`` (K2),
   each count set to 0 just before: one launch each, scan blocks equal to
   ``native.decode_scan_baseline``, peak device memory, end-to-end ms, K7
   (against its first form, device time and events) and K2 by CUDA events;
10b'''. sharded phase: ``decode_batch_sharded`` (``parallel/sharded.py``,
   entropy decode on the card per geometry group), every count set to 0
   just before each checked call: the batch of 32 under ``idct="pallas"``,
   ``"exact"`` and ``"kron"``, each RGB equal to the nibble wire's
   ``BatchDecoder`` under the same IDCT, K7 twice (the 24 DRI-0 1080p
   images, the 4 1000x750 ones: two uniform groups) and K2 once (the 4
   DRI-8 4:4:4 images' 16,200 segments), K6b 3 times (the header's
   geometry) and K1 and K5 never, no row patched by the per-image
   fallback, no K7 lane group over budget nor LUT miss; the ``exact``
   probe: the 24-image group's enqueue and pixel ms and the caching
   allocator's cudaMalloc/cudaFree calls and retries per call, three calls
   after a warm-up, with the parent's pixel route swapped in and with K6b,
   in turns;
   end-to-end MP/s (best of 3) in turns with the nibble wire and
   ``BatchDecoder(entropy="hybrid")``, parse, host plan and device ms per
   group, ``prepare_scan`` of (b); a bucketed group of six web-size frames
   (one power-of-two bucket, DRI 0 and 8, two Huffman table sets, encoded
   in the pool): one K7 launch, each RGB equal to its own ``decode()``,
   K7 on the group equal to ``decode_lanes_torch`` on the card with the
   rows sorted by table set and alternating between sets; the cost of one
   table-set staging (K7 over the 24 DRI-0 1080p images with one set and
   with two copies of it alternating by image, device time queued, the
   stagings counted); the mixed frames: all 32 decoded, the 8
   progressive ones on the progressive lanes (K8a-K8d; each also equal to
   its own ``decode()``), 14 through the host fallback, RGB equal to the
   ``BatchDecoder``'s, MP/s in turns; the
   8192x6144 frame: RGB equal to ``decode(entropy="hybrid")``, peak device
   memory;
10b''''. mesh phase (``parallel/mesh.py``, ``parallel/multihost.py``, the
   ('data', 'seg') split of ``parallel/sharded.py`` and the progressive
   lanes): first K7c (``csrc/emit_carry.cu``, the DC carry across ranks)
   on what the (1, 2) grid gives rank 1 for the batch's 24 DRI-0 1080p
   images (K7 on each rank's share of the lanes, the ranks' DC totals,
   ``sharded.carry_plan``): the carry-and-pack form's send buffer and
   carried blocks equal to ``carry_pack_torch``, to the first form
   followed by the gather and the pad, and to one K7 launch over every
   lane; both forms timed in turns by device time (queued) and by the
   whole call (CUDA events), beside ``index_select`` of the owned rows,
   with their byte bounds; then ``testing/mesh_worker.py`` in one process
   per rank on cuda:0, per grid: (1,1) NCCL, one rank, the batch of 32, the
   mixed frames and the bucketed group; (1,2) gloo (NCCL refuses two ranks on
   one GPU) the batch of 32, the 1080p (a) and the restart progressive
   fixtures' planes and ``decode_scan_sharded`` of (a); (2,1) gloo the
   batch of 32 and the mixed frames; every item (after
   ``allgather_items``), plane and coefficient of every rank equal by
   SHA-256 to the one-GPU route's, no item in error, each rank's counts
   (zeroed just before its checked call) showing K1, K2, K7 (and K7c on
   the (1,2) grid's rank 1), K6b and K8a-K8d where its route reaches them;
   per
   grid the batch of 32's wall time per call (best of 3 after a warm-up,
   the slowest rank of each call) beside the one-GPU route's in the same
   run, and per group of rank 0's checked call its host plan, device
   decode, collective (of it, for K7, the totals and the carry and pack)
   and pixel times and the bytes its collectives gathered;
10e. K6 phase (``csrc/pixels.cu``; run after 10b'''): the groups of the
   batch of 32, the mixed frames, the bucketed group and the 8192x6144
   frame as ``BatchDecoder`` pads them: K6a whole and its first form
   (``jd_unpack_nibble_v1``) equal to the plain ``unpack_nibble`` on every
   element, K6a with the route's trim (the true images, the longest one's
   blocks) equal to its ``[:n_img, :n_rows + 1]`` and the plain output zero
   on all that the trim drops; the route's RGB (K6b on the trimmed blocks)
   byte-equal under every IDCT to K6b on the first form's whole blocks;
   K6b (every IDCT inside the kernel,
   one launch and no ``scan_samples`` product a call) equal over the whole
   RGB tensor, padding included, to the route it replaces on the card
   (``rgb_from_blocks_torch``: the plane gather, K1, K5 or the torch
   product, torch ops) under ``pallas`` (fancy and nn) and ``exact``, and
   within the +-1 IDCT bound under ``kron`` (K1's arithmetic against the
   route's GEMM) and ``fast`` (the kernel's separable form against the
   route's einsum; the bytes that differ are printed); on the batch of 32
   each kernel's device time (5 calls a group queued behind a spin kernel,
   CUDA events, groups summed, median of 2 turns): K6a trimmed, whole and
   its first form in turns, K6b under all four IDCTs on the trimmed and on
   the whole blocks beside its first form (``testing/pixel_v1.py``; under
   kron/fast with its torch product, by events), every function's by CUDA
   events around one call (the plain routes' host work stalls the card, so
   they cannot be queued), K6b at other tiles and CTAs a multiprocessor,
   the byte bounds trimmed and whole with their bytes (and the floor on the
   true blocks and RGB), and the pixel stage (unpack and pixels of every
   group) with K6a's first form and whole blocks before and the route's
   trimmed K6a after under fast, kron and pallas, by CUDA events around it,
   in turns; then (``_k6_routes``) both batch routes under each IDCT,
   counts set to 0 just before: one K6b a group, no K1, no K5, no
   ``scan_samples``; and each route's end-to-end MP/s under its default
   IDCT (``BatchDecoder`` fast, ``decode_batch_sharded`` kron) with the
   trimmed K6a and with K6a's first form in its place, in turns;
10d. progressive lanes phase (K8a-K8d, ``csrc/entropy_prog.cu``, under
   ``ops/entropy_prog.py``; run after 10b''): every scan of the 512x512
   and 1080p (a) progressive fixtures through each kernel and its plain
   version on the card, from the native decoder's prior planes, with
   skeleton lanes at the default count: planes and flags equal, and equal
   to the native decoder's; the 1080p (a), (b), 1080p restart (a restart
   marker every MCU row) and 3840x2160 DRI-0 fixtures: the planes of
   ``decode_to_planes`` under ``pallas``, ``jax`` and ``hybrid`` equal to
   ``native.decode_progressive`` (each count set to 0 just before: every
   K8 kernel launched), again at 512 lanes (DRI 0); ``decode()`` under
   ``pallas`` and ``hybrid`` with ``idct="exact"`` byte-equal to the CPU
   decode and ``"pallas"`` within the batch tolerance; per frame the host
   skeleton walks per scan kind (1 thread, best of 3), K8's device time per
   scan kind (10 launches queued behind a spin kernel, CUDA events; AC
   refinement restores its plane before each, the restores timed apart
   and taken off), both at the default lane target and at JAX's 512 on
   DRI-0 frames, the byte bound, the pixel stage, ``decode()`` end to end
   under ``hybrid`` (also at 512 lanes on DRI-0 frames) and ``native`` and
   the native host progressive decode; per DC scan K8a in both forms (a
   warp per lane, a thread per lane) or K8b against their first forms
   (``testing/prog_v1.py``, the same build) and their plain versions, and
   per AC scan K8c in both forms and K8d (a warp per lane) against their
   first forms, all from the same prior planes (flags and planes equal)
   and timed in turns the same way (each form, first form, first form,
   each form in reverse; every turn printed), with the scan's lanes, the
   form the wrapper picks, its CTAs, the longest lane and the staging
   counters (0 over budget in the picked form unless its budget is
   capped, 0 table misses, asserted); on 1080p (a) and the restart frame
   ``decode()`` under ``hybrid`` in turns with the first forms of K8a/K8b
   or of K8c/K8d swapped in (best of 3 each); K8a's two forms in turns on
   the DC first scans of 1080p (a) and 4K from 256 to 4,096 target lanes
   (the numbers that set ``DC_WARP_LANES_MAX``);
10c. CLI phase: ``python -m jpeg_decoder_tpu_torch`` in subprocesses on the
   card over a temporary directory of three frames (1080p 4:2:0, CMYK,
   12-bit) and a non-JPEG file: ``--idct exact --strict --format bmp
   --time``, ``--batch --idct pallas --format ppm`` and ``--batch
   --device-entropy --idct pallas --format ppm`` (all rc 1 with the bad
   file's error line), the 12-bit frame to ``.npy`` and a ``--resume``
   rerun that writes nothing; every output read back equals ``decode()`` on
   the card (12-bit BMP/PPM as the high 8 bits);
10c'. examples phase: the port's two examples in subprocesses on the card
   (their launches are their own processes', outside the counts): ``python
   examples/torch_serving_pipeline.py --glob`` over the batch of 32 and a
   corrupt file (rc 0, 32 embeddings, the corrupt file's failure line, the
   best of 3 passes' wall time and MP/s), then on one image of each
   geometry and the corrupt file on the card and under ``--device cpu``
   (the same lines, embeddings within 1.5/127.5: a +-1 pixel through the
   model); ``python examples/torch_mixed_corpus_serving.py`` on a (1, 1)
   NCCL mesh, on its default corpus (only the corrupt blob failing) and
   with ``--glob`` over the mixed frames, every line's sha256 (or error
   text) equal to the one-GPU ``decode_batch_sharded(idct="fast")``'s,
   with the best of 3 calls' wall time;
11. probe phase (K3/K4, ``csrc/lut_probe.cu``): the dependent probe chain
   must equal the value tools/pallas_mosaic_repro.py expects and the
   per-lane gather must equal ``lut[idx]``; the kernels' device time per
   launch (50 queued behind a spin, CUDA events) beside ``torch.take``'s
   and an empty kernel's (the same way), and the wrappers
   timed beside their twins and ``torch.take`` by CUDA events;
12. a torch.profiler breakdown of the batch path's device pixel stage (K6a
   and K6b), one
   whole batch decode and one ``decode()`` of each image, and host entropy
   against the host thread pool's size;
13. prints the kernel table as one JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero without the last
line.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 outside the tensor cores


def _image(rng, h: int, w: int) -> np.ndarray:
    """The seeded synthetic photo (``testing/photo.synthetic_photo``):
    smooth random colour fields plus Gaussian luma noise of sigma 3."""
    from jpeg_decoder_tpu_torch.testing.photo import synthetic_photo

    return synthetic_photo(rng, h, w)


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


def _cuda_events(fn, n: int) -> tuple[list, bool]:
    """torch.profiler's CUDA kernel records of ``n`` calls of ``fn`` after
    one warm-up (key_averages), and whether the session is whole.  On the
    card the profiler has lost some kernel records (a kernel launched once
    per call counted 1 of 3 times), which makes a mean per call low; a
    session is whole when every kernel's count is a multiple of ``n``.  A
    session that is not is run again, up to five times in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        got = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        evs = got or evs
        if got and all(e.count % n == 0 for e in got):
            return got, True
    return evs, False


def _kernel_ms(fn, n: int, groups: dict) -> dict:
    """Device time of one call of ``fn``, by kernel, from a whole
    torch.profiler session of ``n`` calls (``_cuda_events``): {group: ms}
    for the kernels whose name contains one of the group's substrings, and
    "other" (with the other kernels' names) for the rest.  A group of
    which the profiler recorded no kernel, and every group when no session
    was whole, is None: not measured."""
    out = {g: None for g in groups}
    out["other"], others = 0.0, set()
    evs, whole = _cuda_events(fn, n)
    if not whole:
        out["other"], out["other_names"] = None, []
        return out
    for e in evs:
        ms = e.self_device_time_total / 1e3 / n
        for g, keys in groups.items():
            if any(k in e.key for k in keys):
                out[g] = (out[g] or 0.0) + ms
                break
        else:
            out["other"] += ms
            others.add(e.key[:40])
    out["other_names"] = sorted(others)
    return out


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _queued_ms(fn, n: int = 20) -> float:
    """Device milliseconds per call of ``fn``: ``n`` calls queued behind a
    spin kernel (``torch.cuda._sleep``), so the card runs them back to back
    and none waits on the host's launch work, timed by CUDA events around
    the ``n``.  ``fn`` must not synchronise.  Raises when the host took
    longer to queue them than the spin lasted, even at 64x the spin."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / n
        cycles *= 4
    raise AssertionError(f"queued timing: {n} calls took {host_ms:.2f} ms "
                         "of host time, longer than the spin")


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _psnr(rgb, src: np.ndarray) -> float:
    """PSNR of decoded RGB against 8-bit source pixels; a 12-bit decode
    (uint16) is compared at 1/16 scale (its encoder took the source x16)."""
    import torch

    scale = 16.0 if rgb.dtype == torch.uint16 else 1.0
    diff = (rgb.float() / scale
            - torch.from_numpy(src).to(rgb.device).float())
    mse = float((diff * diff).mean().item())
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def _close_to_cpu(what: str, gpu, cpu) -> None:
    """GPU RGB against the port's CPU decode: TOL_SLICE and MIN_EQUAL."""
    import torch

    diff = gpu.cpu().to(torch.int32) - cpu.to(torch.int32)
    d = int(diff.abs().max().item())
    n_diff = int((diff != 0).sum().item())
    print(f"{what}: GPU vs CPU twin max |diff| = {d}, {n_diff} of "
          f"{diff.numel()} samples differ")
    if d > TOL_SLICE or n_diff > (1 - MIN_EQUAL) * diff.numel():
        raise AssertionError(f"{what}: GPU vs CPU max {d}, {n_diff} "
                             "samples differ")


def _kernel_fns() -> dict:
    """Every counted wrapper of a kernel on a path, by name."""
    from jpeg_decoder_tpu_torch.ops import (entropy_cuda, entropy_emit_cuda,
                                            entropy_prog_cuda, idct_cuda,
                                            idct_exact_cuda, pixels_cuda)
    from jpeg_decoder_tpu_torch.probes import lut_probe

    return {"K1": idct_cuda.fused_dequant_idct,
            "K2": entropy_cuda.decode_segments,
            "K3": lut_probe.lut_chain_probe,
            "K4": lut_probe.lut_gather,
            "K5": idct_exact_cuda.dequant_idct_exact,
            "K6a": pixels_cuda.unpack_nibble,
            "K6b": pixels_cuda.blocks_to_rgb,
            # The torch product before K6b's first form: 0 on every path.
            "scan_samples": pixels_cuda.scan_samples,
            "K7": entropy_emit_cuda.decode_lanes,
            **entropy_prog_cuda.KERNELS}


def _zero_counts() -> None:
    for fn in _kernel_fns().values():
        fn.launches = 0


def _counts() -> dict:
    return {k: fn.launches for k, fn in _kernel_fns().items()}


def _build_all() -> None:
    """Build the native library and every CUDA source at once (one
    compiler process each); prints the times and ptxas's resource lines."""
    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.ops import (emit_carry_cuda, entropy_cuda,
                                            entropy_emit_cuda,
                                            entropy_prog_cuda, idct_cuda,
                                            idct_exact_cuda, pixels_cuda)
    from jpeg_decoder_tpu_torch.probes import lut_probe
    from jpeg_decoder_tpu_torch.testing import emit_v1

    jobs = {"native entropy (g++)": native._load,
            "idct.cu": idct_cuda.build, "entropy.cu": entropy_cuda.build,
            "lut_probe.cu": lut_probe.build,
            "idct_exact.cu": idct_exact_cuda.build,
            "entropy_emit.cu": entropy_emit_cuda.build,
            "entropy_emit_v1.cu (baseline)": emit_v1.build,
            "entropy_prog.cu": entropy_prog_cuda.build,
            "emit_carry.cu": emit_carry_cuda.build,
            "pixels.cu": pixels_cuda.build}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {name: pool.submit(_wall, fn) for name, fn in jobs.items()}
        secs = {name: f.result() for name, f in futs.items()}
    print(f"build: {time.perf_counter() - t0:.2f} s in all ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + "; nvcc for sm_90a)")
    for lib in (idct_cuda.LIB, entropy_cuda.LIB, lut_probe.LIB,
                idct_exact_cuda.LIB, entropy_emit_cuda.LIB, emit_v1.LIB,
                entropy_prog_cuda.LIB, emit_carry_cuda.LIB, pixels_cuda.LIB):
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                print(f"  ptxas {os.path.basename(lib.src)}: {line.strip()}")


def _idct_phase(dev, rng) -> dict:
    """K1 at the batch path's largest launch (see the module docstring)."""
    import torch

    from jpeg_decoder_tpu_torch.ops import idct_cuda
    from jpeg_decoder_tpu_torch.testing.encoder import qtable

    B, N = 32, 256 * 256
    qt = torch.from_numpy(
        np.tile(qtable(90).astype(np.int32), (B, 1))).to(dev)
    # Ties: DC-only blocks.  Every sample is exactly dc*q/8 (the kernel's
    # separable basis has column 0 exactly 1.0 and divides by 8 last) and a
    # quarter of them are halves; they must equal round-half-to-even of
    # that, computed apart from both versions.
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
    # Library yardstick: the product alone, on blocks dequantised outside
    # the timing (no dequant, no rounding).
    deq = (blocks * qt[:, None, :]).to(torch.float32).view(-1, 64)
    basis = idct_cuda._basis_t(dev)
    ms_lib = _cuda_ms(lambda: torch.matmul(deq, basis), 25)
    del deq
    ms_kern_med = statistics.median(ms_kern)
    ms_plain_med = statistics.median(ms_plain)
    ms_lib_med = statistics.median(ms_lib)
    # The least work: 4 B in and 4 B out per coefficient, and the separable
    # form's 16 FMAs (32 FLOP) per sample.
    nbytes = blocks.numel() * 8
    flops = blocks.numel() * 32
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    gbs = nbytes / 1e9 / ms_kern_med * 1e3
    lib_gbs = nbytes / 1e9 / ms_lib_med * 1e3
    print(f"kernel phase: fused_dequant_idct median {ms_kern_med:.4f} ms "
          f"(min {min(ms_kern):.4f}, max {max(ms_kern):.4f}; {gbs:.0f} GB/s "
          f"of 4 B in + 4 B out per coefficient, {gbs / 3350:.3f} of HBM's "
          f"3.35 TB/s), idct_kron median {ms_plain_med:.4f} ms "
          f"(min {min(ms_plain):.4f}, max {max(ms_plain):.4f}); "
          "50 runs each in two alternating rounds; torch.matmul of the "
          f"dequantised blocks by the basis (product only) median "
          f"{ms_lib_med:.4f} ms (the same bytes at {lib_gbs:.0f} GB/s, "
          f"{lib_gbs / 3350:.3f} of HBM); bound {bound_ms:.4f} ms "
          f"({nbytes / 1e9:.2f} GB at 3.35 TB/s); kernel "
          f"{'below' if ms_kern_med < ms_lib_med else 'NOT below'} the "
          "yardstick")
    return {"name": "fused_dequant_idct", "route": "cuda",
            "source": "jpeg_decoder_tpu_torch/csrc/idct.cu",
            "replaces": "jpeg_decoder_tpu/ops/idct_pallas.py:55",
            "max_abs_err": kern_err, "ms": ms_kern_med,
            "plain_ms": ms_plain_med, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": ms_lib_med,
            "gb_per_s": gbs, "hbm_share": gbs / 3350}


def _idct_jpeg_phase(dev, blob: bytes) -> dict:
    """K1 at the same launch shape on JPEG coefficients instead of uniform
    random ones: the native decoder's blocks of ``blob`` (a 4K q90 frame),
    32 windows of 65,536 consecutive blocks, with the frame's luma table.
    Real blocks are sparse, so the kernel recomputes far fewer samples near
    a half than on the random blocks of the kernel phase."""
    import torch

    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.ops import idct_cuda

    hdr = parser.parse(blob)
    coefs = native.decode_scan_baseline(hdr, hdr.scans[0])
    B, N = 32, 256 * 256
    idx = (np.arange(B)[:, None] * 4099 + np.arange(N)[None, :]) % len(coefs)
    blocks = torch.from_numpy(coefs[idx]).to(dev)
    q = hdr.quant_tables[hdr.components[0].tq].values.astype(np.int32)
    qt = torch.from_numpy(np.tile(q, (B, 1))).to(dev)
    got = idct_cuda.fused_dequant_idct(blocks, qt)
    ref = idct_cuda.idct_kron(blocks, qt)
    err = int((got - ref).abs().max())
    n_diff = int((got != ref).sum())
    if err > TOL_KERNEL or n_diff > (1 - MIN_EQUAL) * got.numel():
        raise AssertionError(f"K1 on JPEG coefficients: max {err}, "
                             f"{n_diff} samples differ")
    ms_kern, ms_plain = [], []
    for _ in range(2):
        ms_plain += _cuda_ms(lambda: idct_cuda.idct_kron(blocks, qt), 25)
        ms_kern += _cuda_ms(
            lambda: idct_cuda.fused_dequant_idct(blocks, qt), 25)
    med = statistics.median(ms_kern)
    gbs = blocks.numel() * 8 / 1e9 / med * 1e3
    print(f"kernel phase, JPEG coefficients (image (d), {B} x {N} blocks): "
          f"max |kernel - twin| = {err}, {n_diff} of {got.numel()} samples "
          f"differ; fused_dequant_idct median {med:.4f} ms ({gbs:.0f} GB/s, "
          f"{gbs / 3350:.3f} of HBM), idct_kron median "
          f"{statistics.median(ms_plain):.4f} ms; 50 runs each")
    return {"ms": med, "plain_ms": statistics.median(ms_plain),
            "max_abs_err": err, "gb_per_s": gbs}


def _batch_phase(dev, rng) -> tuple[dict, list, list]:
    """The batch path (see the module docstring).  Returns the launches in
    the checked run and the blobs and sources of the batch's 8 images."""
    import torch

    from jpeg_decoder_tpu_torch import BatchDecoder
    from jpeg_decoder_tpu_torch.testing.encoder import encode

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

    torch.cuda.reset_peak_memory_stats()
    with BatchDecoder(device=dev, idct="pallas") as bd:
        _zero_counts()
        items = bd.decode(batch)
        torch.cuda.synchronize()
        counts = _counts()
        bad = [(it.index, it.error) for it in items if not it.ok]
        if bad:
            raise AssertionError(f"items failed: {bad}")
        n_groups = len({id(it.rgb_batch) for it in items})
        print(f"slice: {n_groups} groups, kernel launches in the run "
              f"{counts}")
        # Per group one K6a (the nibble wire) and one K6b (K1's arithmetic
        # inside); K1 itself no more.
        if (counts["K6a"], counts["K6b"], counts["K1"]) != (
                n_groups, n_groups, 0):
            raise AssertionError(f"slice: launches {counts}, {n_groups} "
                                 "groups")
        psnrs = []
        for it, src in zip(items, batch_src):
            rgb = it.rgb
            if rgb.device != dev or tuple(rgb.shape) != src.shape:
                raise AssertionError(
                    f"item {it.index}: {rgb.device} {tuple(rgb.shape)}")
            psnrs.append(_psnr(rgb, src))
        print(f"slice: PSNR vs source min {min(psnrs):.2f} dB, "
              f"max {max(psnrs):.2f} dB")
        if min(psnrs) < MIN_PSNR_DB:
            raise AssertionError(f"PSNR {min(psnrs):.2f} < {MIN_PSNR_DB}")

        # One image of each group against the port's own CPU decode (plain
        # twins): 1080p 4:2:0, 1080p 4:4:4 DRI 8, 1000x750 4:2:0 (edge).
        with BatchDecoder(device="cpu", idct="pallas") as cpu_bd:
            cpu_items = cpu_bd.decode([blobs[k] for k in CPU_CHECKED])
        for k, ci in zip(CPU_CHECKED, cpu_items):
            _close_to_cpu(f"slice: image {k}", items[k].rgb, ci.rgb)
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
        _profile_batch(bd, batch, dev)
    return counts, blobs, sources


def _scan_inputs(blob, dev):
    """Host parse and scan prep of ``blob``, the kernel's inputs on ``dev``
    (the LUTs and first-level tables from the per-device cache)."""
    import torch

    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.ops import entropy_cuda, scan_prep

    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    words, nm, block_comp, max_mcus, lay = scan_prep.prepare_scan(hdr, scan)
    luts, l1 = entropy_cuda.device_tables(hdr, scan, dev)
    kw = dict(block_comp=block_comp, n_comps=len(hdr.components),
              max_mcus=max_mcus, l1=l1)
    args = (torch.from_numpy(words).to(dev), torch.from_numpy(nm).to(dev),
            luts)
    return hdr, scan, lay, args, kw


def _symbols(blocks: np.ndarray) -> int:
    """Huffman symbols a decode of these (n, 64) natural-order blocks
    reads: per block one DC, one per non-zero AC term, one ZRL per 16 zeros
    skipped before a term, and an EOB unless the last term sits at 63."""
    from jpeg_decoder_tpu_torch.types import ZIGZAG

    ac = blocks[:, ZIGZAG[1:]] != 0
    flat = np.flatnonzero(ac)
    blk, pos = flat // 63, flat % 63 + 1
    first = np.r_[True, blk[1:] != blk[:-1]]
    prev = np.where(first, 0, np.r_[0, pos[:-1]])
    last = np.zeros(len(blocks), np.int64)
    last[blk] = pos
    return int(len(blocks) + ac.sum() + ((pos - prev - 1) // 16).sum()
               + (last < 63).sum())


K2_PHASES = {"tables": ("build_l1_kernel",),
             "sync": ("seg_chunks_kernel", "sync_kernel", "seal_kernel"),
             "scan": ("offsets_kernel",), "write": ("write_kernel",)}
CHUNK_SWEEP = (512, 1024, 2048, 4096)
#: The benchmark configurations whose frames the entropy phase adds, by tag.
CELL_FRAMES = {"rtp1080 DRI 120": "rtp1080_service",
               "photo12 DRI 0": "photo12_ingest"}
RTP_TAG = "rtp1080 DRI 120"


def _cell_frames(dev) -> dict:
    """{tag: blob}: one frame of each configuration in
    :data:`CELL_FRAMES`, made by the benchmark's corpus on the card from
    :data:`SEED`."""
    from portbench import corpus, harness

    root = os.path.dirname(os.path.abspath(__file__))
    return {tag: corpus.make_frames(harness.load_json(os.path.join(
        root, "portbench", "configs", f"{name}.json"))["frame"], SEED, 1,
        dev)[0].blob for tag, name in CELL_FRAMES.items()}


def _in_place_form(tag: str, hdr, scan, args, kw, rows: tuple,
                   rows_tail: list, n_blocks: int, twin: bool) -> dict:
    """K2's in-place form, ``decode()``'s on the card, on ``tag``'s scan
    (see the module docstring), held to the row form's launch ``rows``
    (blocks, flags) and its ``rows_tail`` on the same scan; to the twin
    too where ``twin``.  Returns its record: ms, bound_ms (scan bytes and
    offset table in, ``n_blocks`` blocks out), bytes, phases_ms."""
    import torch

    from jpeg_decoder_tpu_torch.ops import entropy_cuda, scan_prep

    dev = args[0].device
    seg, n_words, _, _, _ = scan_prep.segment_table(hdr, scan)
    data = torch.from_numpy(np.asarray(scan.data, np.uint8)).to(dev)
    seg_t = torch.from_numpy(seg).to(dev)
    n_seg = args[0].shape[0]
    words = entropy_cuda.segment_words_torch(data, seg_t[:n_seg + 1],
                                             n_words)
    if words.shape != args[0].shape or not torch.equal(words, args[0]):
        raise AssertionError(f"entropy ({tag}): segment_words_torch "
                             "differs from prepare_scan's rows")
    ikw = dict(kw, n_words=n_words)
    tail = []
    out, err = entropy_cuda.decode_scan_bytes(data, seg_t, args[2], **ikw,
                                              tail=tail)
    same = (torch.equal(out, rows[0]) and torch.equal(err, rows[1])
            and torch.equal(tail[0], rows_tail[0]))
    print(f"entropy ({tag}) in place: blocks, flags, chunks and statistics "
          f"equal to the row form's: {same}")
    if not same or int(err.sum()):
        raise AssertionError(f"entropy ({tag}): in-place form differs")
    if twin:
        t_out, t_err = entropy_cuda.decode_segments_torch(
            words, args[1], args[2],
            **{k: v for k, v in kw.items() if k != "l1"})
        n_twin = int((t_out != out).sum())
        print(f"entropy ({tag}) in place vs twin on segment_words_torch's "
              f"rows: {n_twin} of {out.numel()} coefficients differ")
        if n_twin or not torch.equal(t_err, err):
            raise AssertionError(f"in place vs twin: {n_twin} differ")
    ms = _cuda_ms(lambda: entropy_cuda.decode_scan_bytes(
        data, seg_t, args[2], **ikw), 20, warmup=2)
    nbytes = data.numel() + seg_t.numel() * 8 + n_blocks * 256
    ph = _kernel_ms(lambda: entropy_cuda.decode_scan_bytes(
        data, seg_t, args[2], **ikw), 10, K2_PHASES)
    rec = {"ms": statistics.median(ms), "bound_ms":
           nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
           # The first-level tables come built, as in decode().
           "phases_ms": {k: ph[k] for k in ("sync", "scan", "write",
                                            "other")}}
    print(f"entropy ({tag}) in place (decode()'s form): decode_scan_bytes "
          f"median "
          f"{rec['ms']:.4f} ms (min {min(ms):.4f}, max {max(ms):.4f}, 20 "
          f"runs); bound {rec['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.2f} "
          "MB of scan bytes and offsets in, blocks out at 3.35 TB/s); device "
          "ms per phase (profiler, mean of 10): "
          + ", ".join(f"{k} {_fmt_ms(v)}" for k, v in rec["phases_ms"].items()))
    return rec


def _entropy_phase(dev, images: dict, cells: dict) -> dict:
    """K2 on images (a)-(d), and its in-place form on those and on the
    benchmark cells' frames ``cells`` (see the module docstring)."""
    import torch

    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.ops import entropy_cuda, scan_prep

    max_err, by_image = 0, {}
    C = entropy_cuda.CHUNK_BITS
    blobs = {**{t: b for t, (b, _) in images.items()}, **cells}
    for tag, blob in blobs.items():
        hdr, scan, lay, args, kw = _scan_inputs(blob, dev)
        n_seg, n_words = args[0].shape
        n_blocks = lay.n_mcus * len(kw["block_comp"])
        tail = []
        out, err = entropy_cuda.decode_segments(*args, **kw, tail=tail)
        stats = entropy_cuda.launch_stats(tail[0])
        n_chunks = int(entropy_cuda.seg_chunks(args[0], C).sum())
        ref = torch.from_numpy(native.decode_scan_baseline(hdr, scan))
        got = out.view(-1, 64)[:n_blocks].cpu()
        n_diff = int((got != ref).sum())
        max_err = max(max_err, int((got - ref).abs().max()))
        n_flag = int(err.sum())
        print(f"entropy ({tag}): {n_seg} segments x {n_words} words, "
              f"{n_blocks} blocks, {n_chunks} chunks of C = {C} bits; kernel "
              f"vs native decoder: {n_diff} of {ref.numel()} coefficients "
              f"differ, {n_flag} segments flagged; rounds {stats}")
        if n_diff or n_flag:
            raise AssertionError(f"entropy ({tag}): {n_diff} coefficients "
                                 f"differ, {n_flag} flags")
        ms = _cuda_ms(lambda: entropy_cuda.decode_segments(*args, **kw), 20,
                      warmup=2)
        nbytes = n_words * n_seg * 4 + n_seg * 4 + n_blocks * 256
        host = {}
        for threads in (1, os.cpu_count()):
            native.decode_scan_baseline(hdr, scan, n_threads=threads)
            host[threads] = min(_wall(lambda: native.decode_scan_baseline(
                hdr, scan, n_threads=threads)) for _ in range(3)) * 1e3
        rec = {"ms": statistics.median(ms), "bound_ms":
               nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
               "native_1_ms": host[1], "native_all_ms": host[os.cpu_count()]}
        syms = _symbols(ref.numpy())
        print(f"entropy ({tag}): {syms} symbols, {syms / n_chunks:.0f} per "
              f"chunk; row form (the batch routes'): decode_segments median "
              f"{rec['ms']:.4f} ms (min "
              f"{min(ms):.4f}, max {max(ms):.4f}, 20 runs; "
              f"{rec['ms'] * 1e6 / syms:.2f} ns per symbol over the image); "
              f"bound {rec['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB "
              "of words in and blocks out at 3.35 TB/s); host comparison, "
              f"native decoder best of 3: 1 thread {host[1]:.2f} ms, "
              f"{os.cpu_count()} threads {host[os.cpu_count()]:.2f} ms; "
              f"kernel {'below' if rec['ms'] < host[1] else 'NOT below'} "
              "the 1-thread host decoder")
        # Device time per phase (profiler); tables = a cold first-level
        # build, which the per-device cache does once per table set.
        ph = _kernel_ms(lambda: entropy_cuda.decode_segments(*args, **kw),
                        10, K2_PHASES)
        ph["tables"] = _kernel_ms(lambda: entropy_cuda.first_level(args[2]),
                                  10, K2_PHASES)["tables"]
        print(f"entropy ({tag}): device ms per phase (profiler, mean of 10): "
              + ", ".join(f"{k} {_fmt_ms(ph[k])}" for k in K2_PHASES)
              + f", other {_fmt_ms(ph['other'])} "
              f"({', '.join(ph['other_names'])})")
        rec["phases_ms"] = {k: ph[k] for k in (*K2_PHASES, "other")}
        rec["rounds"] = stats
        rec["in_place"] = _in_place_form(
            tag, hdr, scan, args, kw, (out, err), tail, n_blocks,
            twin=tag in ("b", RTP_TAG))
        if tag not in images:
            by_image[tag] = rec
            continue
        # Chunk size sweep: same output, median of 10 runs each.
        sweep = {}
        for cb in CHUNK_SWEEP:
            o2, e2 = entropy_cuda.decode_segments(*args, **kw, chunk_bits=cb)
            if not torch.equal(o2, out) or int(e2.sum()):
                raise AssertionError(f"entropy ({tag}): C = {cb} differs")
            sweep[cb] = statistics.median(_cuda_ms(
                lambda cb=cb: entropy_cuda.decode_segments(
                    *args, **kw, chunk_bits=cb), 10, warmup=1))
        print(f"entropy ({tag}): chunk sweep, median ms of 10 (same output "
              "each): " + ", ".join(f"C={k} {v:.4f}" for k, v in
                                    sweep.items()))
        rec["sweep_ms"] = sweep
        if tag == "b":
            twin, twin_err = entropy_cuda.decode_segments_torch(
                *args, **{k: v for k, v in kw.items() if k != "l1"})
            n_twin = int((twin != out).sum())
            print(f"entropy ({tag}): kernel vs twin: {n_twin} of "
                  f"{out.numel()} coefficients differ")
            if n_twin or int(twin_err.sum()):
                raise AssertionError(f"kernel vs twin: {n_twin} differ")
            plain = _cuda_ms(lambda: entropy_cuda.decode_segments_torch(
                *args, **{k: v for k, v in kw.items() if k != "l1"}), 3,
                warmup=1)
            rec["plain_ms"] = statistics.median(plain)
            print(f"entropy ({tag}): decode_segments_torch median "
                  f"{rec['plain_ms']:.1f} ms (3 runs)")
            # Corrupt copy: bytes inverted at 12 places in the middle half
            # of the scan, and one segment of all ones (a window no
            # standard code takes).
            bad_scan = copy.copy(scan)
            data = scan.data.copy()
            n = len(data)
            for p in np.linspace(n // 4, 3 * n // 4, 12).astype(int):
                data[p:p + 16] ^= 0xFF
            bad_seg = n_seg // 2
            lo, hi = scan.seg_offsets[bad_seg:bad_seg + 2]
            data[lo:hi] = 0xFF
            bad_scan.data = data
            words, nm, _, _, _ = scan_prep.prepare_scan(hdr, bad_scan)
            bad_args = (torch.from_numpy(words).to(dev), args[1], args[2])
            _, k_err = entropy_cuda.decode_segments(*bad_args, **kw)
            _, t_err = entropy_cuda.decode_segments_torch(
                *bad_args, **{k: v for k, v in kw.items() if k != "l1"})
            seg, bad_words, _, _, _ = scan_prep.segment_table(hdr, bad_scan)
            _, i_err = entropy_cuda.decode_scan_bytes(
                torch.from_numpy(data).to(dev), torch.from_numpy(seg).to(dev),
                args[2], n_words=bad_words, **kw)
            flagged = torch.nonzero(k_err).flatten().tolist()
            same = torch.equal(k_err, t_err) and torch.equal(i_err, t_err)
            print(f"entropy ({tag}) corrupt copy: kernel flags {len(flagged)}"
                  f" segments {flagged[:12]}, twin flags "
                  f"{int(t_err.sum())}, in-place form "
                  f"{int(i_err.sum())}; all equal: {same}")
            if not same or bad_seg not in flagged:
                raise AssertionError("corrupt stream: flags differ")
        by_image[tag] = rec
    b = by_image["b"]
    return {"name": "decode_segments", "route": "cuda",
            "source": "jpeg_decoder_tpu_torch/csrc/entropy.cu",
            "replaces": "jpeg_decoder_tpu/ops/entropy_pallas.py:178",
            "max_abs_err": max_err, "ms": b["ms"], "plain_ms": b["plain_ms"],
            "bound_ms": b["bound_ms"], "bound_by": "bytes",
            "in_place_ms": b["in_place"]["ms"],
            "in_place_bound_ms": b["in_place"]["bound_ms"],
            "library_ms": None, "chunk_bits": C,
            "by_image": {t: {k: v for k, v in r.items() if k != "bytes"}
                         for t, r in by_image.items()}}


def _decode_phase(dev, images: dict) -> dict:
    """The single-image path on (a)-(d) (see the module docstring).
    Returns the kernel counts of the checked run."""
    import torch

    from jpeg_decoder_tpu_torch import decode
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.models import decoder as dec_mod
    from jpeg_decoder_tpu_torch.ops import entropy_cuda, pixel, scan_prep

    kw = dict(entropy="pallas", idct="pallas", upsample="fancy", device=dev)
    _zero_counts()
    results, per_image = {}, {}
    for tag, (blob, _) in images.items():
        before = _counts()
        results[tag] = decode(blob, **kw)
        torch.cuda.synchronize()
        per_image[tag] = {k: v - before[k] for k, v in _counts().items()}
    counts = _counts()
    print(f"decode(): kernel launches in the run {counts}, per image "
          f"{per_image}")
    for tag, c in per_image.items():
        if c["K2"] != 1 or c["K6b"] != 1 or c["K1"]:
            raise AssertionError(f"decode() ({tag}): launches {c}")
    for tag, (blob, src) in images.items():
        rgb = results[tag].rgb
        if rgb.device != dev or tuple(rgb.shape) != src.shape:
            raise AssertionError(f"decode() ({tag}): {rgb.device} "
                                 f"{tuple(rgb.shape)}")
        psnr = _psnr(rgb, src)
        print(f"decode() ({tag}): PSNR vs source {psnr:.2f} dB")
        if psnr < MIN_PSNR_DB:
            raise AssertionError(f"PSNR {psnr:.2f} < {MIN_PSNR_DB}")
        cpu = decode(blob, entropy="native", idct="pallas",
                     upsample="fancy", device="cpu")
        _close_to_cpu(f"decode() ({tag})", rgb, cpu.rgb)
    del results

    for tag, (blob, src) in images.items():
        mp = src.shape[0] * src.shape[1] / 1e6
        e2e = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = decode(blob, **kw)
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - t0)
            del out
        # Stages, best of 3: the same calls decode() makes on the card, one
        # by one (K2 reads the scan in place); the copy once with the
        # per-device table cache cleared (LUT upload and first-level build
        # included) and once warm.
        st = {"parse": [], "scan prep": [], "copy (cold tables)": [],
              "copy (warm)": [], "K2": [], "pixel": []}
        for _ in range(3):
            t0 = time.perf_counter()
            hdr = parser.parse(blob)
            t1 = time.perf_counter()
            seg, n_words, bc, mm, lay = scan_prep.segment_table(
                hdr, hdr.scans[0])
            t2 = time.perf_counter()
            copies = {}
            for name in ("copy (cold tables)", "copy (warm)"):
                if name == "copy (cold tables)":
                    entropy_cuda.clear_table_cache()
                torch.cuda.synchronize()
                c0 = time.perf_counter()
                td = torch.from_numpy(np.asarray(hdr.scans[0].data,
                                                 np.uint8)).to(dev)
                ts = torch.from_numpy(seg).to(dev)
                luts, l1 = entropy_cuda.device_tables(hdr, hdr.scans[0], dev)
                torch.cuda.synchronize()
                copies[name] = time.perf_counter() - c0
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            out, _ = entropy_cuda.decode_scan_bytes(
                td, ts, luts, n_words=n_words, block_comp=bc,
                n_comps=len(hdr.components), max_mcus=mm, l1=l1)
            ev[1].record()
            rgb = pixel.pixel_pipeline_from_scan(
                out.view(-1, 64)[: lay.n_mcus * len(bc)],
                tuple(torch.from_numpy(hdr.quant_tables[c.tq].values
                                       .astype(np.int32)).to(dev)
                      for c in hdr.components),
                dec_mod._comp_srcs(hdr, dev),
                comp_shapes=tuple(lay.comp_shapes), height=hdr.height,
                width=hdr.width,
                samplings=tuple((hdr.v_max // c.v, hdr.h_max // c.h)
                                for c in hdr.components),
                idct="pallas", upsample="fancy", color=hdr.colorspace)
            ev[2].record()
            ev[2].synchronize()
            for name, v in (("parse", t1 - t0), ("scan prep", t2 - t1),
                            *copies.items()):
                st[name].append(v * 1e3)
            st["K2"].append(ev[0].elapsed_time(ev[1]))
            st["pixel"].append(ev[1].elapsed_time(ev[2]))
            del out, rgb
        runs = [round(t * 1e3, 2) for t in e2e]
        print(f"decode() ({tag}): end to end {runs} ms -> "
              f"{min(e2e) * 1e3:.2f} ms, {mp / min(e2e):.1f} MP/s "
              "(best of 3) to device-resident RGB; stages (best of 3): "
              + ", ".join(f"{k} {min(v):.3f} ms" for k, v in st.items()))
    return counts


def _probe_phase(dev) -> list[dict]:
    """K3 and K4 (see the module docstring)."""
    import torch

    from jpeg_decoder_tpu_torch.probes import lut_probe

    lut = torch.arange(lut_probe.LUT_SIZE, dtype=torch.int32, device=dev)
    idx = torch.tensor(lut_probe.CHAIN_IDX, dtype=torch.int32,
                       device=dev).view(8, 1)
    expected = lut_probe.chain_expected(lut_probe.CHAIN_IDX)
    got = int(lut_probe.lut_chain_probe(lut, idx))
    chain_err = abs(got - expected)
    print(f"probe: lut_chain_probe {got}, expected {expected}")
    if chain_err:
        raise AssertionError(f"lut_chain_probe {got} != {expected}")
    ms_k3 = _cuda_ms(lambda: lut_probe.lut_chain_probe(lut, idx), 50)
    ms_k3_plain = _cuda_ms(lambda: lut_probe.lut_chain_torch(lut, idx), 20)

    rng = np.random.default_rng(0)   # the JAX file's draw
    gidx = torch.from_numpy(rng.integers(0, 65536, (8, 128),
                                         np.int32)).to(dev)
    gidx64 = gidx.to(torch.int64)
    out = lut_probe.lut_gather(lut, gidx)
    gather_err = int((out - lut[gidx64]).abs().max())
    print(f"probe: lut_gather max |kernel - lut[idx]| = {gather_err}")
    if gather_err:
        raise AssertionError("lut_gather != lut[idx]")
    ms_k4 = _cuda_ms(lambda: lut_probe.lut_gather(lut, gidx), 50)
    ms_k4_plain = _cuda_ms(lambda: lut_probe.lut_gather_torch(lut, gidx), 50)
    ms_k4_lib = _cuda_ms(lambda: torch.take(lut, gidx64), 50)
    # Bytes this run's data needs: the indices read, the LUT entries they
    # touch (each distinct entry once), the output written.
    k3_bytes = 8 * 4 + len(set(lut_probe.CHAIN_IDX)) * 4 + 4
    k4_bytes = gidx.numel() * 8 + int(torch.unique(gidx).numel()) * 4
    med = statistics.median
    # The kernels' own device time, not the wrapper's: a tiny kernel
    # leaves the card idle between two events, so 50 launches are queued
    # behind a spin and timed together (median of 3); the library call and
    # a kernel that does nothing (a spin of 0 cycles, the floor under all
    # three) the same way.
    def dev_ms(fn):
        return med([_queued_ms(fn, 50) for _ in range(3)])
    dev_k3 = dev_ms(lambda: lut_probe.lut_chain_probe(lut, idx))
    dev_k4 = dev_ms(lambda: lut_probe.lut_gather(lut, gidx))
    dev_take = dev_ms(lambda: torch.take(lut, gidx64))
    dev_empty = dev_ms(lambda: torch.cuda._sleep(0))
    print(f"probe: lut_chain_probe device {dev_k3 * 1e3:.2f} us per launch "
          f"(50 launches queued behind a spin, CUDA events, median of 3; "
          f"wrapper median {med(ms_k3):.4f} ms by CUDA events, twin "
          f"{med(ms_k3_plain):.4f} ms); lut_gather device "
          f"{dev_k4 * 1e3:.2f} us (wrapper median {med(ms_k4):.4f} ms, twin "
          f"{med(ms_k4_plain):.4f} ms, torch.take {med(ms_k4_lib):.4f} ms); "
          "CUDA events, 50 runs (twin of the chain 20); torch.take device "
          f"{dev_take * 1e3:.2f} us (queued, like lut_gather's); an empty "
          f"kernel's device time {dev_empty * 1e3:.2f} us (the same way): "
          "the floor under all three")
    return [
        {"name": "lut_chain_probe", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/lut_probe.cu",
         "replaces": "tools/pallas_mosaic_repro.py:45",
         "max_abs_err": chain_err, "ms": dev_k3, "empty_kernel_ms": dev_empty,
         "wrapper_ms": med(ms_k3), "plain_ms": med(ms_k3_plain),
         "bound_ms": k3_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
        {"name": "lut_gather", "route": "cuda",
         "source": "jpeg_decoder_tpu_torch/csrc/lut_probe.cu",
         "replaces": "tools/pallas_mosaic_repro.py:104",
         "max_abs_err": gather_err, "ms": dev_k4, "empty_kernel_ms": dev_empty,
         "wrapper_ms": med(ms_k4), "plain_ms": med(ms_k4_plain),
         "bound_ms": k4_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": dev_take, "library_wrapper_ms": med(ms_k4_lib)},
    ]


def _profile(windows: dict, ours: tuple) -> None:
    """For each window: the sum of device kernel time, the wall time of the
    window under the profiler and their ratio (one stream, so kernels do
    not overlap), then the ops by device time and the port's kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
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
              f"{dev_ms / wall_ms:.3f}, a lower bound: the profiler can "
              "lose kernel records)")
        ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
        mine = [e for e in kernels if any(k in e.key for k in ours)]
        for e in ops[:12] + mine:
            ms = e.self_device_time_total / 1e3
            print(f"  {e.key[:60]:<60} x{e.count:<5} {ms:9.3f} ms "
                  f"{100 * ms / dev_ms:5.1f}%")


def _profile_batch(bd, batch: list[bytes], dev) -> None:
    """Breakdown of the smoke batch, after the checked run: window 1 is the
    device pixel stage of one batch (every group, inputs already on the
    card), window 2 one whole ``decode``.  Last, host entropy against the
    size of the host thread pool."""
    from jpeg_decoder_tpu_torch import BatchDecoder

    groups = bd.group(bd.host_stage(batch))
    tensors = [bd.to_device(g) for g in groups]
    _profile({
        f"device pixel stage, {len(groups)} groups":
            lambda: [bd.pixels(g, t) for g, t in zip(groups, tensors)],
        "whole decode": lambda: bd.decode(batch),
    }, ("fused_dequant_idct", "nibble_", "blocks_to_rgb_kernel"))
    for k in (1, 2, 4, 8):
        with BatchDecoder(device=dev, idct="pallas",
                          host_threads=k) as pool_bd:
            pool_bd.host_stage(batch)
            best = min(_wall(lambda: pool_bd.host_stage(batch))
                       for _ in range(3))
        print(f"profile [host entropy, {k} pool threads]: best of 3 "
              f"{best * 1e3:.1f} ms")


WIRE_NAMES = ("nibble", "sparse", "packed", "slots")


def _n_rgb_differ(items_a, items_b) -> int:
    """Images whose RGB differ between two decodes of the same blobs."""
    import torch

    return sum(not torch.equal(a.rgb, b.rgb) for a, b in zip(items_a, items_b)
               if a.ok or b.ok)


def _e2e(bd, blobs, n: int = 3, **kw) -> list[float]:
    """Seconds of ``n`` whole ``bd.decode(blobs)`` runs, each ending in a
    device synchronise."""
    import torch

    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        items = bd.decode(blobs, **kw)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        del items
    return out


def _same_blocks(a, b) -> bool:
    """Two unpacks of one group agree: equal on the images and blocks both
    hold, zero on the rest (the nibble wire's K6a returns only the true
    images' blocks that the pixels read, the other wires the whole
    bucket)."""
    import torch

    n, m = min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1])
    return torch.equal(a[:n, :m], b[:n, :m]) and not any(
        bool(x[n:].any()) or bool(x[:, m:].any()) for x in (a, b))


def _wires_phase(dev, batch: list[bytes], mp: float) -> tuple[dict, list]:
    """The 32-image batch through every wire: each wire's unpacked blocks
    and RGB must equal the nibble wire's bit for bit, K6b must launch 3
    times (one a group), K6a 3 times on the nibble wire and 0 on the
    others, K1 never; per wire the wire MB copied, the host
    stages, the device unpack (profiler), the pixel stage (CUDA events) and
    end-to-end MP/s.  Returns the per-wire records and the nibble wire's
    items."""
    import torch

    from jpeg_decoder_tpu_torch import BatchDecoder

    ref_items, ref_blocks, recs = None, None, {}
    for wire in WIRE_NAMES:
        with BatchDecoder(device=dev, wire=wire, idct="pallas") as bd:
            bd.decode(batch)                      # warm-up
            torch.cuda.synchronize()
            _zero_counts()
            items = bd.decode(batch)
            torch.cuda.synchronize()
            c = _counts()
            k1 = {k: c[k] for k in ("K1", "K6a", "K6b")}
            bad = [(it.index, it.error) for it in items if not it.ok]
            n_groups = len({id(it.rgb_batch) for it in items})
            want = {"K1": 0, "K6a": 3 if wire == "nibble" else 0, "K6b": 3}
            if bad or n_groups != 3 or k1 != want:
                raise AssertionError(f"wire {wire}: failed {bad}, "
                                     f"{n_groups} groups, launches {k1}")
            groups = bd.group(bd.host_stage(batch))
            tensors = [bd.to_device(g) for g in groups]
            blocks = [bd.unpack(g, t) for g, t in zip(groups, tensors)]
            torch.cuda.synchronize()
            if ref_items is None:
                ref_items, ref_blocks = items, blocks
                n_rgb = n_blk = 0
            else:
                n_rgb = _n_rgb_differ(ref_items, items)
                n_blk = sum(not _same_blocks(a, b)
                            for a, b in zip(ref_blocks, blocks))
            if n_rgb or n_blk:
                raise AssertionError(f"wire {wire}: {n_rgb} images' RGB and "
                                     f"{n_blk} groups' blocks differ from "
                                     "the nibble wire's")
            del items, blocks
            wire_mb = sum(x.nbytes for g in groups for x in g.arrays) / 1e6
            unpack_ms = _kernel_ms(
                lambda: [bd.unpack(g, t) for g, t in zip(groups, tensors)],
                5, {"unpack": ("",)})["unpack"]
            st = {"host entropy": [], "group+pad": [], "copy": [],
                  "pixel stage": []}
            for _ in range(2):
                t0 = time.perf_counter()
                host_out = bd.host_stage(batch)
                t1 = time.perf_counter()
                gs = bd.group(host_out)
                t2 = time.perf_counter()
                ts = [bd.to_device(g) for g in gs]
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                rgbs = [bd.pixels(g, t) for g, t in zip(gs, ts)]
                ev[1].record()
                ev[1].synchronize()
                for k, v in zip(st, ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                     (t3 - t2) * 1e3,
                                     ev[0].elapsed_time(ev[1]))):
                    st[k].append(v)
                del rgbs, ts
            e2e = _e2e(bd, batch)
            del groups, tensors
        rec = {k: min(v) for k, v in st.items()}
        rec.update({"wire_mb": wire_mb, "device_unpack_ms": unpack_ms,
                    "mp_per_s": mp / min(e2e), "launches": c})
        recs[wire] = rec
        print(f"wire {wire}: {wire_mb:.2f} MB copied; host entropy "
              f"{rec['host entropy']:.1f} ms, group+pad "
              f"{rec['group+pad']:.1f} ms, copy {rec['copy']:.2f} ms, "
              f"device unpack {_fmt_ms(unpack_ms)} ms (profiler, mean of 5), "
              f"pixel stage {rec['pixel stage']:.1f} ms (events; stages best "
              f"of 2); end to end {[round(t, 4) for t in e2e]} s -> "
              f"{rec['mp_per_s']:.1f} MP/s (best of 3); launches {k1}; "
              f"blocks and RGB equal to the nibble wire's")
    return recs, ref_items


def _pallas_batch_phase(dev, batch: list[bytes], ref_items, mp: float):
    """The batch under ``entropy="pallas"``: K2 once per image (its blocks
    come back to the host and ride the nibble wire, as in the JAX package),
    RGB bit-identical to the native backend's.  Returns the counts."""
    import torch

    from jpeg_decoder_tpu_torch import BatchDecoder

    with BatchDecoder(device=dev, entropy="pallas",
                      idct="pallas") as bd:
        bd.decode(batch)                          # warm-up, table cache
        torch.cuda.synchronize()
        _zero_counts()
        items = bd.decode(batch)
        torch.cuda.synchronize()
        counts = _counts()
        n_rgb = _n_rgb_differ(ref_items, items)
        bad = [it.index for it in items if not it.ok]
        if bad or counts["K2"] != len(batch) or n_rgb:
            raise AssertionError(f"entropy=pallas batch: failed {bad}, "
                                 f"launches {counts}, {n_rgb} images differ")
        del items
        e2e = _e2e(bd, batch)
        host = min(_wall(lambda: bd.host_stage(batch)) for _ in range(2))
    print(f"batch, entropy=pallas: launches {counts}; RGB equal to "
          f"entropy=native on all {len(batch)} images; host stage (K2 per "
          f"image from {bd.host_threads} pool threads, blocks back to the "
          f"host, nibble encode) {host * 1e3:.1f} ms; end to end "
          f"{[round(t, 4) for t in e2e]} s -> {mp / min(e2e):.1f} MP/s "
          "(best of 3)")
    return counts


def _batch_k7_staged(dev, batch: list[bytes]) -> None:
    """Each distinct DRI-0 image of ``batch`` through the scan decode the
    ``hybrid`` batch runs per image (``decoder._decode_scan_robust``, one
    K7 launch): no lane group over the staging budget."""
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.models import decoder as dec_mod

    seen = set()
    for blob in batch:
        hdr = parser.parse(blob)
        scan = hdr.scans[0]
        if blob in seen or scan.restart_interval or len(scan.seg_offsets) != 2:
            continue
        seen.add(blob)
        dec_mod._decode_scan_robust(hdr, scan, "hybrid", dev)
        _k7_all_staged(f"batch hybrid {hdr.width}x{hdr.height}")
    print(f"batch, entropy=hybrid: K7 staged every lane group on each of the "
          f"{len(seen)} distinct DRI-0 images (0 over budget)")


def _lanes_batch_phase(dev, batch: list[bytes], ref_items,
                       mp: float) -> dict:
    """The batch under ``entropy="hybrid"`` and ``"jax"`` (``idct="pallas"``):
    hybrid decodes each DRI-0 image with K7 (28) and the DRI-8 ones with K2
    (4), jax all 32 with K2; the blocks come back to the host and ride the
    nibble wire; RGB bit-identical to ``entropy="native"``'s.  Returns the
    counts by backend."""
    import torch

    from jpeg_decoder_tpu_torch import BatchDecoder

    want = {"hybrid": {"K7": 28, "K2": 4}, "jax": {"K7": 0, "K2": 32}}
    out = {}
    for entropy in ("hybrid", "jax"):
        with BatchDecoder(device=dev, entropy=entropy, idct="pallas") as bd:
            bd.decode(batch)                      # warm-up, table cache
            torch.cuda.synchronize()
            _zero_counts()
            items = bd.decode(batch)
            torch.cuda.synchronize()
            counts = _counts()
            n_rgb = _n_rgb_differ(ref_items, items)
            bad = [it.index for it in items if not it.ok]
            got = {k: counts[k] for k in want[entropy]}
            if (bad or n_rgb or got != want[entropy] or counts["K6b"] != 3
                    or counts["K1"]):
                raise AssertionError(f"entropy={entropy} batch: failed "
                                     f"{bad}, launches {counts}, {n_rgb} "
                                     "images differ")
            del items
            if entropy == "hybrid":
                _batch_k7_staged(dev, batch)
            e2e = _e2e(bd, batch)
            host = min(_wall(lambda: bd.host_stage(batch)) for _ in range(2))
        out[entropy] = counts
        print(f"batch, entropy={entropy} idct=pallas: launches {counts}; RGB "
              f"equal to entropy=native on all {len(batch)} images; host "
              f"stage (device entropy per image from {bd.host_threads} pool "
              f"threads, blocks back to the host, nibble encode) "
              f"{host * 1e3:.1f} ms; end to end "
              f"{[round(t, 4) for t in e2e]} s -> {mp / min(e2e):.1f} MP/s "
              "(best of 3)")
    return out


def _k7_inputs(hdr, scans, dev, target_steps=None):
    """K7's inputs for same-geometry ``scans``: ``entropy_spec.device_plan``
    (or ``target_steps`` paired steps per lane, no lane cap), the LUTs and
    first levels on ``dev``.  Returns (args, kw, l1, plan)."""
    import torch

    from jpeg_decoder_tpu_torch.ops import entropy_cuda, entropy_spec

    n_mcus = hdr.mcus_x * hdr.mcus_y
    if target_steps is None:
        plan = entropy_spec.device_plan(hdr, scans, threads=1)
    else:
        plan = entropy_spec.prepare_hybrid_batch_emit(
            hdr, scans, threads=1, max_chunks=n_mcus,
            target_steps=target_steps)
    pools, starts, nm, lane_off, t_sym, _, _, seg_first, ok = plan
    if not ok.all():
        raise AssertionError("K7 plan: a skeleton walk failed")
    luts, l1 = entropy_cuda.device_tables(hdr, scans[0], dev)
    args = tuple(torch.from_numpy(a).to(dev) for a in (
        pools, starts, nm, lane_off, seg_first)) + (luts,)
    kw = dict(block_comp=entropy_spec._block_comp(hdr),
              n_comps=len(hdr.components), n_mcus=n_mcus, trips=t_sym,
              precision=hdr.precision)
    return args, kw, l1, plan


def _launch_list(fn, n: int = 3) -> str:
    """The kernels one call of ``fn`` launches on the card, by name, with
    launches per call (``_cuda_events`` over ``n`` calls)."""
    evs, whole = _cuda_events(fn, n)
    if not evs:
        return "not recorded"
    return ", ".join(f"{e.key[:60]} x{e.count / n:g}" for e in sorted(
        evs, key=lambda e: e.key)) + ("" if whole else " (records lost)")


def _k7_all_staged(what: str) -> None:
    """Raises unless K7's last launch (``decode_lanes.last_stats``) staged
    every lane group's words: no group over the staging budget."""
    from jpeg_decoder_tpu_torch.ops import entropy_emit_cuda as k7

    st = dict(zip(k7.STATS, k7.decode_lanes.last_stats.tolist()))
    if st["groups_over_budget"] or not st["groups_staged"]:
        raise AssertionError(f"{what}: K7 staging counters {st}")


def _k7_launcher(args, kw, l1, group_lanes=None, budget_words=None):
    """One K7 launch through ``entropy_emit_cuda.launch`` on preallocated
    buffers (no wrapper checks, no count): ``fn()`` zero-fills the scratch
    and launches.  The group size and staging budget are
    ``decode_lanes``' schedule unless given (a given group size gets its own
    ``staging_words``, cut to what fits the CTA).  Returns (fn, out,
    scratch, (group_lanes, budget_words))."""
    from jpeg_decoder_tpu_torch.ops import entropy_emit_cuda as k7

    pools, starts, luts = args[0], args[1], args[5]
    lanes, budget = k7.schedule(pools.shape[0], pools.shape[1],
                                starts.shape[1], luts.shape[0],
                                k7._n_sms(pools.device))
    if group_lanes is not None:
        lanes = group_lanes
        cap = (k7.SMEM_LIMIT - k7.smem_bytes(lanes, 0, luts.shape[0])
               ) // 16 * 4
        budget = min(cap, k7.staging_words(lanes, pools.shape[1],
                                           starts.shape[1]))
    if budget_words is not None:
        budget = budget_words
    out, scratch = k7.buffers(pools, starts, kw["n_mcus"],
                              len(kw["block_comp"]), lanes)
    full = args + (l1,)

    def fn():
        scratch.zero_()
        k7.launch(full, out, scratch, group_lanes=lanes,
                  budget_words=budget, **kw)
    return fn, out, scratch, (lanes, budget)


def _k7_turns(what: str, args, kw, l1, refs: list, plain: bool = True,
              variants: bool = True, n: int = 20) -> dict:
    """The new K7 and its first form (``testing/emit_v1.py``) on the same
    inputs: both outputs equal to the native decoder's blocks ``refs`` (one
    per image) and, when ``plain``, to ``decode_lanes_torch`` on the card,
    flags included; the new kernel's counters (no group over the staging
    budget).  Both timed in turns (first form, new, new, first form):
    CUDA events around one wrapper call (median of ``n`` each: what a
    caller waits, host work included), device time (``_queued_ms``: ``n``
    launches queued behind a spin, median of 3 such runs each, the first
    form's zero-fills and carry included; its emit and carry launches also
    apart) and the device time of one call queued alone behind the spin
    (median of 6).  The kernels one wrapper call launches, by name
    (torch.profiler).  The byte bound (pools and plan read once,
    blocks written once) and each one's share of it by device time.  With
    ``variants``, the new kernel also with every group over a 4-word
    staging budget (all stream words from device memory; the counters
    must show it) and at the other group sizes, each equal to the native
    decoder."""
    import torch

    from jpeg_decoder_tpu_torch.ops import entropy_emit_cuda as k7
    from jpeg_decoder_tpu_torch.testing import emit_v1

    med = statistics.median
    n_img = args[0].shape[0]
    refs = [r.cpu() for r in refs]

    def check(label, out, err):
        for i, ref in enumerate(refs):
            if int(err[i]) or not torch.equal(out[i].cpu(), ref):
                raise AssertionError(f"K7 {what} {label} image {i}: differs "
                                     "from the native decoder (flag "
                                     f"{int(err[i])})")

    out, err = k7.decode_lanes(*args, **kw, l1=l1)
    torch.cuda.synchronize()
    st = dict(zip(k7.STATS, k7.decode_lanes.last_stats.tolist()))
    check("new", out, err)
    o1, e1 = emit_v1.decode_lanes_v1(*args, **kw, l1=l1)
    torch.cuda.synchronize()
    check("first form", o1, e1)
    max_err = 0
    if plain:
        p_out, p_err = k7.decode_lanes_torch(*args, **kw)
        max_err = int((p_out - out).abs().max())
        if max_err or not torch.equal(p_err, err):
            raise AssertionError(f"K7 {what}: differs from "
                                 "decode_lanes_torch")
        del p_out
    if st["groups_over_budget"]:
        raise AssertionError(f"K7 {what}: groups over the staging budget "
                             f"{st}")
    del out, o1
    half = max(1, n // 2)
    new, old = [], []
    v1_wrap = lambda: emit_v1.decode_lanes_v1(*args, **kw, l1=l1)  # noqa: E731
    new_wrap = lambda: k7.decode_lanes(*args, **kw, l1=l1)  # noqa: E731
    for bucket, fn in ((old, v1_wrap), (new, new_wrap), (new, new_wrap),
                       (old, v1_wrap)):
        bucket.extend(_cuda_ms(fn, half, warmup=2))
    new_fn, _, _, sched = _k7_launcher(args, kw, l1)
    bufs = emit_v1.buffers(args[0], args[1], kw["n_mcus"],
                           len(kw["block_comp"]))
    v1_args = args + (l1, *bufs)

    def v1_fn():
        for t in bufs:
            t.zero_()
        for entry in emit_v1.PHASES:
            emit_v1.launch(v1_args, entry, **kw)
    dev_new, dev_old, one_new, one_old = [], [], [], []
    for _ in range(3):
        for bucket, fn in ((dev_old, v1_fn), (dev_new, new_fn),
                           (dev_new, new_fn), (dev_old, v1_fn)):
            bucket.append(_queued_ms(fn, n))
    for _ in range(3):
        for bucket, fn in ((one_old, v1_fn), (one_new, new_fn),
                           (one_new, new_fn), (one_old, v1_fn)):
            bucket.append(_queued_ms(fn, 1))
    calls = {"new": _launch_list(new_wrap), "first form": _launch_list(
        v1_wrap)}
    v1_ph = {ph: med([_queued_ms(lambda ph=ph: emit_v1.launch(
        v1_args, ph, **kw), n) for _ in range(3)]) for ph in emit_v1.PHASES}
    del bufs, v1_args
    pools, starts = args[0], args[1]
    n_blocks = n_img * kw["n_mcus"] * len(kw["block_comp"])
    nbytes = (sum(t.numel() * t.element_size() for t in args[:5])
              + n_blocks * 256)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    d_new, d_old = med(dev_new), med(dev_old)
    rec = {"ms": med(new), "v1_ms": med(old), "device_ms": d_new,
           "v1_device_ms": d_old, "single_launch_ms": med(one_new),
           "v1_single_launch_ms": med(one_old),
           "v1_emit_device_ms": v1_ph["jd_emit_decode"],
           "v1_carry_device_ms": v1_ph["jd_emit_carry"], "bound_ms": bound,
           "share_of_bound": bound / d_new,
           "v1_share_of_bound": bound / d_old,
           "ns_per_trip": d_new * 1e6 / max(1, kw["trips"]),
           "images": n_img, "lanes": int((args[2] > 0).sum()),
           "C": starts.shape[1], "T_sym": kw["trips"],
           "group_lanes": sched[0], "budget_words": sched[1],
           "ctas_per_sm": k7.ctas_per_sm(sched[0], sched[1],
                                         args[5].shape[0]),
           "max_abs_err": max_err, **st}
    print(f"K7 {what}: device time (queued, median of 3 x {n} launches "
          f"each, in turns) new {d_new:.4f} ms, first form {d_old:.4f} ms "
          f"(emit {rec['v1_emit_device_ms']:.4f} + carry "
          f"{rec['v1_carry_device_ms']:.4f} + zero-fills): "
          f"{d_old / d_new:.2f}x; one call alone behind the spin (median "
          f"of 6) new {rec['single_launch_ms']:.4f} ms, first form "
          f"{rec['v1_single_launch_ms']:.4f} ms; per call with the wrapper "
          f"(CUDA events, "
          f"median of {2 * half} each, in turns) new {rec['ms']:.4f} ms, "
          f"first form {rec['v1_ms']:.4f} ms; bound {bound * 1e3:.2f} us "
          f"(bytes) = {100 * rec['share_of_bound']:.2f}% / "
          f"{100 * rec['v1_share_of_bound']:.2f}% of the device times; "
          f"{n_img} image(s), {rec['lanes']} lanes (C = {rec['C']}), T = "
          f"{kw['trips']}, {rec['ns_per_trip']:.1f} ns per trip; groups of "
          f"{sched[0]} lanes, budget {sched[1]} words, "
          f"{rec['ctas_per_sm']} CTAs/SM; staged {st['groups_staged']}, "
          f"over budget {st['groups_over_budget']}, LUT misses "
          f"{st['lut_misses']}; outputs equal to the native decoder"
          + (" and to decode_lanes_torch" if plain else ""))
    print(f"K7 {what}: kernels one wrapper call launches (torch.profiler, "
          "per call): " + "; ".join(f"{k}: {v}" for k, v in calls.items()))
    if not variants:
        return rec
    runs = {"budget 4 words": {"budget_words": 4}}
    runs.update({f"groups of {g}": {"group_lanes": g}
                 for g in k7.GROUP_LANES if g != sched[0]})
    rec["variants"] = {}
    for label, opt in runs.items():
        fn, o, sc, (g, bw) = _k7_launcher(args, kw, l1, **opt)
        fn()
        torch.cuda.synchronize()
        check(label, o, sc[:n_img])
        st_v = k7.stats(sc, n_img)
        if "budget_words" in opt and not st_v["groups_over_budget"]:
            raise AssertionError(f"K7 {what} {label}: no group over budget")
        ms = med([_queued_ms(fn, n) for _ in range(3)])
        rec["variants"][label] = {"device_ms": ms, "x_new": ms / d_new,
                                  "group_lanes": g, "budget_words": bw,
                                  **st_v}
        del o, sc
    print(f"K7 {what} variants (device time, queued, median of 3; outputs "
          "equal to the native decoder): " + "; ".join(
              f"{k} {v['device_ms']:.4f} ms = {v['x_new']:.2f}x (groups of "
              f"{v['group_lanes']}, budget {v['budget_words']}, staged "
              f"{v['groups_staged']}, over budget {v['groups_over_budget']})"
              for k, v in rec["variants"].items()))
    return rec


LANE_STEPS = (16, 32, 64, 128, 256, 512, 1300)


def _lane_sweep(dev, hdr, scan, ref) -> dict:
    """K7 on one DRI-0 frame at several lane sizes: the host plan with
    ``target_steps`` of :data:`LANE_STEPS` paired steps per lane (no lane
    cap), each output equal to the native decoder's with no group over the
    staging budget; the host emit_prep ms (best of 3), the lanes and trips,
    the staging counters, K7's device time (``_queued_ms``, median of 3 x
    10 launches)."""
    import torch

    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.ops import entropy_emit_cuda

    n_mcus = hdr.mcus_x * hdr.mcus_y
    out = {}
    for ts in LANE_STEPS:
        prep_ms = min(_wall(lambda: native.emit_prep(
            hdr, scan, n_threads=1, max_chunks=n_mcus, target_steps=ts))
            for _ in range(3)) * 1e3
        args, kw, l1, plan = _k7_inputs(hdr, [scan], dev, ts)
        got, err = entropy_emit_cuda.decode_lanes(*args, **kw, l1=l1)
        st = dict(zip(entropy_emit_cuda.STATS,
                      entropy_emit_cuda.decode_lanes.last_stats.tolist()))
        if int(err[0]) or not torch.equal(got[0].cpu(), ref):
            raise AssertionError(f"K7 sweep target_steps={ts}: differs")
        if st["groups_over_budget"]:
            raise AssertionError(f"K7 sweep target_steps={ts}: groups over "
                                 f"the staging budget {st}")
        del got
        fn = _k7_launcher(args, kw, l1)[0]
        ms = statistics.median([_queued_ms(fn, 10) for _ in range(3)])
        out[ts] = {"emit_prep_ms": prep_ms, "lanes": plan[6],
                   "T_sym": kw["trips"], "device_ms": ms, **st}
    print(f"lanes: K7 lane-size sweep on {hdr.width}x{hdr.height} "
          f"{hdr.precision}-bit (target_steps: emit_prep ms, lanes, T, K7 "
          "device ms, groups staged/over budget; outputs equal): "
          + "; ".join(
              f"{ts}: {r['emit_prep_ms']:.2f}, {r['lanes']}, {r['T_sym']}, "
              f"{r['device_ms']:.4f}, {r['groups_staged']}/"
              f"{r['groups_over_budget']}" for ts, r in out.items()))
    return out


def _lanes_phase(dev, images: dict, cpu_refs: dict):
    """``decode(entropy="hybrid"|"jax")`` on (a)-(d) and two 12-bit frames
    (see the module docstring).  Returns the K7 record, K2's 12-bit
    records and the kernel counts of the checked runs, summed."""
    import torch

    from jpeg_decoder_tpu_torch import JPEGError, decode
    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.models import decoder as dec_mod
    from jpeg_decoder_tpu_torch.ops import (entropy_cuda, entropy_emit_cuda,
                                            entropy_spec)

    med = statistics.median
    total, k7_by, k2_12 = {}, {}, {}
    k7_err = 0
    for name, (blob, _) in images.items():
        t0 = time.perf_counter()
        hdr = parser.parse(blob)
        scan = hdr.scans[0]
        ref = torch.from_numpy(native.decode_scan_baseline(hdr, scan))
        dri0 = len(scan.seg_offsets) == 2 and not scan.restart_interval
        # Scan blocks: both backends equal the native decoder everywhere.
        for entropy in ("hybrid", "jax"):
            _zero_counts()
            blocks = dec_mod._decode_scan_robust(hdr, scan, entropy, dev)
            torch.cuda.synchronize()
            c = _counts()
            k7 = int(entropy == "hybrid" and dri0)
            n_diff = int((blocks.cpu() != ref).sum())
            if n_diff or c["K7"] != k7 or c["K2"] != 1 - k7:
                raise AssertionError(f"lanes {name} {entropy}: {n_diff} "
                                     f"coefficients differ, launches {c}")
            if k7:
                _k7_all_staged(f"lanes {name} hybrid")
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        # RGB: strict equal to the CPU decode, pallas to native's on the card.
        cpu = cpu_refs.get(name)
        if cpu is None:
            cpu = decode(blob, entropy="native", idct="exact",
                         upsample="fancy", device="cpu").rgb
        nat = decode(blob, entropy="native", idct="pallas", upsample="fancy",
                     device=dev).rgb
        for entropy in ("hybrid", "jax"):
            for idct, want in (("exact", cpu), ("pallas", nat)):
                _zero_counts()
                got = decode(blob, entropy=entropy, idct=idct,
                             upsample="fancy", device=dev).rgb
                torch.cuda.synchronize()
                for k, v in _counts().items():
                    total[k] = total.get(k, 0) + v
                if not torch.equal(got.cpu(), want.cpu()):
                    raise AssertionError(f"lanes {name} {entropy} {idct}: "
                                         "RGB differs")
                if entropy == "hybrid" and dri0:
                    _k7_all_staged(f"lanes {name} hybrid {idct}")
        check_s = time.perf_counter() - t0

        # Stages: the host plan, K7 (on every frame: restart ones too, for
        # the comparison with K2) against its first form, K2, end to end
        # against pallas.  The plan decode() runs (entropy_spec.device_plan).
        prep_ms = min(_wall(lambda: native.emit_prep(
            hdr, scan, n_threads=1, max_chunks=hdr.mcus_x * hdr.mcus_y,
            target_steps=entropy_spec.LANE_STEPS)) for _ in range(3)) * 1e3
        args, kw, l1, plan = _k7_inputs(hdr, [scan], dev)
        rec = _k7_turns(name, args, kw, l1, [ref])
        rec.update(T_pair=plan[5], emit_prep_ms=prep_ms)
        _, _, _, k2_args, k2_kw = _scan_inputs(blob, dev)
        k2_kw["precision"] = hdr.precision
        ms2 = med(_cuda_ms(lambda: entropy_cuda.decode_segments(
            *k2_args, **k2_kw), 20, warmup=2))
        rec["k2_ms"] = ms2
        n_blocks = len(ref)
        if hdr.precision == 12:
            k2_bytes = (k2_args[0].numel() * 4 + k2_args[1].numel() * 4
                        + n_blocks * 256)
            k2_12[name] = {"ms": ms2, "bound_ms":
                           k2_bytes / HBM_BYTES_PER_S * 1e3}
        if name == "(c)":
            k7_err = rec["max_abs_err"]
            rec["plain_ms"] = med(_cuda_ms(
                lambda: entropy_emit_cuda.decode_lanes_torch(*args, **kw),
                1, warmup=0))
            # A corrupt copy: bytes inverted at 12 places.
            bad = copy.copy(scan)
            data = scan.data.copy()
            for q in np.linspace(len(data) // 4, 3 * len(data) // 4,
                                 12).astype(int):
                data[q:q + 16] ^= 0xFF
            bad.data = data
            try:
                entropy_spec.decode_scan_hybrid(hdr, bad, dev)
            except JPEGError as e:
                print(f"lanes (c) corrupt copy under hybrid: JPEGError: {e}")
            else:
                raise AssertionError("corrupt (c) decoded under hybrid")
        e2e = {}
        for entropy in ("hybrid", "jax", "pallas"):
            if entropy == "pallas" and hdr.precision != 8:
                continue
            kwd = dict(entropy=entropy, idct="pallas", upsample="fancy",
                       device=dev)
            decode(blob, **kwd)
            runs = []
            for _ in range(3):
                t1 = time.perf_counter()
                o = decode(blob, **kwd)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t1) * 1e3)
                del o
            e2e[entropy] = min(runs)
        rec["e2e_ms"] = e2e
        if dri0:
            rec["lane_sweep"] = _lane_sweep(dev, hdr, scan, ref)
        k7_by[name] = rec
        print(f"lanes {name}: {hdr.width}x{hdr.height} {hdr.precision}-bit "
              f"DRI {scan.restart_interval}; hybrid and jax blocks equal to "
              "the native decoder, strict RGB equal to the CPU decode, pallas "
              f"RGB equal to entropy=native's (checks {check_s:.1f} s); host "
              f"emit_prep {prep_ms:.3f} ms (1 thread, best of 3), C = "
              f"{rec['C']} lanes, T = {rec['T_sym']} symbols ({rec['T_pair']} "
              f"paired); K7 device {rec['device_ms']:.4f} ms (first form "
              f"{rec['v1_device_ms']:.4f}), with the wrapper {rec['ms']:.4f} "
              f"ms ({rec['v1_ms']:.4f}), bound "
              f"{rec['bound_ms'] * 1e3:.2f} us; "
              f"K2 on the same frame {ms2:.4f} ms; decode() idct=pallas end "
              "to end (best of 3) "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in e2e.items())
              + ("; K7 plain version on the card "
                 f"{rec['plain_ms']:.1f} ms, equal" if name == "(c)" else ""))
    c = k7_by["(c)"]
    k7 = {"name": "decode_lanes", "route": "cuda",
          "source": "jpeg_decoder_tpu_torch/csrc/entropy_emit.cu",
          "replaces": "jpeg_decoder_tpu/ops/entropy_flat.py:709",
          "max_abs_err": k7_err, "ms": c["device_ms"],
          "wrapper_ms": c["ms"], "plain_ms": c["plain_ms"],
          "bound_ms": c["bound_ms"], "bound_by": "bytes",
          "library_ms": None, "earlier_ms": c["v1_device_ms"],
          "earlier_source": "jpeg_decoder_tpu_torch/csrc/entropy_emit_v1.cu",
          "by_image": {k: {q: v for q, v in r.items() if q != "plain_ms"}
                       for k, r in k7_by.items()}}
    return k7, k2_12, total


def _k7_batch_phase(dev, blobs: list) -> dict:
    """K7 over the batch's 24 DRI-0 1920x1080 images (its six distinct
    4:2:0 images four times) as one B = 24 launch, the shape of a batched
    device-entropy route: the 24 share the test encoder's standard tables
    (asserted), every image equal to the native decoder and to
    ``decode_lanes_torch``, the new kernel against its first form in turns
    (``_k7_turns``)."""
    import torch

    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.ops import entropy_cuda

    hdrs = [parser.parse(blobs[k % 6]) for k in range(24)]
    luts0 = entropy_cuda.device_tables(hdrs[0], hdrs[0].scans[0], dev)[0]
    for h in hdrs[1:6]:
        if not torch.equal(entropy_cuda.device_tables(h, h.scans[0],
                                                      dev)[0], luts0):
            raise AssertionError("K7 B=24: the images' tables differ")
    refs = [torch.from_numpy(native.decode_scan_baseline(h, h.scans[0]))
            for h in hdrs[:6]]
    args, kw, l1, _ = _k7_inputs(hdrs[0], [h.scans[0] for h in hdrs], dev)
    return _k7_turns("B=24 (the batch's DRI-0 1080p images, one launch)",
                     args, kw, l1, [refs[k % 6] for k in range(24)])


PROG_FRAMES = ("progressive_1080p_a.jpg", "progressive_1080p_b.jpg",
               "progressive_1080p_dri.jpg", "progressive_4k.jpg")
#: K8's kernels: (wrapper, TPU code it replaces, what it decodes).
PROG_KERNELS = {
    "K8a": ("dc_first", "jpeg_decoder_tpu/ops/entropy_prog.py:87",
            "DC first"),
    "K8b": ("dc_refine", "jpeg_decoder_tpu/ops/entropy_prog.py:152",
            "DC refine"),
    "K8c": ("ac_first", "jpeg_decoder_tpu/ops/entropy_prog.py:770",
            "AC first"),
    "K8d": ("ac_refine", "jpeg_decoder_tpu/ops/entropy_prog.py:517",
            "AC refine"),
}


def _prog_kind(scan) -> str:
    return ("K8a" if scan.ah == 0 else "K8b") if scan.ss == 0 else (
        "K8c" if scan.ah == 0 else "K8d")


def _prog_bytes(scan, before, after) -> int:
    """The bytes one scan must move: its words, and per block the plane
    elements it reads (a refinement's history: coefficient 0, or the AC
    band) and the elements it changes (read once, written once)."""
    n_words = (len(scan.data) + 3) // 4 + 8
    cis = sorted(set(scan.comp_indices))
    changed = sum(int((a != b).sum()) for ci in cis
                  for a, b in [(before[ci][:-1], after[ci][:-1])])
    blocks = sum(len(before[ci]) - 1 for ci in cis)
    read = blocks * (scan.se - scan.ss + 1) if scan.ah else 0
    return 4 * (n_words + read + changed)


def _ac_turns(scan, k: int, args, planes, restore) -> dict:
    """K8c in both forms (one warp per lane, one thread per lane) or K8d
    (one warp per lane) against the first form (``testing/prog_v1.py``) on
    one scan's inputs: all from the same prior planes, flags and planes
    equal and no lane flagged; then device time, 10 launches queued behind
    a spin kernel each, in turns (each form, first form, first form, each
    form in reverse), K8d's plane restore before each launch timed apart
    and taken off.  Returns the scan's lanes, the form the wrapper picks and
    its CTAs, the longest lane, staging counters and the times."""
    import torch

    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
    from jpeg_decoder_tpu_torch.testing import prog_v1

    refine = scan.ah > 0
    new = k8.ac_refine if refine else k8.ac_first
    forms = ("warp",) if refine else ("warp", "thread")
    fns = {f: lambda *a, f=f, **kw: k8._ac(
        refine, *a, kw["ss"], kw["se"], kw["al"], kw["table"], form=f)
        for f in forms}
    fns["v1"] = prog_v1.ac_refine_v1 if refine else prog_v1.ac_first_v1
    plane = planes[args.cis[0]]
    kw = dict(ss=scan.ss, se=scan.se, al=scan.al, table=args.ac_table)
    got, stats = {}, {}
    for name, fn in fns.items():
        restore()
        err = fn(args.words, args.lanes, args.luts, plane, args.geom, **kw)
        torch.cuda.synchronize()
        got[name] = (err.cpu(), plane.cpu())
        if name != "v1":
            stats[name] = new.last_stats.tolist()
    form = "thread" if k8.use_threads(refine, args.lanes) else "warp"
    for name in forms:
        st = stats[name]
        # The form the wrapper picks must stage every word and probe no
        # table in device memory; K8c's other form may read words past its
        # budget (a warp's 32 long segment lanes), which is counted.
        if got[name][0].any() or not torch.equal(got[name][0], got["v1"][0]) \
                or not torch.equal(got[name][1], got["v1"][1]) \
                or st[2] or (name == form and st[1]):
            raise AssertionError(
                f"prog scan {k}: K8{'d' if refine else 'c'} ({name} form) "
                f"against its first form: flags "
                f"{int(got[name][0].sum())} and {int(got['v1'][0].sum())}, "
                f"{int((got[name][1] != got['v1'][1]).sum())} coefficients "
                f"differ; lanes over budget {st[1]}, table misses {st[2]}")

    def launcher(fn):
        def run():
            if refine:
                restore()
            fn(args.words, args.lanes, args.luts, plane, args.geom, **kw)
        return run

    times = {name: [] for name in fns}
    for name in forms + ("v1", "v1") + forms[::-1]:
        times[name].append(_queued_ms(launcher(fns[name]), n=10))
    off = _queued_ms(restore, n=10) if refine else 0.0
    ms = {name: statistics.mean(v) - off for name, v in times.items()}
    return dict(scan=k, lanes=args.lanes.n, form=form,
                ctas=k8.ac_grid(refine, args.lanes, args.ac_table.n_slots),
                longest_blocks=args.lanes.max_units,
                l2_slots=stats[form][0], over_budget=stats[form][1],
                table_misses=stats[form][2], ms=ms[form],
                v1_ms=ms["v1"], turns=times,
                forms={f: dict(ms=ms[f], over_budget=stats[f][1])
                       for f in forms})


def _dc_turns(scan, k: int, args, planes) -> dict:
    """K8a in both forms (one warp per lane, one thread per lane) or K8b
    against its first form (``testing/prog_v1.py``) and its plain version
    on one DC scan's inputs, all from the same prior planes: flags and
    planes equal and no lane flagged, and K8a with no lane over its
    staging budget in the form the wrapper picks (unless the budget is
    capped) and no table probe in device memory; then device time, 10
    launches queued behind a spin kernel each, in turns (each form, first
    form, first form, each form in reverse), and the plain version's time
    by CUDA events around one call.  Returns the scan's lanes, the form the
    wrapper picks and its CTAs, the longest lane, the counters and the
    times (each turn's too)."""
    import torch

    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
    from jpeg_decoder_tpu_torch.testing import prog_v1

    refine = scan.ah > 0
    g, al, lanes = args.geom, scan.al, args.lanes

    def mine(pl):
        return [pl[ci] for ci in args.cis]

    if refine:
        forms = ("new",)
        ways = {"new": lambda pl: k8.dc_refine(args.words, lanes, mine(pl),
                                               g, al=al),
                "v1": lambda pl: prog_v1.dc_refine_v1(args.words, lanes,
                                                      mine(pl), g, al=al),
                "plain": lambda pl: k8.dc_refine_torch(args.words, lanes,
                                                       mine(pl), g, al=al)}
    else:
        forms = ("warp", "thread")
        ways = {f: lambda pl, f=f: k8._dc_first(
            args.words, lanes, args.luts, mine(pl), g, al, args.dc_table,
            form=f) for f in forms}
        ways["v1"] = lambda pl: prog_v1.dc_first_v1(
            args.words, lanes, args.luts, mine(pl), g, al=al)
        ways["plain"] = lambda pl: k8.dc_first_torch(
            args.words, lanes, args.luts, mine(pl), g, al=al)
    got, stats, plain_ms = {}, {}, None
    for name, fn in ways.items():
        pl = [p.clone() for p in planes]
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        err = fn(pl)
        t1.record()
        t1.synchronize()
        if name == "plain":
            plain_ms = t0.elapsed_time(t1)
        got[name] = (err.cpu(), [p.cpu() for p in mine(pl)])
        if name in ("warp", "thread"):
            stats[name] = k8.dc_first.last_stats.tolist()
    capped = False
    if refine:
        form, ctas = "new", -(-lanes.n_units * g.bpm // 128)
    else:
        threads = k8.dc_use_threads(lanes)
        form = "thread" if threads else "warp"
        budget = k8.dc_budget_words(lanes, threads)
        ctas = k8.dc_grid(lanes, threads, k8.dc_resident(
            threads, args.luts.shape[0], args.dc_table.n_slots, budget))
        capped = budget == k8.AC_MAX_BUDGET
    want = got["plain"]
    for name in forms + ("v1",):
        err, pl = got[name]
        st = stats.get(name, [0, 0, 0])
        if err.any() or want[0].any() or not torch.equal(err, want[0]) \
                or any(not torch.equal(a, b) for a, b in zip(pl, want[1])) \
                or st[2] or (name == form and st[1] and not capped):
            raise AssertionError(
                f"prog scan {k}: K8{'b' if refine else 'a'} ({name}) against "
                f"its plain version: flags {int(err.sum())} and "
                f"{int(want[0].sum())}, "
                f"{sum(int((a != b).sum()) for a, b in zip(pl, want[1]))} "
                f"coefficients differ; counters {st}")
    timed = [p.clone() for p in planes]
    times = {name: [] for name in forms + ("v1",)}
    for name in forms + ("v1", "v1") + forms[::-1]:
        times[name].append(_queued_ms(lambda fn=ways[name]: fn(timed),
                                      n=10))
    ms = {name: statistics.mean(v) for name, v in times.items()}
    st = stats.get(form, [0, 0, 0])
    return dict(scan=k, lanes=lanes.n, form=form, ctas=ctas,
                longest_units=lanes.max_units, l2_slots=st[0],
                over_budget=st[1], table_misses=st[2], ms=ms[form],
                v1_ms=ms["v1"], plain_ms=plain_ms, turns=times,
                forms={f: dict(ms=ms[f], over_budget=stats.get(
                    f, [0, 0, 0])[1]) for f in forms})


def _dc_line(name: str, t, sc, info: dict) -> str:
    """One DC scan's line of the progressive phase (see _dc_turns)."""
    forms = ", ".join(f"{f} form {v['ms']:.4f} ms ({v['over_budget']} over "
                      "budget)" for f, v in info["forms"].items())
    turns = "; ".join(f"{w} " + ", ".join(f"{x:.4f}" for x in v)
                      for w, v in info["turns"].items())
    return (f"prog {name} {'segment' if t is None else t} lanes, scan "
            f"{info['scan']} ({_prog_kind(sc)}, {len(sc.comp_indices)} "
            f"components, al {sc.al}): {info['lanes']} lanes, "
            f"{info['form']} form on {info['ctas']} CTAs, longest "
            f"{info['longest_units']} units; l2 slots {info['l2_slots']}, "
            f"lanes over budget {info['over_budget']}, table misses "
            f"{info['table_misses']}; device {forms}, first form "
            f"{info['v1_ms']:.4f} ms "
            f"({info['v1_ms'] / max(info['ms'], 1e-9):.2f}x); plain "
            f"{info['plain_ms']:.2f} ms (events); turns {turns}")


def _dc_form_sweep(dev) -> None:
    """K8a's two forms on the DC first scan of the 1920x1080 (a) and
    3840x2160 DRI-0 fixtures from 256 to 4,096 target lanes, the numbers
    that set ``DC_WARP_LANES_MAX``: planes equal to the native decoder's,
    then device time (10 launches queued behind a spin kernel) in turns
    (warp, thread, thread, warp), one line per lane count."""
    import torch

    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
    from jpeg_decoder_tpu_torch.testing import photo
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    for name in ("progressive_1080p_a.jpg", "progressive_4k.jpg"):
        hdr = parser.parse(photo.fixture(name)[0])
        states = native_prog_states(hdr)
        scan = hdr.scans[0]
        for t in (256, 512, 768, 1024, 1536, 2048, 3072, 4096):
            args = ep.scan_inputs(hdr, scan, ep.hybrid_scan_prep(
                hdr, scan, {}, target_lanes=t), dev)
            times: dict = {}
            for form in ("warp", "thread", "thread", "warp"):
                planes = [torch.tensor(p, device=dev) for p in states[0]]
                mine = [planes[ci] for ci in args.cis]

                def run(form=form, mine=mine):
                    return k8._dc_first(args.words, args.lanes, args.luts,
                                        mine, args.geom, scan.al,
                                        args.dc_table, form=form)

                err = run()
                if err.any() or any(
                        not np.array_equal(planes[ci].cpu().numpy(),
                                           states[1][ci]) for ci in args.cis):
                    raise AssertionError(f"K8a {form} form at {t} target "
                                         f"lanes on {name}: planes differ")
                times.setdefault(form, []).append(_queued_ms(run, n=10))
            picked = "thread" if k8.dc_use_threads(args.lanes) else "warp"
            print(f"prog K8a forms {name} {t} target lanes: {args.lanes.n} "
                  f"lanes of {args.lanes.max_units} units, {picked} form "
                  "picked; device " + "; ".join(
                      f"{f} " + ", ".join(f"{x:.4f}" for x in v)
                      for f, v in times.items()) + " ms")


def _ac_line(name: str, t, sc, info: dict) -> str:
    """One AC scan's line of the progressive phase (see _ac_turns)."""
    forms = ", ".join(f"{f} form {v['ms']:.4f} ms ({v['over_budget']} over "
                      "budget)" for f, v in info["forms"].items())
    turns = "; ".join(f"{w} " + ", ".join(f"{x:.4f}" for x in v)
                      for w, v in info["turns"].items())
    return (f"prog {name} {'segment' if t is None else t} lanes, scan "
            f"{info['scan']} ({_prog_kind(sc)}, band {sc.ss}..{sc.se}, al "
            f"{sc.al}): {info['lanes']} lanes, {info['form']} form on "
            f"{info['ctas']} CTAs, longest {info['longest_blocks']} blocks; "
            f"l2 slots {info['l2_slots']}, lanes over budget "
            f"{info['over_budget']}, table misses {info['table_misses']}; "
            f"device {forms}, first form {info['v1_ms']:.4f} ms "
            f"({info['v1_ms'] / max(info['ms'], 1e-9):.2f}x); turns {turns}")


class _FirstForms:
    """Inside ``with``: the progressive lanes launch the first forms of
    ``kinds`` ("dc": K8a and K8b, "ac": K8c and K8d;
    ``entropy_prog_cuda``'s wrappers swapped for ``testing/prog_v1.py``'s);
    this script's comparison only."""

    NAMES = {"dc": ("dc_first", "dc_refine"), "ac": ("ac_first", "ac_refine")}

    def __init__(self, kinds: str):
        self.names = self.NAMES[kinds]

    def __enter__(self):
        from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8
        from jpeg_decoder_tpu_torch.testing import prog_v1

        self.saved = {n: getattr(k8, n) for n in self.names}
        for n in self.names:
            setattr(k8, n, getattr(prog_v1, n + "_v1"))

    def __exit__(self, *exc):
        from jpeg_decoder_tpu_torch.ops import entropy_prog_cuda as k8

        for n, fn in self.saved.items():
            setattr(k8, n, fn)


def _prog_phase(dev) -> dict:
    """The progressive lanes on the card (see the module docstring).
    Returns the K8a-K8d records, without ``launches``."""
    import torch

    from jpeg_decoder_tpu_torch import decode
    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.models import decoder as dec_mod
    from jpeg_decoder_tpu_torch.ops import entropy_prog as ep
    from jpeg_decoder_tpu_torch.testing import photo
    from jpeg_decoder_tpu_torch.testing.prog_states import native_prog_states

    t_phase = time.perf_counter()
    recs = {k: {"name": f, "route": "cuda",
                "source": "jpeg_decoder_tpu_torch/csrc/entropy_prog.cu",
                "replaces": rep, "max_abs_err": 0, "library_ms": None,
                "by_frame": {}}
            for k, (f, rep, _) in PROG_KERNELS.items()}
    counts = {}

    def tally(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # Kernels against their plain versions on the card: every scan of the
    # 512x512 and the 1080p (a) fixture, skeleton lanes at the default
    # count, from the native decoder's prior planes.
    plain_ms = {k: 0.0 for k in PROG_KERNELS}
    native_ms = {}
    n_scans = 0
    for name in ("progressive_512.jpg", "progressive_1080p_a.jpg"):
        hdr = parser.parse(photo.fixture(name)[0])
        states = native_prog_states(hdr)
        nzmaps: dict = {}
        for k, scan in enumerate(hdr.scans):
            lanes = ep.hybrid_scan_prep(hdr, scan, nzmaps,
                                        target_lanes=ep.target_lanes_default())
            args = ep.scan_inputs(hdr, scan, lanes, dev)
            got = []
            for kernel in (True, False):
                planes = [torch.tensor(p, device=dev) for p in states[k]]
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                err = ep.launch_scan(scan, args, planes, plain=not kernel)
                t1.record()
                t1.synchronize()
                if not kernel and name != "progressive_512.jpg":
                    plain_ms[_prog_kind(scan)] += t0.elapsed_time(t1)
                got.append((err.cpu(), [p.cpu() for p in planes]))
            kind = _prog_kind(scan)
            d = max(int((a - b).abs().max())
                    for a, b in zip(got[0][1], got[1][1]))
            recs[kind]["max_abs_err"] = max(recs[kind]["max_abs_err"], d)
            off = sum(int((a.numpy() != b).sum())
                      for a, b in zip(got[0][1], states[k + 1]))
            if d or off or got[0][0].any() or \
                    not torch.equal(got[0][0], got[1][0]):
                raise AssertionError(
                    f"prog {name} scan {k} ({kind}): kernel vs plain max "
                    f"|diff| {d}, {off} coefficients off the native "
                    f"decoder, flags {int(got[0][0].sum())} and "
                    f"{int(got[1][0].sum())}")
            n_scans += 1
    print(f"prog kernels: {n_scans} scans of the 512x512 and 1080p (a) "
          "fixtures through K8a-K8d and their plain versions on the card "
          "from the native decoder's prior planes: planes and flags equal, "
          "planes equal to the native decoder's; plain versions on (a) "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in plain_ms.items()))

    # Planes against the native decoder under every device backend, with
    # each count set to 0 just before; a second plan of 512 lanes.
    for name in PROG_FRAMES:
        blob = photo.fixture(name)[0]
        hdr = parser.parse(blob)
        t0 = time.perf_counter()
        want = native.decode_progressive(hdr)
        nat_ms = (time.perf_counter() - t0) * 1e3
        dri0 = hdr.scans[0].restart_interval == 0
        for entropy in ("pallas", "jax", "hybrid"):
            torch.cuda.synchronize()
            _zero_counts()
            got = dec_mod.decode_to_planes(hdr, entropy=entropy, device=dev)
            torch.cuda.synchronize()
            c = _counts()
            tally(c)
            off = sum(int((a != b).sum()) for a, b in zip(got, want))
            if off or any(c[k] == 0 for k in PROG_KERNELS):
                raise AssertionError(f"prog {name} {entropy}: {off} "
                                     f"coefficients off native, launches {c}")
        if dri0:
            got = ep.decode_progressive_hybrid(hdr, dev, target_lanes=512)
            if any(not np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"prog {name}: 512 lanes differ")
        native_ms[name] = nat_ms

    # decode() end to end, stage times per frame.
    for name in PROG_FRAMES:
        blob = photo.fixture(name)[0]
        hdr = parser.parse(blob)
        dri0 = hdr.scans[0].restart_interval == 0
        for idct in ("exact", "pallas"):
            cpu = decode(blob, entropy="native", idct=idct,
                         upsample="fancy", device="cpu").rgb
            for entropy in ("pallas", "hybrid"):
                _zero_counts()
                rgb = decode(blob, entropy=entropy, idct=idct,
                             upsample="fancy", device=dev).rgb
                torch.cuda.synchronize()
                tally(_counts())
                if idct == "exact" and not torch.equal(rgb.cpu(), cpu):
                    raise AssertionError(f"prog {name} {entropy}: strict RGB "
                                         "differs from the CPU decode")
                if idct == "pallas":
                    _close_to_cpu(f"prog {name} {entropy} pallas", rgb, cpu)
        # Host walks per kind (one thread, best of 3) and K8 device time
        # per kind (launches queued behind a spin; AC refinement restores
        # its plane before each launch, the restore timed apart), at the
        # default lane target and, on DRI-0 frames, at JAX's 512.
        states = native_prog_states(hdr)
        targets = (ep.target_lanes_default(), 512) if dri0 else (None,)
        walk_ms = {t: {k: 0.0 for k in PROG_KERNELS} for t in targets}
        dev_ms = {t: {k: 0.0 for k in PROG_KERNELS} for t in targets}
        v1_ms = {t: {k: 0.0 for k in PROG_KERNELS} for t in targets}
        ac_scans = {t: [] for t in targets}
        dc_scans = {t: [] for t in targets}
        byts = {k: 0 for k in PROG_KERNELS}
        nzmaps: dict = {t: {} for t in targets}
        for k, scan in enumerate(hdr.scans):
            kind = _prog_kind(scan)
            byts[kind] += _prog_bytes(scan, states[k], states[k + 1])
            for t in targets:
                lanes = None
                if t is not None:
                    walk = []
                    for _ in range(3):
                        trial = {ci: m.copy()
                                 for ci, m in nzmaps[t].items()}
                        t0 = time.perf_counter()
                        lanes = ep.hybrid_scan_prep(hdr, scan, trial,
                                                    target_lanes=t)
                        walk.append(time.perf_counter() - t0)
                    nzmaps[t] = trial
                    walk_ms[t][kind] += min(walk) * 1e3
                args = ep.scan_inputs(hdr, scan, lanes, dev)
                planes = [torch.tensor(p, device=dev) for p in states[k]]
                prior = [p.clone() for p in planes]

                def restore(pl=planes, pr=prior, cis=args.cis):
                    for ci in cis:
                        pl[ci].copy_(pr[ci])

                if kind in ("K8c", "K8d"):
                    info = _ac_turns(scan, k, args, planes, restore)
                    ac_scans[t].append(info)
                else:
                    info = _dc_turns(scan, k, args, planes)
                    dc_scans[t].append(info)
                dev_ms[t][kind] += info["ms"]
                v1_ms[t][kind] += info["v1_ms"]
        # Pixels on the lanes' planes, end to end (hybrid also at 512 lanes
        # on DRI-0 frames), the host decode.
        planes = ep.decode_progressive_lanes(hdr, dev, as_device=True)
        pix_ms = statistics.median(_cuda_ms(
            lambda: dec_mod.pixels_from_planes(hdr, planes, idct="pallas",
                                               upsample="fancy"), 5))
        e2e = {}
        runs = [("hybrid", None), ("native", None)]
        if dri0:
            runs.append(("hybrid", "512"))
        if name in ("progressive_1080p_a.jpg", "progressive_1080p_dri.jpg"):
            # decode(hybrid) with the new K8a-K8d and with the first forms of
            # K8a/K8b or of K8c/K8d swapped in, in turns (new, AC first
            # forms, DC first forms, DC first forms, AC first forms, new).
            kwd = dict(entropy="hybrid", idct="pallas", upsample="fancy",
                       device=dev)
            turns = {"hybrid": [], "hybrid ac v1": [], "hybrid dc v1": []}
            for tag in ("hybrid", "hybrid ac v1", "hybrid dc v1",
                        "hybrid dc v1", "hybrid ac v1", "hybrid"):
                with (_FirstForms(tag.split()[1]) if tag.endswith("v1")
                      else contextlib.nullcontext()):
                    decode(blob, **kwd)
                    turns[tag].append(min(
                        _wall(lambda: (decode(blob, **kwd),
                                       torch.cuda.synchronize()))
                        for _ in range(3)) * 1e3)
            e2e["turns"] = turns
        for entropy, lanes_env in runs:
            kwd = dict(entropy=entropy, idct="pallas", upsample="fancy",
                       device=dev)
            old = os.environ.get("JD_PROG_LANES")
            if lanes_env:
                os.environ["JD_PROG_LANES"] = lanes_env
            try:
                decode(blob, **kwd)
                e2e[entropy + (f"@{lanes_env}" if lanes_env else "")] = min(
                    _wall(lambda: (decode(blob, **kwd),
                                   torch.cuda.synchronize()))
                    for _ in range(3)) * 1e3
            finally:
                if old is None:
                    os.environ.pop("JD_PROG_LANES", None)
                else:
                    os.environ["JD_PROG_LANES"] = old
        t_def = targets[0]
        mp = hdr.width * hdr.height / 1e6
        for kind in PROG_KERNELS:
            recs[kind]["by_frame"].setdefault(name, {}).update(
                ms=dev_ms[t_def][kind],
                bound_ms=byts[kind] / HBM_BYTES_PER_S * 1e3,
                host_walk_ms=walk_ms[t_def][kind] if dri0 else None,
                ms_512_lanes=dev_ms[512][kind] if dri0 else None,
                host_walk_ms_512_lanes=walk_ms[512][kind] if dri0 else None)
        for kind in PROG_KERNELS:
            recs[kind]["by_frame"][name].update(
                v1_ms=v1_ms[t_def][kind],
                v1_ms_512_lanes=v1_ms[512][kind] if dri0 else None)
        for t in targets:
            for info in dc_scans[t]:
                print(_dc_line(name, t, hdr.scans[info["scan"]], info))
            for info in ac_scans[t]:
                print(_ac_line(name, t, hdr.scans[info["scan"]], info))
            print(f"prog {name} {'segment' if t is None else t} lanes: "
                  + ", ".join(
                      f"{k} {dev_ms[t][k]:.4f} ms (first form "
                      f"{v1_ms[t][k]:.4f}; "
                      f"{v1_ms[t][k] / max(dev_ms[t][k], 1e-9):.2f}x)"
                      for k in PROG_KERNELS))
        if "turns" in e2e:
            tr = e2e.pop("turns")
            recs["K8a"]["by_frame"][name]["decode_hybrid_ms"] = tr
            print(f"prog {name}: decode() hybrid in turns, new K8a-K8d "
                  f"{', '.join(f'{v:.2f}' for v in tr['hybrid'])} ms, "
                  "K8a/K8b first forms swapped in "
                  f"{', '.join(f'{v:.2f}' for v in tr['hybrid dc v1'])} ms, "
                  "K8c/K8d first forms swapped in "
                  f"{', '.join(f'{v:.2f}' for v in tr['hybrid ac v1'])} ms")
        nat_ms = native_ms[name]
        print(f"prog {name} ({hdr.width}x{hdr.height}, DRI "
              f"{hdr.scans[0].restart_interval}, {len(hdr.scans)} scans, "
              f"{len(blob) / 1e6:.2f} MB): planes equal to the native "
              "decoder under pallas, jax and hybrid"
              + (" and at 512 lanes" if dri0 else "") + "; strict RGB equal "
              "to the CPU decode, pallas within the K1 bound; "
              + "; ".join(
                  (f"at {t} target lanes host walks " + ", ".join(
                      f"{PROG_KERNELS[k][2]} {v:.2f} ms"
                      for k, v in walk_ms[t].items()) if t else
                   "segment lanes, no host walks") + ", K8 device "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in dev_ms[t].items())
                  for t in targets)
              + "; K8 bounds " + ", ".join(
                  f"{k} {v / HBM_BYTES_PER_S * 1e6:.2f} us"
                  for k, v in byts.items())
              + f"; pixels {pix_ms:.3f} ms; decode() end to end (best of 3) "
              f"hybrid {e2e['hybrid']:.2f} ms ({mp / e2e['hybrid'] * 1e3:.1f}"
              f" MP/s)"
              + (f", hybrid at 512 lanes {e2e['hybrid@512']:.2f} ms"
                 if dri0 else "")
              + f", native {e2e['native']:.2f} ms; native host "
              f"progressive decode {nat_ms:.2f} ms")
        del planes
    _dc_form_sweep(dev)
    a = "progressive_1080p_a.jpg"
    for kind, rec in recs.items():
        rec.update(ms=rec["by_frame"][a]["ms"], plain_ms=plain_ms[kind],
                   bound_ms=rec["by_frame"][a]["bound_ms"], bound_by="bytes",
                   frame=a)
        rec["first_form_ms"] = rec["by_frame"][a]["v1_ms"]
    recs["K8a"]["decode_counts"] = counts
    print(f"prog phase: {time.perf_counter() - t_phase:.1f} s")
    return recs


BIG = (8192, 6144)   # width, height of the >= 50 MP frame


def _encode_big(seed: int) -> bytes:
    """The 8192x6144 4:2:0 q90 DRI-0 frame (a process-pool job)."""
    from jpeg_decoder_tpu_torch.testing.encoder import encode
    from jpeg_decoder_tpu_torch.testing.photo import synthetic_photo

    w, h = BIG
    img = synthetic_photo(np.random.default_rng(seed), h, w)
    return encode(img, samplings=((2, 2), (1, 1), (1, 1)), quality=90,
                  restart_interval=0)[0]


def _big_frame_phase(dev, blob: bytes) -> dict:
    """The 8192x6144 (50.3 MP) DRI-0 frame through ``decode(entropy=
    "hybrid")`` (K7) and ``decode(entropy="pallas")`` (K2), every count set
    to 0 just before each: one launch of its kernel, peak device memory,
    end-to-end ms; the scan blocks of both routes equal to
    ``native.decode_scan_baseline`` on every coefficient; K7 (against its
    first form, ``_k7_turns``) and K2 timed by CUDA events."""
    import torch

    from jpeg_decoder_tpu_torch import decode
    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.models import decoder as dec_mod
    from jpeg_decoder_tpu_torch.ops import entropy_cuda

    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    t0 = time.perf_counter()
    ref = torch.from_numpy(native.decode_scan_baseline(hdr, scan))
    rec = {"bytes": len(blob), "native_s": time.perf_counter() - t0}
    for entropy, key in (("hybrid", "K7"), ("pallas", "K2")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        t1 = time.perf_counter()
        out = decode(blob, entropy=entropy, idct="pallas", upsample="fancy",
                     device=dev)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t1
        counts = _counts()
        peak = torch.cuda.max_memory_allocated(dev)
        shape = tuple(out.rgb.shape)
        del out
        blocks = dec_mod._decode_scan_robust(hdr, scan, entropy, dev)
        n_diff = int((blocks.cpu() != ref).sum())
        del blocks
        if n_diff or counts[key] != 1 or shape != (BIG[1], BIG[0], 3):
            raise AssertionError(f"{BIG} {entropy}: {n_diff} coefficients "
                                 f"differ, launches {counts}, {shape}")
        rec[entropy] = {"e2e_ms": e2e * 1e3, "peak_bytes": peak,
                        "launches": counts}
    torch.cuda.empty_cache()
    args, kw, l1, _ = _k7_inputs(hdr, [scan], dev)
    rec["k7"] = _k7_turns(f"{BIG[0]}x{BIG[1]}", args, kw, l1, [ref],
                          plain=False, variants=False, n=6)
    del args
    _, _, _, k2_args, k2_kw = _scan_inputs(blob, dev)
    rec["k2_ms"] = statistics.median(_cuda_ms(
        lambda: entropy_cuda.decode_segments(*k2_args, **k2_kw), 5,
        warmup=1))
    print(f"big frame {BIG[0]}x{BIG[1]} 4:2:0 q90 DRI 0 "
          f"({BIG[0] * BIG[1] / 1e6:.1f} MP, {len(blob) / 1e6:.2f} MB): "
          "scan blocks of hybrid (K7) and pallas (K2) equal to the native "
          f"decoder ({rec['native_s']:.2f} s); decode() idct=pallas "
          + ", ".join(f"{e} {rec[e]['e2e_ms']:.1f} ms, peak device memory "
                      f"{rec[e]['peak_bytes'] / 2**20:.1f} MiB, launches "
                      f"{rec[e]['launches']}" for e in ("hybrid", "pallas"))
          + f"; K7 device {rec['k7']['device_ms']:.4f} ms, with the "
          f"wrapper {rec['k7']['ms']:.4f} ms ({rec['k7']['lanes']} lanes), "
          f"K2 {rec['k2_ms']:.4f} ms (CUDA events)")
    return rec


def _cmyk_rgb(planes: list) -> np.ndarray:
    """The RGB a decoder gives for these stored CMYK planes (Adobe
    transform 0): Pillow's cmyk2rgb of the PIL-convention CMYK,
    255 - stored.  The source pixels a CMYK frame is held to."""
    cmyk = 255 - np.stack(planes, -1).astype(np.int32)
    nk = 255 - cmyk[..., 3:4]
    t = cmyk[..., :3] * nk + 128
    return np.clip(nk - ((t + (t >> 8)) >> 8), 0, 255).astype(np.uint8)


def _encode_job(seed: int, h: int, w: int, kw: dict):
    """Encode the synthetic photo of ``seed`` (a process-pool job: the
    arithmetic coder is pure Python).  Returns the blob and the pixels a
    decode is held to: the photo, or for ``cmyk`` (C, M, Y, K = R, G, B, R
    stored) / ``ycck`` frames what the colour conversion makes of it."""
    from jpeg_decoder_tpu_torch.testing.encoder import encode
    from jpeg_decoder_tpu_torch.testing.photo import synthetic_photo

    img = synthetic_photo(np.random.default_rng(seed), h, w)
    kw = dict(kw)
    if kw.pop("cmyk", False):
        planes = [img[..., k % 3] for k in range(4)]
        kw["raw_planes"] = [p.astype(np.float64) for p in planes]
        kw.update(samplings=((1, 1),) * 4, app14_transform=0)
        return encode(img, **kw)[0], _cmyk_rgb(planes)
    if kw.pop("ycck", False):
        # Y, Cb, Cr of the photo and K = 255 - G, 4:2:0 with a full K
        # plane; the decode gives (R, G, B) of the photo darkened by K.
        rgbf = img.astype(np.float64)
        r, g, b = rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]
        ycc = [0.299 * r + 0.587 * g + 0.114 * b,
               -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
               0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        k_plane = 255 - img[..., 1]
        kw["raw_planes"] = ycc + [k_plane.astype(np.float64)]
        kw.update(samplings=((2, 2), (1, 1), (1, 1), (2, 2)),
                  app14_transform=2)
        # PIL-convention CMYK of a YCCK decode: (R, G, B, 255 - K stored).
        return encode(img, **kw)[0], _cmyk_rgb(
            [255 - img[..., c] for c in range(3)] + [k_plane])
    if kw.pop("gray", False):
        return (encode(img[..., 1], grayscale=True, samplings=((1, 1),),
                       **kw)[0], np.repeat(img[..., 1:2], 3, axis=-1))
    if kw.pop("adobe_rgb", False):
        kw["raw_planes"] = [img[..., c].astype(np.float64) for c in range(3)]
        kw.update(samplings=((1, 1),) * 3, app14_transform=0)
    return encode(img, **kw)[0], img


def _drop_last_rst(blob: bytes) -> bytes:
    """Cut out the last RSTn marker: one restart segment fewer than DRI
    says (the resilient decoder then leaves the last interval zero)."""
    i = max(blob.rfind(bytes([0xFF, 0xD0 + k])) for k in range(8))
    return blob[:i] + blob[i + 2:]


MIXED_JOBS = {  # kind -> (seed, h, w, encoder arguments)
    "sof9 a": (201, 1080, 1920, dict(quality=90, arithmetic=True)),
    "sof9 b": (202, 1080, 1920, dict(quality=90, arithmetic=True)),
    "sof10 a": (203, 1080, 1920, dict(quality=90, arithmetic=True,
                                      progressive=True)),
    "sof10 b": (204, 1080, 1920, dict(quality=90, arithmetic=True,
                                      progressive=True)),
    "multi-scan a": (205, 1080, 1920, dict(quality=90, scans=[(0,), (1, 2)])),
    "multi-scan b": (206, 1080, 1920, dict(quality=90, scans=[(0,), (1, 2)])),
    "12-bit": (207, 1080, 1920, dict(quality=90, precision=12)),
    # 1920x1080 12-bit 4:2:0 DRI 8 of the jax/hybrid phase.
    "12-bit dri": (212, 1080, 1920, dict(quality=90, precision=12,
                                         restart_interval=8)),
    "cmyk": (208, 1080, 1920, dict(quality=90, cmyk=True)),
    # 1920x1080 frames of the strict single-image phase.
    "ycck": (209, 1080, 1920, dict(quality=90, ycck=True)),
    "adobe rgb": (210, 1080, 1920, dict(quality=90, adobe_rgb=True)),
    "gray": (211, 1080, 1920, dict(quality=90, gray=True)),
    # 512x512 of each kind for the native-against-python plane check.
    "512 baseline": (301, 512, 512, dict(quality=90)),
    "512 sof9": (302, 512, 512, dict(quality=90, arithmetic=True)),
    "512 sof10": (303, 512, 512, dict(quality=90, arithmetic=True,
                                      progressive=True)),
    "512 multi-scan": (304, 512, 512, dict(quality=90, scans=[(0,), (1, 2)])),
    "512 restart-mismatch": (305, 512, 512, dict(
        quality=95, samplings=((1, 1),) * 3, restart_interval=8)),
    "512 12-bit": (306, 512, 512, dict(quality=90, precision=12)),
    "512 cmyk": (307, 512, 512, dict(quality=90, cmyk=True)),
}


def _python_planes(hdr):
    """The pure-Python oracle's planes of a frame: ``arith``'s decoders for
    arithmetic frames (``decode_to_planes`` takes the native ones whatever
    the backend), else ``decode_to_planes(entropy="python")``."""
    from jpeg_decoder_tpu_torch import layout
    from jpeg_decoder_tpu_torch.entropy import arith
    from jpeg_decoder_tpu_torch.models import decoder as dec_mod

    if not hdr.arithmetic:
        return dec_mod.decode_to_planes(hdr, entropy="python")
    if hdr.progressive:
        return arith._decode_progressive(hdr)
    lay = layout.scan_layout(hdr)
    blocks = arith.decode_scan_baseline(hdr, hdr.scans[0])
    return [blocks[lay.comp_src[ci]].reshape(*lay.comp_shapes[ci], 64)
            for ci in range(len(hdr.components))]


def _mixed_phase(dev, blobs: list, sources: list,
                 futs: dict) -> tuple[int, dict, list]:
    """32 frames of every kind through one ``BatchDecoder`` (see the module
    docstring); ``futs`` the encode pool's jobs of :data:`MIXED_JOBS`.
    Returns the launches in the checked run, the encoded frames (blob,
    pixels) by kind and the 32 blobs."""
    import torch

    from jpeg_decoder_tpu_torch import BatchDecoder, decode
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.models import decoder as dec_mod
    from jpeg_decoder_tpu_torch.testing import photo

    t0 = time.perf_counter()
    enc = {k: f.result() for k, f in futs.items()}
    enc["512 restart-mismatch"] = (
        _drop_last_rst(enc["512 restart-mismatch"][0]),
        enc["512 restart-mismatch"][1])
    fix = {n: photo.fixture(n) for n in photo.PROGRESSIVE_FIXTURES}
    enc["512 progressive"] = fix["progressive_512.jpg"]
    prog = [fix["progressive_1080p_a.jpg"], fix["progressive_1080p_b.jpg"]]
    cut = (_drop_last_rst(blobs[6]), sources[6])
    mixed = ([("baseline DRI 0", (blobs[k % 6], sources[k % 6]))
              for k in range(8)]
             + [("progressive", prog[k % 2]) for k in range(8)]
             + [("sof9", enc[f"sof9 {'ab'[k % 2]}"]) for k in range(4)]
             + [("sof10", enc[f"sof10 {'ab'[k % 2]}"]) for k in range(4)]
             + [("multi-scan", enc[f"multi-scan {'ab'[k % 2]}"])
                for k in range(4)]
             + [("restart-mismatch", cut)] * 2
             + [("12-bit", enc["12-bit"]), ("cmyk", enc["cmyk"])])
    batch = [b for _, (b, _) in mixed]
    print(f"mixed inputs: {len(batch)} frames, "
          f"{sum(map(len, batch)) / 1e6:.2f} MB; encoded (arithmetic, "
          "multi-scan, 12-bit, CMYK, and the 512x512 set) in a pool of "
          "spawned processes started before the batch phase, "
          f"{time.perf_counter() - t0:.1f} s more waited for here (set-up)")

    with BatchDecoder(device=dev, idct="pallas") as bd:
        bd.decode(batch)                          # warm-up
        torch.cuda.synchronize()
        _zero_counts()
        items = bd.decode(batch)
        torch.cuda.synchronize()
        counts = _counts()
        bad = [(kind, it.error) for (kind, _), it in zip(mixed, items)
               if not it.ok]
        dtypes = [str(it.rgb.dtype) for it in items[-2:]]
        if bad or dtypes != ["torch.uint16", "torch.uint8"]:
            raise AssertionError(f"mixed: failed {bad}, 12-bit and CMYK "
                                 f"dtypes {dtypes}")
        print(f"mixed: all {len(items)} decoded (the 12-bit frame as "
              f"{dtypes[0]}, CMYK as {dtypes[1]}); launches {counts}")
        cpu, psnrs = {}, {}
        for (kind, (blob, src)), it in zip(mixed, items):
            key = hash(blob)
            if key not in cpu:
                cpu[key] = decode(blob, entropy="native", idct="pallas",
                                  upsample="fancy", device="cpu").rgb
                _close_to_cpu(f"mixed ({kind})", it.rgb, cpu[key])
            elif not torch.equal(it.rgb.cpu(), cpu[key]):
                _close_to_cpu(f"mixed ({kind}, repeat)", it.rgb, cpu[key])
            psnrs.setdefault(kind, []).append(_psnr(it.rgb, src))
        print("mixed: PSNR vs source, min per kind: " + ", ".join(
            f"{k} {min(v):.2f} dB" for k, v in psnrs.items()))
        if min(min(v) for v in psnrs.values()) < MIN_PSNR_DB:
            raise AssertionError(f"mixed: PSNR below {MIN_PSNR_DB}")
        del items
        e2e = _e2e(bd, batch, n=2)
        mp = sum(src.shape[0] * src.shape[1] for _, (_, src) in mixed)
        host = {}
        for kind, (blob, _) in mixed:
            if kind not in host:
                host[kind] = min(_wall(lambda b=blob: bd._host_one(b))
                                 for _ in range(2)) * 1e3
    print(f"mixed: end to end {[round(t, 4) for t in e2e]} s -> "
          f"{mp / 1e6 / min(e2e):.1f} MP/s of the 32 decoded (best of 2); "
          "host ms per frame by kind (one call, best of 2): " + ", ".join(
              f"{k} {v:.1f}" for k, v in host.items()))

    # 512x512 of each kind: native planes equal the pure-Python oracle's.
    for kind in [k for k in enc if k.startswith("512")]:
        hdr = parser.parse(enc[kind][0])
        t1 = time.perf_counter()
        nat = dec_mod.decode_to_planes(hdr, entropy="native")
        t2 = time.perf_counter()
        ref = _python_planes(hdr)
        t3 = time.perf_counter()
        n_diff = sum(int((a != b).sum()) for a, b in zip(nat, ref))
        print(f"planes ({kind}): native vs python {n_diff} coefficients "
              f"differ (native {(t2 - t1) * 1e3:.1f} ms, python "
              f"{t3 - t2:.1f} s)")
        if n_diff or len(nat) != len(ref):
            raise AssertionError(f"planes ({kind}): native != python")
    return counts, enc, batch


def _waves_phase(dev, batch: list[bytes], mp: float) -> int:
    """192 images (the batch six times): ``decode(blobs, wave=64)`` against
    three back-to-back ``decode(blobs[i:i + 64])`` calls, in turns; the
    results bit-identical and in input order.  Returns the launches in
    the checked waved run."""
    import torch

    from jpeg_decoder_tpu_torch import BatchDecoder

    blobs = batch * 6
    mp_all = mp * 6

    def single():
        return [it for i in range(0, len(blobs), 64)
                for it in bd.decode(blobs[i:i + 64])]

    with BatchDecoder(device=dev, idct="pallas") as bd:
        single()                                  # warm-up
        bd.decode(blobs, wave=64)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ref = single()
        _zero_counts()
        got = bd.decode(blobs, wave=64)
        torch.cuda.synchronize()
        c = _counts()
        k1 = {k: c[k] for k in ("K1", "K6a", "K6b")}
        peak = torch.cuda.max_memory_allocated() / 2**30
        if [it.index for it in got] != list(range(len(blobs))) or not all(
                it.ok for it in got) or k1 != {"K1": 0, "K6a": 9, "K6b": 9}:
            raise AssertionError(f"waves: order, failures or launches {k1}")
        n_rgb = _n_rgb_differ(ref, got)
        if n_rgb:
            raise AssertionError(f"waves: {n_rgb} images differ")
        del ref, got
        times = {"single": [], "waves": []}
        timing = {"single": [], "waves": []}
        for name in ("single", "waves", "waves", "single"):
            t0 = time.perf_counter()
            if name == "single":
                out, host, worker = [], 0.0, 0.0
                for i in range(0, len(blobs), 64):
                    out.append(bd.decode(blobs[i:i + 64]))
                    host += sum(bd.last_timing["host_s"])
                    worker += sum(bd.last_timing["worker_s"])
            else:
                out = bd.decode(blobs, wave=64)
                host = sum(bd.last_timing["host_s"])
                worker = sum(bd.last_timing["worker_s"])
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            timing[name].append((host * 1e3, worker * 1e3))
            del out
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = bd.decode(blobs, wave=64)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        del out
        dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA) / 1e3
    best = {k: min(v) for k, v in times.items()}
    print(f"waves: 192 images ({mp_all:.2f} MP) bit-identical to three "
          f"single passes and in input order; launches {k1}; "
          f"three decode(blobs[i:i+64]) {[round(t, 4) for t in times['single']]}"
          f" s -> {mp_all / best['single']:.1f} MP/s; decode(blobs, wave=64) "
          f"{[round(t, 4) for t in times['waves']]} s -> "
          f"{mp_all / best['waves']:.1f} MP/s (best of 2, in turns); "
          f"speed-up {best['single'] / best['waves']:.3f}")
    for name in ("single", "waves"):
        print(f"waves ({name}): host entropy ms, device worker ms (host "
              "clock: grouping, staging, queued copy and pixel stage), per "
              "run: " + ", ".join(f"{h:.1f} / {w:.1f}"
                                  for h, w in timing[name]))
    print(f"waves: busy share of one waved decode under the profiler "
          f"{dev_ms:.1f} ms of device time in {wall_ms:.1f} ms "
          f"({dev_ms / wall_ms:.3f}; two streams may overlap); peak device "
          f"memory {peak:.2f} GiB")
    return c


def _idct_exact_phase(dev, rng, blob_d: bytes) -> dict:
    """K5 at the batch path's largest launch (B=32, N=65,536; see the
    module docstring): equal to its op-by-op twin run on the card on every
    sample of random, DC-only and JPEG blocks; timed beside K1 on the same
    input, the twin and ``torch.matmul`` (product only)."""
    import torch

    from jpeg_decoder_tpu_torch.entropy import native
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.ops import idct_cuda, idct_exact_cuda
    from jpeg_decoder_tpu_torch.testing.encoder import qtable

    B, N = 32, 256 * 256
    qt = torch.from_numpy(
        np.tile(qtable(90).astype(np.int32), (B, 1))).to(dev)
    hdr = parser.parse(blob_d)
    coefs = native.decode_scan_baseline(hdr, hdr.scans[0])
    idx = (np.arange(B)[:, None] * 4099 + np.arange(N)[None, :]) % len(coefs)
    dc_only = np.zeros((B, N, 64), np.int32)
    dc_only[..., 0] = rng.integers(-2048, 2048, size=(B, N))
    inputs = {
        "random": (rng.integers(-1024, 1024, size=(B, N, 64),
                                dtype=np.int32), qt),
        "DC-only": (dc_only, qt),
        "image (d)": (coefs[idx], torch.from_numpy(np.tile(
            hdr.quant_tables[hdr.components[0].tq].values.astype(np.int32),
            (B, 1))).to(dev)),
    }
    del dc_only
    for name, (blocks_np, q) in inputs.items():
        blocks = torch.from_numpy(blocks_np).to(dev)
        got = idct_exact_cuda.dequant_idct_exact(blocks, q)
        ref = idct_exact_cuda.exact_twin(blocks, q)
        torch.cuda.synchronize()
        n_diff = int((got != ref).sum())
        print(f"K5 phase ({name}): B={B} N={N}: {n_diff} of {got.numel()} "
              "samples differ from the twin run on the card")
        if n_diff:
            raise AssertionError(f"K5 ({name}): {n_diff} samples differ")
        del got, ref
    blocks = torch.from_numpy(inputs["random"][0]).to(dev)
    ms = {"K5": [], "twin": [], "K1": []}
    for _ in range(2):  # twin, K5, K1 in turns
        ms["twin"] += _cuda_ms(
            lambda: idct_exact_cuda.exact_twin(blocks, qt), 5, warmup=1)
        ms["K5"] += _cuda_ms(
            lambda: idct_exact_cuda.dequant_idct_exact(blocks, qt), 25)
        ms["K1"] += _cuda_ms(
            lambda: idct_cuda.fused_dequant_idct(blocks, qt), 25)
    deq = (blocks * qt[:, None, :]).to(torch.float32).view(-1, 64)
    basis = idct_cuda._basis_t(dev)
    ms_lib = _cuda_ms(lambda: torch.matmul(deq, basis), 25)
    del deq
    med = {k: statistics.median(v) for k, v in ms.items()}
    ms_lib_med = statistics.median(ms_lib)
    # The least work: 4 B in and 4 B out per coefficient; 43 float32 ops
    # per 1-D pass of 8 samples, 16 passes per block.
    nbytes = blocks.numel() * 8
    flops = blocks.numel() // 64 * 16 * 43
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    gbs = nbytes / 1e9 / med["K5"] * 1e3
    print(f"K5 phase: dequant_idct_exact median {med['K5']:.4f} ms (min "
          f"{min(ms['K5']):.4f}, max {max(ms['K5']):.4f}; 50 runs; "
          f"{gbs:.0f} GB/s, {gbs / 3350:.3f} of HBM's 3.35 TB/s); K1 "
          f"fused_dequant_idct on the same input median {med['K1']:.4f} ms "
          f"(50 runs); twin exact_twin median {med['twin']:.2f} ms (10 "
          f"runs); torch.matmul of the dequantised blocks by the Kronecker "
          f"basis (product only) median {ms_lib_med:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e9:.2f} GB at 3.35 TB/s; "
          f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s is "
          f"{flops / FP32_FLOP_PER_S * 1e3:.4f} ms); K5 "
          f"{'below' if med['K5'] < ms_lib_med else 'NOT below'} the "
          "yardstick")
    return {"name": "dequant_idct_exact", "route": "cuda",
            "source": "jpeg_decoder_tpu_torch/csrc/idct_exact.cu",
            "replaces": "jpeg_decoder_tpu/ops/pixel.py:123",
            "max_abs_err": 0, "ms": med["K5"], "plain_ms": med["twin"],
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": ms_lib_med, "k1_ms_same_input": med["K1"],
            "gb_per_s": gbs, "hbm_share": gbs / 3350}


def _strict_phase(dev, images: dict, frames: dict) -> tuple[dict, dict]:
    """``decode(idct="exact", strict=True)`` on (a)-(d) and a 1920x1080
    frame of each colour kind (see the module docstring).  Returns the
    kernel counts of the checked runs, summed, and the CPU decodes under
    ``upsample="fancy"`` by frame name."""
    import torch

    from jpeg_decoder_tpu_torch import decode
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.models import decoder as dec_mod
    from jpeg_decoder_tpu_torch.ops import pixel

    total, cpu_fancy = {}, {}
    cases = {**{f"({t})": v for t, v in images.items()}, **frames}
    for name, (blob, src) in cases.items():
        hdr = parser.parse(blob)
        entropy = "pallas" if hdr.precision == 8 else "native"
        for up in ("nn", "fancy"):
            kw = dict(entropy=entropy, idct="exact", strict=True,
                      upsample=up)
            _zero_counts()
            got = decode(blob, device=dev, **kw)
            torch.cuda.synchronize()
            c = _counts()
            want_k2 = 1 if entropy == "pallas" else 0
            if c["K6b"] != 1 or c["K5"] or c["K1"] or c["K2"] != want_k2:
                raise AssertionError(f"strict {name} {up}: launches {c}")
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
            # The CPU reference takes the native host decoder (K2 equals it
            # on every coefficient; K2's CPU twin is one slow lane per
            # segment) and the twin of K5.
            cpu = decode(blob, device="cpu",
                         **dict(kw, entropy="native")).rgb
            if up == "fancy":
                cpu_fancy[name] = cpu
            if not torch.equal(got.rgb.cpu(), cpu):
                n = int((got.rgb.cpu().to(torch.int32)
                         != cpu.to(torch.int32)).sum())
                raise AssertionError(f"strict {name} {up}: {n} samples "
                                     "differ from the CPU twin")
            psnr = _psnr(got.rgb, src)
            if psnr < MIN_PSNR_DB:
                raise AssertionError(f"strict {name}: PSNR {psnr:.2f}")
        # Timing (fancy), best of 3 after the warm-up above; the torch
        # pixel route K6b replaced, alone by CUDA events on blocks already
        # on the card.
        mp = hdr.height * hdr.width / 1e6
        e2e = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = decode(blob, device=dev, **kw)
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - t0)
            del out
        blocks = dec_mod._decode_scan_robust(hdr, hdr.scans[0], entropy, dev)
        if not isinstance(blocks, torch.Tensor):
            blocks = torch.from_numpy(blocks).to(dev)
        lay = dec_mod.layout_mod.scan_layout(hdr)
        qts = tuple(torch.from_numpy(hdr.quant_tables[c.tq].values.astype(
            np.int32)).to(dev) for c in hdr.components)
        pix_ms = min(_cuda_ms(lambda: pixel.pixel_pipeline_from_scan(
            blocks, qts, dec_mod._comp_srcs(hdr, dev),
            comp_shapes=tuple(lay.comp_shapes), height=hdr.height,
            width=hdr.width, samplings=tuple(
                (hdr.v_max // c.v, hdr.h_max // c.h)
                for c in hdr.components),
            idct="exact", upsample="fancy", color=hdr.colorspace,
            precision=hdr.precision), 3, warmup=1))
        best = min(e2e) * 1e3
        print(f"strict {name}: {hdr.width}x{hdr.height} {hdr.colorspace} "
              f"{hdr.precision}-bit, entropy={entropy}: K6b 1, K5 0, K1 0, "
              f"K2 {want_k2} per decode; RGB equal to the CPU twin's (nn and "
              f"fancy), PSNR {psnr:.2f} dB; end to end "
              f"{[round(t * 1e3, 2) for t in e2e]} ms -> {best:.2f} ms, "
              f"{mp / best * 1e3:.1f} MP/s (best of 3, fancy); torch pixel "
              f"route {pix_ms:.3f} ms ({pix_ms / best:.3f} of end to end)")
    # K2 on the CMYK frame (4 components): every coefficient equal to the
    # native decoder's.
    blob = frames["cmyk"][0]
    hdr = parser.parse(blob)
    _zero_counts()
    got = decode(blob, entropy="pallas", idct="pallas", upsample="fancy",
                 keep_planes=True, device=dev)
    torch.cuda.synchronize()
    c = _counts()
    ref = dec_mod.decode_to_planes(hdr, entropy="native")
    n_diff = sum(int((a != b).sum())
                 for a, b in zip(got.quantized_planes, ref))
    print(f"strict phase, CMYK under entropy=pallas idct=pallas: K2 vs "
          f"native decoder {n_diff} coefficients differ; launches {c}")
    if n_diff or c["K2"] != 1 or c["K1"] != 4:
        raise AssertionError(f"CMYK pallas: {n_diff} differ, {c}")
    for k, v in c.items():
        total[k] = total.get(k, 0) + v
    return total, cpu_fancy


def _batch_exact_phase(dev, batch: list[bytes], mp: float,
                       nibble_mp_s: float) -> int:
    """The 32-image batch through ``BatchDecoder(idct="exact")``: K6b 3
    times (K5's arithmetic inside), K5 and K1 never, one image of each
    group equal to the port's CPU ``decode(idct="exact",
    upsample="fancy")`` byte for byte.  Returns the launches."""
    import torch

    from jpeg_decoder_tpu_torch import BatchDecoder, decode

    with BatchDecoder(device=dev, idct="exact") as bd:
        bd.decode(batch)                          # warm-up
        torch.cuda.synchronize()
        _zero_counts()
        items = bd.decode(batch)
        torch.cuda.synchronize()
        c = _counts()
        if (c["K6b"] != 3 or c["K5"] or c["K1"]
                or not all(it.ok for it in items)):
            raise AssertionError(f"batch exact: launches {c}")
        for k in CPU_CHECKED:
            cpu = decode(batch[k], idct="exact", upsample="fancy",
                         device="cpu").rgb
            if not torch.equal(items[k].rgb.cpu(), cpu):
                raise AssertionError(f"batch exact: image {k} differs from "
                                     "the CPU decode")
        del items
        e2e = _e2e(bd, batch)
    print(f"batch, idct=exact: launches {c}; images {list(CPU_CHECKED)} "
          f"equal to the CPU decode byte for byte; end to end "
          f"{[round(t, 4) for t in e2e]} s -> {mp / min(e2e):.1f} MP/s "
          f"(best of 3), beside idct=pallas on the nibble wire "
          f"{nibble_mp_s:.1f} MP/s")
    return c


def _k6_bytes(group, tensors, out) -> dict:
    """Bytes K6a and K6b must move for one group (each input read once,
    each output written once), whole and with the route's trim, and the
    true blocks' and the wire's.  K6a whole: the wire in, the whole (B,
    n_blk + 1, 64) int32 blocks out; trimmed: the true images' rows of the
    wire (their first n_rows DC values) in, the (n_img, n_rows + 1, 64)
    blocks out.  K6b: the blocks each row's geometry covers (whole: the
    padding rows' too, as the kernel computes them from whole blocks;
    trimmed: the true images'), the tables and the geometry in, the whole
    RGB tensor out."""
    geom = tensors[-1].cpu().numpy().astype(np.int64)
    bpm = sum(h * v for h, v in group.comp_hv)
    covered = (geom[:, 0] * geom[:, 1]) * bpm * 256
    true = sum(h.mcus_x * h.mcus_y for h in group.headers) * bpm * 256
    b, n1 = tensors[0].shape[0], tensors[0].shape[1] + 1
    n, rows = group.n_img, group.n_rows
    wire = sum(t.numel() * t.element_size() for t in tensors[:-2])
    wire_trim = n * rows * 2 + sum(
        t[:n].numel() * t.element_size() for t in tensors[1:-2])
    side = (tensors[-2].numel() * 4 + tensors[-1].numel() * 4
            + out.numel() * out.element_size())
    return {"k6a": wire + b * n1 * 64 * 4,
            "k6a_trim": wire_trim + n * (rows + 1) * 64 * 4,
            "k6b": int(covered.sum()) + side,
            "k6b_trim": int(covered[:n].sum()) + side,
            "true": true, "wire": wire}


def _k6_phase(dev, batch: list, mixed: list, dyn: list,
              big_blob: bytes) -> tuple[dict, dict]:
    """K6a and K6b against the route they replace, on the card (see the
    module docstring).  Returns the records of K6a and K6b (without
    launches)."""
    import torch

    from jpeg_decoder_tpu_torch import BatchDecoder
    from jpeg_decoder_tpu_torch.models import batch as tb
    from jpeg_decoder_tpu_torch.ops import pixels_cuda as k6
    from jpeg_decoder_tpu_torch.testing import pixel_v1

    med = statistics.median
    idcts = ("pallas", "exact", "kron", "fast")
    err_a = err_b = 0
    sets = (("batch of 32", batch), ("mixed frames", mixed),
            ("bucketed group", dyn), (f"{BIG[0]}x{BIG[1]}", [big_blob]))
    timed = None

    def trim(g):
        return dict(n_img=g.n_img, n_rows=g.n_rows)

    for label, blobs in sets:
        with BatchDecoder(device=dev, idct="pallas") as bd:
            groups = bd.group(bd.host_stage(blobs))
            tensors = [bd.to_device(g) for g in groups]
        line = []
        for g, t in zip(groups, tensors):
            # K6a whole, trimmed (as the route calls it) and its first
            # form, against the plain version; the plain version zero on
            # all that the trim drops.
            got_a = k6.unpack_nibble(*t[:-2])
            got_t = k6.unpack_nibble(*t[:-2], **trim(g))
            v1_a = pixel_v1.unpack_nibble_v1(*t[:-2])
            ref_a = tb.unpack_nibble(*t[:-2])
            n, m = g.n_img, g.n_rows + 1
            n_a = int((got_a != ref_a).sum())
            n_t = int((got_t != ref_a[:n, :m]).sum())
            n_v1 = int((v1_a != ref_a).sum())
            dropped = int(ref_a[n:].count_nonzero()
                          + ref_a[:n, m:].count_nonzero())
            err_a = max(err_a, int((got_a - ref_a).abs().max()),
                        int((got_t - ref_a[:n, :m]).abs().max()),
                        int((v1_a - ref_a).abs().max()), dropped)
            diffs = []
            for idct in idcts:
                for up in (("fancy", "nn") if idct == "pallas"
                           else ("fancy",)):
                    kw = dict(comp_shapes=g.comp_shapes, comp_hv=g.comp_hv,
                              height=g.height, width=g.width,
                              samplings=g.samplings, idct=idct, upsample=up,
                              color=g.color, precision=g.precision)
                    before = (k6.blocks_to_rgb.launches,
                              k6.scan_samples.launches)
                    got = k6.blocks_to_rgb(got_a, t[-2], t[-1], **kw)
                    if (k6.blocks_to_rgb.launches - before[0],
                            k6.scan_samples.launches - before[1]) != (1, 0):
                        raise AssertionError(f"K6b {label} {idct}: not one "
                                             "launch and no product")
                    # The route (trimmed K6a, K6b on its short blocks)
                    # against K6b on the first form's whole blocks.
                    n_route = int((k6.blocks_to_rgb(got_t, t[-2], t[-1], **kw)
                                   != k6.blocks_to_rgb(v1_a, t[-2], t[-1],
                                                       **kw)).sum())
                    ref = tb.rgb_from_blocks_torch(got_a, t[-2], t[-1], **kw)
                    if got.shape != ref.shape or got.dtype != ref.dtype:
                        raise AssertionError(f"K6b {label}: {got.shape} "
                                             f"{got.dtype}, route "
                                             f"{ref.shape} {ref.dtype}")
                    d = (got.to(torch.int32) - ref.to(torch.int32)).abs()
                    n_b, d_max = int((d != 0).sum()), int(d.max())
                    diffs.append(f"{idct}/{up} {n_b} (max {d_max}; trimmed "
                                 f"route against whole first-form blocks "
                                 f"{n_route})")
                    if n_route:
                        raise AssertionError(f"K6 {label} {idct}/{up}: "
                                             f"{n_route} bytes of the "
                                             "trimmed route differ")
                    if idct in ("kron", "fast"):
                        # K1's arithmetic against the route's GEMM, the
                        # kernel's separable fast against the route's
                        # einsum: the +-1 IDCT bound.
                        if d_max > TOL_SLICE or \
                                n_b > (1 - MIN_EQUAL) * d.numel():
                            raise AssertionError(f"K6b {label} {idct}: "
                                                 f"{n_b} bytes differ, max "
                                                 f"{d_max}")
                    else:
                        err_b = max(err_b, d_max)
                    del got, ref, d
            line.append(f"{len(g.idxs)} x {g.width}x{g.height} "
                        f"{''.join(map(str, g.comp_hv))} {g.color} "
                        f"{g.precision}-bit: K6a {n_a} of {got_a.numel()} "
                        f"elements differ, trimmed {n_t} of {got_t.numel()} "
                        f"(n_img {n}, n_rows {g.n_rows}), first form {n_v1}, "
                        f"nonzero where the trim drops {dropped}; K6b bytes "
                        f"differing {', '.join(diffs)}")
            del got_a, got_t, v1_a, ref_a
        print(f"K6 {label}: {len(groups)} groups: " + "; ".join(line))
        if err_a or err_b:
            raise AssertionError(f"K6 {label}: K6a max |diff| {err_a}, K6b "
                                 f"{err_b}")
        if label == "batch of 32":
            timed = (groups, tensors)
        else:
            del groups, tensors
        torch.cuda.empty_cache()

    # Device time on the batch of 32, per group summed: each kernel, the
    # first forms and the plain routes (queued behind a spin, CUDA events),
    # in turns.  K6b on the whole blocks (K6a's output without a trim) and
    # on the route's trimmed blocks.
    groups, tensors = timed
    blocks = [k6.unpack_nibble(*t[:-2]) for t in tensors]
    short = [k6.unpack_nibble(*t[:-2], **trim(g))
             for g, t in zip(groups, tensors)]
    outs = []

    def kw(g, idct):
        return dict(comp_shapes=g.comp_shapes, comp_hv=g.comp_hv,
                    height=g.height, width=g.width, samplings=g.samplings,
                    idct=idct, upsample="fancy", color=g.color,
                    precision=g.precision)

    # Kernels: device time queued behind a spin; every function also by
    # CUDA events around one call (the torch product before the first form
    # under kron/fast and the plain routes do host work and cudaMalloc
    # calls that stall the card, so they cannot be queued).
    kern = {"K6a trim": lambda t, a, s, g: k6.unpack_nibble(*t[:-2],
                                                            **trim(g)),
            "K6a whole": lambda t, a, s, g: k6.unpack_nibble(*t[:-2]),
            "K6a v1": lambda t, a, s, g: pixel_v1.unpack_nibble_v1(*t[:-2])}
    for idct in idcts:
        kern[f"K6b {idct}"] = (lambda t, a, s, g, i=idct: k6.blocks_to_rgb(
            a, t[-2], t[-1], **kw(g, i)))
        kern[f"K6b {idct} trim"] = (
            lambda t, a, s, g, i=idct: k6.blocks_to_rgb(s, t[-2], t[-1],
                                                        **kw(g, i)))
    for idct in ("pallas", "exact"):
        kern[f"K6b v1 {idct}"] = (
            lambda t, a, s, g, i=idct: pixel_v1.blocks_to_rgb_v1(
                a, t[-2], t[-1], **kw(g, i)))
    fns = dict(kern)
    for idct in ("kron", "fast"):
        fns[f"K6b v1 {idct}"] = (
            lambda t, a, s, g, i=idct: pixel_v1.blocks_to_rgb_v1(
                a, t[-2], t[-1], **kw(g, i)))
        fns[f"scan_samples {idct}"] = (
            lambda t, a, s, g, i=idct: k6.scan_samples(a, t[-2], g.comp_hv,
                                                       i))
    fns["unpack_nibble (plain)"] = \
        lambda t, a, s, g: tb.unpack_nibble(*t[:-2])
    fns["unpack_nibble (plain, trimmed)"] = \
        lambda t, a, s, g: tb.unpack_nibble(
            t[0][:g.n_img, :g.n_rows], *(x[:g.n_img] for x in t[1:-2]))
    for idct in idcts:
        fns[f"route {idct}"] = (lambda t, a, s, g, i=idct:
                                tb.rgb_from_blocks_torch(
                                    a, t[-2], t[-1], **kw(g, i)))
    queued = {k: [] for k in kern}
    events = {k: [] for k in fns}
    order = list(fns)
    for turn in (order, order[::-1]):
        for name in turn:
            calls = [lambda f=fns[name], t=t, a=a, sh=sh, g=g: f(t, a, sh, g)
                     for t, a, sh, g in zip(tensors, blocks, short, groups)]
            if name in kern:
                queued[name].append(sum(_queued_ms(c, 5) for c in calls))
            events[name].append(sum(med(_cuda_ms(c, 3, warmup=1))
                                    for c in calls))
    turns_a = {k: [round(x, 4) for x in queued[k]]
               for k in ("K6a trim", "K6a whole", "K6a v1")}
    queued = {k: med(v) for k, v in queued.items()}
    events = {k: med(v) for k, v in events.items()}
    ms = queued
    # K6b's tile and CTAs a multiprocessor: the committed ones and others,
    # queued, under pallas, on the route's trimmed blocks.
    sweep, committed = {}, (k6.TILE, dict(k6.CTAS_PER_SM))
    try:
        for tile, ctas in ((k6.TILE, None), ((64, 128), None),
                           ((128, 64), None), (k6.TILE, 2), (k6.TILE, 4)):
            k6.TILE = tile
            k6.CTAS_PER_SM["pallas"] = ctas or committed[1]["pallas"]
            sweep[(tile, ctas)] = sum(_queued_ms(
                lambda t=t, sh=sh, g=g: k6.blocks_to_rgb(
                    sh, t[-2], t[-1], **kw(g, "pallas")), 5)
                for t, sh, g in zip(tensors, short, groups))
    finally:
        k6.TILE, k6.CTAS_PER_SM = committed
    nb = {}
    for g, t, a in zip(groups, tensors, blocks):
        out = k6.blocks_to_rgb(a, t[-2], t[-1], **kw(g, "pallas"))
        for key, v in _k6_bytes(g, t, out).items():
            nb[key] = nb.get(key, 0) + v
        outs.append(out)
    rgb_true = sum(h.width * h.height * 3 for g in groups
                   for h in g.headers)
    bound = {k: nb[k] / HBM_BYTES_PER_S * 1e3
             for k in ("k6a", "k6a_trim", "k6b", "k6b_trim")}
    floor_a = (nb["wire"] + nb["true"]) / HBM_BYTES_PER_S * 1e3
    floor_b = (nb["true"] + rgb_true) / HBM_BYTES_PER_S * 1e3
    # The stage before and after: every group's unpack and pixels, the old
    # (K6a's first form, K6b on its whole blocks) against the route's
    # (trimmed K6a, K6b on its short blocks), CUDA events around the whole
    # stage, in turns (before, after, after, before), twice, under the
    # defaults' IDCTs and pallas.
    stage = {}
    for idct in ("fast", "kron", "pallas"):
        for name in ("before", "after"):
            stage[f"{idct} {name}"] = []
        for _ in range(2):
            for name in ("before", "after", "after", "before"):
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                for g, t in zip(groups, tensors):
                    a = (pixel_v1.unpack_nibble_v1(*t[:-2])
                         if name == "before"
                         else k6.unpack_nibble(*t[:-2], **trim(g)))
                    k6.blocks_to_rgb(a, t[-2], t[-1], **kw(g, idct))
                ev[1].record()
                ev[1].synchronize()
                stage[f"{idct} {name}"].append(ev[0].elapsed_time(ev[1]))
    print("K6 batch of 32 device ms (queued behind a spin, 5 calls a "
          "group, groups summed, median of 2 turns): " + ", ".join(
              f"{k} {v:.4f}" for k, v in queued.items())
          + "; K6a's turns: " + ", ".join(f"{k} {v}"
                                          for k, v in turns_a.items())
          + "; ms by CUDA events around one call (median of 3, groups "
          "summed, median of 2 turns): " + ", ".join(
              f"{k} {v:.4f}" for k, v in events.items())
          + "; K6b pallas on the trimmed blocks by tile / grid's CTAs a "
          "multiprocessor (queued; default: CTAS_PER_SM): " + ", ".join(
              f"{h}x{w}/{c or 'default'} {v:.4f}"
              for ((h, w), c), v in sweep.items()))
    print(f"K6 batch of 32 bounds (bytes at 3.35 TB/s): K6a trimmed "
          f"{bound['k6a_trim']:.4f} ms ({nb['k6a_trim'] / 1e6:.1f} MB: the "
          f"true images' wire in, their blocks to the longest one's out), "
          f"whole {bound['k6a']:.4f} ms ({nb['k6a'] / 1e6:.1f} MB: the wire "
          f"in, every block out); K6b on the trimmed blocks "
          f"{bound['k6b_trim']:.4f} ms ({nb['k6b_trim'] / 1e6:.1f} MB: the "
          f"true images' covered blocks in, the whole RGB out), on the whole "
          f"blocks {bound['k6b']:.4f} ms ({nb['k6b'] / 1e6:.1f} MB: every "
          f"row's covered blocks in); floors on the true blocks and RGB: K6a "
          f"{floor_a:.4f} ms, K6b {floor_b:.4f} ms; K6a trimmed at "
          f"{bound['k6a_trim'] / ms['K6a trim']:.3f} of its bound, whole at "
          f"{bound['k6a'] / ms['K6a whole']:.3f}, first form at "
          f"{bound['k6a'] / ms['K6a v1']:.3f}; K6b at "
          + ", ".join(f"{i} {bound['k6b'] / ms[f'K6b {i}']:.3f} (trimmed "
                      f"{bound['k6b_trim'] / ms[f'K6b {i} trim']:.3f})"
                      for i in idcts))
    print("K6 batch of 32 pixel stage (unpack + pixels of every group, "
          "before: K6a's first form and K6b on its whole blocks, after: the "
          "route's trimmed K6a and K6b, CUDA events around the stage, 4 "
          "turns): " + ", ".join(
              f"{k} median {med(v):.3f} ms (min {min(v):.3f})"
              for k, v in stage.items()))
    del blocks, short, outs, tensors, groups
    torch.cuda.empty_cache()
    rec_a = {"name": "unpack_nibble", "route": "cuda",
             "source": "jpeg_decoder_tpu_torch/csrc/pixels.cu",
             "replaces": "jpeg_decoder_tpu/models/batch.py:256",
             "max_abs_err": err_a, "ms": ms["K6a trim"],
             "plain_ms": events["unpack_nibble (plain, trimmed)"],
             "ms_by_events": events["K6a trim"],
             "bound_ms": bound["k6a_trim"], "bound_by": "bytes",
             "library_ms": None, "bytes": nb["k6a_trim"],
             "ms_whole": ms["K6a whole"], "bound_whole_ms": bound["k6a"],
             "bytes_whole": nb["k6a"],
             "plain_whole_ms": events["unpack_nibble (plain)"],
             "v1_ms": ms["K6a v1"], "v1_ms_by_events": events["K6a v1"],
             "turns": turns_a, "true_blocks_floor_ms": floor_a}
    rec_b = {"name": "blocks_to_rgb", "route": "cuda",
             "source": "jpeg_decoder_tpu_torch/csrc/pixels.cu",
             "replaces": "jpeg_decoder_tpu/models/batch.py:52",
             "max_abs_err": err_b, "ms": ms["K6b pallas trim"],
             "plain_ms": events["route pallas"],
             "bound_ms": bound["k6b_trim"], "bound_by": "bytes",
             "library_ms": None, "bytes": nb["k6b_trim"],
             "true_floor_ms": floor_b,
             "ms_by_idct": {i: ms[f"K6b {i} trim"] for i in idcts},
             "ms_by_idct_whole_blocks": {i: ms[f"K6b {i}"] for i in idcts},
             "bound_whole_blocks_ms": bound["k6b"],
             "v1_ms_by_idct": {
                 **{i: ms[f"K6b v1 {i}"] for i in ("pallas", "exact")},
                 **{i: events[f"K6b v1 {i}"] for i in ("kron", "fast")}},
             "ms_by_events": {i: events[f"K6b {i} trim"] for i in idcts},
             "route_ms_by_events": {i: events[f"route {i}"] for i in idcts},
             "ms_by_tile_and_ctas": {f"{h}x{w}/{c or 'default'}": v
                                     for ((h, w), c), v in sweep.items()},
             "stage_ms": {k: med(v) for k, v in stage.items()}}
    return rec_a, rec_b


def _k6_routes(dev, batch: list, mp: float) -> dict:
    """Both batch routes under each IDCT, every count set to 0 just before
    and read just after: one K6b a group, no K1, no K5, no ``scan_samples``
    product; then each route's end-to-end MP/s under its default IDCT
    (``BatchDecoder``: fast, ``decode_batch_sharded``: kron) with K6a
    trimmed and with K6a's first form (whole blocks) in its place, in turns
    (before, after, after, before), best of 3 a turn, with the groups' pixel
    ms of the sharded route's last call (its host-fallback batch alone runs
    K6a).  Returns the launches per path."""
    import torch

    from jpeg_decoder_tpu_torch import BatchDecoder, decode_batch_sharded
    from jpeg_decoder_tpu_torch.ops import pixels_cuda as k6
    from jpeg_decoder_tpu_torch.testing import pixel_v1

    paths = {}
    for idct in ("pallas", "exact", "kron", "fast"):
        with BatchDecoder(device=dev, idct=idct) as bd:
            bd.decode(batch)
            torch.cuda.synchronize()
            _zero_counts()
            items = bd.decode(batch)
            torch.cuda.synchronize()
            c = _counts()
        n_groups = len({id(it.rgb_batch) for it in items if it.ok})
        _, cs, _ = _sharded_run(dev, batch, idct)
        for route, cc in (("BatchDecoder", c), ("decode_batch_sharded", cs)):
            got = {k: cc[k] for k in ("K6b", "K1", "K5", "scan_samples")}
            if got != {"K6b": n_groups, "K1": 0, "K5": 0,
                       "scan_samples": 0}:
                raise AssertionError(f"{route} idct={idct}: launches {got}")
            paths[f"{route} idct={idct} (K6 phase)"] = cc
        print(f"K6 routes idct={idct}: BatchDecoder and decode_batch_sharded "
              f"each {n_groups} K6b (one a group), K1 0, K5 0, scan_samples "
              "0")
    own = k6.unpack_nibble

    def first_form(*wire, n_img=None, n_rows=None):
        return pixel_v1.unpack_nibble_v1(*wire)

    res = {}
    for route in ("BatchDecoder", "decode_batch_sharded"):
        for name in ("before", "after"):
            res[(route, name)] = []
        with BatchDecoder(device=dev) as bd:
            for name in ("before", "after", "after", "before"):
                k6.unpack_nibble = first_form if name == "before" else own
                try:
                    if route == "BatchDecoder":
                        ms = min(_e2e(bd, batch)) * 1e3
                        pix = None
                    else:
                        decode_batch_sharded(batch, dev)
                        times = []
                        for _ in range(3):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            decode_batch_sharded(batch, dev)
                            torch.cuda.synchronize()
                            times.append((time.perf_counter() - t0) * 1e3)
                        ms = min(times)
                        pix = sum(g.get("pixels_ms") or 0.0 for g in
                                  decode_batch_sharded.last_timing["groups"])
                finally:
                    k6.unpack_nibble = own
                res[(route, name)].append((ms, pix))
    print("K6 routes end to end under their defaults (BatchDecoder idct=fast, "
          "decode_batch_sharded idct=kron; best of 3 a turn; before: K6a's "
          "first form, whole blocks, in K6a's place): " + "; ".join(
              f"{r} {n}: " + ", ".join(
                  f"{ms:.1f} ms ({mp / ms * 1e3:.1f} MP/s"
                  + (f", group pixels {pix:.2f} ms" if pix is not None
                     else "") + ")" for ms, pix in v)
              for (r, n), v in res.items()))
    return paths


# Sizes of the bucketed group of the sharded phase: web-photo sizes of one
# power-of-two MCU bucket at 4:2:0 (33..64 MCUs a side), DRI 0 and 8, two
# Huffman table sets.  (height, width, DRI, luma/chroma tables exchanged)
DYN_JOBS = [(750, 1000, 0, False), (768, 1024, 8, True), (600, 800, 0, True),
            (720, 960, 8, False), (540, 960, 0, False), (1024, 768, 8, True)]


def _encode_dyn(seed: int, h: int, w: int, ri: int, swapped: bool) -> bytes:
    """One frame of the bucketed group (a process-pool job)."""
    from jpeg_decoder_tpu_torch.testing.encoder import (
        encode, encode_swapped_tables)
    from jpeg_decoder_tpu_torch.testing.photo import synthetic_photo

    img = synthetic_photo(np.random.default_rng(seed), h, w)
    enc = encode_swapped_tables if swapped else encode
    return enc(img, quality=90, restart_interval=ri)[0]


def _sharded_run(dev, blobs, idct: str) -> tuple:
    """One checked ``decode_batch_sharded`` call, every count set to 0 just
    before and read just after.  Returns (items, counts, timing); raises
    when a group's K7 launch staged a group over budget or missed the
    shared tables."""
    import torch

    from jpeg_decoder_tpu_torch import decode_batch_sharded

    torch.cuda.synchronize()
    _zero_counts()
    items = decode_batch_sharded(blobs, dev, idct=idct, upsample="fancy")
    torch.cuda.synchronize()
    counts = _counts()
    timing = decode_batch_sharded.last_timing
    for g in timing["groups"]:
        st = g.get("k7_stats")
        if st and (st["groups_over_budget"] or st["lut_misses"]):
            raise AssertionError(f"sharded {idct}: K7 counters {st}")
    return items, counts, timing


def _group_line(timing) -> str:
    """Per group of a ``decode_batch_sharded`` call: its route and images,
    the host plan (walks or ``prepare_scan``) and the rest of its dispatch
    on the host clock, and its device ms after the plan (CUDA events on its
    stream: copy + tables + entropy kernel, then planes + pixels)."""
    return "; ".join(
        f"{g['route']} x{g['images']}: host plan {g['host_s'] * 1e3:.2f} "
        f"ms, enqueue {(g['dispatch_s'] - g['host_s']) * 1e3:.2f} ms; "
        f"device copy+entropy {_fmt_ms(g.get('entropy_ms'))} ms, pixels "
        f"{_fmt_ms(g.get('pixels_ms'))} ms"
        + (f"; K7 {g['k7_stats']}" if g.get("k7_stats") else "")
        for g in timing["groups"])


def _k7_group_fn(args, kw, l1):
    """A K7 launch of a bucketed group on preallocated buffers (no checks,
    no count): ``fn()`` zero-fills the scratch and launches.  Returns (fn,
    out, scratch)."""
    from jpeg_decoder_tpu_torch.ops import entropy_emit_cuda as k7

    pools, starts = args[0], args[1]
    lanes, budget = k7.schedule(pools.shape[0], pools.shape[1],
                                starts.shape[1], 2 * kw["n_comps"],
                                k7._n_sms(pools.device))
    kw = dict(kw)
    rows = kw.pop("rows", None)
    out, scratch = k7.buffers(pools, starts, kw["n_mcus"],
                              len(kw["block_comp"]), lanes, rows=rows)

    def fn():
        scratch.zero_()
        k7.launch(args + (l1,), out, scratch, group_lanes=lanes,
                  budget_words=budget, **kw)
    return fn, out, scratch


def _restage_cost(dev, batch: list) -> dict:
    """The cost of a table-set staging in K7: the batch's 24 DRI-0 1080p
    images in one launch (840 lane groups on a persistent grid, so a CTA
    takes several tickets), with one table set (each CTA stages once) and
    with that set stacked twice and the images pointed at the two copies
    alternately (a CTA stages again whenever its next ticket is on an
    image of the other copy).  Both equal; their device time (queued,
    median of 3 x 20, in turns) and table stagings give the time of one
    extra staging."""
    import torch

    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.ops import entropy_emit_cuda as k7

    hdrs = [parser.parse(b) for k, b in enumerate(batch) if k % 8 < 6]
    args, kw, l1, _ = _k7_inputs(hdrs[0], [h.scans[0] for h in hdrs], dev)
    ref, _ = k7.decode_lanes(*args, **kw, l1=l1)
    stack = args[:5] + (torch.cat([args[5], args[5]]),)
    l1_2 = torch.cat([l1, l1])
    n = len(hdrs)
    rec, fns = {}, {}
    alternating = torch.tensor([6 * (k % 2) for k in range(n)],
                               dtype=torch.int32, device=dev)
    for label, a, kw_l, l1_l in (
            ("one set", args, kw, l1),
            ("alternating", stack, dict(kw, lut_base=alternating), l1_2)):
        fns[label], out, scratch = _k7_group_fn(a, kw_l, l1_l)
        fns[label]()
        torch.cuda.synchronize()
        st = k7.stats(scratch, n)
        if (not torch.equal(out, ref) or scratch[:n].any()
                or st["groups_over_budget"] or st["lut_misses"]):
            raise AssertionError(f"K7 two sets ({label}): differs from the "
                                 f"one-set launch, counters {st}")
        rec[label] = {"table_stages": st["table_stages"], "device_ms": []}
    del ref
    for _ in range(3):
        for label in ("alternating", "one set", "one set", "alternating"):
            rec[label]["device_ms"].append(_queued_ms(fns[label], 20))
    for r in rec.values():
        r["device_ms"] = statistics.median(r["device_ms"])
    extra = (rec["alternating"]["table_stages"]
             - rec["one set"]["table_stages"])
    rec["restage_us"] = ((rec["alternating"]["device_ms"]
                          - rec["one set"]["device_ms"]) * 1e3
                         / max(1, extra))
    print(f"K7 table-set staging: B = {n} 1080p DRI-0 images, one table set "
          "and two copies of it alternating by image, outputs equal; device "
          "time (queued, median of 3 x 20, in turns) one set "
          f"{rec['one set']['device_ms']:.4f} ms "
          f"({rec['one set']['table_stages']} stagings), alternating "
          f"{rec['alternating']['device_ms']:.4f} ms "
          f"({rec['alternating']['table_stages']} stagings): "
          f"{rec['restage_us']:.3f} us of device time per extra staging")
    return {"restage": rec}


def _exact_stall_probe(dev, batch: list) -> dict:
    """The ``idct="exact"`` sharded calls of the batch of 32 with the
    parent's pixel route (``sharded._pixels_torch``: the scan layout's
    gather, K5 and torch ops, in ``sharded._pixels``' place) and with K6b,
    in turns (parent, K6b, K6b, parent), each turn as
    the sharded phase checks a route: a ``BatchDecoder(idct="exact")``
    decode, a warm-up call, then three calls; per call the 24-image
    group's enqueue and pixels ms and the caching allocator's cudaMalloc
    and cudaFree calls and retries (``torch.cuda.memory_stats``)."""
    import torch

    from jpeg_decoder_tpu_torch import BatchDecoder, decode_batch_sharded
    from jpeg_decoder_tpu_torch.parallel import sharded

    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
    res = {"parent": [], "K6b": []}
    own = sharded._pixels
    for route in ("parent", "K6b", "K6b", "parent"):
        sharded._pixels = (sharded._pixels_torch if route == "parent"
                           else own)
        try:
            with BatchDecoder(device=dev, idct="exact") as bd:
                bd.decode(batch)
            decode_batch_sharded(batch, dev, idct="exact")
            for _ in range(3):
                torch.cuda.synchronize()
                st0 = torch.cuda.memory_stats(dev)
                decode_batch_sharded(batch, dev, idct="exact")
                torch.cuda.synchronize()
                st1 = torch.cuda.memory_stats(dev)
                g = [x for x in decode_batch_sharded.last_timing["groups"]
                     if x["images"] == 24][0]
                res[route].append(
                    {"enqueue_ms": (g["dispatch_s"] - g["host_s"]) * 1e3,
                     "pixels_ms": g.get("pixels_ms"),
                     **{k: st1.get(k, 0) - st0.get(k, 0) for k in keys}})
        finally:
            sharded._pixels = own
    for route, calls in res.items():
        print(f"sharded exact probe, {route} pixel route (24-image group, "
              "per call: enqueue ms / pixels ms / cudaMalloc / cudaFree / "
              "allocator retries): " + "; ".join(
                  f"{c['enqueue_ms']:.2f} / {_fmt_ms(c['pixels_ms'])} / "
                  f"{c['num_device_alloc']} / {c['num_device_free']} / "
                  f"{c['num_alloc_retries']}" for c in calls))
    return res


def _sharded_phase(dev, batch: list, mp: float, mixed: list, dyn: list,
                   big_blob: bytes) -> dict:
    """``decode_batch_sharded`` on the card (see the module docstring):
    the batch of 32 under three IDCTs, a bucketed group, the mixed frames
    and the 8192x6144 frame.  Returns the launch counts by path and K7's
    bucketed-group record."""
    import torch

    from jpeg_decoder_tpu_torch import (BatchDecoder, decode,
                                        decode_batch_sharded)
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.ops import entropy_cuda, entropy_spec
    from jpeg_decoder_tpu_torch.ops import entropy_emit_cuda as k7
    from jpeg_decoder_tpu_torch.ops import scan_prep

    med = statistics.median
    launches = {}
    # The batch of 32: three groups, K7 over the 24 DRI-0 1080p images and
    # over the 4 1000x750 ones, K2 over the 4 DRI-8 4:4:4 ones' 16,200
    # restart segments; RGB equal to the nibble wire's under each IDCT.
    want = {"K7": 2, "K2": 1}
    for idct in ("pallas", "exact", "kron"):
        with BatchDecoder(device=dev, idct=idct) as bd:
            ref = bd.decode(batch)
            decode_batch_sharded(batch, dev, idct=idct)      # warm-up
            items, counts, timing = _sharded_run(dev, batch, idct)
            n_rgb = _n_rgb_differ(ref, items)
            bad = [it.index for it in items if not it.ok]
            got = {k: counts[k] for k in want}
            if (bad or n_rgb or got != want or timing["fallback_rows"]
                    or counts["K6b"] != 3 or counts["K1"] or counts["K5"]):
                raise AssertionError(
                    f"sharded batch {idct}: failed {bad}, {n_rgb} images "
                    f"differ from the nibble wire, launches {counts}, "
                    f"{timing['fallback_rows']} rows patched")
            launches[f"batch {idct}"] = counts
            del ref, items
            line = (f"sharded batch of 32, idct={idct}: launches {counts}; "
                    "RGB equal to the nibble wire's on all 32; 0 rows "
                    f"patched; parse {timing['parse_s'] * 1e3:.2f} ms; "
                    f"groups: {_group_line(timing)}")
            if idct == "pallas":
                turns = {"nibble": [], "sharded": [], "hybrid": []}
                with BatchDecoder(device=dev, idct="pallas",
                                  entropy="hybrid") as hy:
                    hy.decode(batch)
                    fns = {"nibble": lambda: bd.decode(batch),
                           "sharded": lambda: decode_batch_sharded(
                               batch, dev, idct="pallas"),
                           "hybrid": lambda: hy.decode(batch)}
                    for _ in range(3):
                        for k in ("nibble", "sharded", "hybrid"):
                            turns[k].append(_wall(lambda f=fns[k]: (
                                f(), torch.cuda.synchronize())))
                sh = decode_batch_sharded.last_timing
                line += ("; end to end (best of 3, in turns): " + ", ".join(
                    f"{k} {mp / min(v):.1f} MP/s ({min(v) * 1e3:.1f} ms)"
                    for k, v in turns.items())
                    + f"; last sharded call: parse {sh['parse_s'] * 1e3:.2f}"
                    f" ms, dispatch {sh['dispatch_s'] * 1e3:.2f} ms, flags "
                    f"{sh['finish_s'] * 1e3:.2f} ms; {_group_line(sh)}")
                launches["e2e_mp_per_s"] = {k: mp / min(v)
                                            for k, v in turns.items()}
        print(line)
    exact_probe = _exact_stall_probe(dev, batch)
    hdr_b = parser.parse(batch[6])
    prep = min(_wall(lambda: scan_prep.prepare_scan(hdr_b, hdr_b.scans[0]))
               for _ in range(3))
    print(f"sharded: scan_prep.prepare_scan of (b) (1080p 4:4:4 DRI 8, "
          f"4,050 segments) {prep * 1e3:.2f} ms (best of 3)")

    # The bucketed group: one K7 launch with two table sets.
    hdrs = [parser.parse(b) for b in dyn]
    items, counts, timing = _sharded_run(dev, dyn, "pallas")
    g = timing["groups"]
    if (counts["K7"] != 1 or counts["K2"] or len(g) != 1
            or g[0]["route"] != "dyn" or g[0]["table_sets"] < 2
            or timing["fallback_rows"] or counts["K6b"] != 1 or counts["K1"]):
        raise AssertionError(f"sharded bucket: launches {counts}, groups "
                             f"{g}, {timing['fallback_rows']} rows patched")
    for it, blob in zip(items, dyn):
        one = decode(blob, idct="pallas", upsample="fancy", device=dev).rgb
        if not it.ok or not torch.equal(it.rgb, one):
            raise AssertionError(f"sharded bucket: image {it.index} differs "
                                 "from decode()")
    launches["bucket"] = counts
    plan = entropy_spec.plan_bucket_group(hdrs, [h.scans[0] for h in hdrs])
    luts, l1 = entropy_cuda.device_table_stack(plan.sets, dev)
    bpm = 6

    def group_args(rows_order):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(
                a[rows_order])).to(dev)
        args = (t(plan.pools), t(plan.starts), t(plan.nm_lane),
                t(plan.lane_off), None, luts)
        kw = dict(block_comp=(0, 0, 0, 0, 1, 2), n_comps=3,
                  n_mcus=plan.n_mcus, trips=plan.trips, precision=8,
                  rows=plan.n_mcus * bpm + 1, lut_base=t(plan.lut_base),
                  n_mcus_img=t(plan.n_mcus_img), ri=t(plan.ri))
        return args, kw

    sets = plan.lut_base.tolist()
    alternate = sorted(range(len(sets)),
                       key=lambda r: (sets[:r].count(sets[r]), sets[r]))
    rec = {"images": len(dyn), "table_sets": len(plan.sets),
           "C": int(plan.starts.shape[1]), "T_sym": int(plan.trips)}
    for label, order in (("sorted", list(range(len(sets)))),
                         ("alternating", alternate)):
        args, kw = group_args(order)
        out, err = k7.decode_lanes(*args, **kw, l1=l1)
        torch.cuda.synchronize()
        st = dict(zip(k7.STATS, k7.decode_lanes.last_stats.tolist()))
        p_out, p_err = k7.decode_lanes_torch(*args, **kw)
        rec["max_abs_err"] = max(rec.get("max_abs_err", 0),
                                 int((p_out - out).abs().max()))
        if (rec["max_abs_err"] or err.any() or not torch.equal(p_err, err)
                or st["groups_over_budget"] or st["lut_misses"]):
            raise AssertionError(f"K7 bucket ({label}): differs from "
                                 f"decode_lanes_torch or counters {st}")
        rec[f"{label}_table_stages"] = st["table_stages"]
        del p_out, out
    print(f"sharded bucket: {len(dyn)} frames ("
          + ", ".join(f"{w}x{h} DRI {r}" for h, w, r, _ in DYN_JOBS)
          + f"), {len(plan.sets)} table sets, one K7 launch (launches "
          f"{counts}), RGB equal to each frame's decode() on the card; "
          f"{_group_line(timing)}; K7 on the group equal to "
          "decode_lanes_torch on the card with the rows sorted by set "
          f"({rec['sorted_table_stages']} table stagings) and alternating "
          f"({rec['alternating_table_stages']})")
    rec.update(_restage_cost(dev, batch))

    # The mixed frames: the device routes and the host fallback, equal to
    # the mixed phase's BatchDecoder.
    with BatchDecoder(device=dev, idct="pallas") as bd:
        ref = bd.decode(mixed)
        decode_batch_sharded(mixed, dev, idct="pallas")      # warm-up
        items, counts, timing = _sharded_run(dev, mixed, "pallas")
        bad = [it.index for it in items if not it.ok]
        n_rgb = _n_rgb_differ(ref, items)
        # The 8 progressive frames ride the lanes (K8a-K8d), each equal to
        # its own decode() too; 14 frames remain on the host fallback.
        n_prog = 0
        for it, blob in zip(items, mixed):
            if parser.parse(blob).progressive and it.ok and not parser.parse(
                    blob).arithmetic:
                one = decode(blob, idct="pallas", upsample="fancy",
                             device=dev).rgb
                n_prog += int(torch.equal(it.rgb, one))
        if (bad or n_rgb or timing["host_fallback"] != 14
                or timing["progressive"] != 8 or n_prog != 8
                or timing["progressive_fallback"] or timing["fallback_rows"]
                or any(counts[k] == 0 for k in PROG_KERNELS)):
            raise AssertionError(f"sharded mixed: failed {bad}, {n_rgb} "
                                 f"differ, {timing['host_fallback']} on the "
                                 f"host fallback, {n_prog} progressive "
                                 f"equal to decode(), launches {counts}")
        launches["mixed"] = counts
        del ref, items
        m_mp = sum(parser.parse(b).width * parser.parse(b).height
                   for b in mixed) / 1e6
        turns = {"BatchDecoder": [], "sharded": []}
        for _ in range(2):
            for k in ("sharded", "BatchDecoder", "BatchDecoder", "sharded"):
                fn = ((lambda: bd.decode(mixed)) if k == "BatchDecoder"
                      else (lambda: decode_batch_sharded(mixed, dev,
                                                         idct="pallas")))
                turns[k].append(_wall(lambda f=fn: (
                    f(), torch.cuda.synchronize())))
    print(f"sharded mixed: all {len(mixed)} decoded, RGB equal to the "
          f"BatchDecoder's; {timing['progressive']} progressive frames on "
          f"the lanes ({timing['progressive_s'] * 1e3:.1f} ms, equal to "
          f"their decode()); {timing['host_fallback']} frames on the host "
          f"fallback ({timing['fallback_s'] * 1e3:.1f} ms); launches "
          f"{counts}; {_group_line(timing)}; end to end (best of 4, in "
          "turns): " + ", ".join(f"{k} {m_mp / min(v):.1f} MP/s"
                                 for k, v in turns.items()))

    # The 8192x6144 DRI-0 frame.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    items, counts, timing = _sharded_run(dev, [big_blob], "pallas")
    e2e = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    one = decode(big_blob, entropy="hybrid", idct="pallas", upsample="fancy",
                 device=dev).rgb
    if not items[0].ok or not torch.equal(items[0].rgb, one) or \
            counts["K7"] != 1 or counts["K6b"] != 1 or counts["K1"]:
        raise AssertionError(f"sharded {BIG}: differs from decode(hybrid) "
                             f"or launches {counts}")
    launches["big"] = counts
    del items, one
    print(f"sharded {BIG[0]}x{BIG[1]}: RGB equal to decode(entropy=hybrid); "
          f"launches {counts}; {e2e * 1e3:.1f} ms end to end (first call "
          f"after the others); peak device memory {peak / 2**20:.1f} MiB; "
          f"{_group_line(timing)}")
    rec["launches"] = launches
    rec["exact_probe"] = exact_probe
    return rec


# The mesh phase: (grid, backend, phases) of each worker run, on cuda:0.
MESH_GRIDS = (((1, 1), "nccl", "collectives,batch:b32,batch:mixed,"
                               "batch:bucket"),
              ((1, 2), "gloo", "collectives,batch:b32,prog:prog_a,"
                               "prog:prog_dri,scan:cam"),
              ((2, 1), "gloo", "collectives,batch:b32,batch:mixed"))
MESH_TIMEOUT = 300   # seconds, each grid's worker run
MESH_REPEAT = 3      # timed calls of the batch of 32 after a warm-up


def _digest(t) -> str:
    import hashlib

    a = t.detach().cpu().numpy() if hasattr(t, "detach") else t
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _carry_check(dev, batch: list) -> tuple[dict, dict]:
    """K7c (``csrc/emit_carry.cu``) on the inputs the (1, 2) grid gives
    rank 1 for the batch's 24 DRI-0 1080p images: K7 on each rank's share
    of the lanes, the ranks' DC totals, rank 1's plan
    (``sharded.carry_plan``).  The carry-and-pack form's send buffer and
    carried blocks equal to its plain version ``carry_pack_torch``, to the
    first form followed by the gather of the owned rows and the pad (the
    path it replaced), and to one K7 launch over every lane.  Both forms
    timed in turns two ways: device time (20 launches queued behind a spin
    kernel, the plan already on the card, median of 3 rounds) and the whole
    call with its plan (CUDA events around the host call, median of 20 a
    round); beside them ``torch.index_select`` of the owned rows, the pack
    alone.  Returns the records of the new form and of the first form."""
    import torch

    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.ops import emit_carry_cuda as k7c
    from jpeg_decoder_tpu_torch.ops import entropy_cuda, entropy_spec
    from jpeg_decoder_tpu_torch.ops import entropy_emit_cuda as k7
    from jpeg_decoder_tpu_torch.ops.staging import upload
    from jpeg_decoder_tpu_torch.parallel import sharded

    blobs = [b for b in batch if parser.parse(b).width == 1920
             and not parser.parse(b).scans[0].restart_interval]
    hdrs = [parser.parse(b) for b in blobs]
    hdr = hdrs[0]
    scans = [h.scans[0] for h in hdrs]
    (pools, starts, nm, lane_off, t_sym, _, _, seg_first,
     ok) = entropy_spec.device_plan(hdr, scans)
    luts, l1 = entropy_cuda.device_tables(hdr, scans[0], dev)
    args = [torch.from_numpy(a).to(dev)
            for a in (pools, starts, nm, lane_off, seg_first)] + [luts]
    bc = entropy_spec._block_comp(hdr)
    bpm = len(bc)
    n_mcus = hdr.mcus_x * hdr.mcus_y
    rows = n_mcus * bpm
    kw = dict(block_comp=bc, n_comps=3, n_mcus=n_mcus, trips=t_sym,
              precision=8, l1=l1)
    cuts, m_a, m_b = sharded.share_mcus(nm, lane_off, bpm, 2)
    shares = [k7.decode_lanes(*args, **kw, lanes=cut) for cut in cuts]
    whole, _ = k7.decode_lanes(*args, **kw)
    tot = torch.stack([sharded.dc_totals(out, m_b[q], bc)
                       for q, (out, _) in enumerate(shares)])

    def make_plan():
        return sharded.carry_plan(m_a, m_b, 1, [0] * len(blobs),
                                  [n_mcus] * len(blobs), bpm, rows, dev)

    plan = make_plan()
    base = shares[1][0]
    mine = sharded._ranges(plan.own_lo, plan.own_hi, rows, dev)
    pad = plan.n_send - plan.n_own

    def first_form_path(out, on_card=None, index=None):
        # The first form's path: the carry, the index gather, the pad.
        if on_card is None:
            k7c.add_carry(out, tot, plan.w, plan.lo, plan.hi, block_comp=bc)
        else:
            k7c._launch_v1(out, tot, *on_card, bc, max_span)
        if index is None:
            index = sharded._ranges(plan.own_lo, plan.own_hi, rows, dev)
        t = out.view(-1, 64)[index]
        return torch.cat([t, t.new_zeros(pad, 64)]) if pad else t

    got_blocks = base.clone()
    got = k7c.carry_pack(got_blocks, tot, plan, block_comp=bc)
    plain_blocks = base.clone()
    plain = k7c.carry_pack_torch(plain_blocks, tot, plan, block_comp=bc)
    v1_blocks = base.clone()
    v1 = first_form_path(v1_blocks)
    ref = torch.cat([whole[b, lo:hi] for b, (lo, hi) in
                     enumerate(zip(plan.own_lo, plan.own_hi))])
    ref = torch.cat([ref, ref.new_zeros(pad, 64)])
    err = int((got - plain).abs().max())
    at = mine.view(-1)
    if err or not (torch.equal(got, plain) and torch.equal(got, v1)
                   and torch.equal(got, ref)
                   and torch.equal(got_blocks, plain_blocks)
                   and torch.equal(got_blocks.view(-1, 64)[at],
                                   whole.view(-1, 64)[at])):
        raise AssertionError(f"K7c: the send buffer {err} off its plain "
                             "version, or it or the carried blocks differ "
                             "from the first form's path or one K7 launch")
    v1_err = int((v1_blocks - plain_blocks).abs().max())
    if v1_err:
        raise AssertionError(f"K7c first form: {v1_err} off the plain "
                             "version")

    max_span = int(np.maximum(plan.hi - plan.lo, 0).max())
    on_card = upload([plan.w.astype(np.int32), plan.lo, plan.hi], dev)
    work = base.clone()
    flat = work.view(-1, 64)
    device = {  # device time, the plan already on the card
        "new": lambda: k7c.carry_pack(work, tot, plan, block_comp=bc),
        "v1 kernel": lambda: k7c._launch_v1(work, tot, *on_card, bc,
                                            max_span),
        "v1 path": lambda: first_form_path(work, on_card, mine),
        "index_select": lambda: flat.index_select(0, mine)}
    call = {  # CUDA events around the host call
        "new": lambda: k7c.carry_pack(work, tot, plan, block_comp=bc),
        "new with plan": lambda: k7c.carry_pack(work, tot, make_plan(),
                                                block_comp=bc),
        "v1 kernel": lambda: k7c.add_carry(work, tot, plan.w, plan.lo,
                                           plan.hi, block_comp=bc),
        "v1 path": lambda: first_form_path(work)}
    dev_ms = {k: [] for k in device}
    call_ms = {k: [] for k in call}
    for turn in range(4):
        order = list(device) if turn % 2 == 0 else list(device)[::-1]
        for k in order:
            dev_ms[k].append(_queued_ms(device[k], 20))
        order = list(call) if turn % 2 == 0 else list(call)[::-1]
        for k in order:
            call_ms[k].append(statistics.median(_cuda_ms(call[k], 20)))
    dev_med = {k: statistics.median(v) for k, v in dev_ms.items()}
    call_med = {k: statistics.median(v) for k, v in call_ms.items()}
    ms_plain = statistics.median(_cuda_ms(lambda: k7c.carry_pack_torch(
        work, tot, plan, block_comp=bc), 10))
    ms_plain_v1 = statistics.median(_cuda_ms(lambda: k7c.add_carry_torch(
        work, tot, plan.w, plan.lo, plan.hi, block_comp=bc), 10))

    n_carried = int(np.maximum(plan.hi - plan.lo, 0).sum())
    small = 4 * tot.numel()
    nbytes = (256 * plan.n_own + 256 * plan.n_send + 4 * n_carried + small
              + plan.table.nbytes)
    nbytes_v1 = 8 * n_carried + small + 4 * plan.w.size + 16 * len(blobs)
    rec = {"name": "K7c emit carry and pack across ranks", "route": "cuda",
           "source": "jpeg_decoder_tpu_torch/csrc/emit_carry.cu",
           "replaces": "jpeg_decoder_tpu/parallel/sharded.py:630",
           "max_abs_err": err, "ms": dev_med["new"], "plain_ms": ms_plain,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": dev_med["index_select"],
           "call_ms": call_med["new"],
           "call_with_plan_ms": call_med["new with plan"],
           "first_form_path_device_ms": dev_med["v1 path"],
           "first_form_path_call_ms": call_med["v1 path"],
           "turns": {"device": dev_ms, "call": call_ms},
           "rows_owned": plan.n_own, "rows_sent": plan.n_send,
           "rows_carried": n_carried, "images": len(blobs),
           "plan_in_parameters": plan.on_card is None}
    rec_v1 = {"name": "K7c v1 emit carry (first form, baseline)",
              "route": "cuda",
              "source": "jpeg_decoder_tpu_torch/csrc/emit_carry.cu",
              "replaces": "jpeg_decoder_tpu/parallel/sharded.py:630",
              "max_abs_err": v1_err, "ms": dev_med["v1 kernel"],
              "plain_ms": ms_plain_v1,
              "bound_ms": nbytes_v1 / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes", "library_ms": None,
              "call_ms": call_med["v1 kernel"]}
    print(f"K7c (the (1,2) grid's rank 1, {len(blobs)} 1080p DRI-0 images, "
          f"{plan.n_own} block rows owned, {n_carried} carried, send buffer "
          f"{plan.n_send} rows, plan in the launch's parameters: "
          f"{plan.on_card is None}): the send buffer and the carried blocks "
          "equal to carry_pack_torch, to the first form + gather + pad and "
          "to one K7 launch over every lane")
    def turns(by):
        return {k: [round(x, 4) for x in v] for k, v in by.items()}

    print(f"K7c device ms (queued, 20 launches, median of 4 turns; turns "
          f"{turns(dev_ms)}): "
          f"carry and pack {dev_med['new']:.4f}, first form kernel "
          f"{dev_med['v1 kernel']:.4f}, first form + gather + pad "
          f"{dev_med['v1 path']:.4f}, index_select of the owned rows (the "
          f"pack alone) {dev_med['index_select']:.4f}; bound "
          f"{rec['bound_ms'] * 1e3:.3f} us (first form "
          f"{rec_v1['bound_ms'] * 1e3:.3f} us), bytes")
    print(f"K7c call ms (CUDA events, median of 20, median of 4 turns; "
          f"turns {turns(call_ms)}): carry and pack {call_med['new']:.4f} "
          f"({call_med['new with plan']:.4f} with carry_plan), first form "
          f"add_carry with its plan copy "
          f"{call_med['v1 kernel']:.4f}, first form + index + gather + pad "
          f"{call_med['v1 path']:.4f}; plain carry_pack_torch "
          f"{ms_plain:.4f}, add_carry_torch {ms_plain_v1:.4f}")
    return rec, rec_v1


def _mesh_refs(dev, sets: dict) -> dict:
    """Digests of what the one-GPU route gives for every worker phase:
    ``decode_batch_sharded(blobs, dev, idct="pallas")`` item RGB, the
    progressive lanes' planes, ``decode_scan_sharded``'s coefficients."""
    from jpeg_decoder_tpu_torch import decode_batch_sharded
    from jpeg_decoder_tpu_torch.io import parser
    from jpeg_decoder_tpu_torch.ops import entropy_prog
    from jpeg_decoder_tpu_torch.parallel import sharded

    refs = {}
    for name, blobs in sets.items():
        if name in ("b32", "mixed", "bucket"):
            items = decode_batch_sharded(blobs, dev, idct="pallas")
            for k, it in enumerate(items):
                if not it.ok:
                    raise AssertionError(f"mesh refs: {name} item {k} "
                                         f"failed: {it.error}")
                refs[f"{name}/rgb/{k}"] = _digest(it.rgb)
        elif name.startswith("prog"):
            planes = entropy_prog.decode_progressive_lanes(
                parser.parse(blobs[0]), dev, as_device=True)
            for c, p in enumerate(planes):
                refs[f"{name}/plane/0/{c}"] = _digest(p)
        else:
            hdr = parser.parse(blobs[0])
            refs[f"{name}/coef/0"] = _digest(
                sharded.decode_scan_sharded(hdr, hdr.scans[0], dev))
    return refs


def _mesh_phase(dev, batch: list, mixed: list, dyn: list,
                blob_cam: bytes) -> dict:
    """The mesh route on the card (see the module docstring): each grid of
    ``MESH_GRIDS`` runs ``testing/mesh_worker.py`` in one process per rank
    on cuda:0 (NCCL for one rank; gloo for two, which NCCL refuses on one
    GPU), every item, plane and coefficient of every rank (after
    ``allgather_items``) equal to the one-GPU route, the kernels of each
    route launched on every rank.  Returns the launches of each kernel by
    grid (each rank's checked calls, counts zeroed just before, summed)."""
    import socket
    import tempfile

    import torch

    from jpeg_decoder_tpu_torch import decode_batch_sharded
    from jpeg_decoder_tpu_torch.testing.photo import FIXTURES_DIR

    def fixture(name):
        with open(os.path.join(FIXTURES_DIR, name), "rb") as f:
            return f.read()

    sets = {"b32": batch, "mixed": mixed, "bucket": dyn,
            "prog_a": [fixture("progressive_1080p_a.jpg")],
            "prog_dri": [fixture("progressive_1080p_dri.jpg")],
            "cam": [blob_cam]}
    refs = _mesh_refs(dev, sets)
    one_gpu = []
    decode_batch_sharded(batch, dev, idct="pallas")
    for _ in range(MESH_REPEAT):
        one_gpu.append(_wall(lambda: (decode_batch_sharded(
            batch, dev, idct="pallas"), torch.cuda.synchronize())))
    torch.cuda.empty_cache()
    launches: dict = {}
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), **{
            f"{n}/{k}": np.frombuffer(b, np.uint8)
            for n, blobs in sets.items() for k, b in enumerate(blobs)})
        for grid, backend, phases in MESH_GRIDS:
            world = grid[0] * grid[1]
            out = os.path.join(d, f"{grid[0]}x{grid[1]}")
            sock = socket.socket()
            sock.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{sock.getsockname()[1]}"
            sock.close()
            cmd = [sys.executable, "-m",
                   "jpeg_decoder_tpu_torch.testing.mesh_worker",
                   "--world", str(world), "--addr", addr, "--grid",
                   *map(str, grid), "--device-type", dev.type, "--backend",
                   backend, "--local", "1", "--inputs",
                   os.path.join(d, "in.npz"), "--out", out, "--phases",
                   phases, "--idct", "pallas", "--save", "digest",
                   "--repeat", str(MESH_REPEAT), "--timed", "b32"]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=repo,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for r in range(world)]
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(timeout=MESH_TIMEOUT))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            for p, (_, err) in zip(procs, logs):
                if p.returncode:
                    raise AssertionError(f"mesh {grid} {backend}: a rank "
                                         f"failed:\n{err[-3000:]}")
            facts = []
            for r in range(world):
                with open(os.path.join(out, f"rank{r}.json")) as f:
                    facts.append(json.load(f))
            _mesh_check(grid, backend, phases, facts, refs, sets)
            for r, f in enumerate(facts):
                for phase in phases.split(","):
                    for k, n in f[phase]["counts"].items():
                        by = launches.setdefault(k, {})
                        key = f"mesh {grid} {backend}"
                        by[key] = by.get(key, 0) + n
            calls = [max(f["batch:b32"]["calls"][i]["wall_s"]
                         for f in facts) for i in range(MESH_REPEAT)]
            _mesh_lines(grid, backend, facts, calls, min(one_gpu),
                        time.perf_counter() - t0)
    return launches


def _mesh_check(grid, backend, phases, facts, refs, sets) -> None:
    """Every rank of a grid: every digest equal to the one-GPU route's, no
    item in error, each phase's kernels launched on every rank (K7c where a
    rank's first segment needs a carry), and the collectives' transport
    checked on the grid's backend (the worker fails a rank whose gathers or
    sums differ from what was sent)."""
    prog = tuple(PROG_KERNELS)
    need = {"b32": ("K6b", "K2", "K7"), "mixed": prog + ("K6b",),
            "bucket": ("K6b", "K7"), "prog_a": prog, "prog_dri": prog,
            "cam": ("K2",)}
    for r, f in enumerate(facts):
        dg = f["digests"]
        for key, want in refs.items():
            name = key.split("/", 1)[0]
            kinds = [p for p in phases.split(",")
                     if p.partition(":")[2] == name]
            for phase in kinds:
                got = dg.get(f"{phase}/{key.split('/', 1)[1]}")
                if got is None or got[0] != want:
                    raise AssertionError(f"mesh {grid} {backend} rank {r}: "
                                         f"{phase} {key} differs from the "
                                         "one-GPU route")
        for phase in phases.split(","):
            name = phase.partition(":")[2]
            if phase == "collectives":
                if not f[phase]["checked"] or f[phase]["backend"] != backend:
                    raise AssertionError(f"mesh {grid} rank {r}: the "
                                         f"collectives were not checked on "
                                         f"{backend}")
                continue
            if phase.startswith("batch") and any(f[phase]["errors"]):
                raise AssertionError(f"mesh {grid} rank {r}: {phase} "
                                     f"errors {f[phase]['errors']}")
            zero = [k for k in need[name] if not f[phase]["counts"][k]]
            if grid[1] == 2 and name == "b32" and r == 1:
                zero += [] if f[phase]["counts"]["K7c"] else ["K7c"]
            if zero:
                raise AssertionError(f"mesh {grid} rank {r}: {phase} "
                                     f"launched none of {zero}")


def _mesh_lines(grid, backend, facts, calls, one_gpu_s, run_s) -> None:
    """A grid's wall per call of the batch of 32, its exchanged bytes and
    the decode / collective / pixels split per group (rank 0, the checked
    call)."""
    def ms(x):
        return "none" if x is None else f"{x:.4f} ms"

    f = facts[0]
    groups = f["batch:b32"]["timing"]["groups"]
    split = "; ".join(
        f"{g['route']} x{g['images']}: host plan {g['host_s'] * 1e3:.2f} ms"
        f", device decode {ms(g.get('entropy_ms'))}, collective "
        f"{ms(g.get('exchange_ms'))} (of it totals + carry and pack "
        f"{ms(g.get('pack_ms'))}; host {g['exchange_s'] * 1e3:.2f} ms)"
        f", pixels {ms(g.get('pixels_ms'))}, exchanged "
        f"{g['exchange_bytes'] / 1e6:.2f} MB" for g in groups)
    print(f"mesh {grid} {backend} ({len(facts)} rank(s) on cuda:0): every "
          "item, plane and coefficient equal to the one-GPU route; batch of "
          f"32 {min(calls) * 1e3:.1f} ms a call (best of {len(calls)} after "
          f"a warm-up: {', '.join(f'{c * 1e3:.1f}' for c in calls)}), the "
          f"one-GPU route {one_gpu_s * 1e3:.1f} ms; rank 0's checked call: "
          f"{split}; launches {[x['batch:b32']['counts'] for x in facts]}; "
          f"collectives: {f['collectives']['checked']} transport checks over "
          f"{f['collectives']['backend']} on rank 0's lines "
          f"{f['collectives']['lines']}, every one exact; worker run "
          f"{run_s:.1f} s")


def _cli_phase(dev, frames: dict) -> None:
    """``python -m jpeg_decoder_tpu_torch`` in subprocesses on the card over
    a temporary directory of three frames (1080p 4:2:0, CMYK, 12-bit) and a
    non-JPEG file: the single path (exact, strict, BMP), the batch path
    (pallas, PPM), a 12-bit frame to .npy and a --resume rerun; outputs
    read back equal ``decode()`` on the card."""
    import tempfile

    import torch

    from jpeg_decoder_tpu_torch import decode
    from jpeg_decoder_tpu_torch.io import writers

    def ppm(path):
        with open(path, "rb") as f:
            _, dims, _, data = f.read().split(b"\n", 3)
        w, h = map(int, dims.split())
        return np.frombuffer(data, np.uint8).reshape(h, w, 3)

    def run(*argv):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "jpeg_decoder_tpu_torch",
                            *argv], capture_output=True, text=True,
                           timeout=300, cwd=os.path.dirname(
                               os.path.abspath(__file__)))
        return p, time.perf_counter() - t0

    def as8(rgb):
        rgb = rgb.cpu()
        if rgb.dtype == torch.uint16:
            rgb = (rgb.to(torch.int32) >> 4).to(torch.uint8)
        return rgb.numpy()

    with tempfile.TemporaryDirectory() as d:
        names = {"a420": frames["c"][0], "cmyk": frames["cmyk"][0],
                 "b12": frames["12-bit 4:2:0"][0]}
        paths = []
        for name, blob in names.items():
            paths.append(os.path.join(d, f"{name}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(blob)
        bad = os.path.join(d, "bad.jpg")
        with open(bad, "wb") as f:
            f.write(b"not a JPEG")
        inputs = paths[:2] + [bad] + paths[2:]
        out1, out2 = os.path.join(d, "single"), os.path.join(d, "batch")
        p1, t1 = run("--idct", "exact", "--strict", "--format", "bmp",
                     "--time", "-o", out1, *inputs)
        p2, t2 = run("--batch", "--idct", "pallas", "--format", "ppm",
                     "-o", out2, *inputs)
        npy = os.path.join(d, "b12.npy")
        p3, t3 = run("--idct", "exact", "-o", npy, paths[2])
        p4, t4 = run("--batch", "--idct", "pallas", "--format", "ppm",
                     "--resume", "-o", out2, *paths)
        out5 = os.path.join(d, "device_entropy")
        p5, t5 = run("--batch", "--device-entropy", "--idct", "pallas",
                     "--format", "ppm", "-o", out5, *inputs)
        for p, rc in ((p1, 1), (p2, 1), (p3, 0), (p4, 0), (p5, 1)):
            if p.returncode != rc:
                raise AssertionError(f"CLI rc {p.returncode} != {rc}:\n"
                                     f"{p.stdout}\n{p.stderr}")
        for p in (p1, p2, p5):
            if f"{bad}: ERROR: not a JPEG file (missing SOI)" not in p.stderr:
                raise AssertionError(f"CLI error line missing:\n{p.stderr}")
        if p4.stdout.count("exists, skipped") != 3 or " -> " in p4.stdout:
            raise AssertionError(f"CLI --resume wrote:\n{p4.stdout}")
        n_checked = 0
        for path in paths:
            base = os.path.splitext(os.path.basename(path))[0]
            exact = decode(path, idct="exact", device=dev).rgb
            pal = decode(path, idct="pallas", device=dev).rgb
            got_bmp = writers.read_bmp(os.path.join(out1, f"{base}.bmp"))
            got_ppm = ppm(os.path.join(out2, f"{base}.ppm"))
            got_dev = ppm(os.path.join(out5, f"{base}.ppm"))
            if not (np.array_equal(got_bmp, as8(exact))
                    and np.array_equal(got_ppm, as8(pal))
                    and np.array_equal(got_dev, as8(pal))):
                raise AssertionError(f"CLI outputs of {base} differ from "
                                     "decode() on the card")
            n_checked += 3
        if not np.array_equal(np.load(npy), decode(
                paths[2], idct="exact", device=dev).rgb.cpu().numpy()):
            raise AssertionError("CLI .npy of the 12-bit frame differs")
    timing = [ln for ln in p1.stdout.splitlines() if "MP/s" in ln]
    print(f"CLI: single --idct exact --strict bmp rc 1 ({t1:.1f} s), batch "
          f"--idct pallas ppm rc 1 ({t2:.1f} s), 12-bit to .npy rc 0 "
          f"({t3:.1f} s), --resume rc 0 wrote nothing ({t4:.1f} s), --batch "
          f"--device-entropy --idct pallas ppm rc 1 ({t5:.1f} s); the bad "
          f"file's error line in all three; {n_checked + 1} outputs read "
          "back "
          f"equal to decode() on the card; per-image lines: {timing}")


EXAMPLE_TIMEOUT = 300   # seconds, each example run
EMB_BOUND = 1.5 / 127.5  # +-1 pixel through the model: 1/127.5 times
                         # the largest column sum of |W|, 1.5


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]


def _start_example(name: str, *argv):
    """Start ``examples/<name>.py`` in a session of its own (so that a
    time-out can stop the ranks it spawns too)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, os.path.join(repo, "examples", f"{name}.py"),
         *argv], cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True), time.perf_counter()


def _stop_example(started) -> None:
    """Kill a run of :func:`_start_example` and every process it started,
    if it is still running."""
    import signal

    p = started[0]
    if p.poll() is None:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()


def _finish_example(started, what: str) -> tuple[list, float]:
    """Wait for a run of :func:`_start_example`: its stdout lines and the
    process's wall seconds; raises unless it exits with 0."""
    p, t0 = started
    try:
        out, err = p.communicate(timeout=EXAMPLE_TIMEOUT)
    finally:
        _stop_example(started)
    if p.returncode:
        raise AssertionError(f"examples: {what} rc {p.returncode}:\n"
                             f"{out[-2000:]}\n{err[-3000:]}")
    return out.splitlines(), time.perf_counter() - t0


def _embeddings(lines: list) -> dict:
    """The serving example's lines: path -> embedding or failure text."""
    import re

    out = {}
    for ln in lines:
        m = re.match(r"(.+?): (embedding \[(.*)\]|failed: (.*))$", ln)
        if m:
            out[m[1]] = (np.array(m[3].split(), np.float64)
                         if m[3] is not None else m[4])
    return out


def _mixed_check(what: str, lines: list, blobs: list, dev) -> None:
    """The mixed example's lines against the one-GPU
    ``decode_batch_sharded(blobs, dev, idct="fast")``: per item the same
    error text, or the same sha256 of its RGB; then that call timed here,
    with its parts."""
    import torch

    from jpeg_decoder_tpu_torch import decode_batch_sharded

    got = [ln for ln in lines if ln.startswith("[")]
    ref = decode_batch_sharded(blobs, dev, idct="fast", upsample="fancy")
    calls = []
    for _ in range(3):
        calls.append(_wall(lambda: (decode_batch_sharded(
            blobs, dev, idct="fast", upsample="fancy"),
            torch.cuda.synchronize())))
        if calls[-1] == min(calls):
            t = dict(decode_batch_sharded.last_timing)
    print(f"examples: {what}: the one-GPU call here {min(calls) * 1e3:.1f} "
          f"ms (best of {len(calls)} after the checked one: "
          f"{', '.join(f'{c * 1e3:.1f}' for c in calls)}): parse "
          f"{t['parse_s'] * 1e3:.1f} ms, dispatch {t['dispatch_s'] * 1e3:.1f} "
          f"({', '.join(g['route'] + ' x' + str(g['images']) for g in t['groups'])}"
          f"), progressive {t['progressive_s'] * 1e3:.1f} (x"
          f"{t['progressive']}), host fallback {t['fallback_s'] * 1e3:.1f} "
          f"(x{t['host_fallback']}), flags and finish "
          f"{t['finish_s'] * 1e3:.1f}")
    if len(got) != len(ref):
        raise AssertionError(f"examples: {what}: {len(got)} lines for "
                             f"{len(ref)} blobs")
    for k, (ln, it) in enumerate(zip(got, ref)):
        want = (f"[{k}] FAILED (isolated): {it.error}" if not it.ok
                else f" sha256 {_digest(it.rgb)}")
        if not (ln == want if not it.ok else
                ln.startswith(f"[{k}] ") and ln.endswith(want)):
            raise AssertionError(f"examples: {what}: item {k} differs from "
                                 f"the one-GPU route:\n{ln}\n{want}")


def _examples_phase(dev, batch: list, mixed: list) -> None:
    """Both port examples in subprocesses on the card (see the module
    docstring).  Their launches happen in their own processes, so they
    are not part of this process's kernel counts."""
    import tempfile

    t_phase = time.perf_counter()
    card = _card()
    repo = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_mixed_corpus_serving",
        os.path.join(repo, "examples", "torch_mixed_corpus_serving.py"))
    mixed_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mixed_mod)
    with tempfile.TemporaryDirectory() as d:
        full, sub, mix = (os.path.join(d, n) for n in ("full", "sub", "mix"))
        for sub_dir in (full, sub, mix):
            os.mkdir(sub_dir)
        for k, blob in enumerate(batch):
            with open(os.path.join(full, f"img{k:02d}.jpg"), "wb") as f:
                f.write(blob)
        with open(os.path.join(full, "zz_bad.jpg"), "wb") as f:
            f.write(mixed_mod.CORRUPT)
        # One image of each geometry group of the batch, and the corrupt
        # file.
        for name in ("img00.jpg", "img06.jpg", "img07.jpg", "zz_bad.jpg"):
            shutil.copy(os.path.join(full, name), sub)
        for k, blob in enumerate(mixed):
            with open(os.path.join(mix, f"m{k:02d}.jpg"), "wb") as f:
                f.write(blob)

        lines, wall = _finish_example(_start_example(
            "torch_serving_pipeline", "--glob", os.path.join(full, "*.jpg"),
            "--repeat", "3"), "serving")
        got = _embeddings(lines)
        fails = {p: e for p, e in got.items() if isinstance(e, str)}
        n_emb = len(got) - len(fails)
        if n_emb != len(batch) or list(fails) != [
                os.path.join(full, "zz_bad.jpg")]:
            raise AssertionError(f"examples: serving: {n_emb} embeddings, "
                                 f"failures {fails}")
        print(f"examples: serving (torch_serving_pipeline.py --glob, the "
              f"batch of {len(batch)} and a corrupt file) on the card: rc 0, "
              f"{n_emb} embeddings, the corrupt file's line "
              f"'{next(iter(fails.values()))}'; {lines[-1]}; process "
              f"{wall:.1f} s; card {card}")

        sub_glob = os.path.join(sub, "*.jpg")
        on_cpu = _start_example("torch_serving_pipeline", "--glob",
                                sub_glob, "--device", "cpu")
        try:
            on_card, _ = _finish_example(_start_example(
                "torch_serving_pipeline", "--glob", sub_glob),
                "serving subset")
        except BaseException:
            _stop_example(on_cpu)
            raise
        on_cpu, _ = _finish_example(on_cpu, "serving subset --device cpu")
        a, b = _embeddings(on_card), _embeddings(on_cpu)
        if list(a) != list(b) or any(
                isinstance(a[p], str) != isinstance(b[p], str) for p in a):
            raise AssertionError(f"examples: serving subset: card {a}, "
                                 f"cpu {b}")
        diff = max(float(np.abs(a[p] - b[p]).max()) for p in a
                   if not isinstance(a[p], str))
        if diff > EMB_BOUND:
            raise AssertionError(f"examples: serving subset: card and CPU "
                                 f"embeddings differ by {diff} > "
                                 f"{EMB_BOUND}")
        print(f"examples: serving subset ({len(a) - 1} images, one of each "
              f"geometry, and the corrupt file) on the card and under "
              f"--device cpu: the same files and failure, embeddings within "
              f"{diff!r} (bound {EMB_BOUND!r})")

        for what, argv, blobs in (
                ("mixed default corpus", (), mixed_mod.corpus()),
                ("mixed frames", ("--glob", os.path.join(mix, "*.jpg")),
                 mixed)):
            lines, wall = _finish_example(_start_example(
                "torch_mixed_corpus_serving", *argv, "--repeat", "3"), what)
            _mixed_check(what, lines, blobs, dev)
            failed = [ln.split("]")[0] + "]" for ln in lines
                      if " FAILED (isolated): " in ln]
            if not argv and failed != ["[4]"]:
                raise AssertionError(f"examples: {what}: failed {failed}")
            print(f"examples: {what} (torch_mixed_corpus_serving.py"
                  f"{' --glob' if argv else ''}) on a (1, 1) NCCL mesh: "
                  f"{len(blobs)} lines, each equal to the one-GPU "
                  f"decode_batch_sharded(idct='fast'), failed {failed}; "
                  f"{lines[-1]}; process {wall:.1f} s; card {card}")
    print(f"examples: phase {time.perf_counter() - t_phase:.1f} s")


def _phases(dev, pool, big_fut, mixed_futs, dyn_futs) -> int:
    """Every phase after the build, in order (see the module docstring);
    ``pool`` the encode pool with the big frame's, the mixed frames' and
    the bucketed group's jobs."""
    import torch

    from jpeg_decoder_tpu_torch import decode
    from jpeg_decoder_tpu_torch.testing.encoder import encode

    rng = np.random.default_rng(SEED)
    k1 = _idct_phase(dev, rng)
    torch.cuda.empty_cache()
    slice_counts, blobs, sources = _batch_phase(dev, rng)
    batch = blobs * 4
    mp = sum(im.shape[0] * im.shape[1] for im in sources * 4) / 1e6
    wires, nibble_items = _wires_phase(dev, batch, mp)
    pallas_counts = _pallas_batch_phase(dev, batch, nibble_items, mp)
    lanes_batch = _lanes_batch_phase(dev, batch, nibble_items, mp)
    del nibble_items
    torch.cuda.empty_cache()
    waves_counts = _waves_phase(dev, batch, mp)
    torch.cuda.empty_cache()
    mixed_counts, enc, mixed_batch = _mixed_phase(dev, blobs, sources,
                                                  mixed_futs)
    torch.cuda.empty_cache()
    exact_counts = _batch_exact_phase(dev, batch, mp,
                                      wires["nibble"]["mp_per_s"])
    torch.cuda.empty_cache()

    # Images of the entropy and single-image phases: (a) and (d) are 4K
    # frames made here, (b) and (c) the batch's 4:4:4 DRI 8 and 4:2:0 DRI 0
    # images.
    t0 = time.perf_counter()
    img_a = _image(rng, 2160, 3840)
    blob_a, _ = encode(img_a, samplings=((2, 2), (1, 1), (1, 1)),
                       quality=90, restart_interval=240)
    img_d = _image(rng, 2160, 3840)
    blob_d, _ = encode(img_d, samplings=((2, 2), (1, 1), (1, 1)),
                       quality=90, restart_interval=0)
    images = {"a": (blob_a, img_a), "b": (blobs[6], sources[6]),
              "c": (blobs[0], sources[0]), "d": (blob_d, img_d)}
    print(f"entropy inputs: (a) 3840x2160 4:2:0 q90 DRI 240, "
          f"{len(blob_a) / 1e6:.2f} MB; (b) 1920x1080 4:4:4 q95 DRI 8, "
          f"{len(blobs[6]) / 1e6:.2f} MB; (c) 1920x1080 4:2:0 q90 DRI 0, "
          f"{len(blobs[0]) / 1e6:.2f} MB; (d) 3840x2160 4:2:0 q90 DRI 0, "
          f"{len(blob_d) / 1e6:.2f} MB; (a) and (d) encoded in "
          f"{time.perf_counter() - t0:.1f} s (set-up)")
    k1["on_jpeg_coefficients"] = _idct_jpeg_phase(dev, blob_d)
    k5 = _idct_exact_phase(dev, rng, blob_d)
    torch.cuda.empty_cache()
    k2 = _entropy_phase(dev, images, _cell_frames(dev))
    counts = _decode_phase(dev, images)
    strict_frames = {"cmyk": enc["cmyk"], "ycck": enc["ycck"],
                     "adobe rgb": enc["adobe rgb"],
                     "12-bit 4:2:0": enc["12-bit"], "gray": enc["gray"]}
    strict_counts, cpu_fancy = _strict_phase(dev, images, strict_frames)
    k7, k2_12, lanes_counts = _lanes_phase(
        dev, {**{f"({t})": v for t, v in images.items()},
              "12-bit 4:2:0 DRI 0": enc["12-bit"],
              "12-bit 4:2:0 DRI 8": enc["12-bit dri"]},
        {**cpu_fancy, "12-bit 4:2:0 DRI 0": cpu_fancy["12-bit 4:2:0"]})
    torch.cuda.empty_cache()
    k7["B=24"] = _k7_batch_phase(dev, blobs)
    torch.cuda.empty_cache()
    k8 = _prog_phase(dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    big_blob = big_fut.result()
    print(f"big frame: encoded in the pool, {time.perf_counter() - t0:.1f} s "
          "more waited for here (set-up)")
    k7["big_frame"] = _big_frame_phase(dev, big_blob)
    torch.cuda.empty_cache()
    dyn = [f.result() for f in dyn_futs]
    k7["sharded_bucket"] = _sharded_phase(dev, batch, mp, mixed_batch, dyn,
                                          big_blob)
    sharded = k7["sharded_bucket"].pop("launches")
    exact_probe = k7["sharded_bucket"].pop("exact_probe")
    torch.cuda.empty_cache()
    k6a, k6b = _k6_phase(dev, batch, mixed_batch, dyn, big_blob)
    k6_paths = _k6_routes(dev, batch, mp)
    k6b["sharded_exact_probe"] = exact_probe
    k7c, k7c_v1 = _carry_check(dev, batch)
    mesh = _mesh_phase(dev, batch, mixed_batch, dyn, images["a"][0])
    pool.shutdown()
    del big_blob
    torch.cuda.empty_cache()
    _cli_phase(dev, {**strict_frames, "c": images["c"]})
    _examples_phase(dev, batch, mixed_batch)
    probes = _probe_phase(dev)
    kw = dict(entropy="pallas", idct="pallas", upsample="fancy", device=dev)
    _profile({f"decode() ({tag})": (lambda b=blob: decode(b, **kw))
              for tag, (blob, _) in images.items()},
             ("fused_dequant_idct",
              *(k for keys in K2_PHASES.values() for k in keys)))

    # Every checked run of a path, counts zeroed just before it.
    paths = {
        "BatchDecoder": slice_counts,
        **{f"BatchDecoder wire={w}": r["launches"] for w, r in wires.items()},
        "BatchDecoder entropy=pallas": pallas_counts,
        "BatchDecoder mixed frames": mixed_counts,
        "BatchDecoder wave=64": waves_counts,
        "BatchDecoder idct=exact": exact_counts, "decode": counts,
        "decode strict": strict_counts,
        "BatchDecoder entropy=hybrid": lanes_batch["hybrid"],
        "BatchDecoder entropy=jax": lanes_batch["jax"],
        "decode jax/hybrid": lanes_counts,
        **{f"decode_batch_sharded {k}": v for k, v in sharded.items()
           if k != "e2e_mp_per_s"}, **k6_paths}
    for key, rec in (("K1", k1), ("K5", k5), ("K6a", k6a), ("K6b", k6b)):
        rec["launches_by_path"] = {p: c[key] for p, c in paths.items()}
    k1["launches"] = sum(k1["launches_by_path"].values())
    k2["launches_by_path"] = {
        "BatchDecoder entropy=pallas": pallas_counts["K2"],
        "decode": counts["K2"], "decode strict": strict_counts["K2"],
        "BatchDecoder entropy=hybrid": lanes_batch["hybrid"]["K2"],
        "BatchDecoder entropy=jax": lanes_batch["jax"]["K2"],
        "decode jax/hybrid": lanes_counts["K2"],
        **{f"decode_batch_sharded {k}": v["K2"] for k, v in sharded.items()
           if k != "e2e_mp_per_s"}}
    k2["launches"] = sum(k2["launches_by_path"].values())
    k2["by_image"].update(k2_12)
    for rec, key in zip(probes, ("K3", "K4")):
        rec["launches"] = counts[key]   # on no path: 0
    k5["launches"] = sum(k5["launches_by_path"].values())
    k7["launches_by_path"] = {
        "BatchDecoder entropy=hybrid": lanes_batch["hybrid"]["K7"],
        "decode jax/hybrid": lanes_counts["K7"],
        **{f"decode_batch_sharded {k}": v["K7"] for k, v in sharded.items()
           if k != "e2e_mp_per_s"}}
    decode_counts = k8["K8a"].pop("decode_counts")
    for key, rec in k8.items():
        rec["launches_by_path"] = {
            "decode/decode_to_planes pallas, jax, hybrid": decode_counts[key],
            "decode_batch_sharded mixed": sharded["mixed"][key]}
    # The mesh route's launches, each grid's ranks summed.
    for key, rec in (("K1", k1), ("K2", k2), ("K5", k5), ("K6a", k6a),
                     ("K6b", k6b), ("K7", k7), ("K7c", k7c),
                     ("K7c v1", k7c_v1), *k8.items()):
        rec.setdefault("launches_by_path", {}).update(mesh.get(key, {}))
        rec["launches"] = sum(rec["launches_by_path"].values())
    print(json.dumps({"kernels": [k1, k2, *probes, k5, k6a, k6b, k7, k7c,
                                  k7c_v1, *k8.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(_card())  # the card's name and power limit
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")

    _build_all()
    # The encode pool: the >= 50 MP frame first (about 80 s of one
    # process), then the mixed-frame jobs, all overlapping the phases
    # before they are needed.
    pool = ProcessPoolExecutor(
        min(6, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))
    big_fut = pool.submit(_encode_big, SEED + 1)
    mixed_futs = {k: pool.submit(_encode_job, *v) for k, v in
                  sorted(MIXED_JOBS.items(), key=lambda kv: -kv[1][1])}
    dyn_futs = [pool.submit(_encode_dyn, SEED + 40 + k, *job)
                for k, job in enumerate(DYN_JOBS)]
    try:
        return _phases(dev, pool, big_fut, mixed_futs, dyn_futs)
    finally:
        # A failed phase must not leave encoder processes behind.
        for proc in list((pool._processes or {}).values()):
            proc.terminate()
        pool.shutdown(wait=False, cancel_futures=True)


if __name__ == "__main__":
    sys.exit(main())
