"""Peaks of the card and the bytes each kernel must move.

A kernel's roofline share is the least time the card could take for its
work (its bytes over the HBM bandwidth: K2 and K6b do few operations a
byte) over the time the trace measured.  Bytes count each input read once
and each output written once, computed from the frames' shapes, as the
port's kernel table (PERF.md section 6) counts them; K2's input is the
frames' entropy-coded bytes rather than their padded words.
"""

from __future__ import annotations

import re

#: NVIDIA H100 SXM HBM3 bandwidth, bytes per second (NVIDIA's data sheet,
#: at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12

#: K2, ``csrc/entropy.cu``: its kernels, and the one it launches once per
#: ``decode_segments`` call.
K2_KERNELS = re.compile(
    r"(?<![A-Za-z0-9_])(build_l1|seg_chunks|sync|seal|offsets|write)_kernel"
    r"\b")
K2_LAUNCH = re.compile(r"(?<![A-Za-z0-9_])offsets_kernel\b")
#: K6b, ``csrc/pixels.cu``.
K6B_KERNELS = re.compile(r"(?<![A-Za-z0-9_])blocks_to_rgb_kernel\b")
#: Copies and sets, which are no kernel of the program.
COPIES = re.compile(r"^(Memcpy|Memset|memcpy|memset)")


def blocks(frame) -> int:
    """8x8 blocks the frame's interleaved scan codes."""
    return sum(int(p.shape[0]) * int(p.shape[1]) for p in frame.planes)


def k2_bytes(frame) -> int:
    """K2 on one frame: its entropy-coded bytes and its segments' MCU
    counts in, its natural-order int32 blocks out."""
    return frame.scan_bytes + 4 * frame.segments + 256 * blocks(frame)


def k6b_bytes(frames) -> int:
    """K6b on a batch of same-geometry frames: their blocks, tables and
    geometry in, the (B, H, W, 3) uint8 RGB out."""
    return sum(256 * blocks(f) + 4 * 64 * len(f.planes) + 16
               + 3 * f.height * f.width for f in frames)


def share(nbytes: float, seconds: float) -> float | None:
    """Percent of the byte roofline reached, None without a time."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds


def kernel_time(ops: list, pattern) -> tuple[float, int]:
    """(seconds, operations) of the device operations whose names match."""
    hit = [(a, b) for n, a, b in ops if pattern.search(n)]
    return sum(b - a for a, b in hit) * 1e-9, len(hit)


def k2_share(ctx) -> float | None:
    """K2's roofline share over a traced window: its launches there times
    the mean bytes of a completed request's frames, over K2's kernel time."""
    sec, _ = kernel_time(ctx.trace.device_ops, K2_KERNELS)
    _, launches = kernel_time(ctx.trace.device_ops, K2_LAUNCH)
    if not launches or not ctx.requests:
        return None
    per = sum(sum(k2_bytes(ctx.frames[i]) for i in r.frames)
              for r in ctx.requests) / len(ctx.requests)
    return share(per * launches, sec)
