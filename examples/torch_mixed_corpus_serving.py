"""Example: the PyTorch port's one call for an arbitrary mixed corpus.

The counterpart of examples/mixed_corpus_serving.py for
jpeg_decoder_tpu_torch.  ``decode_batch_sharded`` takes JPEG bytes of any
mix (sizes, restart intervals, baseline and progressive, even corrupt
blobs) over a ('data', 'seg') mesh and returns RGB on each rank's device:

* baseline frames decode in emit lanes on the device, grouped by pow-2
  geometry bucket;
* progressive frames decode in the progressive scan kernels' lanes;
* arithmetic, 12-bit and multi-scan frames fall back per image to the host
  entropy path;
* a corrupt blob fails alone.

Run:  python examples/torch_mixed_corpus_serving.py [--procs N] [--grid D S]
                                                     [--device-type cuda|cpu]
                                                     [--glob 'dir/*.jpg']

One process per rank, as examples/torch_sharded_decode.py runs them (one
rank runs in this process): by
default one per GPU over NCCL (stopping without one), on the grid (2, N/2)
for an even N, else (1, N); ranks that share one GPU need ``--backend
gloo``, and ``--device-type cpu --procs 2`` runs gloo processes on the CPU.
The default corpus is made here from seeds (``testing/encoder.encode``, the
port's progressive fixture); ``--glob`` decodes files instead, and then
checks only that every file has its own result.  Rank 0 prints one line per
image with a sha256 of its RGB bytes, then the wall time of the call
(``--repeat R``: the best of R calls, the lines from the last).
"""

import argparse
import glob
import hashlib
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from jpeg_decoder_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from jpeg_decoder_tpu_torch.parallel import multihost, sharded  # noqa: E402
from jpeg_decoder_tpu_torch.testing.encoder import encode  # noqa: E402
from jpeg_decoder_tpu_torch.testing.photo import FIXTURES_DIR  # noqa: E402

CORRUPT = b"\xff\xd8not-a-jpeg"


def blob(w: int, h: int, seed: int, **kw) -> bytes:
    """examples/mixed_corpus_serving.py's ``blob``: block-constant random
    colours, q88 4:2:0, encoded by the port's encoder."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(h // 8 + 1, w // 8 + 1, 3))
    rgb = np.kron(base, np.ones((8, 8, 1)))[:h, :w].astype(np.uint8)
    return encode(rgb, quality=88, **kw)[0]


def corpus() -> list[bytes]:
    """The JAX example's six kinds in its order; the progressive frame is
    the committed 4:2:2 fixture (the port's encoder writes no progressive
    Huffman stream)."""
    with open(os.path.join(FIXTURES_DIR, "progressive_422.jpg"), "rb") as f:
        prog = f.read()
    return [
        blob(200, 150, 1),                            # baseline
        blob(137, 213, 2),                            # odd size
        blob(180, 120, 3, restart_interval=4),        # restart intervals
        prog,                                         # progressive
        CORRUPT,                                      # corrupt
        blob(96, 240, 5),
    ]


def digest(rgb: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        rgb.cpu().numpy()).tobytes()).hexdigest()


def _rank(rank: int, args, addr: str) -> None:
    multihost.initialize(addr, args.procs, rank,
                         device_type=args.device_type, backend=args.backend)
    mesh = mesh_mod.make_mesh(tuple(args.grid), device_type=args.device_type)
    if args.glob is None:
        blobs = corpus()
    else:
        blobs = []
        for p in sorted(glob.glob(args.glob)):
            with open(p, "rb") as f:
                blobs.append(f.read())
    walls = []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        items = sharded.allgather_items(sharded.decode_batch_sharded(
            blobs, mesh, idct="fast", upsample="fancy"), mesh)
        if args.device_type == "cuda":
            torch.cuda.current_stream().synchronize()
        walls.append(time.perf_counter() - t0)
    if rank == 0:
        for it in items:
            if it.error is not None:
                print(f"[{it.index}] FAILED (isolated): {it.error}")
                continue
            h, w = it.header.height, it.header.width
            kind = "progressive" if it.header.progressive else "baseline"
            print(f"[{it.index}] {w}x{h} {kind} -> device RGB "
                  f"{tuple(it.rgb.shape)} sha256 {digest(it.rgb)}")
    if [it.index for it in items] != list(range(len(blobs))):
        raise AssertionError("not one result per blob, in input order")
    if args.glob is None:
        failed = [it.index for it in items if it.error is not None]
        if failed != [blobs.index(CORRUPT)]:
            raise AssertionError(f"only the corrupt blob may fail: {failed}")
    if rank == 0:
        print(f"{len(blobs)} blobs served in {min(walls) * 1e3:.1f} ms "
              f"(calls {', '.join(f'{t * 1e3:.1f}' for t in walls)} ms) on "
              f"mesh {tuple(args.grid)} {args.device_type}; "
              f"{sum(it.error is not None for it in items)} isolated")
    torch.distributed.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=None,
                    help="ranks (default: the GPUs, or 2 on the CPU)")
    ap.add_argument("--grid", type=int, nargs=2, default=None)
    ap.add_argument("--device-type", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None)
    ap.add_argument("--glob", default=None,
                    help="JPEG files to decode (default: made here)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="calls timed; the lines are the last call's")
    args = ap.parse_args()
    if args.procs is None:
        args.procs = (max(1, torch.cuda.device_count())
                      if args.device_type == "cuda" else 2)
    n = args.procs
    args.grid = args.grid or ([2, n // 2] if n % 2 == 0 else [1, n])
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    if args.procs == 1:
        _rank(0, args, addr)
    else:
        mp.start_processes(_rank, args=(args, addr), nprocs=args.procs,
                           start_method="spawn")


if __name__ == "__main__":
    main()
