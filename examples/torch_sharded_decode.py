"""Example: the PyTorch port's sharded decode over a ('data', 'seg') mesh.

The counterpart of examples/sharded_decode.py for jpeg_decoder_tpu_torch:
one process per rank, a torch.distributed process group and a DeviceMesh.
Restart segments and emit lanes split over 'seg' (DC predictors reset at
every RSTn; the DC carry crosses the ranks inside one segment), images
over 'data'.  The inputs are made here from a seed by the port's own
encoder (testing/encoder.py), and a progressive frame from its committed
fixtures.

Run:  python examples/torch_sharded_decode.py [--procs N] [--grid D S]
                                               [--device-type cuda|cpu]

By default each rank decodes on its GPU (rank % GPUs) over NCCL, and stops
without one; ranks that share one GPU need ``--backend gloo``.  With
``--device-type cpu`` N gloo processes run the kernels' plain versions.
"""

import argparse
import os
import socket
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from jpeg_decoder_tpu_torch import decode  # noqa: E402
from jpeg_decoder_tpu_torch.io import parser  # noqa: E402
from jpeg_decoder_tpu_torch.ops import scan_prep  # noqa: E402
from jpeg_decoder_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from jpeg_decoder_tpu_torch.parallel import multihost, sharded  # noqa: E402
from jpeg_decoder_tpu_torch.testing.encoder import encode  # noqa: E402
from jpeg_decoder_tpu_torch.testing.photo import FIXTURES_DIR  # noqa: E402


def _photo(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / w, y * 255.0 / h,
                     (x + y) * 127.0 / (w + h) + 60], axis=-1)
    return np.clip(base + rng.normal(0.0, 8.0, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _rank(rank: int, args, addr: str) -> None:
    multihost.initialize(addr, args.procs, rank,
                         device_type=args.device_type, backend=args.backend)
    mesh = mesh_mod.make_mesh(tuple(args.grid),
                              device_type=args.device_type)
    dev = mesh_mod.mesh_device(mesh)
    say = print if rank == 0 else (lambda *a, **k: None)
    one = dict(idct="pallas", upsample="fancy", device=dev)

    # One restart image (DRI 6: 10 segments), its segments over 'seg'.
    blob, _ = encode(_photo(1, 96, 160), restart_interval=6, quality=90)
    hdr = parser.parse(blob)
    scan = hdr.scans[0]
    got = sharded.decode_scan_sharded(hdr, scan, mesh)
    ref = sharded.decode_scan_sharded(hdr, scan, dev)
    assert np.array_equal(got, ref)
    say(f"decode_scan_sharded: {len(scan.seg_offsets) - 1} segments over "
        f"mesh {tuple(mesh.mesh.shape)}, equal to one device")

    # full_decode_step: a batch of 4 copies, images over 'data'.
    words, nm, _bc, _mm, _lay = scan_prep.prepare_scan(hdr, scan)
    rgb, _err, err_img = sharded.full_decode_step(
        hdr, np.stack([words] * 4), np.stack([nm] * 4), mesh,
        idct="pallas")
    rgb = multihost.process_allgather(rgb, mesh)
    assert not bool(multihost.process_allgather(err_img, mesh).any())
    want = decode(blob, entropy="pallas", **one).rgb
    assert all(torch.equal(r, want) for r in rgb)
    say(f"full_decode_step: batch of 4, this rank held "
        f"{multihost.local_data_rows(mesh, 4)}, gathered equal to decode()")

    # decode_batch_sharded: a DRI-0 pair, a restart image, a progressive
    # frame (the port's committed 4:2:2 fixture; its lanes split over the
    # whole mesh) and a multi-scan one (host fallback).
    with open(os.path.join(FIXTURES_DIR, "progressive_422.jpg"), "rb") as f:
        prog = f.read()
    blobs = [encode(_photo(2, 64, 96), quality=90)[0],
             encode(_photo(3, 64, 96), quality=90)[0], blob, prog,
             encode(_photo(5, 48, 64), scans=[(0,), (1, 2)])[0]]
    items = sharded.allgather_items(
        sharded.decode_batch_sharded(blobs, mesh, idct="pallas"), mesh)
    for it, b in zip(items, blobs):
        assert it.error is None, it.error
        assert torch.equal(it.rgb, decode(b, entropy="hybrid", **one).rgb)
    say(f"decode_batch_sharded: {len(blobs)} blobs, every item equal to "
        "decode() on every rank")
    torch.distributed.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--grid", type=int, nargs=2, default=None)
    ap.add_argument("--device-type", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None)
    args = ap.parse_args()
    args.grid = args.grid or [1, args.procs]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    mp.start_processes(_rank, args=(args, addr), nprocs=args.procs,
                       start_method="spawn")


if __name__ == "__main__":
    main()
