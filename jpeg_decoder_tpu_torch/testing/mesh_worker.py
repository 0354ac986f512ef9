"""One rank of a mesh run: joins the process group, builds the
('data', 'seg') mesh, runs the phases it is told to on the inputs it is
given, and writes what this rank holds to ``<out>/rank<r>.npz`` (arrays)
and ``<out>/rank<r>.json`` (errors, flags, kernel launch counts, timings).
Exits non-zero on any failure.  The CPU tests (``tests/test_torch_mesh.py``,
gloo processes on the CPU, where the kernels run their plain versions) and
``chip_smoke.py`` (NCCL or gloo ranks on the card) spawn it::

    python -m jpeg_decoder_tpu_torch.testing.mesh_worker --rank R \\
        --world N --addr 127.0.0.1:PORT --grid D S [--device-type cpu] \\
        --inputs in.npz --out DIR --phases batch:mixed,scan:dri7

The ranks decode on the card (one CUDA device per rank, NCCL) unless
``--device-type cpu`` asks for the CPU (gloo).

``--inputs`` is an ``.npz`` of JPEG blobs as uint8 arrays named
``<set>/<k>``; a phase ``kind:set`` runs on set ``set`` in order of k, on
the mesh of ``--grid`` or, as ``kind@DxS:set``, on a (D, S) mesh of its
own (every rank builds the meshes in the same order), and with the IDCT of
``--idct`` or, as ``kind+IDCT:set`` (after any ``@DxS``), its own:

* ``batch``: ``decode_batch_sharded(blobs, mesh, idct=...)``; per item its
  error, and the RGB of the rows this rank holds and of the whole batch
  after ``allgather_items``;
* ``scan`` / ``planes``: ``decode_scan_sharded`` / ``decode_planes_sharded``
  of each blob;
* ``step``: ``full_decode_step`` of the set (one geometry, restart
  streams): the whole RGB, err and err_img after ``process_allgather``;
* ``pixels``: ``batch_pixel_pipeline`` of the set's native planes (one
  geometry), gathered over 'data' x 'seg';
* ``prog``: ``decode_progressive_lanes(hdr, mesh)`` planes of each blob;
* ``emit``: K7 over the mesh on each blob alone (the uniform group route's
  entropy step, ``sharded._k7_shared``): its scan blocks, the MCU where each
  rank's lanes start, and the restart interval;
* ``lanes``: per chained scan of each (DRI-0 progressive) blob, the
  skeleton lanes with the first lane of rank 1's share moved one bit on:
  every rank's lane flags (rank 0's last lane must be flagged);
* ``meshes`` (no set): ``make_mesh`` and ``global_mesh`` shapes and rank
  arrays, ``local_data_rows`` for batches of 1-9, and the error a
  ``"cuda"`` mesh gives on a machine without a card;
* ``collectives`` (no set): the transport under every collective of the
  mesh routes, on the 'seg', 'data' and whole-mesh lines of this rank (the
  last the world group the flags ride), lines of one rank included, where
  the routes skip it: tensors of six dtypes and odd byte counts gathered
  from every rank of the line, row gathers of uneven counts and sums, each
  held to what the line's ranks sent; any difference fails the rank.

``--save digest`` writes SHA-256 digests of the arrays instead of the
arrays (the card's batches); ``--repeat K`` times the ``batch`` phases of
the sets ``--timed`` names K times after a warm-up (a barrier before each)
and records each call's wall time and ``last_timing``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import collectives as coll
from ..io import parser
from ..ops import (emit_carry_cuda, entropy_cuda, entropy_emit_cuda,
                   entropy_prog, entropy_prog_cuda, entropy_spec, idct_cuda,
                   idct_exact_cuda, pixels_cuda, scan_prep)
from ..parallel import mesh as mesh_mod
from ..parallel import multihost, sharded

#: The kernels whose launches a phase counts, by name.
KERNELS = {"K1": idct_cuda.fused_dequant_idct,
           "K2": entropy_cuda.decode_segments,
           "K5": idct_exact_cuda.dequant_idct_exact,
           "K7": entropy_emit_cuda.decode_lanes,
           "K7c": emit_carry_cuda.carry_pack,
           "K6a": pixels_cuda.unpack_nibble,
           "K6b": pixels_cuda.blocks_to_rgb,
           **entropy_prog_cuda.KERNELS}


def zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def counts() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


class Out:
    """What this rank writes: arrays (or their digests) and JSON facts."""

    def __init__(self, digest: bool):
        self.digest = digest
        self.arrays: dict = {}
        self.facts: dict = {}

    def put(self, name: str, a) -> None:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        a = np.ascontiguousarray(a)
        if self.digest:
            self.facts.setdefault("digests", {})[name] = (
                hashlib.sha256(a.tobytes()).hexdigest(), list(a.shape),
                str(a.dtype))
        else:
            self.arrays[name] = a


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _batch(out: Out, name: str, blobs, mesh, dev, args, idct) -> None:
    kw = dict(idct=idct, upsample="fancy")
    calls = []
    if args.repeat and name.rsplit(":", 1)[-1] in args.timed.split(","):
        sharded.decode_batch_sharded(blobs, mesh, **kw)     # warm-up
        for _ in range(args.repeat):
            dist.barrier()
            t0 = time.perf_counter()
            sharded.decode_batch_sharded(blobs, mesh, **kw)
            _sync(dev)
            calls.append({"wall_s": time.perf_counter() - t0,
                          "timing": _plain(
                              sharded.decode_batch_sharded.last_timing)})
    dist.barrier()
    _sync(dev)
    zero_counts()
    items = sharded.decode_batch_sharded(blobs, mesh, **kw)
    _sync(dev)
    got = counts()
    facts = {"counts": got, "calls": calls,
             "timing": _plain(sharded.decode_batch_sharded.last_timing),
             "errors": [None if it.error is None else repr(it.error)
                        for it in items],
             "rows": [it.rows for it in items],
             "batch_index": [it.batch_index for it in items]}
    facts["elsewhere_raises"] = []
    for k, it in enumerate(items):
        if it.error is None and (it.rows is None
                                 or it.rows[0] <= it.batch_index
                                 < it.rows[1]):
            out.put(f"{name}/own/{k}", it.rgb)
        elif it.error is None:
            try:
                it.rgb
            except IndexError:
                facts["elsewhere_raises"].append(k)
    for k, it in enumerate(sharded.allgather_items(items, mesh)):
        if it.error is None:
            out.put(f"{name}/rgb/{k}", it.rgb)
    out.facts[name] = facts


def _plain(timing: dict) -> dict:
    """``last_timing`` as JSON."""
    return json.loads(json.dumps(timing, default=str))


def _scan(out: Out, name: str, blobs, mesh, planes: bool) -> None:
    zero_counts()
    for k, blob in enumerate(blobs):
        hdr = parser.parse(blob)
        if planes:
            for c, p in enumerate(sharded.decode_planes_sharded(hdr, mesh)):
                out.put(f"{name}/plane/{k}/{c}", p)
        else:
            out.put(f"{name}/coef/{k}",
                    sharded.decode_scan_sharded(hdr, hdr.scans[0], mesh))
    out.facts[name] = {"counts": counts()}


def _step(out: Out, name: str, blobs, mesh, idct) -> None:
    hdrs = [parser.parse(b) for b in blobs]
    prepped = [scan_prep.prepare_scan(h, h.scans[0])[:2] for h in hdrs]
    s_max = max(len(nm) for _, nm in prepped)
    w_max = max(w.shape[1] for w, _ in prepped)
    words = np.zeros((len(hdrs), s_max, w_max), np.uint32)
    nm_b = np.zeros((len(hdrs), s_max), np.int32)
    for k, (w, nm) in enumerate(prepped):
        words[k, :w.shape[0], :w.shape[1]] = w
        nm_b[k, :len(nm)] = nm
    zero_counts()
    rgb, err, err_img = sharded.full_decode_step(
        hdrs[0], words, nm_b, mesh, idct=idct, upsample="fancy")
    out.facts[name] = {"counts": counts(), "rows": len(rgb)}
    for key, t in (("rgb", rgb), ("err", err), ("err_img", err_img)):
        out.put(f"{name}/{key}", multihost.process_allgather(t, mesh))


def _pixels(out: Out, name: str, blobs, mesh, idct) -> None:
    from ..models.decoder import decode_to_planes

    hdrs = [parser.parse(b) for b in blobs]
    planes = [decode_to_planes(h, "native") for h in hdrs]
    batch = tuple(np.stack([np.asarray(p[c]) for p in planes])
                  for c in range(len(hdrs[0].components)))
    qts = [hdrs[0].quant_tables[c.tq].values for c in hdrs[0].components]
    zero_counts()
    rgb = sharded.batch_pixel_pipeline(batch, qts, hdrs[0], mesh,
                                       idct=idct)
    out.facts[name] = {"counts": counts(), "rows": len(rgb)}
    out.put(f"{name}/rgb", multihost.process_allgather(
        rgb, mesh, mesh_mod.AXES))


def _prog(out: Out, name: str, blobs, mesh) -> None:
    zero_counts()
    for k, blob in enumerate(blobs):
        hdr = parser.parse(blob)
        planes = entropy_prog.decode_progressive_lanes(hdr, mesh,
                                                       as_device=True)
        for c, p in enumerate(planes):
            out.put(f"{name}/plane/{k}/{c}", p)
    out.facts[name] = {"counts": counts()}


def _emit(out: Out, name: str, blobs, mesh, dev) -> None:
    _, place = sharded._target(mesh)
    facts = {"first_mcu": [], "ri": []}
    zero_counts()
    for k, blob in enumerate(blobs):
        hdr = parser.parse(blob)
        scan = hdr.scans[0]
        (pools, starts, nm, lane_off, t_sym, _, _, seg_first,
         skel_ok) = entropy_spec.device_plan(hdr, [scan])
        assert skel_ok.all(), "walk failed"
        luts, l1 = entropy_cuda.device_tables(hdr, scan, dev)
        args = tuple(torch.from_numpy(a).to(dev) for a in (
            pools, starts, nm, lane_off, seg_first)) + (luts,)
        lay = sharded.scan_layout(hdr)
        bpm = lay.blocks_per_mcu
        rec = {"exchange_s": 0.0, "exchange_bytes": 0}
        blocks, err = sharded._k7_shared(
            args, rec, place, nm, lane_off, [scan.restart_interval],
            [lay.n_mcus], block_comp=entropy_spec._block_comp(hdr),
            rows=lay.n_mcus * bpm, n_comps=len(hdr.components),
            n_mcus=lay.n_mcus, trips=t_sym, precision=hdr.precision, l1=l1)
        assert not bool(err.any()), "K7 flagged the image"
        c = starts.shape[1]
        facts["first_mcu"].append([
            int(lane_off[0, mesh_mod.split(c, place.n_seg, q)[0]]
                // (64 * bpm)) for q in range(place.n_seg)])
        facts["ri"].append(scan.restart_interval)
        out.put(f"{name}/blocks/{k}", blocks[0])
    facts["counts"] = counts()
    out.facts[name] = facts


def _lanes(out: Out, name: str, blobs, mesh, dev) -> None:
    ranks = mesh_mod.size(mesh)
    facts = []
    for blob in blobs:
        hdr = parser.parse(blob)
        _, planes = entropy_prog._zero_planes(hdr, dev)
        nzmaps: dict = {}
        for k, scan in enumerate(hdr.scans):
            lanes = entropy_prog.hybrid_scan_prep(hdr, scan, nzmaps,
                                                  target_lanes=8)
            if lanes is None:
                continue
            s = len(lanes[0])
            cut = -(-s // ranks)          # rank 1's first lane
            nxt = lanes[0][cut + 1] if cut + 1 < s else len(scan.data) * 8
            if cut >= s or lanes[1][cut] == 0 or nxt <= lanes[0][cut] + 1:
                # No lane there with bits to move one on: just apply it.
                entropy_prog.apply_scan_device(hdr, scan, planes,
                                               lanes=lanes, mesh=mesh)
                continue
            moved = (lanes[0].copy(),) + tuple(lanes[1:])
            moved[0][cut] += 1
            errs: list = []
            entropy_prog.apply_scan_device(hdr, scan, [p.clone()
                                                       for p in planes],
                                           lanes=moved, err_sink=errs,
                                           mesh=mesh)
            entropy_prog.apply_scan_device(hdr, scan, planes, lanes=lanes,
                                           err_sink=errs, mesh=mesh)
            facts.append({"scan": k, "lanes": s, "cut": cut,
                          "moved": errs[0].cpu().tolist(),
                          "true": errs[1].cpu().tolist()})
    out.facts[name] = facts


def _sent(rank: int, dtype, rows: int = 3) -> torch.Tensor:
    """What rank ``rank`` sends in the ``collectives`` phase: (rows, 5)
    values of ``dtype`` that differ from rank to rank."""
    x = (torch.arange(rows * 5).reshape(rows, 5) * 31 + rank * 7) % 251
    return x % 2 == 1 if dtype == torch.bool else x.to(dtype)


def _collectives(out: Out, name: str, mesh, dev) -> None:
    dtypes = (torch.uint8, torch.bool, torch.int16, torch.int32,
              torch.int64, torch.float32)
    me = dist.get_rank()
    facts = {"backend": dist.get_backend(), "lines": {}, "checked": 0}

    def same(got, want, what):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{what}: {got.cpu()} != {want}")
        facts["checked"] += 1

    for axes in ("seg", "data", tuple(mesh.mesh_dim_names)):
        key = "+".join((axes,) if isinstance(axes, str) else axes)
        group, line = coll.line_group(mesh, axes)
        facts["lines"][key] = line
        for dt in dtypes:
            for got, r in zip(coll.gather_over(_sent(me, dt).to(dev), group,
                                               line), line):
                same(got, _sent(r, dt), f"gather_over {key} {dt} rank {r}")
            for got, r in zip(coll.all_gather(_sent(me, dt).to(dev), mesh,
                                              axes), line):
                same(got, _sent(r, dt), f"all_gather {key} {dt} rank {r}")
        want = sum(_sent(r, torch.int32) for r in line)
        same(coll.reduce_over(_sent(me, torch.int32).to(dev), group), want,
             f"reduce_over {key}")
        same(coll.all_reduce_sum(_sent(me, torch.int32).to(dev), mesh, axes),
             want, f"all_reduce_sum {key}")
        held = [k % 3 + 1 for k in range(len(line))]
        parts = coll.all_gather_rows(
            _sent(me, torch.int64, held[line.index(me)]).to(dev), mesh, axes,
            held)
        for got, r, n in zip(parts, line, held):
            same(got, _sent(r, torch.int64, n), f"all_gather_rows {key}")
    facts["counts"] = counts()
    out.facts[name] = facts


def _meshes(out: Out, args) -> None:
    world = dist.get_world_size()
    facts = {"world": world, "meshes": {}, "rows": {}}
    shapes = [(1, world), (world, 1)]
    if world == 4:
        shapes.append((2, 2))
    for shape in shapes:
        m = mesh_mod.make_mesh(shape, device_type=args.device_type)
        facts["meshes"][str(shape)] = {
            "shape": list(m.mesh.shape), "ranks": m.mesh.tolist(),
            "names": list(m.mesh_dim_names),
            "coordinate": list(m.get_coordinate()),
            "rows": {b: multihost.local_data_rows(m, b)
                     for b in range(1, 10)}}
    g = multihost.global_mesh()
    facts["global"] = {"shape": list(g.mesh.shape), "ranks": g.mesh.tolist()}
    s1 = mesh_mod.make_mesh(device_type=args.device_type)
    facts["default"] = list(s1.mesh.shape)
    one = mesh_mod.single_axis_mesh(device_type=args.device_type)
    facts["single"] = [list(one.mesh.shape), list(one.mesh_dim_names)]
    try:
        mesh_mod.make_mesh(device_type="cuda")
        facts["cuda_error"] = None
    except RuntimeError as e:
        facts["cuda_error"] = str(e)
    out.facts["meshes"] = facts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--addr", required=True, help="host:port")
    ap.add_argument("--grid", type=int, nargs=2, required=True,
                    metavar=("DATA", "SEG"))
    ap.add_argument("--device-type", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None)
    ap.add_argument("--local", type=int, default=None,
                    help="ranks per host (multihost.initialize)")
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--phases", default="")
    ap.add_argument("--idct", default="pallas")
    ap.add_argument("--repeat", type=int, default=0)
    ap.add_argument("--timed", default="", help="sets whose batch phases "
                    "--repeat times")
    ap.add_argument("--save", default="arrays", choices=("arrays", "digest"))
    args = ap.parse_args(argv)

    multihost.initialize(args.addr, args.world, args.rank, args.local,
                         device_type=args.device_type, backend=args.backend)
    out = Out(args.save == "digest")
    rc = 0
    meshes: dict = {}

    def mesh_of(grid):
        if grid not in meshes:
            meshes[grid] = mesh_mod.make_mesh(grid,
                                              device_type=args.device_type)
        return meshes[grid]

    try:
        dev = mesh_mod.mesh_device(mesh_of(tuple(args.grid)))
        sets: dict = {}
        if args.inputs:
            with np.load(args.inputs) as z:
                for key in z.files:
                    name, k = key.rsplit("/", 1)
                    sets.setdefault(name, []).append((int(k),
                                                      z[key].tobytes()))
        blobs = {n: [b for _, b in sorted(v)] for n, v in sets.items()}
        for phase in filter(None, args.phases.split(",")):
            kind, _, name = phase.partition(":")
            kind, _, idct = kind.partition("+")
            kind, _, grid = kind.partition("@")
            idct = idct or args.idct
            mesh = mesh_of(tuple(map(int, grid.split("x"))) if grid
                           else tuple(args.grid))
            t0 = time.perf_counter()
            if kind == "batch":
                _batch(out, phase, blobs[name], mesh, dev, args, idct)
            elif kind in ("scan", "planes"):
                _scan(out, phase, blobs[name], mesh, kind == "planes")
            elif kind == "step":
                _step(out, phase, blobs[name], mesh, idct)
            elif kind == "pixels":
                _pixels(out, phase, blobs[name], mesh, idct)
            elif kind == "prog":
                _prog(out, phase, blobs[name], mesh)
            elif kind == "emit":
                _emit(out, phase, blobs[name], mesh, dev)
            elif kind == "lanes":
                _lanes(out, phase, blobs[name], mesh, dev)
            elif kind == "meshes":
                _meshes(out, args)
            elif kind == "collectives":
                _collectives(out, phase, mesh, dev)
            else:
                raise ValueError(f"unknown phase {phase!r}")
            _sync(dev)
            out.facts.setdefault("phase_s", {})[phase] = \
                time.perf_counter() - t0
        dist.barrier()
    except Exception:  # noqa: BLE001 — the rank fails, the caller sees it
        traceback.print_exc()
        out.facts["failed"] = traceback.format_exc()
        rc = 1
    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out.arrays)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(out.facts, f)
    if rc == 0:
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
