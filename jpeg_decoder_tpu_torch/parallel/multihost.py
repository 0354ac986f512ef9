"""Multi-host decode: a ``torch.distributed`` process group and the global
``('data', 'seg')`` mesh over it.

Counterpart of ``jpeg_decoder_tpu/parallel/multihost.py``.  One process per
GPU: each host contributes its GPUs' ranks to a global mesh whose ``data``
axis runs over hosts (images shard across them) and whose ``seg`` axis runs
over the GPUs of a host (restart segments and lanes shard across those,
over NVLink), the layout the mesh routes of ``parallel/sharded.py`` and
``ops/entropy_prog.py`` expect.

Start a mesh in every process::

    multihost.initialize("host0:29500", n_processes, rank,
                         local_device_count=gpus_per_host)
    mesh = multihost.global_mesh()

``initialize`` sets the process's CUDA device (``rank % gpus_per_host``)
and joins an NCCL group; ``device_type="cpu"`` joins a gloo group for a run
on the CPU (the tests run two and four local CPU processes that way), and
``backend=`` overrides the backend (two ranks that share one card need
``"gloo"``: NCCL refuses them).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import mesh as mesh_mod

#: Ranks per host and device type of the group this process joined.
_local = {"count": None, "device_type": "cuda"}


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: int | None = None, *,
               device_type: str = "cuda", backend: str | None = None):
    """Join (or form) the process group: rank ``process_id`` of
    ``num_processes``, rendezvous at ``tcp://coordinator_address``
    (``host:port``).  ``local_device_count`` is the ranks (GPUs) per host,
    by default every CUDA device of this host (one host on the CPU).  On
    ``"cuda"`` the process's device becomes ``process_id %
    local_device_count`` and the backend NCCL; ``"cpu"`` takes gloo.
    Raises on ``"cuda"`` without a card."""
    device_type = mesh_mod._mesh_device_type(device_type)
    if device_type == "cuda":
        n_local = local_device_count or torch.cuda.device_count()
        torch.cuda.set_device(process_id % n_local)
        backend = backend or "nccl"
    else:
        n_local = local_device_count or num_processes
        backend = backend or "gloo"
    if num_processes % n_local:
        raise ValueError(f"{num_processes} processes are not whole hosts of "
                         f"{n_local}")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _local.update(count=n_local, device_type=device_type)


def global_mesh(seg_per_host: int | None = None):
    """The global ('data', 'seg') mesh: hosts on 'data', each host's ranks
    on 'seg' (``seg_per_host`` of them per 'seg' line, all by default).
    Ranks are numbered host after host, as ``torchrun`` numbers them."""
    mesh_mod._check_group()
    world = dist.get_world_size()
    per_host = _local["count"] or world
    seg = per_host if seg_per_host is None else seg_per_host
    if world % seg:
        raise ValueError(f"{world} ranks do not split into 'seg' lines of "
                         f"{seg}")
    return mesh_mod.make_mesh((world // seg, seg), mesh_mod.AXES,
                              device_type=_local["device_type"])


def local_data_rows(mesh, batch: int) -> list[int]:
    """The rows of a 'data'-sharded batch this rank holds: its 'data'
    coordinate's block of ``ceil(batch / n_data)`` rows (JAX's split)."""
    return list(range(*mesh_mod.split(batch, mesh_mod.size(mesh, "data"),
                                      mesh_mod.coordinate(mesh, "data"))))


def process_allgather(t: torch.Tensor, mesh, axes="data") -> torch.Tensor:
    """The whole of a batch sharded over ``axes`` (by default 'data'; the
    rows of each coordinate in order, as ``local_data_rows`` splits them),
    on every rank: the counterpart of ``jax.experimental.multihost_utils.
    process_allgather(x, tiled=True)`` for a 'data'-sharded array.  Ranks
    may hold different row counts (the last coordinate's block may be
    short)."""
    counts = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = [int(c) for c in torch.cat(mesh_mod.all_gather(
        counts, mesh, axes)).tolist()]
    return torch.cat(mesh_mod.all_gather_rows(t, mesh, axes, counts))
