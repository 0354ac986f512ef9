"""Device meshes over ``torch.distributed`` ranks (and, re-exported, the
collectives the mesh routes run on them).

Counterpart of ``jpeg_decoder_tpu/parallel/mesh.py``.  The decode has two
parallel axes: ``data`` (independent images, pure data parallelism) and
``seg`` (restart segments or lanes within a scan; DC predictors reset at
every RSTn).  One process drives one GPU, so where JAX builds a
``jax.sharding.Mesh`` over devices, the port builds a
``torch.distributed.device_mesh.DeviceMesh`` over ranks: lay ``data`` over
hosts and ``seg`` over the GPUs of a host, so that segment traffic rides
NVLink (``multihost.global_mesh``).

A mesh needs a process group (``multihost.initialize``, or the caller's own
``init_process_group``); these functions never start one.  The device type is
``"cuda"`` (each rank's current CUDA device) unless the caller asks for
``"cpu"``, where the kernels run their plain versions and gloo carries the
collectives.

The rank splits and collectives the mesh routes run (``split``, ``size``,
``coordinate``, ``all_gather``, ``all_gather_rows``, ``all_reduce_sum``, ...)
live in ``jpeg_decoder_tpu_torch/collectives.py``, below the ops and this
package, and are re-exported here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..collectives import (all_gather, all_gather_rows, all_reduce_sum,
                           coordinate, is_mesh, mesh_device, size, split)

__all__ = ["AXES", "make_mesh", "single_axis_mesh", "split", "is_mesh",
           "mesh_device", "size", "coordinate", "all_gather",
           "all_gather_rows", "all_reduce_sum"]

AXES = ("data", "seg")


def _check_group() -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: call multihost.initialize (or "
            "torch.distributed.init_process_group) in every process first")


def _mesh_device_type(device_type: str) -> str:
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device_type='cpu' for a mesh on the CPU")
    return device_type


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] = AXES, devices=None, *,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over ``devices`` (a list of ranks; all ranks of the world by
    default), reshaped to ``shape``.  The default shape is ``(1, ..., 1,
    n)``: every rank on the last axis, single-host segment parallelism, as
    in JAX.  Multi-host callers pass ``(n_hosts, ranks_per_host)`` or use
    ``multihost.global_mesh``.  Every rank of the world calls this with the
    same arguments (the mesh's sub-groups are made collectively)."""
    device_type = _mesh_device_type(device_type)
    _check_group()
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (len(ranks),)
    arr = torch.tensor(ranks, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(device_type, arr, mesh_dim_names=tuple(axis_names))


def single_axis_mesh(name: str = "seg", devices=None, *,
                     device_type: str = "cuda") -> DeviceMesh:
    """A one-axis mesh named ``name`` over ``devices`` (all ranks)."""
    return make_mesh(None, (name,), devices, device_type=device_type)
