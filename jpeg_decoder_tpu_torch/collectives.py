"""Rank splits and collectives over a ``torch.distributed`` ``DeviceMesh``.

The mesh routes of ``ops/entropy_prog.py`` and ``parallel/sharded.py`` cut
their work by mesh coordinate and exchange it with these; ``parallel/
mesh.py`` builds the meshes and re-exports them.  They sit below both
layers and import neither.

The collectives take a mesh and the names of the axes they run over.  Their
results are ordered by mesh coordinate, never by the group's own rank
order, and a line of one rank costs nothing.  Tensors go through the list
forms of ``all_gather`` and ``all_reduce``, which NCCL and gloo (CUDA
tensors included) both run, on the caller's current stream.
:func:`line_group`, :func:`gather_over` and :func:`reduce_over` are the
transport itself, with no short cut for one rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def split(n: int, parts: int, k: int) -> tuple[int, int]:
    """Part k, [lo, hi), of ``n`` items cut into ``parts`` of
    ``ceil(n / parts)`` (the last ones short or empty): how JAX pads an
    axis to a multiple of the mesh and shards it."""
    per = -(-n // parts)
    return min(k * per, n), min((k + 1) * per, n)


def is_mesh(x) -> bool:
    return isinstance(x, DeviceMesh)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank decodes on: its current CUDA device on a
    ``"cuda"`` mesh (set by ``multihost.initialize``; raises without a
    card), the CPU on a ``"cpu"`` one."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type != "cuda":
        raise ValueError(f"no decode on a {mesh.device_type!r} mesh")
    if not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh on a machine without a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _names(mesh: DeviceMesh, axes) -> tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names or ())
    if axes is None:
        return names
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in names:
            raise ValueError(f"mesh axes {names} have no {a!r}")
    return tuple(a for a in names if a in axes)   # in mesh order


def size(mesh: DeviceMesh, axes=None) -> int:
    """Ranks along ``axes`` (a name or names; all axes when None)."""
    dims = [mesh.mesh_dim_names.index(a) for a in _names(mesh, axes)]
    return int(np.prod([mesh.mesh.shape[d] for d in dims], dtype=np.int64))


def coordinate(mesh: DeviceMesh, axes=None) -> int:
    """This rank's index along ``axes`` flattened row-major (its position
    in the lanes or rows split over them)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not part of the mesh")
    idx = 0
    for a in _names(mesh, axes):
        d = mesh.mesh_dim_names.index(a)
        idx = idx * mesh.mesh.shape[d] + coord[d]
    return idx


def line_group(mesh: DeviceMesh, axes=None) -> tuple:
    """(process group, global ranks) of this rank's line along ``axes``
    (the other coordinates fixed), the ranks in flattened coordinate order.
    The group is the mesh's own sub-group for one axis, the world for all
    axes of a mesh over the whole world."""
    names = _names(mesh, axes)
    coord = mesh.get_coordinate()
    idx = tuple(slice(None) if a in names else coord[d]
                for d, a in enumerate(mesh.mesh_dim_names))
    line = [int(r) for r in mesh.mesh[idx].reshape(-1).tolist()]
    if len(names) == 1:
        return mesh.get_group(names[0]), line
    if len(names) == mesh.mesh.dim() and \
            mesh.mesh.numel() == dist.get_world_size():
        return dist.group.WORLD, line
    raise NotImplementedError(
        "collectives over several axes need a mesh over the whole world")


def gather_over(t: torch.Tensor, group, line: list[int]) -> list:
    """``t`` of every rank of ``line`` (global ranks, in the order wanted)
    through one ``all_gather`` on ``group``, also for one rank.  The bytes
    travel as int32, padded to a multiple of 4: gloo refuses uint8, uint16
    and bool CUDA tensors."""
    raw = t.contiguous().view(-1).view(torch.uint8)
    n = raw.numel()
    if n % 4:
        raw = torch.cat([raw, raw.new_zeros(4 - n % 4)])
    parts = [torch.empty_like(raw).view(torch.int32) for _ in line]
    dist.all_gather(parts, raw.view(torch.int32), group=group)
    grank = [dist.get_global_rank(group, i) if group is not
             dist.group.WORLD else i for i in range(len(line))]
    by_rank = dict(zip(grank, parts))
    return [by_rank[r].view(torch.uint8)[:n].view(t.dtype).view(t.shape)
            for r in line]


def reduce_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` through one ``all_reduce`` (a new
    tensor), also for one rank."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather(t: torch.Tensor, mesh: DeviceMesh, axes) -> list:
    """``t`` of every rank of this rank's line along ``axes``, in
    coordinate order (every rank passes a tensor of the same shape and
    dtype; :func:`gather_over`)."""
    group, line = line_group(mesh, axes)
    return [t] if len(line) == 1 else gather_over(t, group, line)


def all_gather_rows(t: torch.Tensor, mesh: DeviceMesh, axes,
                    counts: list[int], dim: int = 0) -> list:
    """``t`` of every rank of the line, in coordinate order, where rank k
    holds ``counts[k]`` entries along ``dim``: padded to the most entries
    for the collective, cut back after it."""
    n = max(max(counts), 1)
    pad = t
    if t.shape[dim] < n:
        shape = list(t.shape)
        shape[dim] = n - t.shape[dim]
        pad = torch.cat([t, t.new_zeros(shape)], dim)
    parts = all_gather(pad, mesh, axes)
    return [p.narrow(dim, 0, c) for p, c in zip(parts, counts)]


def all_reduce_sum(t: torch.Tensor, mesh: DeviceMesh, axes) -> torch.Tensor:
    """The sum of ``t`` over this rank's line along ``axes`` (a new
    tensor)."""
    group, line = line_group(mesh, axes)
    return t.clone() if len(line) == 1 else reduce_over(t, group)
