"""The collectives of tensor-parallel serving, over a :class:`Mesh`'s
groups: the sum all-reduce after a row-parallel matmul, the all-gather
along a dim in rank order (the embeddings' hidden dim, the head's vocab,
the heads of an exported page), and the host-object channel that carries
rank 0's calls to the other ranks.

Gloo carries CUDA tensors through its own host copies; NCCL keeps them
on the card.  Every rank runs the same collectives in the same order,
and each result is bit-identical on every rank: an all-reduce computes
each element's sum once and hands it to every rank."""

from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist

from kubegpu_tpu_torch.parallel.mesh import Mesh


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the mesh's ranks, in place; returns ``x``."""
    dist.all_reduce(x, group=mesh.group)
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order: the
    whole tensor of which each rank holds ``1/tp`` along ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def broadcast_object(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's picklable ``obj`` on every rank (the others pass None)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.control)
    return box[0]


def gather_objects(obj: Any, mesh: Mesh) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    out: List[Any] = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.control)
    return out
