"""The collectives of the port's meshes, over a :class:`Mesh`'s groups.

Serving (in place, invisible to autograd): the sum all-reduce after a
row-parallel matmul, the all-gather along a dim in rank order (the
embeddings' hidden dim, the head's vocab, the heads of an exported
page), and the host-object channel that carries rank 0's calls to the
other ranks.  They refuse a tensor that requires grad: training through
them would drop or double gradients without an error.

Training (``torch.autograd.Function``\\ s, each with its backward
written out, since GSPMD inserts these for the JAX package):

- :func:`copy_to_model`, Megatron's *f*: identity forward, the gradient
  summed over the ``"model"`` group backward;
- :func:`reduce_from_model`, *g*: the sum over ``"model"`` forward,
  identity backward (``torch.distributed.nn.functional.all_reduce``
  sums the gradient too, which would multiply it by tp);
- :func:`gather_seq`: all-gather of the sequence dim forward,
  reduce-scatter backward; :func:`scatter_seq`: reduce-scatter forward,
  all-gather backward (sequence parallelism around each block's pair of
  matmuls);
- :func:`split_seq`: a replicated tensor's own sequence slice forward,
  all-gather backward;
- :func:`gather_hidden`: all-gather along the last dim forward (the
  hidden-sharded embedding lookup), this rank's slice of the gradient
  backward;
- :func:`data_mean`: the mean over the ``"data"`` group forward,
  identity backward (the reported loss), and :func:`mean_grads_over_data`,
  the gradients' mean over ``"data"`` in one flat all-reduce.

Gloo carries CUDA tensors through its own host copies; NCCL keeps them
on the card.  Every rank runs the same collectives in the same order,
and each result is bit-identical on every rank of the group: an
all-reduce computes each element's sum once and hands it to every
rank."""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
import torch.distributed as dist

from kubegpu_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    tp_size,
)

SEQ_DIM = 1


def _no_grad_input(x: torch.Tensor, what: str) -> None:
    if x.requires_grad:
        raise RuntimeError(
            f"{what} runs an in-place collective that autograd does not "
            "see, so gradients through it would be wrong: training runs "
            "the autograd collectives (copy_to_model, reduce_from_model, "
            "gather_seq, scatter_seq, gather_hidden)")


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``x`` over the mesh's ``"model"`` ranks, in place; returns
    ``x``.  Refuses a tensor that requires grad."""
    _no_grad_input(x, "all_reduce_sum")
    dist.all_reduce(x, group=mesh.group)
    return x


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = -1) -> torch.Tensor:
    """Every ``"model"`` rank's ``x`` concatenated along ``dim`` in rank
    order: the whole tensor of which each rank holds ``1/tp`` along
    ``dim``.  Refuses a tensor that requires grad."""
    _no_grad_input(x, "all_gather")
    return _gather(x, mesh.group, tp_size(mesh), dim)


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


# -- training: the autograd collectives over the "model" group ---------------


def _sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.group)
    return y


def _slice(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    return x.chunk(tp_size(mesh), dim=dim)[mesh.coord(MODEL_AXIS)].contiguous()


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of every ``"model"``
    rank's ``x``."""
    parts = [p.contiguous() for p in x.chunk(tp_size(mesh), dim=dim)]
    out = torch.empty_like(parts[mesh.coord(MODEL_AXIS)])
    dist.reduce_scatter(out, parts, group=mesh.group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh.group, tp_size(mesh), SEQ_DIM)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, SEQ_DIM), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _reduce_scatter(x, mesh, SEQ_DIM)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh.group, tp_size(ctx.mesh), SEQ_DIM), None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _slice(x, mesh, SEQ_DIM)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh.group, tp_size(ctx.mesh), SEQ_DIM), None


class _GatherHidden(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh.group, tp_size(mesh), -1)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh, -1), None


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        y = x.detach().clone()
        dist.all_reduce(y, group=mesh.axis_group(DATA_AXIS))
        return y / mesh.axis_size(DATA_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """*f*: ``x`` (replicated over ``"model"``) as it is; its gradient is
    summed over the ``"model"`` ranks, each of which saw one shard's
    contribution."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """*g*: the sum of every ``"model"`` rank's partial ``x``; the
    gradient passes through unchanged."""
    return _ReduceFromModel.apply(x, mesh)


def gather_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(b, s / tp, ...)`` sequence shards -> the whole ``(b, s, ...)``
    on every ``"model"`` rank; the gradient is reduce-scattered back."""
    return _GatherSeq.apply(x, mesh)


def scatter_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Partial sums ``(b, s, ...)`` -> this rank's ``(b, s / tp, ...)``
    rows of their sum; the gradient is all-gathered back."""
    return _ScatterSeq.apply(x, mesh)


def split_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated ``(b, s, ...)`` -> this rank's ``(b, s / tp, ...)``
    rows; the gradient is all-gathered back."""
    return _SplitSeq.apply(x, mesh)


def gather_hidden(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Hidden shards ``(..., d / tp)`` -> the whole ``(..., d)`` on every
    ``"model"`` rank (exact: a concatenation); the gradient backward is
    this rank's slice of the whole one."""
    return _GatherHidden.apply(x, mesh)


def data_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``x`` over the ``"data"`` ranks; the gradient passes
    through unchanged (each data rank differentiates its own rows, and
    :func:`mean_grads_over_data` averages the gradients)."""
    if mesh.axis_size(DATA_AXIS) == 1:
        return x
    return _DataMean.apply(x, mesh)


def flat_all_reduce(tensors: Sequence[torch.Tensor], group,
                    scale: float = 1.0) -> None:
    """Sum ``tensors`` over ``group`` in one all-reduce of their
    concatenation (a fixed order: the order given), times ``scale``,
    written back in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def mean_grads_over_data(grads: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average ``grads`` over the ``"data"`` ranks in place: one
    all-reduce of all of them flattened, divided by dp."""
    dp = mesh.axis_size(DATA_AXIS)
    if dp > 1:
        flat_all_reduce(grads, mesh.axis_group(DATA_AXIS), 1.0 / dp)
