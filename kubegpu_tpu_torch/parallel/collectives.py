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
  sums the gradient too, which would multiply it by tp).  Both take an
  ``axis``: over ``"expert"`` they are expert parallelism's pair (each
  rank runs its own experts on the replicated tokens, and the combine's
  contraction over the experts is the sum);
- :func:`psum`: the sum over an axis forward and the sum of the
  gradient backward (``jax.lax.psum``'s pair), for a value that every
  rank of the axis goes on to use whole (the MoE router's batch
  statistics over ``"data"``);
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
  the gradients' mean over ``"data"`` in one flat all-reduce;
- :func:`global_batch_norm`: training-mode BatchNorm whose statistics
  are the global batch's, as GSPMD reduces them for the JAX ResNet: the
  f32 ``[sum x, sum x^2]`` of each channel summed over ``"data"`` in one
  all-reduce forward, the two sums the input gradient needs (``sum dy``
  and ``sum dy * xhat``) in one all-reduce backward.

Context parallelism, along the ``"seq"`` axis (the JAX collectives
``ppermute``, ``all_to_all`` and GSPMD's gathers, written out):

- :func:`ring_shift`: rank i's tensor to rank (i + 1) % n, rank
  (i - 1) % n's received, one ``batch_isend_irecv`` with the sends and
  receives posted together; as an autograd function its gradient
  shifts the other way (the transpose of ``ppermute``); a list of
  tensors shifts in one batch, outside autograd;
- :func:`seq_to_heads` / :func:`heads_to_seq`: the Ulysses all-to-alls
  (``all_to_all_single`` on a contiguous repack), each the other's
  backward;
- :func:`gather_axis`: all-gather forward, reduce-scatter backward,
  over any axis and along any dim (the einsum attention's K/V under CP,
  and under TP x CP the q, k and v of heads replicated over
  ``"model"``);
- :func:`mesh_mean` and :func:`mean_grads_over_mesh`: the loss's and the
  gradients' mean over every rank (``"data"`` x ``"seq"``), the
  parameters being replicated on each; on a 3-D mesh
  :func:`data_seq_mean` and :func:`mean_grads_over_data_seq` take them
  over this rank's ``"data"`` x ``"seq"`` plane, since a parameter
  sharded over ``"model"`` must be averaged with its own shard only.

ZeRO-1 (``parallel/zero.py``) reduce-scatters a gradient over ``"data"``
onto this rank's slice with :func:`reduce_scatter`, outside autograd.

Pipeline parallelism, along the ``"pipe"`` axis (the three crossings of
the JAX ``pipeline_apply``'s ``shard_map``):

- :func:`pipe_enter`: the microbatch stream, replicated, enters the
  pipeline (``in_specs`` ``P()``; only the first stage reads it):
  identity forward, the gradient summed over ``"pipe"`` backward
  (Megatron's *f* over ``"pipe"``), which is how the embeddings get
  their gradient on every stage;
- :func:`pipe_hop`: ``ppermute`` one stage on, the point-to-point shift
  of :func:`ring_shift` with or without the edge from the last stage to
  the first (GPipe leaves it unused, the circular schedule carries its
  wrap over it); the schedule (``parallel/pipeline.py``) writes its own
  backward, which hops each cotangent one stage back, so the hop is not
  an autograd function;
- :func:`pipe_broadcast_last`: ``psum(where(stage == last, out, 0))``,
  the last stage's outputs on every stage: the sum forward, each rank's
  own gradient backward, not summed (Megatron's *g* over ``"pipe"``):
  every stage computes the same head and loss from the sum, so a
  summing backward would scale the last stage's gradients by the stage
  count.

Gloo carries CUDA tensors through its own host copies for its
collectives; NCCL keeps them on the card.  Gloo's point-to-point and
all-to-all ops take CPU tensors only, so on gloo a CUDA tensor crossing
:func:`ring_shift`, :func:`pipe_hop`, the all-to-alls or
:func:`reduce_scatter` is staged explicitly: copied into a pinned host
buffer, exchanged, and copied back (the transport of a gang whose ranks
share one card).
:data:`CP_TRAFFIC` counts the bytes this process sent through the
point-to-point shifts (the ring's hops along ``"seq"`` and the
pipeline's along ``"pipe"``, under ``"ring_shift"``) and the
all-to-alls, and the bytes it staged through the host (those of the
ZeRO-1 reduce-scatters too).

Every rank runs the same collectives in the same order, and each result
is bit-identical on every rank of the group: an all-reduce computes
each element's sum once and hands it to every rank."""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
import torch.distributed as dist

from kubegpu_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DATA_SEQ,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Mesh,
    tp_size,
)

SEQ_DIM = 1
# bytes this process sent since import: through point-to-point shifts
# (the "seq" ring's hops and the "pipe" hops), through all-to-alls (the
# slices for other ranks), and those staged through pinned host buffers
# (gloo with CUDA tensors)
CP_TRAFFIC = {"ring_shift": 0, "all_to_all": 0, "host_staged": 0}


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


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = -1,
               axis: str = MODEL_AXIS) -> torch.Tensor:
    """Every ``axis`` rank's ``x`` (default the ``"model"`` ranks')
    concatenated along ``dim`` in rank order: the whole tensor of which
    each rank holds ``1/n`` along ``dim``.  Refuses a tensor that
    requires grad."""
    _no_grad_input(x, "all_gather")
    return _gather(x, mesh.axis_group(axis), mesh.axis_size(axis), dim)


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


def _sum(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=mesh.axis_group(axis))
    return y


def _slice(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    return x.chunk(tp_size(mesh), dim=dim)[mesh.coord(MODEL_AXIS)].contiguous()


def _reduce_scatter_over(x: torch.Tensor, group, n: int, i: int,
                         dim: int) -> torch.Tensor:
    """Slice ``i`` of ``n`` along ``dim`` of the sum of every rank of
    ``group``'s ``x``."""
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[i])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of every ``"model"``
    rank's ``x``."""
    return _reduce_scatter_over(x, mesh.group, tp_size(mesh),
                                mesh.coord(MODEL_AXIS), dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axis), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


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


class _GroupMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh,
                  axis: str = MODEL_AXIS) -> torch.Tensor:
    """*f*: ``x`` (replicated over ``axis``, default ``"model"``) as it
    is; its gradient is summed over the ``axis`` ranks, each of which saw
    one shard's contribution."""
    return _CopyToModel.apply(x, mesh, axis)


def reduce_from_model(x: torch.Tensor, mesh: Mesh,
                      axis: str = MODEL_AXIS) -> torch.Tensor:
    """*g*: the sum of every ``axis`` rank's partial ``x`` (default the
    ``"model"`` ranks'); the gradient passes through unchanged."""
    return _ReduceFromModel.apply(x, mesh, axis)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of every ``axis`` rank's ``x``, which each rank then uses
    whole; backward, each rank's gradient is the sum of every rank's
    (``jax.lax.psum`` and its transpose).  Where each rank's loss
    carries the same function of the sum and the gradients are then
    averaged over ``axis`` (``mean_grads_over_data``), this gives every
    rank's share of it exactly once."""
    if mesh.axis_size(axis) == 1:
        return x
    return reduce_from_model(copy_to_model(x, mesh, axis), mesh, axis)


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
    dp = mesh.axis_size(DATA_AXIS)
    if dp == 1:
        return x
    return _GroupMean.apply(x, mesh.axis_group(DATA_AXIS), dp)


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


BN_DIMS = (0, 2, 3)   # N, H, W of an NCHW (channels_last) activation


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class _GlobalBatchNorm(torch.autograd.Function):
    """flax's BatchNorm in training mode (``_compute_stats`` and
    ``_normalize`` of flax 0.12): f32 statistics over N, H and W,
    ``var = max(E[x^2] - E[x]^2, 0)`` (biased), and
    ``y = (x - mean) * (scale * rsqrt(var + eps)) + bias`` in f32, cast to
    ``x``'s dtype.  Over a ``"data"`` axis the sums are the global
    batch's; the backward's sums too, so each rank's input gradient is
    that of every rank's loss.  The parameter gradients are this rank's
    own sums, which ``mean_grads_over_data`` then averages with the
    rest."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, mesh):
        dp = 1 if mesh is None else mesh.axis_size(DATA_AXIS)
        c = x.shape[1]
        xf = x.float()
        sums = torch.cat([xf.sum(BN_DIMS), (xf * xf).sum(BN_DIMS)])
        if dp > 1:
            dist.all_reduce(sums, group=mesh.axis_group(DATA_AXIS))
        count = x.numel() // c * dp
        mean = sums[:c] / count
        var = torch.clamp_min(sums[c:] / count - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        y = (xf - _channel(mean)) * _channel(inv * scale) + _channel(bias)
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.mesh, ctx.dp, ctx.count = mesh, dp, count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mean, inv, scale = ctx.saved_tensors
        c = x.shape[1]
        g = gy.float()
        xhat = (x.float() - _channel(mean)) * _channel(inv)
        mine = torch.cat([g.sum(BN_DIMS), (g * xhat).sum(BN_DIMS)])
        sums = mine
        if ctx.dp > 1:
            sums = mine.clone()
            dist.all_reduce(sums, group=ctx.mesh.axis_group(DATA_AXIS))
        sums = sums / ctx.count
        gx = (g - _channel(sums[:c]) - xhat * _channel(sums[c:])) \
            * _channel(inv * scale)
        return gx.to(x.dtype), mine[c:], mine[:c], None, None


def global_batch_norm(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float,
                      mesh=None) -> tuple:
    """Training-mode BatchNorm of ``x`` (``(N, C, H, W)``) over the
    global batch: ``(y, mean, var)``, ``mean`` and ``var`` the batch's
    f32 statistics (biased variance; no gradient).  ``mesh`` None (or a
    ``"data"`` axis of 1) reduces this rank's rows only."""
    return _GlobalBatchNorm.apply(x, scale, bias, eps, mesh)


# -- context parallelism: the "seq" axis -------------------------------------


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    """Whether ``x`` crosses gloo from a card: then through pinned host
    buffers (gloo's point-to-point and all-to-all take CPU tensors)."""
    return mesh.backend == "gloo" and x.device.type != "cpu"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    CP_TRAFFIC["host_staged"] += _nbytes(x)
    return buf


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _empty_like(x: torch.Tensor, staged: bool) -> torch.Tensor:
    if staged:
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return torch.empty_like(x)


def _shift(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str,
           step: int, wrap: bool = True) -> List[torch.Tensor]:
    """Each tensor of ``tensors`` sent ``step`` ranks on along ``axis``
    (to ``(i + step) % n``) and the one from ``(i - step) % n``
    received: every send and receive posted in one
    ``batch_isend_irecv``, one tag a tensor.  ``wrap=False`` leaves out
    the edge between the axis' two ends: a rank whose peer lies past an
    end sends nothing, and one whose source does receives zeros."""
    n = mesh.axis_size(axis)
    i = mesh.coord(axis)
    send = wrap or 0 <= i + step < n
    recv = wrap or 0 <= i - step < n
    if n == 1:
        return [t if recv else torch.zeros_like(t) for t in tensors]
    group = mesh.axis_group(axis)
    dst = dist.get_global_rank(group, (i + step) % n)
    src = dist.get_global_rank(group, (i - step) % n)
    staged = _staged(mesh, tensors[0])
    sends = [t.contiguous() for t in tensors]
    if send:
        CP_TRAFFIC["ring_shift"] += sum(_nbytes(t) for t in sends)
        if staged:
            sends = [_to_host(t) for t in sends]
    recvs = [_empty_like(t, staged) for t in sends]
    ops = []
    for tag, (s, r) in enumerate(zip(sends, recvs)):
        if send:
            ops.append(dist.P2POp(dist.isend, s, dst, group, tag))
        if recv:
            ops.append(dist.P2POp(dist.irecv, r, src, group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if not recv:
        return [torch.zeros_like(t) for t in tensors]
    if staged:
        recvs = [r.to(t.device) for r, t in zip(recvs, tensors)]
    return recvs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _shift([x], mesh, axis, 1)[0]

    @staticmethod
    def backward(ctx, g):
        return _shift([g], ctx.mesh, ctx.axis, -1)[0], None, None


def ring_shift(x, mesh: Mesh, axis: str = SEQ_AXIS):
    """``jax.lax.ppermute`` with ``perm = [(i, (i + 1) % n)]`` along
    ``axis``: rank i's ``x`` goes to rank (i + 1) % n and rank
    (i - 1) % n's arrives.  A tensor goes through the autograd form,
    whose gradient shifts the other way; a list or tuple of tensors
    shifts in one batch outside autograd and comes back as a list.  One
    rank on the axis: ``x`` itself."""
    if isinstance(x, (list, tuple)):
        return _shift(x, mesh, axis, 1)
    return _RingShift.apply(x, mesh, axis)


def _all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` ``(n, ...)``: slice j goes to rank j of ``axis``; returns
    ``(n, ...)`` whose slice j came from rank j."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    staged = _staged(mesh, x)
    CP_TRAFFIC["all_to_all"] += _nbytes(x) * (n - 1) // n
    src = _to_host(x) if staged else x.contiguous()
    out = _empty_like(src, staged)
    dist.all_to_all_single(out, src, group=mesh.axis_group(axis))
    return out.to(x.device) if staged else out


def _seq_to_heads(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    b, s, h, d = x.shape
    n = mesh.axis_size(axis)
    parts = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    got = _all_to_all(parts, mesh, axis)   # slice j: rank j's rows
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(y: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    b, s_all, hl, d = y.shape
    n = mesh.axis_size(axis)
    s = s_all // n
    parts = y.reshape(b, n, s, hl, d).permute(1, 0, 2, 3, 4).contiguous()
    got = _all_to_all(parts, mesh, axis)   # slice j: rank j's heads
    return got.permute(1, 2, 0, 3, 4).reshape(b, s, n * hl, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _seq_to_heads(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.mesh, ctx.axis), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _heads_to_seq(y, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.mesh, ctx.axis), None, None


def seq_to_heads(x: torch.Tensor, mesh: Mesh,
                 axis: str = SEQ_AXIS) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis=2, concat_axis=1,
    tiled=True)``: this rank's ``(b, s / n, h, d)`` rows of every head
    -> every rank's rows, in rank order, of this rank's ``h / n`` heads,
    ``(b, s, h / n, d)``, contiguous.  The gradient goes back through
    :func:`heads_to_seq`."""
    return _SeqToHeads.apply(x, mesh, axis)


def heads_to_seq(y: torch.Tensor, mesh: Mesh,
                 axis: str = SEQ_AXIS) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads` (``split_axis=1,
    concat_axis=2``): ``(b, s, h / n, d)`` -> this rank's ``(b, s / n,
    h, d)`` rows of every head; the gradient goes back through
    :func:`seq_to_heads`."""
    return _HeadsToSeq.apply(y, mesh, axis)


class _GatherAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh.axis_group(axis), mesh.axis_size(axis), dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def gather_axis(x: torch.Tensor, mesh: Mesh, axis: str = SEQ_AXIS,
                dim: int = SEQ_DIM) -> torch.Tensor:
    """Every ``axis`` rank's ``x`` concatenated along ``dim`` (default
    the sequence of a ``(b, s, ...)`` tensor) in rank order; the gradient
    is reduce-scattered back (each rank's slice of the sum of every
    rank's gradient): every rank goes on to use the whole tensor for a
    part of the result (the einsum attention's K/V under CP; q, k and v
    gathered over ``"model"`` where TP x CP replicates the heads)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _GatherAxis.apply(x, mesh, axis, dim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str,
                   dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` (one of ``n`` equal ones, by its
    ``axis`` coordinate) of the sum of every ``axis`` rank's ``x``, a new
    tensor.  Outside autograd.  On gloo a CUDA ``x`` is staged through
    pinned host buffers (counted in ``CP_TRAFFIC["host_staged"]``), as
    the point-to-point shifts are."""
    n, i = mesh.axis_size(axis), mesh.coord(axis)
    if n == 1:
        return x.clone()
    if not _staged(mesh, x):
        return _reduce_scatter_over(x, mesh.axis_group(axis), n, i, dim)
    parts = [_to_host(p) for p in x.chunk(n, dim=dim)]
    out = _empty_like(parts[i], True)
    dist.reduce_scatter(out, parts, group=mesh.axis_group(axis))
    return out.to(x.device)


def mesh_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``x`` over every rank of the mesh; the gradient passes
    through unchanged (each rank differentiates its own rows and
    :func:`mean_grads_over_mesh` averages the gradients)."""
    if mesh.size == 1:
        return x
    return _GroupMean.apply(x, dist.group.WORLD, mesh.size)


def mean_grads_over_mesh(grads: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average ``grads`` over every rank of the mesh in place, one
    all-reduce of all of them flattened, divided by the mesh's size: the
    gradients of parameters every rank holds whole."""
    if mesh.size > 1:
        flat_all_reduce(grads, dist.group.WORLD, 1.0 / mesh.size)


def _data_seq(mesh: Mesh) -> tuple:
    """This rank's ``"data"`` x ``"seq"`` plane: its group and size."""
    n = mesh.axis_size(DATA_AXIS) * mesh.axis_size(SEQ_AXIS)
    return mesh.axis_group(DATA_SEQ), n


def data_seq_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """:func:`mesh_mean` over this rank's ``"data"`` x ``"seq"`` plane
    (the ranks of its ``"model"`` coordinate) on a 3-D mesh, where every
    ``"model"`` rank of a plane's line holds the same value."""
    group, n = _data_seq(mesh)
    if n == 1:
        return x
    return _GroupMean.apply(x, group, n)


def mean_grads_over_data_seq(grads: Sequence[torch.Tensor],
                             mesh: Mesh) -> None:
    """:func:`mean_grads_over_mesh` over this rank's ``"data"`` x
    ``"seq"`` plane: on a 3-D mesh a parameter sharded over ``"model"``
    is averaged with the same shard on the other ranks of its
    ``"model"`` coordinate, never with another shard."""
    group, n = _data_seq(mesh)
    if n > 1:
        flat_all_reduce(grads, group, 1.0 / n)


# -- pipeline parallelism: the "pipe" axis -----------------------------------


def pipe_enter(stream: torch.Tensor, mesh: Mesh,
               axis: str = PIPE_AXIS) -> torch.Tensor:
    """The microbatch stream, replicated over ``axis``, as it enters the
    pipeline: ``stream`` itself; backward, the sum over ``axis`` of every
    stage's gradient of it (only the first stage's is not zero)."""
    if mesh.axis_size(axis) == 1:
        return stream
    return copy_to_model(stream, mesh, axis)


def pipe_hop(x: torch.Tensor, mesh: Mesh, axis: str = PIPE_AXIS, *,
             step: int = 1, wrap: bool) -> torch.Tensor:
    """``jax.lax.ppermute`` one stage along ``axis``: this rank's ``x`` to
    stage ``i + step``, stage ``i - step``'s received (``step`` -1 is the
    transpose, a cotangent sent one stage back).  ``wrap=False`` (GPipe)
    leaves the edge between the last stage and the first unused: the
    stage at the receiving end gets zeros.  Outside autograd."""
    return _shift([x], mesh, axis, step, wrap)[0]


def pipe_broadcast_last(out: torch.Tensor, mesh: Mesh,
                        axis: str = PIPE_AXIS) -> torch.Tensor:
    """The sum over ``axis`` of every stage's ``out`` (zeros but on the
    last stage: its outputs on every stage); the gradient passes through
    unchanged, each stage's own (they are all the same)."""
    if mesh.axis_size(axis) == 1:
        return out
    return reduce_from_model(out, mesh, axis)
