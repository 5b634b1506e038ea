"""Pipeline parallelism over a ``"pipe"`` mesh axis: the port of
``kubegpu_tpu/parallel/pipeline.py``.

Stages are laid out along one mesh axis, so a stage's activations hop
one rank per tick:

- **GPipe** (``num_rounds=1``): ``M + P - 1`` ticks; at tick ``t`` the
  rank holding stage ``s`` processes microbatch ``t - s``.  Bubble
  fraction ``(P-1)/(M+P-1)``.
- **Circular / interleaved** (``num_rounds=V > 1``): each rank holds V
  round-interleaved stage slices (global stage ``s = v*P + p`` lives on
  rank ``p``) and every microbatch makes V trips around the ring; the
  edge from the last rank to the first carries the wrap.  Item
  (microbatch m, round v) runs on rank p at tick ``t = v*M + m + p``;
  rank 0 banks an arriving wrap in a slot buffer until its next round's
  tick (hence ``M >= P``); ``V*M + P - 1`` ticks in all, bubble fraction
  ``(P-1)/(V*M + P - 1)``.

Each rank holds its stage's leaves, as ``place_pipeline_lm`` cuts them
from whole stacks: ``[1, ...]`` (GPipe: its stage of a ``[P]`` stack)
or ``[V, 1, ...]`` (circular: its round slices of a ``[V, P]`` stack),
and under PP x TP each leaf also cut over ``"model"`` (the stage
function then runs its own collectives).  The stream of microbatches
``[M, microbatch...]`` is replicated; the output, the last stage's, is
on every rank (``collectives.pipe_enter``/``pipe_broadcast_last``).

**The backward is written out, not left to autograd.**  The JAX package
runs one SPMD program: every device computes every tick (garbage on a
bubble tick, masked out) and ``jax.grad`` transposes the scan, reversing
the permutes.  The port runs one process a stage, and a point-to-point
hop pairs up only if every rank takes part in every tick's hop, forward
and backward, in the same order.  Autograd's engine orders a rank's
backward by that rank's own graph, and the stages' graphs differ (the
first stage reads the stream, rank 0 banks the wrap, the bubbles fall
on other ticks), so relying on it would mean building the same graph
on every rank, garbage ticks included.  Instead the pipelined region is
one autograd function (as the ring attention is):

- forward, tick by tick, each rank runs its stage on its live ticks
  only, each from a detached input, keeping that tick's graph, and
  skips the arithmetic on a bubble tick; every tick (but the last,
  whose send nobody reads) it sends its output, or zeros on a bubble,
  one stage on;
- backward, tick by tick in reverse, one hop carries every rank's
  cotangent of what it received one stage back, then each rank
  backpropagates through its own tick's graph (the stage's collectives,
  e.g. the TP all-reduces over ``"model"``, run inside, and every rank
  of a ``"model"`` group shares its live ticks), accumulating its
  leaves' gradients; rank 0 hands the first round's cotangents to the
  stream and banks the later ones for the wrap hop that brought them.

So the order of every collective is the tick order on every rank, by
construction, and a rank computes nothing on its ``P - 1`` bubble
ticks.  The graphs of the live ticks are kept until the backward, as
JAX keeps the scan's residuals.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Tuple

import torch

from kubegpu_tpu_torch.parallel.collectives import (
    pipe_broadcast_last,
    pipe_enter,
    pipe_hop,
)
from kubegpu_tpu_torch.parallel.mesh import PIPE_AXIS


def bubble_fraction(num_micro: int, num_stages: int,
                    num_rounds: int = 1) -> float:
    """Idle fraction of the pipeline schedule: (P-1)/(V*M + P - 1)."""
    return (num_stages - 1) / (num_rounds * num_micro + num_stages - 1)


def _flatten(tree: Mapping, prefix: str = "") -> List[Tuple[str, Any]]:
    out = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.extend(_flatten(v, path) if isinstance(v, Mapping)
                   else [(path, v)])
    return out


def _unflatten(paths: List[str], leaves) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


def check_stage_dims(stacked: Mapping, devices: int, num_rounds: int = 1,
                     axis: str = PIPE_AXIS) -> None:
    """The JAX refusals of whole stacks that do not fit the mesh: every
    leaf leads with ``[devices]`` (GPipe) or ``[num_rounds, devices]``
    (circular); anything else would drop stages without an error."""
    for path, leaf in _flatten(stacked):
        if num_rounds == 1 and leaf.shape[0] != devices:
            raise ValueError(
                f"stacked param {path} has leading dim {leaf.shape[0]} but "
                f"mesh axis {axis!r} has {devices} devices — the ranks "
                f"would silently drop stages")
        if num_rounds > 1 and tuple(leaf.shape[:2]) != (num_rounds, devices):
            raise ValueError(
                f"circular stacked param {path} must lead with "
                f"[num_rounds={num_rounds}, devices={devices}], got "
                f"{tuple(leaf.shape[:2])}")


class _Schedule:
    """What one call of the pipelined region needs besides its tensors:
    the stage function, where this rank sits, and the leaves' paths."""

    def __init__(self, stage_fn, mesh, axis: str, rounds: int,
                 paths: List[str], grad: bool) -> None:
        self.stage_fn = stage_fn
        self.mesh = mesh
        self.axis = axis
        self.rounds = rounds
        self.paths = paths
        self.grad = grad
        self.devices = 1 if mesh is None else mesh.axis_size(axis)
        self.coord = 0 if mesh is None else mesh.coord(axis)

    def ticks(self, num_micro: int) -> int:
        return self.rounds * num_micro + self.devices - 1

    def work(self, t: int, num_micro: int):
        """``(microbatch, round)`` this rank processes at tick ``t``, or
        None on a bubble tick."""
        s = t - self.coord
        if not 0 <= s < self.rounds * num_micro:
            return None
        return s % num_micro, s // num_micro

    def stage(self, leaves, v: int, x: torch.Tensor) -> torch.Tensor:
        idx = (v, 0) if self.rounds > 1 else (0,)
        return self.stage_fn(_unflatten(self.paths,
                                        [a[idx] for a in leaves]), x)

    def hop(self, x: torch.Tensor, step: int) -> torch.Tensor:
        if self.mesh is None:   # one stage: its own next stage
            return x
        return pipe_hop(x, self.mesh, self.axis, step=step,
                        wrap=self.rounds > 1)


class _Pipeline(torch.autograd.Function):
    """The pipelined region of one rank: ``(stream, *leaves)`` -> the
    last stage's outputs ``[M, ...]`` (zeros on the other ranks), with
    the schedule's backward written out (see the module docstring)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, stream, *leaves):
        num_micro = stream.shape[0]
        last, first = sched.devices - 1, sched.coord == 0
        wrap = sched.rounds > 1
        zeros = torch.zeros_like(stream[0])
        out = torch.zeros_like(stream)
        params = [a.detach().requires_grad_() for a in leaves]
        saved: Dict[int, tuple] = {}
        banked: Dict[int, torch.Tensor] = {}
        recv = zeros
        ticks = sched.ticks(num_micro)
        for t in range(ticks):
            if first and wrap and t >= sched.devices:
                # a wrap arrives: bank it before the read, so that M == P
                # reads it in this tick
                banked[(t - sched.devices) % num_micro] = recv
            send = zeros
            work = sched.work(t, num_micro)
            if work is not None:
                m, v = work
                if first:
                    x = stream[m] if v == 0 else banked[m]
                else:
                    x = recv
                if sched.grad:
                    x = x.detach().requires_grad_()
                    with torch.enable_grad():
                        y = sched.stage(params, v, x)
                    saved[t] = (x, y)
                    send = y.detach()
                else:
                    send = sched.stage(leaves, v, x)
                if sched.coord == last and v == sched.rounds - 1:
                    out[m] = send
            if t < ticks - 1:
                recv = sched.hop(send, 1)
        ctx.sched, ctx.params, ctx.saved = sched, params, saved
        return out

    @staticmethod
    def backward(ctx, g_out):
        sched, params, saved = ctx.sched, ctx.params, ctx.saved
        num_micro = g_out.shape[0]
        last, first = sched.devices - 1, sched.coord == 0
        wrap = sched.rounds > 1
        zeros = torch.zeros_like(g_out[0])
        g_stream = torch.zeros_like(g_out)
        g_leaves: List[Any] = [None] * len(params)
        g_banked: Dict[int, torch.Tensor] = {}
        g_recv = zeros   # the cotangent of what this rank received
        ticks = sched.ticks(num_micro)
        for t in reversed(range(ticks)):
            g_y = sched.hop(g_recv, -1) if t < ticks - 1 else zeros
            g_recv = zeros
            work = sched.work(t, num_micro)
            if work is not None:
                m, v = work
                if sched.coord == last and v == sched.rounds - 1:
                    g_y = g_y + g_out[m]
                x, y = saved.pop(t)
                g_x, *g_p = torch.autograd.grad(y, [x] + params, g_y,
                                                allow_unused=True)
                for i, g in enumerate(g_p):
                    if g is not None:
                        g_leaves[i] = g if g_leaves[i] is None \
                            else g_leaves[i].add_(g)
                if not first:
                    g_recv = g_x
                elif v == 0:
                    g_stream[m] = g_x
                else:
                    g_banked[m] = g_x
            if first and wrap and t >= sched.devices:
                g_recv = g_banked.pop((t - sched.devices) % num_micro, zeros)
        ctx.params = ctx.saved = None
        return (None, g_stream, *g_leaves)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   mesh, axis: str = PIPE_AXIS,
                   num_rounds: int = 1) -> Callable:
    """A pipelined application of ``stage_fn`` over ``mesh[axis]``
    (``mesh`` None: one stage, no collective).

    ``stage_fn(stage_params, x) -> y`` must preserve ``x``'s shape; its
    output must be the same on every rank of the mesh's other axes.  The
    returned callable maps ``(stage_params, stream)`` to outputs of
    ``stream``'s shape, on every rank: ``stream`` is ``[M, microbatch
    ...]``, the same on every rank, and ``stage_params`` this rank's
    leaves, leading with ``[1]`` (GPipe: this rank's stage) or ``[V, 1]``
    (``num_rounds == V > 1``, circular: this rank's V round slices).
    PP x TP composes with GPipe only (``pipeline_lm_logits`` refuses the
    circular schedule with a ``model_axis``)."""
    devices = 1 if mesh is None else mesh.axis_size(axis)
    lead = (num_rounds, 1) if num_rounds > 1 else (1,)

    def run(stage_params: Mapping, stream: torch.Tensor) -> torch.Tensor:
        flat = _flatten(stage_params)
        for path, leaf in flat:
            if tuple(leaf.shape[:len(lead)]) != lead:
                raise ValueError(
                    f"stacked param {path} leads with "
                    f"{tuple(leaf.shape[:len(lead)])} on this rank, not "
                    f"{lead}: each of the {devices} ranks of axis {axis!r} "
                    f"holds its own stage{'s' if num_rounds > 1 else ''} "
                    "(cut the whole stack with place_pipeline_lm)")
        if num_rounds > 1 and stream.shape[0] < devices:
            raise ValueError(
                f"circular schedule needs microbatches >= devices "
                f"({stream.shape[0]} < {devices}): a wrapped microbatch "
                f"re-enters device 0 only after the stream ahead drains")
        leaves = [leaf for _, leaf in flat]
        grad = torch.is_grad_enabled() and (
            stream.requires_grad or any(a.requires_grad for a in leaves))
        sched = _Schedule(stage_fn, mesh, axis, num_rounds,
                          [p for p, _ in flat], grad)
        if mesh is not None:
            stream = pipe_enter(stream, mesh, axis)
        out = _Pipeline.apply(sched, stream, *leaves)
        if mesh is None:
            return out
        return pipe_broadcast_last(out, mesh, axis)

    return run
