"""LM training at one device and over a ``("data", "model")`` mesh: the
port of ``kubegpu_tpu/models/train.py``'s ``TrainState``,
``cross_entropy``, ``lm_loss``, ``make_lm_train_step`` and ``place_lm``.

The optimizer is the JAX package's default, ``optax.sgd(0.1,
momentum=0.9, nesterov=True)``, as ``torch.optim.SGD(lr=0.1,
momentum=0.9, nesterov=True)``.  The two compute the same update.  optax
chains ``trace(decay=0.9, nesterov=True)`` with a scale by ``-lr``: from
the trace ``t`` (zeros at init) and the gradient ``g`` it takes
``t' = g + 0.9 t`` and the update ``-0.1 (g + 0.9 t')``.  torch's SGD
keeps ``momentum_buffer`` ``b``: ``b' = 0.9 b + g`` (on its first step
``b' = g``, which is ``0.9 * 0 + g``), then with nesterov
``p' = p - 0.1 (g + 0.9 b')``.  So ``b`` is ``t`` step for step, and a
state carried across with ``momentum_buffer = trace``
(:func:`train_state_from_numpy`) continues identically.

Parameters are float32 leaves bound to the model with
``requires_grad=True``; the optimizer steps them in place, so the state's
tree is always the current weights.

Over a mesh (the model built with ``mesh=``) every rank holds its
Megatron shard of the parameters and of the momentum (:func:`place_lm`,
the JAX ``place_lm``/``state_shardings``) and its ``batch / dp`` rows of
the global batch.  The head is vocab-parallel, so :func:`cross_entropy`
takes the max, the sum of exponentials and the target logit by
all-reduces over ``"model"`` and never gathers the logits.  Each data
rank differentiates the mean of its own rows; the loss it returns is the
mean over ``"data"`` of those, JAX's global mean.  :func:`lm_step` then
(a) under sequence parallelism sums the gradients of the parameters
replicated over ``"model"`` (the LayerNorms: each rank saw its own rows),
(b) averages every gradient over ``"data"`` in one flat all-reduce, and
(c) steps the local shards.  Every rank of a ``"data"`` group ends a
step with the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from kubegpu_tpu_torch.models.params import (
    Tree,
    bind_params,
    params_from_numpy,
    resolve_device,
    tree_map,
)
from kubegpu_tpu_torch.parallel.collectives import (
    data_mean,
    flat_all_reduce,
    mean_grads_over_data,
)
from kubegpu_tpu_torch.parallel.mesh import MODEL_AXIS, tp_size
from kubegpu_tpu_torch.parallel.sharding import (
    gather_params,
    shard_dim,
    shard_state,
)

LEARNING_RATE = 0.1
MOMENTUM = 0.9


@dataclass
class TrainState:
    """The model bound to its float32 tree, the optimizer over it, and
    the number of steps taken (the JAX ``TrainState.step``)."""

    model: nn.Module
    params: Tree
    opt: torch.optim.SGD
    step: int = 0

    @property
    def mesh(self):
        """The model's mesh (None at one device)."""
        return getattr(self.model, "mesh", None)


def create_train_state(model: nn.Module, params: Tree, *,
                       step: int = 0) -> TrainState:
    """Bind ``params`` (float32 leaves, on the device to train on) to
    ``model`` as trainable parameters and build nesterov SGD over them
    with an empty momentum (optax's zero trace)."""
    bind_params(model, params, trainable=True)
    opt = torch.optim.SGD(model.parameters(), lr=LEARNING_RATE,
                          momentum=MOMENTUM, nesterov=True)
    return TrainState(model=model, params=params, opt=opt, step=step)


def _set_momentum(state: TrainState, trace: Tree) -> None:
    for path, param in state.model.named_parameters():
        node = trace
        for part in path.split("."):
            node = node[part]
        state.opt.state[param]["momentum_buffer"] = node.float().clone()


def train_state_from_numpy(model: nn.Module, params: Mapping,
                           trace: Optional[Mapping] = None, *, step: int = 0,
                           device="cuda", mesh=None) -> TrainState:
    """A JAX train state carried across: ``params`` is the flax tree and
    ``trace`` optax's momentum trace (``opt_state[0].trace``), both as
    numpy (``jax.tree.map(np.asarray, ...)``).  SGD's ``momentum_buffer``
    of each parameter is set to its trace leaf, so a state taken mid-
    training continues as the JAX step would.  Over a mesh (``mesh``, or
    the model's) both trees are whole and this rank keeps its shard of
    each (:func:`place_lm`), on the mesh's device."""
    mesh = mesh if mesh is not None else getattr(model, "mesh", None)
    if mesh is not None:
        # the whole trees wait on the host; the rank keeps its shards
        return place_lm(model, params_from_numpy(params),
                        None if trace is None else params_from_numpy(trace),
                        step=step, mesh=mesh)
    dev = resolve_device(device)
    state = create_train_state(model, params_from_numpy(params, dev),
                               step=step)
    if trace is not None:
        _set_momentum(state, params_from_numpy(trace, dev))
    return state


def place_lm(model: nn.Module, params: Mapping,
             trace: Optional[Mapping] = None, *, step: int = 0,
             mesh=None) -> TrainState:
    """The JAX ``place_lm``: a train state over ``mesh`` (default the
    model's) from WHOLE trees of tensors on any device, ``params`` and
    optionally the momentum ``trace``: this rank keeps its shard of each
    by the Megatron rules (``shard_state``), copied onto the mesh's
    device, so the whole tree can be freed once the caller drops it.
    Every rank of a ``"data"`` group gets the same shards."""
    mesh = mesh if mesh is not None else getattr(model, "mesh", None)
    if mesh is None:
        raise ValueError("place_lm needs a mesh (the model's or mesh=)")
    dev = resolve_device(mesh.device)

    def shards(tree):
        return tree_map(lambda t: t.to(dev), shard_state(tree, mesh))

    state = create_train_state(model, shards(params), step=step)
    if trace is not None:
        _set_momentum(state, shards(trace))
    return state


def _param_tree(state: TrainState, leaf) -> Tree:
    tree: Tree = {}
    for path, param in state.model.named_parameters():
        node = tree
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf(param)
    return tree


def momentum_tree(state: TrainState) -> Tree:
    """SGD's momentum buffers in the parameter tree's layout (the optax
    trace's counterpart; over a mesh, this rank's shards of it); zeros
    before the first step."""
    def buffer(param):
        buf = state.opt.state.get(param, {}).get("momentum_buffer")
        return torch.zeros_like(param) if buf is None else buf.detach()

    return _param_tree(state, buffer)


def grad_tree(state: TrainState) -> Tree:
    """Each parameter's ``.grad`` in the parameter tree's layout (over a
    mesh, this rank's shards)."""
    return _param_tree(state, lambda param: param.grad)


def gather_state(state: TrainState) -> Tuple[Tree, Tree]:
    """The whole parameter and momentum trees from every ``"model"``
    rank's shards (every rank of a ``"model"`` group calls it); at one
    device, copies of both."""
    return (gather_params(state.params, state.mesh),
            gather_params(momentum_tree(state), state.mesh))


class _VocabParallelCrossEntropy(torch.autograd.Function):
    """Mean NLL over rows whose float32 logits are split by columns over
    the ``"model"`` ranks (this rank holds vocab ids ``[r v, (r + 1) v)``):
    the rows' max, sum of exponentials and target logit come from three
    all-reduces; the gradient is softmax minus one-hot on this rank's
    columns, never the whole vocabulary."""

    @staticmethod
    def forward(ctx, logits, labels, mesh):
        group = mesh.group
        v = logits.shape[-1]
        local = labels.long() - mesh.coord(MODEL_AXIS) * v
        mine = (local >= 0) & (local < v)
        idx = local.clamp(0, v - 1)[..., None]
        m = logits.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        sumexp = e.sum(-1)
        dist.all_reduce(sumexp, group=group)
        target = torch.where(mine, logits.gather(-1, idx)[..., 0],
                             torch.zeros((), dtype=logits.dtype,
                                         device=logits.device))
        dist.all_reduce(target, group=group)
        ctx.save_for_backward(e, sumexp, idx, mine)
        return (torch.log(sumexp) + m - target).mean()

    @staticmethod
    def backward(ctx, g):
        e, sumexp, idx, mine = ctx.saved_tensors
        grad = e / sumexp[..., None]
        grad.scatter_add_(-1, idx, -mine[..., None].to(grad.dtype))
        return grad * (g / mine.numel()), None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits`` (the
    JAX ``cross_entropy``: log-softmax, take, mean).  Over a mesh with a
    ``"model"`` axis the logits are this rank's vocab columns
    (:class:`_VocabParallelCrossEntropy`)."""
    if tp_size(mesh) > 1:
        return _VocabParallelCrossEntropy.apply(logits, labels, mesh)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def lm_loss(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token loss of a ``(b, s + 1)`` token window: the model reads
    ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``.  Over a mesh
    ``tokens`` are this data rank's rows: the value is the mean over the
    ``"data"`` ranks, the gradient that of this rank's own mean."""
    mesh = getattr(model, "mesh", None)
    loss = cross_entropy(model(tokens[:, :-1]), tokens[:, 1:], mesh)
    return loss if mesh is None else data_mean(loss, mesh)


def _path(name: str) -> str:
    return name.replace(".", "/")


def replicated_params(model: nn.Module) -> List[nn.Parameter]:
    """The parameters every ``"model"`` rank holds whole (no rule shards
    them: the LayerNorms), in the model's order."""
    return [p for n, p in model.named_parameters()
            if shard_dim(_path(n)) is None]


def sync_grads(state: TrainState) -> None:
    """After ``backward()`` over a mesh: (a) under sequence parallelism
    sum the replicated parameters' gradients over ``"model"`` (each rank
    differentiated its own rows of the LayerNorms), then (b) average all
    gradients over ``"data"`` in one flat all-reduce.  Nothing at one
    device."""
    mesh = state.mesh
    if mesh is None:
        return
    if getattr(state.model, "seq_sharded", False):
        flat_all_reduce([p.grad for p in replicated_params(state.model)],
                        mesh.group)
    mean_grads_over_data([p.grad for p in state.model.parameters()], mesh)


def lm_grads(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
    """The step's loss and gradients, without the update: zero the
    gradients, differentiate :func:`lm_loss`, :func:`sync_grads`.  Each
    parameter's ``.grad`` is then the gradient of the global mean loss
    for this rank's shard."""
    state.opt.zero_grad(set_to_none=True)
    loss = lm_loss(state.model, tokens)
    loss.backward()
    sync_grads(state)
    return loss.detach()


def lm_step(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
    """One training step, the JAX ``make_lm_train_step``'s: loss,
    gradients (:func:`lm_grads`), one nesterov-SGD update in place on
    this rank's shards.  Returns the step's loss as a 0-d tensor on the
    device (no host sync)."""
    loss = lm_grads(state, tokens)
    state.opt.step()
    state.step += 1
    return loss
