"""Training at one device and over a mesh: the port of
``kubegpu_tpu/models/train.py``'s ``TrainState``,
``create_train_state(tx=)``, ``cross_entropy``, ``resnet_loss``,
``make_resnet_train_step``, ``place_resnet``, ``lm_loss``,
``make_lm_train_step``, ``place_lm``, ``draft_distill_loss``,
``make_draft_distill_step``, ``moe_loss``, ``make_moe_train_step`` and
``place_moe``.

The optimizer is an :class:`Optimizer`: :func:`sgd` or :func:`adam`.  The
default is the JAX package's, ``optax.sgd(0.1,
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
Megatron shard of the parameters and of the optimizer state
(:func:`place_lm`,
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

A ResNet (``models/resnet.py``) trains data-parallel over a ``{"data":
n}`` mesh (:func:`place_resnet`, the JAX ``place_resnet``): every rank
holds the whole parameters, optimizer state and BatchNorm statistics
(the state's ``batch_stats``, bound to the model's buffers) and its
``batch / n`` rows.  Its BatchNorms reduce over the global batch
(``parallel.collectives.global_batch_norm``), so the new statistics are
the same on every rank and every rank's loss and gradients are one
device's at the global batch once :func:`sync_grads` averages the
gradients over ``"data"``.

Over a ``("data", "seq")`` mesh (the context-parallel model,
:func:`place_cp_lm`, the JAX ``place_cp_lm``) every rank holds the whole
parameters and optimizer state.  A rank's ``(b, s + 1)`` window feeds
the model its ``"seq"`` coordinate's ``s / cp`` consecutive rows and
takes the next token of each as its label (:func:`lm_loss`); the loss it
returns is the mean over ``"data"`` x ``"seq"``, and :func:`sync_grads`
averages every gradient over all dp x cp ranks in one flat all-reduce
(the attention's collectives have already carried each rank's share of
another rank's K/V gradient home).

Over a ``("data", "model", "seq")`` mesh (the context-parallel model
placed by :func:`place_lm`, each rank its Megatron shards, whole over
``"seq"``) the logits are vocab-parallel, :func:`cross_entropy` reduces
them over ``"model"``, and the loss and :func:`sync_grads` average over
this rank's ``"data"`` x ``"seq"`` plane.  ZeRO-1
(``parallel/zero.py``) cuts optimizer state over ``"data"``: the state's
``zero1`` names each cut parameter's slice, which the optimizer steps;
:func:`sync_grads` reduce-scatters its gradient, :func:`lm_step`
all-gathers the new slices (:func:`gather_slices`), and the whole-tree
readers and writers gather and cut the slices.

The MoE transformer (``models/moe.py``) trains over a ``("data",
"expert"[, "model"])`` mesh (:func:`place_moe`, the JAX ``place_moe``):
each rank keeps its experts' slices of ``w_up``/``w_down`` (and under
EP x TP its Megatron shard of those and of the attention, embeddings and
head), the rest whole, its optimizer state sharded alike, and its
``batch / dp`` rows (every rank of one data shard the same rows).
:func:`moe_loss` adds ``aux_weight`` times the layers' mean aux loss to
the cross-entropy; the aux is the whole batch's (its sums are added over
``"data"`` with a gradient summed back, so the mean over ``"data"``
that :func:`sync_grads` takes leaves each rank's share once), and
:func:`sync_grads` averages every gradient over ``"data"``: the experts'
collectives have already summed what crosses ``"expert"`` and
``"model"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from kubegpu_tpu_torch.models.moe import layer_mean
from kubegpu_tpu_torch.models.params import (
    Tree,
    bind_buffers,
    bind_params,
    params_from_numpy,
    resolve_device,
    tree_map,
)
from kubegpu_tpu_torch.parallel.collectives import (
    all_gather,
    data_mean,
    data_seq_mean,
    flat_all_reduce,
    mean_grads_over_data,
    mean_grads_over_data_seq,
    mean_grads_over_mesh,
    mesh_mean,
    reduce_scatter,
)
from kubegpu_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    cp_size,
    tp_size,
)
from kubegpu_tpu_torch.parallel.sharding import (
    MOE_EP_RULES,
    MOE_EP_TP_RULES,
    mesh_gather,
    mesh_place,
    placed_dims,
    rules_of,
    shard_dims,
    shard_slice,
    shard_state,
)

LEARNING_RATE = 0.1
MOMENTUM = 0.9
# the reference's quality runs train with optax.adam(3e-4)
ADAM_LEARNING_RATE = 3e-4


@dataclass(frozen=True)
class Optimizer:
    """An optax optimizer by name and hyperparameters, built over a
    model's parameters as its torch counterpart:

    - ``"sgd"``: ``optax.sgd(lr, momentum, nesterov)`` is
      ``torch.optim.SGD``; optax's ``trace`` is SGD's ``momentum_buffer``
      (see the module docstring);
    - ``"adam"``: ``optax.adam(lr, b1, b2, eps)`` (``eps_root`` 0) is
      ``torch.optim.Adam``: both take ``m' = b1 m + (1 - b1) g``,
      ``v' = b2 v + (1 - b2) g^2`` and
      ``p' = p - lr (m' / (1 - b1^t)) / (sqrt(v' / (1 - b2^t)) + eps)``
      at step ``t``; optax's ``mu``, ``nu`` and ``count`` are Adam's
      ``exp_avg``, ``exp_avg_sq`` and ``step``.  They round in another
      order (torch folds ``1 - b1`` into a lerp and divides the square
      root by ``sqrt(1 - b2^t)``), so the two agree to float32 rounding,
      not bit for bit.

    The state's tree (:func:`opt_state_tree`) is optax's: ``{"trace":
    tree}`` for sgd, ``{"count": (), "mu": tree, "nu": tree}`` for adam,
    each ``tree`` in the parameter tree's layout."""

    name: str = "sgd"
    lr: float = LEARNING_RATE
    momentum: float = MOMENTUM
    nesterov: bool = True
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def build(self, parameters) -> torch.optim.Optimizer:
        if self.name == "sgd":
            return torch.optim.SGD(parameters, lr=self.lr,
                                   momentum=self.momentum,
                                   nesterov=self.nesterov)
        if self.name == "adam":
            return torch.optim.Adam(parameters, lr=self.lr,
                                    betas=(self.b1, self.b2), eps=self.eps)
        raise ValueError(f"optimizer {self.name!r}: one of {OPTIMIZERS}")

    @property
    def slots(self) -> Dict[str, str]:
        """optax's per-parameter state trees by name, each with the
        torch optimizer's state key."""
        return dict(_SLOTS[self.name])

    def config(self) -> dict:
        """The hyperparameters that define the update (a checkpoint
        records them)."""
        if self.name == "sgd":
            return dict(name="sgd", lr=self.lr, momentum=self.momentum,
                        nesterov=self.nesterov)
        return dict(name="adam", lr=self.lr, b1=self.b1, b2=self.b2,
                    eps=self.eps)


OPTIMIZERS = ("sgd", "adam")
_SLOTS = {"sgd": (("trace", "momentum_buffer"),),
          "adam": (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}


def sgd(lr: float = LEARNING_RATE, momentum: float = MOMENTUM,
        nesterov: bool = True) -> Optimizer:
    """``optax.sgd(lr, momentum=momentum, nesterov=nesterov)``, the JAX
    package's default optimizer at its defaults."""
    return Optimizer("sgd", lr=lr, momentum=momentum, nesterov=nesterov)


def adam(lr: float = ADAM_LEARNING_RATE, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """``optax.adam(lr, b1, b2, eps)``."""
    return Optimizer("adam", lr=lr, b1=b1, b2=b2, eps=eps)


@dataclass
class TrainState:
    """The model bound to its float32 tree, the optimizer over it (built
    from ``optimizer``), the number of steps taken (the JAX
    ``TrainState.step``) and the model's BatchNorm statistics
    (``batch_stats``, bound to its buffers; empty for the LM).

    Under ZeRO-1 (``parallel/zero.py``) ``zero1`` maps each parameter
    whose optimizer state is cut over ``"data"`` to ``(dim, part)``:
    ``part`` is this rank's slice of it along ``dim``, a tensor of its
    own that the optimizer steps in the parameter's place (empty: every
    parameter is stepped itself)."""

    model: nn.Module
    params: Tree
    opt: torch.optim.Optimizer
    step: int = 0
    optimizer: Optimizer = field(default_factory=Optimizer)
    batch_stats: Tree = field(default_factory=dict)
    zero1: Dict[nn.Parameter, Tuple[int, torch.Tensor]] = field(
        default_factory=dict)

    @property
    def mesh(self):
        """The model's mesh (None at one device)."""
        return getattr(self.model, "mesh", None)


def create_train_state(model: nn.Module, params: Tree, *,
                       optimizer: Optional[Optimizer] = None,
                       step: int = 0,
                       batch_stats: Optional[Tree] = None) -> TrainState:
    """Bind ``params`` (float32 leaves, on the device to train on) to
    ``model`` as trainable parameters, and ``batch_stats`` (a ResNet's
    BatchNorm statistics) to its buffers, and build ``optimizer``
    (default :func:`sgd`, the JAX ``create_train_state``'s nesterov SGD)
    over the parameters with an empty state (optax's zero trace or
    moments)."""
    optimizer = optimizer or sgd()
    bind_params(model, params, trainable=True)
    if batch_stats:
        bind_buffers(model, batch_stats)
    return TrainState(model=model, params=params,
                      opt=optimizer.build(model.parameters()), step=step,
                      optimizer=optimizer, batch_stats=batch_stats or {})


def _leaf(tree: Mapping, dotted: str):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


def stepped(state: TrainState, param: nn.Parameter) -> torch.Tensor:
    """The tensor the optimizer steps for ``param``: its ZeRO-1 slice
    (``state.zero1``), else the parameter itself."""
    owned = state.zero1.get(param)
    return param if owned is None else owned[1]


def _data_part(state: TrainState, param: nn.Parameter,
               t: torch.Tensor) -> torch.Tensor:
    """This rank's ZeRO-1 slice of ``t`` (a leaf in ``param``'s shape),
    or ``t`` where ``param``'s state is not cut over ``"data"``."""
    owned = state.zero1.get(param)
    if owned is None:
        return t
    mesh = state.mesh
    return shard_slice(t, owned[0], mesh.coord(DATA_AXIS),
                       mesh.axis_size(DATA_AXIS))


def set_param_opt_state(state: TrainState, param: nn.Parameter,
                        slots: Mapping[str, torch.Tensor],
                        count: Optional[int] = None,
                        copy: bool = True) -> None:
    """One parameter's optimizer state from optax-layout leaves (``slots``
    by name, this rank's shard; Adam's ``count``), on the parameter's
    device; ``copy=False`` lets a leaf already there become the state.
    Under ZeRO-1 the state is this rank's ``"data"`` slice of each leaf,
    always copied (a slice would keep the whole leaf alive)."""
    target = stepped(state, param)
    slot_state = state.opt.state[target]
    slot_state.clear()
    cut = target is not param
    for name, key in state.optimizer.slots.items():
        slot_state[key] = _data_part(state, param, slots[name]).to(
            device=target.device, dtype=torch.float32, copy=copy or cut)
    if state.optimizer.name == "adam":
        # torch keeps Adam's step count as a float32 host tensor per
        # parameter; optax one int32 count
        slot_state["step"] = torch.tensor(float(count), dtype=torch.float32)


def set_opt_state(state: TrainState, opt_state: Mapping) -> None:
    """Load an optimizer state tree in optax's layout
    (:func:`opt_state_tree`; over a mesh, this rank's shards) into the
    torch optimizer, copied onto each parameter's device."""
    need = set(state.optimizer.slots) | (
        {"count"} if state.optimizer.name == "adam" else set())
    if need - set(opt_state):
        raise KeyError(f"{state.optimizer.name} state needs {sorted(need)}, "
                       f"got {sorted(opt_state)}")
    count = opt_state.get("count")
    for path, param in state.model.named_parameters():
        set_param_opt_state(
            state, param,
            {name: _leaf(opt_state[name], path)
             for name in state.optimizer.slots},
            None if count is None else int(count))


def train_state_from_numpy(model: nn.Module, params: Mapping,
                           trace: Optional[Mapping] = None, *,
                           opt_state: Optional[Mapping] = None,
                           optimizer: Optional[Optimizer] = None,
                           step: int = 0, device="cuda",
                           mesh=None) -> TrainState:
    """A JAX train state carried across: ``params`` is the flax tree and
    ``opt_state`` optax's state in its layout (``{"trace": ...}`` of
    ``opt_state[0].trace`` for sgd, ``{"count", "mu", "nu"}`` of
    ``opt_state[0]`` for adam), or for sgd ``trace`` alone, all as numpy
    (``jax.tree.map(np.asarray, ...)``).  The torch optimizer's state is
    set from it (:func:`set_opt_state`), so a state taken mid-training
    continues as the JAX step would.  Over a mesh (``mesh``, or the
    model's) the trees are whole and this rank keeps its shard of each
    (:func:`place_lm`), on the mesh's device."""
    if trace is not None:
        opt_state = {"trace": trace}
    mesh = mesh if mesh is not None else getattr(model, "mesh", None)
    if mesh is not None:
        # the whole trees wait on the host; the rank keeps its shards
        return place_lm(model, params_from_numpy(params),
                        opt_state=(None if opt_state is None
                                   else _opt_from_numpy(opt_state)),
                        optimizer=optimizer, step=step, mesh=mesh)
    dev = resolve_device(device)
    state = create_train_state(model, params_from_numpy(params, dev),
                               optimizer=optimizer, step=step)
    if opt_state is not None:
        set_opt_state(state, _opt_from_numpy(opt_state, dev))
    return state


def _opt_from_numpy(opt_state: Mapping, device="cpu") -> Tree:
    return {k: (params_from_numpy(v, device) if isinstance(v, Mapping)
                else torch.as_tensor(np.asarray(v)))
            for k, v in opt_state.items()}


def place_lm(model: nn.Module, params: Mapping,
             trace: Optional[Mapping] = None, *,
             opt_state: Optional[Mapping] = None,
             optimizer: Optional[Optimizer] = None, step: int = 0,
             mesh=None) -> TrainState:
    """The JAX ``place_lm``: a train state over ``mesh`` (default the
    model's) from WHOLE trees of tensors on any device, ``params`` and
    optionally the optimizer state ``opt_state`` in optax's layout (or
    SGD's ``trace`` alone): this rank keeps its shard of each tree by the
    Megatron rules (``shard_state``: a moment shards like its parameter,
    Adam's ``count`` is replicated), copied onto the mesh's device, so
    the whole tree can be freed once the caller drops it.  Every rank of
    a ``"data"`` group gets the same shards (on a 3-D mesh, every rank of
    a ``"data"`` x ``"seq"`` plane)."""
    mesh = mesh if mesh is not None else getattr(model, "mesh", None)
    if mesh is None:
        raise ValueError("place_lm needs a mesh (the model's or mesh=)")
    if trace is not None:
        opt_state = {"trace": trace}
    return place_shards(model, params, opt_state, optimizer, step, mesh,
                        rules_of(model))


def place_shards(model: nn.Module, params: Mapping,
                 opt_state: Optional[Mapping],
                 optimizer: Optional[Optimizer], step: int, mesh,
                 rules) -> TrainState:
    """A train state over ``mesh`` from WHOLE trees: this rank's part of
    ``params`` and of each optimizer slot by ``rules``
    (``shard_state``), copied onto the mesh's device; Adam's ``count``
    as it is."""
    dev = resolve_device(mesh.device)

    def shards(tree):
        return tree_map(lambda t: t.to(dev), shard_state(tree, mesh, rules))

    state = create_train_state(model, shards(params), optimizer=optimizer,
                               step=step)
    if opt_state is not None:
        set_opt_state(state, {k: shards(v) if isinstance(v, Mapping) else v
                              for k, v in opt_state.items()})
    return state


def place_moe(model: nn.Module, params: Mapping, *,
              opt_state: Optional[Mapping] = None,
              optimizer: Optional[Optimizer] = None, step: int = 0,
              mesh=None) -> TrainState:
    """The JAX ``place_moe``: the MoE transformer's train state over a
    ``("data", "expert"[, "model"])`` mesh (default the model's; at one
    device, ``mesh`` None, on the device the trees are on) from WHOLE
    trees of tensors, ``params`` and optionally the optimizer state in
    optax's layout: ``MOE_EP_TP_RULES`` where the mesh has ``"model"``,
    else ``MOE_EP_RULES``, cut each leaf and each optimizer slot alike,
    this rank's shards copied onto the mesh's device.  The batch half is
    the caller's: each rank feeds the model its ``"data"`` rows."""
    mesh = mesh if mesh is not None else getattr(model, "mesh", None)
    if mesh is None:
        state = create_train_state(
            model, tree_map(lambda t: t.clone(), params),
            optimizer=optimizer, step=step)
        if opt_state is not None:
            set_opt_state(state, opt_state)
        return state
    if EXPERT_AXIS not in mesh.axis_names:
        raise ValueError(f"place_moe needs an 'expert' axis, got "
                         f"{tuple(mesh.axis_names)}")
    rules = MOE_EP_TP_RULES if MODEL_AXIS in mesh.axis_names else MOE_EP_RULES
    if rules is not rules_of(model):
        raise ValueError("the model was built for another mesh: its "
                         "shard rules are not place_moe's")
    return place_shards(model, params, opt_state, optimizer, step, mesh,
                        rules)


def place_cp_lm(model: nn.Module, params: Mapping, *,
                opt_state: Optional[Mapping] = None,
                optimizer: Optional[Optimizer] = None, step: int = 0,
                mesh=None) -> TrainState:
    """The JAX ``place_cp_lm``: a train state over a ``("data", "seq")``
    mesh (default the model's, built with ``context_parallel=True``)
    from WHOLE trees of tensors on any device, ``params`` and optionally
    the optimizer state in optax's layout: every rank keeps all of both,
    copied onto the mesh's device (the activations, not the weights, are
    split over ``"seq"``)."""
    mesh = mesh if mesh is not None else getattr(model, "mesh", None)
    if mesh is None or SEQ_AXIS not in mesh.axis_names:
        raise ValueError("place_cp_lm needs a mesh with a 'seq' axis")
    dev = resolve_device(mesh.device)

    def whole(tree):
        return tree_map(lambda t: t.to(dev, copy=True), tree)

    state = create_train_state(model, whole(params), optimizer=optimizer,
                               step=step)
    if opt_state is not None:
        set_opt_state(state, {k: whole(v) if isinstance(v, Mapping) else v
                              for k, v in opt_state.items()})
    return state


def place_resnet(model: nn.Module, params: Mapping, batch_stats: Mapping,
                 *, opt_state: Optional[Mapping] = None,
                 optimizer: Optional[Optimizer] = None, step: int = 0,
                 mesh=None) -> TrainState:
    """The JAX ``place_resnet``'s state half: a ResNet's train state from
    WHOLE trees of tensors on any device (``params``, ``batch_stats`` and
    optionally the optimizer state in optax's layout), every rank keeping
    a copy of all of them on the mesh's device (default the model's; at
    one device, ``mesh`` None, on the device the trees are on).  The
    batch half is the caller's: each rank feeds the model its own
    rows."""
    mesh = mesh if mesh is not None else getattr(model, "mesh", None)

    def whole(tree):
        if mesh is None:
            return tree_map(lambda t: t.clone(), tree)
        dev = resolve_device(mesh.device)
        return tree_map(lambda t: t.to(dev, copy=True), tree)

    state = create_train_state(model, whole(params), optimizer=optimizer,
                               step=step, batch_stats=whole(batch_stats))
    if opt_state is not None:
        set_opt_state(state, {k: whole(v) if isinstance(v, Mapping) else v
                              for k, v in opt_state.items()})
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


def _slot_buffer(state: TrainState, param: nn.Parameter,
                 key: str) -> torch.Tensor:
    """``param``'s optimizer buffer ``key`` (its ZeRO-1 slice's), zeros
    before the first step."""
    target = stepped(state, param)
    buf = state.opt.state.get(target, {}).get(key)
    return torch.zeros_like(target) if buf is None else buf.detach()


def _slot_tree(state: TrainState, key: str) -> Tree:
    return _param_tree(state, lambda param: _slot_buffer(state, param, key))


def step_count(state: TrainState) -> torch.Tensor:
    """Adam's step count as optax's ``count`` (an int32 scalar; 0 before
    the first step)."""
    steps = {int(s["step"]) for s in state.opt.state.values() if "step" in s}
    if len(steps) > 1:
        raise RuntimeError(f"parameters at different step counts {steps}")
    return torch.tensor(steps.pop() if steps else 0, dtype=torch.int32)


def opt_state_tree(state: TrainState) -> Tree:
    """The optimizer's state in optax's layout (:class:`Optimizer`):
    each per-parameter state in the parameter tree's layout (over a
    mesh, this rank's shards of it, ZeRO-1's ``"data"`` slices
    included), zeros before the first step."""
    out: Tree = {name: _slot_tree(state, key)
                 for name, key in state.optimizer.slots.items()}
    if state.optimizer.name == "adam":
        out["count"] = step_count(state)
    return out


def momentum_tree(state: TrainState) -> Tree:
    """SGD's momentum buffers in the parameter tree's layout (the optax
    trace's counterpart; over a mesh, this rank's shards of it); zeros
    before the first step."""
    if state.optimizer.name != "sgd":
        raise ValueError(f"{state.optimizer.name} keeps no momentum trace; "
                         "read opt_state_tree")
    return _slot_tree(state, "momentum_buffer")


def grad_tree(state: TrainState) -> Tree:
    """Each parameter's ``.grad`` in the parameter tree's layout (over a
    mesh, this rank's shards)."""
    return _param_tree(state, lambda param: param.grad)


def _path(name: str) -> str:
    return name.replace(".", "/")


def iter_whole_state(state: TrainState) -> Iterator[Tuple[str, torch.Tensor]]:
    """The whole training tree one leaf at a time, as ``(path, tensor)``
    with ``/``-joined paths: ``params/...``, then each optimizer tree
    ``opt_state/<name>/...`` (and Adam's ``opt_state/count``), then a
    ResNet's statistics ``batch_stats/...`` (replicated: never
    gathered).  Over a
    mesh each sharded leaf is all-gathered over ``"model"`` as it comes
    (every rank of a ``"model"`` group iterates it in step), and under
    ZeRO-1 each optimizer slice over ``"data"`` first (then every rank
    iterates it); at one device the leaves are the state's own tensors,
    detached, not copies.  One leaf at a time keeps a save's extra
    memory to one leaf."""
    mesh = state.mesh
    place = mesh_place(mesh)
    rules = rules_of(state.model)

    def whole(path: str, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        dims = placed_dims(path, t.ndim, place, rules)
        return mesh_gather(t, dims, mesh) if dims else t

    named = list(state.model.named_parameters())
    for name, param in named:
        yield f"params/{_path(name)}", whole(_path(name), param)
    for slot, key in state.optimizer.slots.items():
        for name, param in named:
            buf = _slot_buffer(state, param, key)
            owned = state.zero1.get(param)
            if owned is not None:
                buf = all_gather(buf, mesh, owned[0], axis=DATA_AXIS)
            yield f"opt_state/{slot}/{_path(name)}", whole(_path(name), buf)
    if state.optimizer.name == "adam":
        yield "opt_state/count", step_count(state)
    for name, buf in state.model.named_buffers():
        yield f"batch_stats/{_path(name)}", buf.detach()


def gather_state(state: TrainState) -> Tuple[Tree, Tree]:
    """The whole parameter tree and optimizer state (optax's layout:
    ``{"trace": tree}`` for sgd) from every ``"model"`` rank's shards
    (every rank of a ``"model"`` group calls it; under ZeRO-1 every
    rank); at one device, copies of both.  (A ResNet's statistics are
    the state's ``batch_stats``.)"""
    params: Tree = {}
    opt: Tree = {}
    for path, t in iter_whole_state(state):
        root, _, rest = path.partition("/")
        if root == "batch_stats":
            continue
        node = params if root == "params" else opt
        parts = rest.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t.clone()
    return params, opt


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


def resnet_loss(state: TrainState, images: torch.Tensor,
                labels: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """The JAX ``resnet_loss``: a training-mode forward of this rank's
    NHWC ``images`` and the mean cross-entropy of ``labels``, with the
    new BatchNorm statistics from the same forward, which updates the
    state's ``batch_stats`` in place (returned).  Over a mesh the value
    is the mean over ``"data"`` and the gradient that of this rank's own
    mean, as :func:`lm_loss`'s."""
    loss = cross_entropy(state.model(images, train=True), labels)
    if state.mesh is not None:
        loss = data_mean(loss, state.mesh)
    return loss, state.batch_stats


def resnet_grads(state: TrainState, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """The step's loss and gradients without the update: zero the
    gradients, differentiate :func:`resnet_loss` (the statistics move),
    :func:`sync_grads`."""
    state.opt.zero_grad(set_to_none=True)
    loss, _ = resnet_loss(state, images, labels)
    loss.backward()
    sync_grads(state)
    return loss.detach()


def resnet_step(state: TrainState, images: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """One training step, the JAX ``make_resnet_train_step``'s: loss,
    gradients and new statistics (:func:`resnet_grads`), one update of
    the optimizer.  Returns the loss as a 0-d tensor on the device."""
    loss = resnet_grads(state, images, labels)
    state.opt.step()
    state.step += 1
    return loss


def lm_loss(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token loss of a ``(b, s + 1)`` token window: the model reads
    ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``.  Over a mesh
    ``tokens`` are this data rank's rows: the value is the mean over the
    ``"data"`` ranks, the gradient that of this rank's own mean.  Over a
    ``"seq"`` axis of cp ranks the model reads this rank's ``s / cp``
    rows, ``tokens[:, i * s / cp:(i + 1) * s / cp]`` at coordinate i,
    and predicts the token after each; the value is the mean over
    ``"data"`` x ``"seq"``.  With a ``"model"`` axis too (the 3-D mesh)
    the logits are this rank's vocab columns, reduced over ``"model"``
    by the vocab-parallel :func:`cross_entropy`, and the mean is taken
    over this rank's ``"data"`` x ``"seq"`` plane."""
    mesh = getattr(model, "mesh", None)
    if getattr(model, "cp_mesh", None) is not None:
        cp = cp_size(mesh)
        s = tokens.shape[1] - 1
        if s % cp:
            raise ValueError(f"context parallelism: {s} positions do not "
                             f"divide over cp={cp}")
        s_loc = s // cp
        first = mesh.coord(SEQ_AXIS) * s_loc
        rows = tokens[:, first:first + s_loc + 1]
        loss = cross_entropy(model(rows[:, :-1]), rows[:, 1:], mesh)
        if MODEL_AXIS in mesh.axis_names:
            return data_seq_mean(loss, mesh)
        return mesh_mean(loss, mesh)
    loss = cross_entropy(model(tokens[:, :-1]), tokens[:, 1:], mesh)
    return loss if mesh is None else data_mean(loss, mesh)


def replicated_params(model: nn.Module) -> List[nn.Parameter]:
    """The parameters every ``"model"`` rank holds whole (no rule shards
    them over ``"model"``: the LayerNorms), in the model's order."""
    rules = rules_of(model)
    return [p for n, p in model.named_parameters()
            if MODEL_AXIS not in shard_dims(_path(n), rules)]


def sync_grads(state: TrainState) -> None:
    """After ``backward()`` over a mesh: (a) under sequence parallelism
    sum the replicated parameters' gradients over ``"model"`` (each rank
    differentiated its own rows of the LayerNorms), then (b) average all
    gradients over ``"data"`` in one flat all-reduce.  Context parallel,
    every gradient is averaged over all ranks (``"data"`` x ``"seq"``)
    in one flat all-reduce; on a 3-D mesh over this rank's ``"data"`` x
    ``"seq"`` plane (the LayerNorms need no sum over ``"model"``: the
    stream is replicated there).  Nothing at one device.

    Under ZeRO-1 (``state.zero1``) each cut parameter's gradient is
    instead reduce-scattered over ``"data"`` onto its slice (divided by
    dp) and dropped from the parameter."""
    mesh = state.mesh
    if mesh is None:
        return
    if getattr(state.model, "cp_mesh", None) is not None:
        grads = [p.grad for p in state.model.parameters()]
        if MODEL_AXIS in mesh.axis_names:
            mean_grads_over_data_seq(grads, mesh)
        else:
            mean_grads_over_mesh(grads, mesh)
        return
    if getattr(state.model, "seq_sharded", False):
        flat_all_reduce([p.grad for p in replicated_params(state.model)],
                        mesh.group)
    mean_grads_over_data([p.grad for p in state.model.parameters()
                          if p not in state.zero1], mesh)
    dp = mesh.axis_size(DATA_AXIS)
    for param, (dim, part) in state.zero1.items():
        part.grad = reduce_scatter(param.grad, mesh, DATA_AXIS,
                                   dim).mul_(1.0 / dp)
        param.grad = None


def refresh_slices(state: TrainState) -> None:
    """Each ZeRO-1 slice copied from its parameter, after the parameters
    were set in place (a restore); nothing without ZeRO-1."""
    with torch.no_grad():
        for param, (_, part) in state.zero1.items():
            part.copy_(_data_part(state, param, param))


def gather_slices(state: TrainState) -> None:
    """After a ZeRO-1 update: each parameter cut over ``"data"`` becomes
    the all-gather of every data rank's new slice (nothing without
    ZeRO-1)."""
    with torch.no_grad():
        for param, (dim, part) in state.zero1.items():
            param.copy_(all_gather(part, state.mesh, dim, axis=DATA_AXIS))


def lm_grads(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
    """The step's loss and gradients, without the update: zero the
    gradients, differentiate :func:`lm_loss`, :func:`sync_grads`.  Each
    parameter's ``.grad`` is then the gradient of the global mean loss
    for this rank's shard (under ZeRO-1 its slice's, for a parameter
    cut over ``"data"``)."""
    state.opt.zero_grad(set_to_none=True)
    loss = lm_loss(state.model, tokens)
    loss.backward()
    sync_grads(state)
    return loss.detach()


def lm_step(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
    """One training step, the JAX ``make_lm_train_step``'s: loss,
    gradients (:func:`lm_grads`), one update of the state's optimizer in
    place on this rank's shards (under ZeRO-1 on its slices, then
    :func:`gather_slices`).  Returns the step's loss as a 0-d tensor on
    the device (no host sync)."""
    loss = lm_grads(state, tokens)
    state.opt.step()
    gather_slices(state)
    state.step += 1
    return loss


# -- the MoE transformer -------------------------------------------------------


MOE_AUX_WEIGHT = 0.01


def moe_loss(model: nn.Module, tokens: torch.Tensor,
             aux_weight: float = MOE_AUX_WEIGHT
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``moe_loss`` of a ``(b, s + 1)`` token window:
    ``(cross_entropy + aux_weight * aux, aux)``, ``aux`` the mean over
    layers of each MoE layer's aux loss (the whole batch's).  Over a mesh
    ``tokens`` are this data rank's rows; the cross-entropy is the mean
    over ``"data"`` (the gradient that of this rank's own mean, as in
    :func:`lm_loss`); the aux is the same on every rank.  The returned
    aux carries no gradient."""
    mesh = getattr(model, "mesh", None)
    logits, sown = model.apply(tokens[:, :-1])
    aux = layer_mean(sown["aux_loss"])
    ce = cross_entropy(logits, tokens[:, 1:], mesh)
    if mesh is not None:
        ce = data_mean(ce, mesh)
    return ce + aux_weight * aux, aux.detach()


def moe_grads(state: TrainState, tokens: torch.Tensor,
              aux_weight: float = MOE_AUX_WEIGHT
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's ``(loss, aux)`` and gradients without the update:
    zero the gradients, differentiate :func:`moe_loss`,
    :func:`sync_grads`."""
    state.opt.zero_grad(set_to_none=True)
    loss, aux = moe_loss(state.model, tokens, aux_weight)
    loss.backward()
    sync_grads(state)
    return loss.detach(), aux


def moe_step(state: TrainState, tokens: torch.Tensor,
             aux_weight: float = MOE_AUX_WEIGHT
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One training step, the JAX ``make_moe_train_step``'s: loss, aux
    and gradients (:func:`moe_grads`), one update of the optimizer in
    place on this rank's shards.  Returns ``(loss, aux)`` as 0-d tensors
    on the device."""
    loss, aux = moe_grads(state, tokens, aux_weight)
    state.opt.step()
    state.step += 1
    return loss, aux


# -- draft distillation (speculative decoding) --------------------------------
#
# The port of the JAX ``draft_distill_loss`` and ``make_draft_distill_step``:
# the draft learns to match the target's conditionals on target rollouts,
# since the speculative accept rate at a position is 1 - TV(p, q).  Forward
# KL(teacher || draft) bounds the rejection rate; a small hard-label term
# keeps the draft's argmax on the teacher's for the greedy lane.


def draft_distill_loss(model: nn.Module, tokens: torch.Tensor,
                       teacher_logits: torch.Tensor,
                       temperature: float = 1.0,
                       hard_weight: float = 0.1) -> torch.Tensor:
    """Distillation loss of a draft ``model`` on rollouts ``tokens``
    ``(b, L + 1)`` with the teacher's logits ``(b, L, V)`` at each
    next-token position: ``KL(teacher || draft) * T^2 + hard_weight *
    CE(draft, tokens)`` at temperature ``T``, in float32.  No gradient
    reaches ``teacher_logits``.  One device only (the KL would need the
    vocab-parallel head's collectives over a mesh)."""
    if getattr(model, "mesh", None) is not None:
        raise NotImplementedError("draft distillation runs at one device")
    logits = model(tokens[:, :-1])
    t = float(temperature)
    t_logp = torch.log_softmax(teacher_logits.detach().float() / t, dim=-1)
    s_logp = torch.log_softmax(logits.float() / t, dim=-1)
    # forward KL: mass where the teacher puts it, the measure the
    # rejection sampler scores the draft against
    kl = (t_logp.exp() * (t_logp - s_logp)).sum(-1).mean() * t * t
    return kl + hard_weight * cross_entropy(logits, tokens[:, 1:])


def draft_distill_step(state: TrainState, teacher: nn.Module,
                       tokens: torch.Tensor, temperature: float = 1.0,
                       hard_weight: float = 0.1) -> torch.Tensor:
    """One distillation step of the draft ``state`` against the frozen
    ``teacher`` (a model bound to the target's weights): the teacher's
    logits under ``torch.no_grad()``, the gradient of
    :func:`draft_distill_loss`, one update of the draft's optimizer.
    Returns the loss as a 0-d tensor on the device."""
    with torch.no_grad():
        t_logits = teacher(tokens[:, :-1])
    state.opt.zero_grad(set_to_none=True)
    loss = draft_distill_loss(state.model, tokens, t_logits,
                              temperature=temperature,
                              hard_weight=hard_weight)
    loss.backward()
    state.opt.step()
    state.step += 1
    return loss.detach()
