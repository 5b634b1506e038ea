"""ZeRO-1, optimizer-state sharding over ``"data"``: the port of
``kubegpu_tpu/parallel/zero.py`` (``_zero1_spec``,
``zero1_state_shardings``, ``place_zero1_lm``,
``make_zero1_lm_train_step``, ``state_bytes_per_device``).

Plain data parallelism keeps the parameters and the whole optimizer
state on every rank: Adam's two float32 moments of the 1.08B flagship
are 8.6 GB a rank mirroring the others.  ZeRO-1 keeps the parameters
replicated (the forward and backward are unchanged) and cuts each
optimizer-state leaf over ``"data"``: every rank updates its slice of
the parameter and the new slices are all-gathered back.

The JAX package only annotates shardings and lets GSPMD lower the
update to a reduce-scatter and an all-gather; the port writes that
decomposition out (``train.sync_grads`` and ``train.gather_slices``):

- a leaf's layout (:func:`zero1_state_shardings`) is, in the JAX order
  of checks, replicated for a scalar (Adam's ``count``), the rule's
  shard where ``rules`` shard the parameter (a TP moment mirrors its
  parameter), else ``"data"`` on the first dim at least dp wide that dp
  divides, else replicated;
- :func:`place_zero1_lm` binds the parameters (whole, or by the model's
  Megatron rules over ``"model"``) and gives each parameter whose layout
  names ``"data"`` a slice of its own, ``train.TrainState.zero1``, which
  the optimizer steps in the parameter's place: ``torch.optim`` keys its
  state by tensor, and a view of a replicated parameter along a later
  dim is not contiguous;
- a step (:func:`make_zero1_lm_train_step`, ``train.lm_step``)
  reduce-scatters each cut parameter's gradient over ``"data"`` onto its
  slice (``collectives.reduce_scatter``, staged through the host on gloo
  with a card), averages the others' as plain DP does, steps the
  optimizer, and all-gathers each new slice into its parameter.

``train.opt_state_tree`` reads a rank's slices;
``train.iter_whole_state`` and ``train.gather_state`` gather them whole
(so a ZeRO-1 checkpoint is the whole optax-layout tree and restores on
any mesh), and ``train.set_opt_state`` and the checkpoint's restore cut
a whole leaf to this rank's slice."""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from kubegpu_tpu_torch.models.params import resolve_device, tree_map
from kubegpu_tpu_torch.models.train import (
    Optimizer,
    TrainState,
    create_train_state,
    lm_step,
    set_opt_state,
    set_param_opt_state,
    sgd,
    stepped,
)
from kubegpu_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, tp_size
from kubegpu_tpu_torch.parallel.sharding import (
    rules_of,
    shard_dims,
    shard_slice,
    shard_state,
)

# a leaf's layout as a JAX PartitionSpec reads: the axis each dim is cut
# over, or None; () is replicated
Spec = Tuple[Optional[str], ...]


def _spec(dims: Mapping[str, int], ndim: int) -> Spec:
    spec: list = [None] * ndim
    for axis, dim in dims.items():
        spec[dim] = axis
    return tuple(spec)


def _rule_spec(path: str, ndim: int, mesh, rules) -> Spec:
    """A leaf's spec by ``rules`` (() without or where none cuts it); a
    rule naming an axis the mesh lacks raises, as a JAX
    ``NamedSharding`` does."""
    dims = shard_dims(path, rules) if rules and ndim else {}
    missing = [a for a in dims if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"{path}: the rules cut it over {missing}, not an "
                         f"axis of the mesh {mesh.shape}")
    return _spec(dims, ndim) if dims else ()


def _zero1_spec(path: str, shape: Tuple[int, ...], mesh,
                rules=None) -> Spec:
    """An optimizer-state leaf's spec: the rule's if one cuts it (TP
    moments must mirror their parameters), else ``"data"`` on the first
    dim at least the ``"data"`` width that it divides; scalars and
    indivisible shapes are replicated."""
    if not len(shape):
        return ()
    spec = _rule_spec(path, len(shape), mesh, rules)
    if spec:
        return spec
    dp = mesh.axis_size(DATA_AXIS)
    if dp > 1:
        for axis, n in enumerate(shape):
            if n >= dp and n % dp == 0:
                return _spec({DATA_AXIS: axis}, len(shape))
    return ()


def _paths(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _paths(v, path)
        else:
            yield path, v


def _nest(flat) -> dict:
    out: dict = {}
    for path, v in flat:
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


def zero1_state_shardings(params: Mapping, mesh, rules=None,
                          optimizer: Optional[Optimizer] = None) -> dict:
    """The layout of a ZeRO-1 train state over ``mesh`` from the WHOLE
    parameter tree (leaves with a ``shape``): ``{"params": tree,
    "opt_state": tree}``, each leaf a :data:`Spec`.  The parameters
    follow ``rules`` (replicated without); ``opt_state`` is in optax's
    layout for ``optimizer`` (default sgd: ``{"trace": tree}``; adam:
    ``{"count": (), "mu": tree, "nu": tree}``), every slot's leaf laid
    out by :func:`_zero1_spec`."""
    optimizer = optimizer or sgd()
    leaves = list(_paths(params))
    layout = _nest((p, _zero1_spec(p, tuple(v.shape), mesh, rules))
                   for p, v in leaves)
    opt: dict = {slot: layout for slot in optimizer.slots}
    if optimizer.name == "adam":
        opt["count"] = ()
    placed = _nest((p, _rule_spec(p, len(v.shape), mesh, rules))
                   for p, v in leaves)
    return {"params": placed, "opt_state": opt}


def place_zero1_lm(model, params: Mapping, *,
                   opt_state: Optional[Mapping] = None,
                   optimizer: Optional[Optimizer] = None, step: int = 0,
                   mesh=None) -> Tuple[TrainState, dict]:
    """ZeRO-1 placement over a ``("data"[, "model"])`` mesh (default the
    model's) from WHOLE trees of tensors: the parameters replicated, or
    over ``"model"`` by the model's Megatron rules (``rules_of``, the
    rules the JAX caller passes), and the optimizer state (``opt_state``
    in optax's layout, else zeros) by :func:`zero1_state_shardings` under
    the same rules: a leaf cut over ``"data"`` keeps this rank's slice,
    on a tensor the optimizer steps in the parameter's place.  The batch
    half is the caller's.  Returns ``(state, shardings)``."""
    mesh = mesh if mesh is not None else getattr(model, "mesh", None)
    if mesh is None or DATA_AXIS not in mesh.axis_names:
        raise ValueError("place_zero1_lm needs a mesh with a 'data' axis")
    extra = set(mesh.axis_names) - {DATA_AXIS, MODEL_AXIS}
    if extra:
        raise ValueError(f"ZeRO-1 runs over ('data'[, 'model']), not "
                         f"{tuple(mesh.axis_names)}")
    # one source of the parameters' layout: without a "model" axis no
    # rule cuts a leaf (and the rules name an axis the mesh lacks)
    rules = rules_of(model) if tp_size(mesh) > 1 else ()
    optimizer = optimizer or sgd()
    sh = zero1_state_shardings(params, mesh, rules, optimizer)
    dev = resolve_device(mesh.device)
    state = create_train_state(
        model, tree_map(lambda t: t.to(dev),
                        shard_state(params, mesh, rules)),
        optimizer=optimizer, step=step)
    layout = dict(_paths(sh["opt_state"][next(iter(optimizer.slots))]))
    dp, coord = mesh.axis_size(DATA_AXIS), mesh.coord(DATA_AXIS)
    for name, param in model.named_parameters():
        spec = layout[name.replace(".", "/")]
        if DATA_AXIS in spec:
            dim = spec.index(DATA_AXIS)
            part = shard_slice(param.detach(), dim, coord, dp).clone()
            state.zero1[param] = (dim, part)
    state.opt = optimizer.build([stepped(state, p)
                                 for p in model.parameters()])
    if opt_state is not None:
        set_opt_state(state, {k: shard_state(v, mesh, rules)
                              if isinstance(v, Mapping) else v
                              for k, v in opt_state.items()})
        return state, sh
    # zeros, one leaf at a time (optax's init), so the memory a rank
    # holds is its own from the start
    for param in model.parameters():
        zero = torch.zeros_like(param.detach())
        set_param_opt_state(state, param,
                            {slot: zero for slot in optimizer.slots},
                            0 if optimizer.name == "adam" else None)
    return state, sh


def _cut_dims(state: TrainState) -> Dict[str, int]:
    """Each cut parameter's dim over ``"data"``, by its tree path."""
    return {name.replace(".", "/"): state.zero1[p][0]
            for name, p in state.model.named_parameters()
            if p in state.zero1}


def make_zero1_lm_train_step(mesh, shardings: dict) -> Callable:
    """The ZeRO-1 LM step over ``mesh``: ``step(state, tokens)`` for a
    state from :func:`place_zero1_lm` with ``shardings`` (refused
    otherwise), this rank's ``"data"`` rows as ``tokens``; returns the
    loss.  It is ``train.lm_step``: loss and gradients, the
    reduce-scatter of each cut gradient onto its slice, the update, the
    all-gather of the new slices."""

    slots = shardings["opt_state"]
    layout = next(v for k, v in slots.items() if k != "count")
    want = {path: spec.index(DATA_AXIS) for path, spec in _paths(layout)
            if DATA_AXIS in spec}

    def step(state: TrainState, tokens: torch.Tensor) -> torch.Tensor:
        if state.mesh is not mesh or _cut_dims(state) != want:
            raise ValueError("not a ZeRO-1 state of this mesh and layout: "
                             "place it with place_zero1_lm")
        return lm_step(state, tokens)

    return step


def state_bytes_per_device(state: TrainState) -> Tuple[int, int]:
    """``(param_bytes, opt_bytes)`` that this rank holds: its parameter
    shards and its optimizer state (each slot a float32 tensor the size
    of what it steps, a ZeRO-1 slice where cut, counted before the first
    step too; Adam's int32 ``count`` 4 bytes), the JAX function's
    per-device reckoning."""
    def nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    params = list(state.model.parameters())
    opt = sum(4 * stepped(state, p).numel() for p in params
              for _ in state.optimizer.slots)
    if state.optimizer.name == "adam":
        opt += 4
    return sum(nbytes(p) for p in params), opt
