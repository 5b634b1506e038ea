"""The Megatron sharding rules of tensor-parallel serving and training:
the port's own copy of ``TRANSFORMER_TP_RULES``, ``param_shardings``,
``state_shardings``, ``batch_axes``, the pool and dense-cache specs and
``tp_all_reduce_wire_bytes`` of ``kubegpu_tpu/parallel/sharding.py``.

A rule maps a parameter's ``/``-joined tree path to the dim it shards
over the ``"model"`` axis (None: every rank holds it whole).  The first
(column-parallel) matmul of a block shards its output dim, the second
(row-parallel) its input dim, so each block needs one all-reduce after
each row-parallel matmul.  The embeddings shard their hidden dim and the
head its vocab dim.  An int8 kernel shards like its float twin, and its
per-output-channel ``qscale`` follows the output dim: split where the
output dim is (column-parallel), whole where the input dim is
(row-parallel).

Expert parallelism (``MOE_EP_RULES``, ``MOE_EP_TP_RULES``, the MoE
transformer's): a rule may name a dim for each of several axes, as a
``{axis: dim}`` mapping.  The stacked expert kernels ``w_up`` ``(e, d,
h)`` and ``w_down`` ``(e, h, d)`` shard their expert dim over
``"expert"`` and, under EP x TP, ``w_up``'s output dim and ``w_down``'s
input dim over ``"model"``; the router stays whole.  A plain int is a
dim over ``"model"``, so the serving and LM rules read as they did.

A training state shards its momentum like its parameters
(:func:`shard_state`, the JAX ``state_shardings``: the trace mirrors the
parameter tree, so the same rules cut it), and :func:`gather_params`
puts a tree back together from every rank's shards along every axis.
A model names its rules as ``shard_rules`` (:func:`rules_of`; the
transformer rules where it names none)."""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from kubegpu_tpu_torch.models.params import tree_map
from kubegpu_tpu_torch.parallel.collectives import all_gather
from kubegpu_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
)

# a rule's value: a dim over "model", None (whole), or {axis: dim}
Placement = Union[None, int, Mapping[str, int]]

TRANSFORMER_TP_RULES: Tuple[Tuple[str, Placement], ...] = (
    (r".*embed.*/embedding$", 1),
    (r".*(q_proj|k_proj|v_proj)/kernel$", 1),
    (r".*o_proj/kernel$", 0),
    (r".*mlp_up/kernel$", 1),
    (r".*mlp_down/kernel$", 0),
    (r".*lm_head/kernel$", 1),
    (r".*(q_proj|k_proj|v_proj|mlp_up|lm_head)/kernel_int8$", 1),
    (r".*(o_proj|mlp_down)/kernel_int8$", 0),
    (r".*(q_proj|k_proj|v_proj|mlp_up|lm_head)/qscale$", 0),
    (r".*(o_proj|mlp_down)/qscale$", None),
    (r".*bias$", None),
    (r".*scale$", None),
)

# Expert parallelism for the MoE transformer (models/moe.py): the stacked
# expert kernels shard their leading expert dim; the router is whole on
# every rank (every token needs every router row).
MOE_EP_RULES: Tuple[Tuple[str, Placement], ...] = (
    (r".*moe_mlp/w_up$", {EXPERT_AXIS: 0}),
    (r".*moe_mlp/w_down$", {EXPERT_AXIS: 0}),
    (r".*router/kernel$", None),
    (r".*bias$", None),
    (r".*scale$", None),
)

# EP x TP: each expert's FFN is also Megatron-sharded over "model" inside
# its expert shard (column-parallel w_up, row-parallel w_down), and the
# attention, embeddings and head take the transformer rules.  The expert
# rules come first, so they win.
MOE_EP_TP_RULES: Tuple[Tuple[str, Placement], ...] = (
    (r".*moe_mlp/w_up$", {EXPERT_AXIS: 0, MODEL_AXIS: 2}),
    (r".*moe_mlp/w_down$", {EXPERT_AXIS: 0, MODEL_AXIS: 1}),
    (r".*router/kernel$", None),
) + TRANSFORMER_TP_RULES

# the heads dim of the page pool (pool_pages, heads, page, head_dim) and
# of its int8 scales (pool_pages, heads): the dim each rank holds 1/tp
# of (the station and draft ring caches, (slots, rows, heads, head_dim),
# shard dim 2, and the ring's (slots, heads) scales dim 1)
POOL_HEADS_DIM = 1


def shard_dims(path: str, rules=TRANSFORMER_TP_RULES) -> Dict[str, int]:
    """``{axis: dim}`` of the first rule matching ``path`` (empty:
    replicated, also where no rule matches)."""
    for pattern, placed in rules:
        if re.match(pattern, path):
            if placed is None:
                return {}
            if isinstance(placed, int):
                return {MODEL_AXIS: placed}
            return dict(placed)
    return {}


def shard_dim(path: str, rules=TRANSFORMER_TP_RULES) -> Optional[int]:
    """The dim the first matching rule shards ``path`` over ``"model"``
    (None: whole over ``"model"``, also where no rule matches)."""
    return shard_dims(path, rules).get(MODEL_AXIS)


def rules_of(model) -> tuple:
    """The sharding rules of ``model``'s tree: its ``shard_rules``, else
    the transformer rules."""
    return getattr(model, "shard_rules", TRANSFORMER_TP_RULES)


# where a rank sits: {axis: (its coordinate, the axis' width)} over the
# axes of more than one rank
Place = Mapping[str, Tuple[int, int]]


def mesh_place(mesh) -> Dict[str, Tuple[int, int]]:
    """This rank's :data:`Place` on ``mesh`` (empty: no mesh)."""
    if mesh is None:
        return {}
    return {a: (mesh.coord(a), mesh.axis_size(a)) for a in mesh.axis_names
            if mesh.axis_size(a) > 1}


def placed_dims(path: str, ndim: int, place: Place,
                rules) -> Dict[str, int]:
    """The ``{axis: dim}`` that ``place`` really cuts a leaf of ``ndim``
    dims at ``path`` along: the rule's, less the axes of one rank."""
    if not ndim:
        return {}
    return {a: d for a, d in shard_dims(path, rules).items() if a in place}


def whole_shape(shape, dims: Mapping[str, int],
                place: Place) -> Tuple[int, ...]:
    """The whole leaf's shape from a shard's ``shape`` cut along
    ``dims`` (:func:`placed_dims`)."""
    out = list(shape)
    for axis, dim in dims.items():
        out[dim] *= place[axis][1]
    return tuple(out)


def place_slice(a, dims: Mapping[str, int], place: Place):
    """The shard at ``place`` of a whole leaf ``a`` (numpy or a tensor)
    cut along ``dims`` (:func:`placed_dims`), each dim by the coordinate
    on its axis."""
    for axis, dim in dims.items():
        a = shard_slice(a, dim, *place[axis])
    return a


def mesh_gather(t: torch.Tensor, dims: Mapping[str, int], mesh):
    """The whole leaf from every rank's shard ``t`` cut along ``dims``:
    one all-gather a cut axis, in the mapping's order (every rank calls
    it)."""
    for axis, dim in dims.items():
        t = all_gather(t, mesh, dim, axis=axis)
    return t


def shard_slice(a, dim: int, rank: int, tp: int):
    """Rank ``rank``'s ``1/tp`` of ``a`` along ``dim`` (a numpy array or
    a tensor); raises when the dim does not divide."""
    n = a.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of size {n} does not divide over "
                         f"{tp} ranks")
    w = n // tp
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(rank * w, (rank + 1) * w)
    part = a[tuple(idx)]
    if isinstance(part, torch.Tensor):
        return part.contiguous()
    return np.ascontiguousarray(part)


def shard_tree(tree: Mapping, place: Place, rules=TRANSFORMER_TP_RULES,
               _path: str = "") -> dict:
    """The part at ``place`` of a whole tree (nested dicts of numpy
    arrays or tensors): every leaf a rule shards is cut along each of
    the rule's axes that ``place`` spans, the rest pass through as they
    are."""
    out = {}
    for k, v in tree.items():
        path = f"{_path}/{k}" if _path else str(k)
        if isinstance(v, Mapping):
            out[k] = shard_tree(v, place, rules, path)
            continue
        out[k] = place_slice(v, placed_dims(path, v.ndim, place, rules),
                             place)
    return out


def shard_params(tree: Mapping, rank: int, tp: int,
                 rules=TRANSFORMER_TP_RULES) -> dict:
    """Rank ``rank``'s part of a whole parameter tree (nested dicts of
    numpy arrays or tensors): every leaf a rule shards over ``"model"``
    is cut to its ``1/tp``, the rest pass through.  At ``tp`` 1 the
    tree's leaves come back as they are.  Quantize
    (``quantize_params_int8``) before sharding: the scales are the whole
    column's."""
    return shard_tree(tree, {MODEL_AXIS: (rank, tp)} if tp > 1 else {},
                      rules)


def shard_state(tree: Mapping, mesh, rules=TRANSFORMER_TP_RULES) -> dict:
    """This rank's part of a whole training tree of tensors (parameters,
    or the momentum that mirrors them) on ``mesh``: every leaf a rule shards
    cut to this rank's part along each of the rule's axes and copied, so
    the whole leaf can be freed; the rest copied whole (every ``"data"``
    rank holds the same shards)."""
    return tree_map(torch.clone, shard_tree(tree, mesh_place(mesh), rules))


def gather_params(tree: Mapping, mesh, rules=TRANSFORMER_TP_RULES,
                  _path: str = "") -> dict:
    """The whole tree from every rank's shards of ``tree`` (tensors),
    concatenated in rank order along each rule's dims: the inverse of
    :func:`shard_state`.  Every rank of the cut axes' groups calls it (it
    all-gathers) and gets the whole tree."""
    out = {}
    for k, v in tree.items():
        path = f"{_path}/{k}" if _path else str(k)
        if isinstance(v, Mapping):
            out[k] = gather_params(v, mesh, rules, path)
            continue
        dims = placed_dims(path, v.ndim, mesh_place(mesh), rules)
        v = v.detach()
        out[k] = mesh_gather(v, dims, mesh) if dims else v.clone()
    return out


def batch_axes(mesh) -> Optional[str]:
    """The axis the batch dim shards over: ``"data"`` where the mesh has
    it, else None (the JAX ``batch_axes`` without multislice's
    ``"dcn"``)."""
    if mesh is not None and DATA_AXIS in mesh.axis_names:
        return DATA_AXIS
    return None


def tp_all_reduce_wire_bytes(tp: int, payload_bytes: int) -> int:
    """Per-device wire traffic of one ring all-reduce of
    ``payload_bytes``: ``2 (tp - 1) / tp`` of the payload (reduce-scatter
    and all-gather), 0 at tp 1.  The serving ledger's collective bytes
    use it as the cost model of each all-reduce."""
    if tp <= 1:
        return 0
    return int(2 * (tp - 1) * payload_bytes // tp)
