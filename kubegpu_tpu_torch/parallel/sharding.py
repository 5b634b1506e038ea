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

A training state shards its momentum like its parameters
(:func:`shard_state`, the JAX ``state_shardings``: the trace mirrors the
parameter tree, so the same rules cut it), and :func:`gather_params`
puts a tree back together from every ``"model"`` rank's shards."""

from __future__ import annotations

import re
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from kubegpu_tpu_torch.models.params import tree_map
from kubegpu_tpu_torch.parallel.collectives import all_gather
from kubegpu_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, tp_size

TRANSFORMER_TP_RULES: Tuple[Tuple[str, Optional[int]], ...] = (
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

# the heads dim of the page pool (pool_pages, heads, page, head_dim) and
# of its int8 scales (pool_pages, heads): the dim each rank holds 1/tp
# of (the station and draft ring caches, (slots, rows, heads, head_dim),
# shard dim 2, and the ring's (slots, heads) scales dim 1)
POOL_HEADS_DIM = 1


def shard_dim(path: str, rules=TRANSFORMER_TP_RULES) -> Optional[int]:
    """The dim the first matching rule shards ``path`` over (None:
    replicated, also where no rule matches)."""
    for pattern, dim in rules:
        if re.match(pattern, path):
            return dim
    return None


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


def shard_params(tree: Mapping, rank: int, tp: int,
                 rules=TRANSFORMER_TP_RULES, _path: str = "") -> dict:
    """Rank ``rank``'s part of a whole parameter tree (nested dicts of
    numpy arrays or tensors): every leaf a rule shards is cut to its
    ``1/tp``, the rest pass through.  At ``tp`` 1 the tree's leaves come
    back as they are.  Quantize (``quantize_params_int8``) before
    sharding: the scales are the whole column's."""
    out = {}
    for k, v in tree.items():
        path = f"{_path}/{k}" if _path else str(k)
        if isinstance(v, Mapping):
            out[k] = shard_params(v, rank, tp, rules, path)
            continue
        dim = shard_dim(path, rules) if tp > 1 and v.ndim else None
        out[k] = v if dim is None else shard_slice(v, dim, rank, tp)
    return out


def shard_state(tree: Mapping, mesh, rules=TRANSFORMER_TP_RULES) -> dict:
    """This rank's part of a whole training tree of tensors (parameters,
    or the momentum that mirrors them) on ``mesh``: every leaf a rule shards
    cut to this rank's ``1/tp`` along ``"model"`` and copied, so the
    whole leaf can be freed; the rest copied whole (every ``"data"``
    rank holds the same shards)."""
    tp = tp_size(mesh)
    part = shard_params(tree, mesh.coord(MODEL_AXIS) if tp > 1 else 0, tp,
                        rules)
    return tree_map(torch.clone, part)


def gather_params(tree: Mapping, mesh, rules=TRANSFORMER_TP_RULES,
                  _path: str = "") -> dict:
    """The whole tree from every ``"model"`` rank's shards of ``tree``
    (tensors), concatenated in rank order along each rule's dim: the
    inverse of :func:`shard_params`.  Every rank of the ``"model"`` group
    calls it (it all-gathers) and gets the whole tree."""
    tp = tp_size(mesh)
    out = {}
    for k, v in tree.items():
        path = f"{_path}/{k}" if _path else str(k)
        if isinstance(v, Mapping):
            out[k] = gather_params(v, mesh, rules, path)
            continue
        dim = shard_dim(path, rules) if tp > 1 and v.ndim else None
        v = v.detach()
        out[k] = v.clone() if dim is None else all_gather(v, mesh, dim)
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
