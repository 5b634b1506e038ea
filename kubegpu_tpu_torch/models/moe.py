"""The Mixture-of-Experts transformer: the port of
``kubegpu_tpu/models/moe.py`` (``MoEMLP``, ``MoeBlock``,
``MoeTransformerLM``, ``moe_router_stats``) at one device and over a
``("data", "expert"[, "model"])`` mesh.

The tree is flax's: ``layer{i}/{ln1,attn,ln2}`` as in
``TransformerLM``, ``layer{i}/moe_mlp/router/kernel`` ``(d, e)`` and the
stacked float32 expert kernels ``layer{i}/moe_mlp/w_up`` ``(e, d, h)``
and ``w_down`` ``(e, h, d)``, then ``embed``, ``pos_embed``, ``ln_f`` and
``lm_head``.  Attention, LayerNorm, Embed and Dense are the LM's own.

Routing is GShard's grouped, static-capacity routing, and its arithmetic
is carried over as the JAX module does it (the fp32 parity hangs on it):

- each batch row is a routing group of ``s`` tokens, and every expert
  takes ``capacity = min(s, int(math.ceil(s * capacity_factor / e)))``
  slots of it;
- the router is a float32 Dense on ``x`` in float32, then a softmax;
- ``top1`` (Switch): the first argmax; slot positions from an integer
  cumsum along the row; a token is kept when ``0 < position <=
  capacity``; the Switch aux loss ``e * sum(density * density_proxy)``;
- ``top2`` (GShard): the second choice is the argmax of ``gates * (1 -
  m1)``, both gates renormalised with ``+ 1e-9``; second choices take
  slots after the expert's first-choice count; a token is dropped when
  no choice survives; the aux loss judges first choices;
- ``expert_choice``: each expert takes its top ``capacity`` tokens of
  the row, the lower index first among equal gates (a stable descending
  sort: ``jax.lax.top_k``'s order; ``torch.topk`` promises none); the
  aux is 1; it always takes the dense path;
- ``density``, ``density_proxy`` and the drop rate are means over the
  whole batch: over ``"data"`` their sums are added up (:func:`psum`)
  before the product.

``dispatch_impl="einsum"`` moves tokens with one-hot ``(b, s, e, c)``
dispatch and combine tensors; ``"gather"`` with index form (each slot's
token gathered into expert order; each token's k expert outputs
gathered back and weighted in float32).  ``fast_dispatch`` (the default)
takes both dense einsums' operands in the model dtype with float32
results, the combine's rounded once to the model dtype at the end; the
dispatch is exact in the model dtype (one token a slot), so it runs
there.  ``fast_dispatch=False`` runs both in float32.  The experts cast
``w_up``/``w_down`` to the model dtype on every call and use flax's tanh
GELU.

Expert parallelism, as the JAX package lays it out: the batch shards
over ``"data"`` only, so every rank along ``"expert"`` holds the same
token rows and runs the same attention and router; each runs its ``e /
ep`` experts (its slice of ``w_up``/``w_down``) on their slots, and the
combine's contraction over the experts is a sum over ``"expert"``
(``reduce_from_model(..., axis="expert")``).  No all-to-all.  Backward,
the gradients that reach the tokens and the combine's gates through the
local experts are partial, so ``copy_to_model(..., axis="expert")``
sums them over ``"expert"`` once; the gates the aux loss reads are
whole on every rank and are not summed, so the replicated parameters
end the backward equal along ``"expert"``.  Under EP x TP each expert's
FFN is also Megatron-sharded over ``"model"`` (column-parallel ``w_up``,
row-parallel ``w_down``, one sum per expert MLP), and the attention,
embeddings and head are the LM's tensor-parallel layers without
sequence parallelism (*f* and *g* around each pair of matmuls; the
vocab-parallel head).

``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``); a block returns its aux loss and drop rate
beside its output, so the recompute never counts them twice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubegpu_tpu_torch.models.decoding import Dense, Embed, LayerNorm
from kubegpu_tpu_torch.models.params import meta_param
from kubegpu_tpu_torch.models.transformer import (
    CausalSelfAttention,
    check_attn_impl,
)
from kubegpu_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_hidden,
    psum,
    reduce_from_model,
)
from kubegpu_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    ep_size,
    tp_size,
)
from kubegpu_tpu_torch.parallel.sharding import MOE_EP_RULES, MOE_EP_TP_RULES

ROUTERS = ("top1", "top2", "expert_choice")
DISPATCH_IMPLS = ("einsum", "gather")
MESH_AXES = (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS)


def capacity_of(s: int, num_experts: int, capacity_factor: float) -> int:
    """Each expert's slots in a routing group (one batch row) of ``s``
    tokens: the JAX module's expression, as it is."""
    return min(s, int(math.ceil(s * capacity_factor / num_experts)))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of integer ``idx`` over ``n`` classes."""
    out = torch.zeros(idx.shape + (n,), dtype=torch.float32,
                      device=idx.device)
    return out.scatter_(-1, idx[..., None], 1.0)


def _positions(m: torch.Tensor) -> torch.Tensor:
    """1-based position of each routed token in its expert's slots along
    the row (an integer cumsum: float32 would merge slots past 2^24),
    0 where the token does not go to that expert."""
    im = m.to(torch.int64)
    return torch.cumsum(im, dim=1) * im


def _kept(pos: torch.Tensor, capacity: int) -> torch.Tensor:
    return ((pos > 0) & (pos <= capacity)).to(torch.float32)


class MoEMLP(nn.Module):
    """flax ``MoEMLP``: ``forward(x)`` with ``x`` ``(b, s, d)`` returns
    ``(out, aux_loss, drop_rate)``, ``out`` in ``x``'s dtype and the two
    float32 scalars the JAX module sows.  Over a mesh this rank holds
    ``e / ep`` experts (and ``h / tp`` of each one's hidden units)."""

    def __init__(self, hidden: int, num_experts: int,
                 capacity_factor: float = 2.0, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16,
                 router_type: str = "top1", fast_dispatch: bool = True,
                 dispatch_impl: str = "einsum", mesh=None) -> None:
        super().__init__()
        if router_type not in ROUTERS:
            raise ValueError(f"unknown router_type {router_type!r}; "
                             "expected top1 | top2 | expert_choice")
        if dispatch_impl not in DISPATCH_IMPLS:
            raise ValueError(f"unknown dispatch_impl {dispatch_impl!r}; "
                             "expected einsum | gather")
        ep, tp = ep_size(mesh), tp_size(mesh)
        h = hidden * mlp_ratio
        if num_experts % ep:
            raise ValueError(f"num_experts {num_experts} does not divide "
                             f"over ep={ep}")
        if h % tp:
            raise ValueError(f"the expert hidden {h} does not divide over "
                             f"tp={tp}")
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router_type = router_type
        self.fast_dispatch = fast_dispatch
        self.dispatch_impl = dispatch_impl
        self.mesh = mesh
        self.ep, self.tp = ep, tp
        self.local_experts = num_experts // ep
        self.router = Dense(hidden, num_experts, torch.float32)
        self.w_up = meta_param(self.local_experts, hidden, h // tp)
        self.w_down = meta_param(self.local_experts, h // tp, hidden)

    # -- the routing decisions ------------------------------------------

    def _stats(self, density_sum, proxy_sum, covered_sum, rows: int):
        """``(aux, drop)`` from this rank's sums over its ``rows`` tokens:
        the whole batch's means, the sums added over ``"data"`` first."""
        e = self.num_experts
        parts = [covered_sum.reshape(1)]
        if proxy_sum is not None:
            parts = [density_sum, proxy_sum] + parts
        sums = torch.cat(parts)
        n = rows
        if self.mesh is not None:
            sums = psum(sums, self.mesh, DATA_AXIS)
            n = rows * self.mesh.axis_size(DATA_AXIS)
        drop = 1.0 - sums[-1].detach() / n
        if proxy_sum is None:
            return None, drop
        aux = e * torch.sum((sums[:e] / n) * (sums[e:2 * e] / n))
        return aux, drop

    def _top1(self, gates, gates_c, capacity):
        """Per token: expert, 1-based position, gate, kept; the aux loss
        and the drop rate."""
        b, s, e = gates.shape
        idx = torch.argmax(gates, dim=-1)
        mask = _one_hot(idx, e)
        gate = torch.sum(gates_c * mask, dim=-1)
        pos = _positions(mask)
        keep = _kept(pos, capacity)
        aux, drop = self._stats(mask.sum((0, 1)), gates.sum((0, 1)),
                                keep.sum(), b * s)
        return [(idx, mask, gate, pos, keep)], aux, drop

    def _top2(self, gates, gates_c, capacity):
        b, s, e = gates.shape
        idx1 = torch.argmax(gates, dim=-1)
        m1 = _one_hot(idx1, e)
        idx2 = torch.argmax(gates * (1.0 - m1), dim=-1)
        m2 = _one_hot(idx2, e)
        g1 = torch.sum(gates_c * m1, dim=-1)
        g2 = torch.sum(gates_c * m2, dim=-1)
        denom = g1 + g2 + 1e-9
        g1, g2 = g1 / denom, g2 / denom
        pos1 = _positions(m1)
        used1 = m1.to(torch.int64).sum(1)                        # [b, e]
        pos2 = (torch.cumsum(m2.to(torch.int64), dim=1)
                + used1[:, None, :]) * m2.to(torch.int64)
        keep1, keep2 = _kept(pos1, capacity), _kept(pos2, capacity)
        covered = torch.clamp(keep1.sum(-1) + keep2.sum(-1), 0.0, 1.0)
        aux, drop = self._stats(m1.sum((0, 1)), gates.sum((0, 1)),
                                covered.sum(), b * s)
        return ([(idx1, m1, g1, pos1, keep1), (idx2, m2, g2, pos2, keep2)],
                aux, drop)

    def _expert_choice(self, gates, gates_c, capacity):
        """Dense ``(dispatch, combine)`` of each expert's top ``capacity``
        tokens of the row (lower index first among equal gates)."""
        b, s, e = gates.shape
        order = torch.sort(gates.transpose(1, 2), dim=-1, descending=True,
                           stable=True).indices
        idx = order[..., :capacity]                              # [b, e, c]
        vals = torch.gather(gates_c.transpose(1, 2), -1, idx)
        dispatch = _one_hot(idx, s).permute(0, 3, 1, 2)          # [b, s, e, c]
        combine = dispatch * vals[:, None, :, :]
        covered = torch.clamp(dispatch.sum((2, 3)), 0.0, 1.0)
        _, drop = self._stats(None, None, covered.sum(), b * s)
        return dispatch, combine, torch.ones((), device=gates.device), drop

    # -- moving the tokens ---------------------------------------------

    def _local(self) -> int:
        """The first expert this rank holds."""
        if self.mesh is None:
            return 0
        return self.mesh.coord(EXPERT_AXIS) * self.local_experts

    def _to_experts(self, t: torch.Tensor) -> torch.Tensor:
        """A replicated tensor entering this rank's experts: its
        gradient is summed over ``"expert"`` (each rank's is partial)."""
        return t if self.ep == 1 else copy_to_model(t, self.mesh, EXPERT_AXIS)

    def _from_experts(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's experts' part of the combine, summed over
        ``"expert"``."""
        return t if self.ep == 1 else reduce_from_model(t, self.mesh,
                                                        EXPERT_AXIS)

    def _experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """``(b, e / ep, c, d)`` in the model dtype -> the experts'
        outputs; over ``"model"`` this rank's ``h / tp`` hidden units,
        then one sum."""
        if self.tp > 1:
            expert_in = copy_to_model(expert_in, self.mesh)
        mid = F.gelu(torch.einsum("becd,edh->bech", expert_in,
                                  self.w_up.to(self.dtype)),
                     approximate="tanh")
        out = torch.einsum("bech,ehd->becd", mid, self.w_down.to(self.dtype))
        if self.tp > 1:
            out = reduce_from_model(out, self.mesh)
        return out

    def _dense(self, x, x_c, dispatch, combine):
        lo, n = self._local(), self.local_experts
        dispatch = dispatch[:, :, lo:lo + n]
        combine = combine[:, :, lo:lo + n]
        if self.fast_dispatch:
            # one token a slot: the model-dtype product is the float32
            # result rounded to the model dtype, which the experts take
            expert_in = torch.einsum("bsec,bsd->becd",
                                     dispatch.to(self.dtype),
                                     x_c.to(self.dtype))
        else:
            expert_in = torch.einsum("bsec,bsd->becd", dispatch, x_c.float())
        expert_out = self._experts(expert_in.to(self.dtype))
        # model-dtype operands, float32 sums, rounded once at the end
        weights = (combine.to(self.dtype).float() if self.fast_dispatch
                   else combine)
        out = torch.einsum("bsec,becd->bsd", weights, expert_out.float())
        return self._from_experts(out).to(x.dtype)

    def _gather(self, x, x_c, choices, capacity):
        """Index-form dispatch and combine over ``choices`` (one
        ``(idx, mask, gate, pos, keep)`` per routing choice)."""
        b, s, d = x.shape
        c, lo, n = capacity, self._local(), self.local_experts
        comp = self.dtype if self.fast_dispatch else torch.float32
        e_idx = torch.stack([ch[0] for ch in choices], -1)       # [b, s, k]
        slot = torch.stack(
            [torch.sum(torch.clamp(ch[3] - 1, min=0)
                       * ch[1].to(torch.int64), -1) for ch in choices], -1)
        gate = torch.stack([ch[2] for ch in choices], -1)
        keep = torch.stack([torch.sum(ch[4] * ch[1], -1) for ch in choices],
                           -1)
        k = e_idx.shape[-1]
        mine = (e_idx >= lo) & (e_idx < lo + n)
        le = torch.clamp(e_idx - lo, 0, n - 1)
        # dropped choices, and other ranks' experts, write to slot c: a
        # column past the slots, cut off (the JAX scatter's mode="drop")
        slot_w = torch.where((keep > 0) & mine, slot,
                             torch.full_like(slot, c))
        target = (le * (c + 1) + slot_w).reshape(b, s * k)
        tok = torch.arange(s, device=x.device).repeat_interleave(k)
        tok = tok.expand(b, s * k)
        src = torch.zeros((b, n * (c + 1)), dtype=torch.int64,
                          device=x.device).scatter(1, target, tok)
        filled = torch.zeros((b, n * (c + 1)), dtype=comp,
                             device=x.device).scatter(
            1, target, torch.ones((b, s * k), dtype=comp, device=x.device))
        src = src.view(b, n, c + 1)[:, :, :c].reshape(b, n * c)
        filled = filled.view(b, n, c + 1)[:, :, :c]
        expert_in = torch.gather(
            x_c.to(comp), 1, src[:, :, None].expand(b, n * c, d)
        ).view(b, n, c, d) * filled[..., None]
        expert_out = self._experts(expert_in.to(self.dtype))
        flat = expert_out.to(comp).reshape(b, n * c, d)
        pick = (le * c + torch.clamp(slot, max=c - 1)).reshape(b, s * k)
        picked = torch.gather(flat, 1, pick[:, :, None].expand(b, s * k, d))
        w = (gate * keep * mine).to(torch.float32)[..., None]
        out = torch.sum(picked.view(b, s, k, d).float() * w, dim=2)
        return self._from_experts(out).to(x.dtype)

    def _gates(self, x: torch.Tensor) -> torch.Tensor:
        """The router's ``(b, s, e)`` softmax, in float32: argmax and
        softmax must not lose ties to bf16, and the aux loss needs
        accurate densities."""
        return torch.softmax(self.router(x.float()), dim=-1)

    def forward(self, x: torch.Tensor):
        b, s, d = x.shape
        capacity = capacity_of(s, self.num_experts, self.capacity_factor)
        gates = self._gates(x)                                   # [b, s, e]
        gates_c = self._to_experts(gates)
        x_c = self._to_experts(x)
        if self.router_type == "expert_choice":
            dispatch, combine, aux, drop = self._expert_choice(
                gates, gates_c, capacity)
            return self._dense(x, x_c, dispatch, combine), aux, drop
        route = self._top1 if self.router_type == "top1" else self._top2
        choices, aux, drop = route(gates, gates_c, capacity)
        if self.dispatch_impl == "gather":
            return self._gather(x, x_c, choices, capacity), aux, drop
        dispatch = combine = 0.0
        for _, _, gate, pos, keep in choices:
            # a slot past capacity is not kept: any column will do
            one = keep[..., None] * _one_hot(
                torch.clamp(pos - 1, 0, capacity - 1), capacity)
            dispatch = dispatch + one
            combine = combine + one * gate[..., None, None]
        return self._dense(x, x_c, dispatch, combine), aux, drop


class MoeBlock(nn.Module):
    """flax ``MoeBlock``: pre-norm attention, then the MoE MLP, each added
    to the residual stream; returns ``(x, aux_loss, drop_rate)``.  Over a
    ``"model"`` axis the attention is this rank's heads between *f* and
    *g*."""

    def __init__(self, hidden: int, num_heads: int, num_experts: int, *,
                 capacity_factor: float = 2.0, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "einsum", router_type: str = "top1",
                 fast_dispatch: bool = True, dispatch_impl: str = "einsum",
                 mesh=None) -> None:
        super().__init__()
        tp = tp_size(mesh)
        self.tp_mesh = mesh if tp > 1 else None
        self.ln1 = LayerNorm(hidden, dtype)
        self.attn = CausalSelfAttention(hidden, num_heads, dtype, attn_impl,
                                        tp=tp)
        self.ln2 = LayerNorm(hidden, dtype)
        self.moe_mlp = MoEMLP(hidden, num_experts,
                              capacity_factor=capacity_factor,
                              mlp_ratio=mlp_ratio, dtype=dtype,
                              router_type=router_type,
                              fast_dispatch=fast_dispatch,
                              dispatch_impl=dispatch_impl, mesh=mesh)

    def forward(self, x: torch.Tensor):
        y = self.ln1(x)
        if self.tp_mesh is None:
            x = x + self.attn(y)
        else:
            x = x + reduce_from_model(
                self.attn(copy_to_model(y, self.tp_mesh)), self.tp_mesh)
        out, aux, drop = self.moe_mlp(self.ln2(x))
        return x + out, aux, drop


class MoeTransformerLM(nn.Module):
    """flax ``MoeTransformerLM``: ``forward(tokens)`` with tokens ``(b,
    s)`` returns float32 logits ``(b, s, vocab)`` (over a ``"model"``
    axis this rank's ``(b, s, vocab / tp)``); :meth:`apply` also returns
    each layer's aux loss and drop rate, the JAX model's sown
    ``intermediates``.  ``mesh``: a ``("data", "expert"[, "model"])``
    mesh, every rank holding its shard of the tree by
    :attr:`shard_rules`."""

    def __init__(self, *, vocab_size: int = 32000, num_layers: int = 4,
                 num_heads: int = 8, hidden: int = 512, num_experts: int = 8,
                 capacity_factor: float = 2.0, max_seq: int = 2048,
                 dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "einsum", router_type: str = "top1",
                 fast_dispatch: bool = True, dispatch_impl: str = "einsum",
                 remat: bool = False, mlp_ratio: int = 4, mesh=None) -> None:
        super().__init__()
        check_attn_impl(attn_impl)
        if mesh is not None and set(mesh.axis_names) - set(MESH_AXES):
            raise ValueError(f"a mesh of {tuple(mesh.axis_names)}: the MoE "
                             f"transformer trains over {MESH_AXES}")
        tp = tp_size(mesh)
        for what, n in (("num_heads", num_heads), ("vocab_size", vocab_size),
                        ("hidden", hidden)):
            if n % tp:
                raise ValueError(f"{what} {n} does not divide over tp={tp}")
        self.mesh = mesh
        self.tp = tp
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.num_heads, self.hidden, self.max_seq = num_heads, hidden, max_seq
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.mlp_ratio = mlp_ratio
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.router_type = router_type
        self.fast_dispatch = fast_dispatch
        self.dispatch_impl = dispatch_impl
        self.remat = remat
        self.embed = Embed(vocab_size, hidden // tp, dtype)
        self.pos_embed = Embed(max_seq, hidden // tp, dtype)
        for i in range(num_layers):
            setattr(self, f"layer{i}", MoeBlock(
                hidden, num_heads, num_experts,
                capacity_factor=capacity_factor, mlp_ratio=mlp_ratio,
                dtype=dtype, attn_impl=attn_impl, router_type=router_type,
                fast_dispatch=fast_dispatch, dispatch_impl=dispatch_impl,
                mesh=mesh))
        self.ln_f = LayerNorm(hidden, dtype)
        self.lm_head = Dense(hidden, vocab_size // tp, torch.float32)

    @property
    def shard_rules(self) -> tuple:
        """``MOE_EP_TP_RULES`` over a ``"model"`` axis, else
        ``MOE_EP_RULES`` (the JAX ``place_moe``'s choice)."""
        return MOE_EP_TP_RULES if self.tp > 1 else MOE_EP_RULES

    def dims(self) -> Dict[str, object]:
        """What a checkpoint records of the model."""
        return dict(family="moe", vocab_size=self.vocab_size,
                    num_layers=self.num_layers, num_heads=self.num_heads,
                    hidden=self.hidden, max_seq=self.max_seq,
                    num_experts=self.num_experts,
                    capacity_factor=self.capacity_factor,
                    mlp_ratio=self.mlp_ratio, router_type=self.router_type,
                    dispatch_impl=self.dispatch_impl)

    def blocks(self) -> List[MoeBlock]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def apply(self, tokens: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, List[torch.Tensor]]]:
        """``(logits, {"aux_loss": [...], "drop_rate": [...]})``, one
        scalar of each a layer."""
        s = tokens.shape[1]
        x = self.embed(tokens) + self.pos_embed(
            torch.arange(s, device=tokens.device)[None, :])
        if self.tp > 1:
            x = gather_hidden(x, self.mesh)
        sown: Dict[str, List[torch.Tensor]] = {"aux_loss": [],
                                               "drop_rate": []}
        for block in self.blocks():
            if self.remat and torch.is_grad_enabled():
                x, aux, drop = checkpoint(block, x, use_reentrant=False)
            else:
                x, aux, drop = block(x)
            sown["aux_loss"].append(aux)
            sown["drop_rate"].append(drop)
        x = self.ln_f(x)
        if self.tp > 1:
            x = copy_to_model(x, self.mesh)
        return self.lm_head(x), sown

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.apply(tokens)[0]


def layer_mean(values: List[torch.Tensor]) -> torch.Tensor:
    """The mean over layers of one sown scalar a layer, summed in layer
    order as the JAX package sums them (0 without a layer)."""
    if not values:
        return torch.zeros(())
    return sum(values) / len(values)


def moe_router_stats(model: MoeTransformerLM, tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(aux_loss, drop_rate)``, each the mean over layers, from one
    forward of ``tokens`` without gradients: the routing health metrics
    (a capacity factor too low for the token distribution shows as a
    rising drop rate before the loss moves)."""
    with torch.no_grad():
        _, sown = model.apply(tokens)
    return layer_mean(sown["aux_loss"]), layer_mean(sown["drop_rate"])
