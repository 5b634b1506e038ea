"""The decoder-only LM the trainer runs: the port of
``kubegpu_tpu/models/transformer.py`` at one device, over a
``("data", "model")`` mesh, over a ``("data", "seq")`` mesh and over a
``("data", "model", "seq")`` mesh.

``TransformerLM`` has the flax model's parameter tree (the tree
``models/params.py`` describes, shared with the decode models) and its
numerics: it reuses the decode models' ``Dense``, ``LayerNorm`` and
``Embed`` (flax's dtype promotion, float32 LayerNorm statistics, tanh
GELU) and returns float32 logits ``(b, s, vocab)``.

Attention is one of two paths, as in JAX:

- ``attn_impl="einsum"``: scores in the model dtype divided by
  ``sqrt(hd)`` rounded to that dtype, a ``finfo.min`` causal mask, a
  float32 softmax cast back (the decode models' math);
- ``attn_impl="flash"``: :func:`~kubegpu_tpu_torch.ops.attention.flash_attention`,
  which on the card runs the hand-written kernels K3 forward and K4, K5
  backward; scores in float32 times ``1/sqrt(hd)`` and a -inf mask.

The two differ in the last bits, as they do in JAX.  ``"ring"`` and
``"ulysses"`` are context-parallel attention over a ``"seq"`` mesh axis;
without one they run flash, as the JAX model does.
``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``), the counterpart of ``nn.remat(Block)``.

Over a mesh (``mesh=``, a ``parallel.mesh.Mesh`` whose ``"model"`` axis
is tp wide) every rank holds its Megatron shard of the tree
(``parallel.sharding.shard_state``) and runs this rank's ``heads / tp``
heads, with column-parallel q/k/v and ``mlp_up`` and row-parallel
``o_proj`` and ``mlp_down``; the collectives GSPMD inserts for the JAX
model are written out as autograd functions
(``parallel/collectives.py``):

- the embeddings hold ``hidden / tp`` columns: look up, then
  ``gather_hidden`` (exact);
- with ``sequence_parallel=True`` (the JAX worker's setting) the
  residual stream and the LayerNorms between blocks live on this rank's
  ``s / tp`` rows (JAX's ``constrain_seq_sharded``): a block gathers the
  normed rows (``gather_seq``), runs the column-parallel matmul, the
  attention or the MLP and the row-parallel matmul on the whole
  sequence, and reduce-scatters the partial sums back onto its rows
  (``scatter_seq``).  Without it the stream is replicated and Megatron's
  *f* and *g* (``copy_to_model``, ``reduce_from_model``) surround the
  pair of matmuls;
- the head is vocab-parallel: ``forward`` returns this rank's float32
  logits ``(b, s, vocab / tp)``, which ``train.cross_entropy`` reduces
  without gathering them.

The LayerNorm parameters are replicated; under sequence parallelism each
rank's gradient covers its rows only and ``train.lm_step`` sums them.
At one device ``sequence_parallel`` does nothing, in JAX as here.

With ``context_parallel=True`` over a mesh with a ``"seq"`` axis of cp
ranks (the JAX ``constrain_ctx_sharded`` layout) every parameter is
whole on every rank, and ``forward`` takes this rank's ``s / cp``
consecutive token rows (``train.lm_loss`` cuts them): they are embedded
at their global positions (``my * s / cp`` on), and the LayerNorms, the
MLPs, ``ln_f`` and the head run on them alone; nothing gathers the
sequence between blocks.  Attention crosses the ranks:
``attn_impl="ring"`` and ``"ulysses"`` run ``ops.attention``'s
``ring_attention`` and ``ulysses_attention``; ``"einsum"`` computes the
full attention GSPMD computes for the JAX model, this rank's query rows
against K/V gathered over ``"seq"`` (``gather_axis``, reduce-scattered
backward) under the causal mask offset by ``my * s / cp``.  ``"flash"``
is refused there (the worker turns it into ``"ring"``, as the JAX
worker does).

Over a mesh with both ``"model"`` and ``"seq"`` (JAX's DP x TP x CP,
``context_parallel=True``) the two compose.  Every rank holds its
Megatron shard of the tree (whole over ``"seq"``) and its ``s / cp``
rows; the residual stream is ``(data, seq)``-sharded and replicated over
``"model"`` (JAX's ``constrain_ctx_sharded``; ``sequence_parallel``
changes nothing, as in JAX, whose ``Block`` checks ``context_parallel``
first), so *f* and *g* surround each pair of matmuls.  The attention
follows the JAX rule (:func:`cp_heads_sharded`): where ``heads % tp ==
0`` (and, for Ulysses, ``(heads / tp) % cp == 0``) each rank runs the CP
attention on its own ``heads / tp`` heads; otherwise the heads are
replicated over ``"model"``: q, k and v are gathered over ``"model"``
along their columns (``gather_axis``, reduce-scattered backward), the CP
attention runs on every head, and the rank keeps its ``hidden / tp``
columns of the result for the row-parallel ``o_proj`` (a column shard,
not whole heads: 2 heads over tp 4 put half a head on a rank).  The head
stays vocab-parallel; ``train.lm_loss`` reduces its logits over
``"model"`` and averages over ``"data"`` x ``"seq"``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubegpu_tpu_torch.models.decoding import (
    Dense,
    LayerNorm,
    LMBase,
    attn_scale,
)
from kubegpu_tpu_torch.ops.attention import (
    flash_attention,
    ring_attention,
    ulysses_attention,
)
from kubegpu_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_axis,
    gather_hidden,
    gather_seq,
    reduce_from_model,
    scatter_seq,
    split_seq,
)
from kubegpu_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    SEQ_AXIS,
    cp_size,
    tp_size,
)

ATTN_IMPLS = ("einsum", "flash", "ring", "ulysses")
# context-parallel attention; without a "seq" axis it runs flash
CP_IMPLS = ("ring", "ulysses")


def check_attn_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: one of {ATTN_IMPLS}")


def cp_heads_sharded(num_heads: int, tp: int, cp: int,
                     attn_impl: str) -> bool:
    """Whether heads stay sharded over ``"model"`` through the attention
    of a TP x CP mesh (``kubegpu_tpu/models/transformer.py:71-83``): the
    heads must divide by tp and, for Ulysses' head scatter, this rank's
    ``heads / tp`` by cp.  Otherwise they are replicated over
    ``"model"``."""
    return num_heads % tp == 0 and (
        attn_impl != "ulysses" or (num_heads // tp) % cp == 0)


class CausalSelfAttention(nn.Module):
    """This rank's ``num_heads / tp`` heads (all of them at ``tp`` 1):
    column-parallel q/k/v, and ``o_proj``'s partial product, which the
    block sums over the ``"model"`` ranks.  With ``heads_mesh`` set (TP
    x CP with heads replicated over ``"model"``) it gathers q, k and v's
    columns over ``"model"``, attends on every head and keeps this
    rank's columns of the result."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 attn_impl: str = "einsum", tp: int = 1) -> None:
        super().__init__()
        check_attn_impl(attn_impl)
        self.head_dim = hidden // num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        # the mesh with a "seq" axis under context parallelism, else None
        self.cp_mesh = None
        # the mesh whose "model" ranks replicate the heads, else None
        self.heads_mesh = None
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, Dense(hidden, hidden // tp, dtype))
        self.o_proj = Dense(hidden // tp, hidden, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        whole = self.heads_mesh
        if whole is not None:
            q, k, v = (gather_axis(t, whole, MODEL_AXIS, dim=-1)
                       for t in (q, k, v))
        hd = self.head_dim
        h = q.shape[-1] // hd
        out = self._attend(*(t.view(b, s, h, hd) for t in (q, k, v)))
        out = out.reshape(b, s, h * hd)
        if whole is not None:
            cols = out.shape[-1] // tp_size(whole)
            out = out.narrow(-1, whole.coord(MODEL_AXIS) * cols, cols)
        return self.o_proj(out)

    def _attend(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        s, hd = q.shape[1], self.head_dim
        mesh = self.cp_mesh
        if mesh is not None and self.attn_impl == "ring":
            out = ring_attention(q, k, v, mesh, True)
        elif mesh is not None and self.attn_impl == "ulysses":
            out = ulysses_attention(q, k, v, mesh, True)
        elif self.attn_impl in ("flash",) + CP_IMPLS:
            out = flash_attention(q, k, v, True)
        else:
            offset = 0
            if mesh is not None:
                # this rank's query rows against the whole sequence's K/V
                offset = mesh.coord(SEQ_AXIS) * s
                k, v = gather_axis(k, mesh), gather_axis(v, mesh)
            dev = q.device
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / attn_scale(
                hd, self.dtype, dev)
            mask = (torch.arange(k.shape[1], device=dev)[None, :]
                    <= offset + torch.arange(s, device=dev)[:, None])
            scores = torch.where(mask, scores, torch.finfo(self.dtype).min)
            probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return out


class Block(nn.Module):
    """flax ``Block``: pre-norm attention and a 4x tanh-GELU MLP, each
    added to the residual stream; over a mesh, this rank's shard of both
    (the module docstring)."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 quant: bool = False, mesh=None) -> None:
        super().__init__()
        if quant:
            raise ValueError("training runs float weights: no int8 Dense")
        tp = tp_size(mesh)
        self.mesh = mesh if tp > 1 else None
        self.sequence_parallel = False
        self.ln1 = LayerNorm(hidden, dtype)
        self.attn = CausalSelfAttention(hidden, num_heads, dtype, tp=tp)
        self.ln2 = LayerNorm(hidden, dtype)
        self.mlp_up = Dense(hidden, 4 * hidden // tp, dtype)
        self.mlp_down = Dense(4 * hidden // tp, hidden, dtype)

    def _enter(self, y: torch.Tensor) -> torch.Tensor:
        """Into a column-parallel matmul: the whole sequence, its
        gradient summed over the ``"model"`` ranks."""
        if self.mesh is None:
            return y
        if self.sequence_parallel:
            return gather_seq(y, self.mesh)
        return copy_to_model(y, self.mesh)

    def _leave(self, y: torch.Tensor) -> torch.Tensor:
        """Out of a row-parallel matmul: the sum of the ranks' partial
        products (this rank's rows of it under sequence parallelism)."""
        if self.mesh is None:
            return y
        if self.sequence_parallel:
            return scatter_seq(y, self.mesh)
        return reduce_from_model(y, self.mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._leave(self.attn(self._enter(self.ln1(x))))
        # flax nn.gelu is the tanh approximation
        y = F.gelu(self.mlp_up(self._enter(self.ln2(x))), approximate="tanh")
        return x + self._leave(self.mlp_down(y))


class TransformerLM(LMBase):
    """flax ``TransformerLM``: ``forward(tokens)`` with tokens ``(b, s)``,
    ``s <= max_seq``, returns float32 logits ``(b, s, vocab)``, or over
    a mesh with a ``"model"`` axis this rank's ``(b, s, vocab / tp)``
    (under sequence parallelism ``s`` must divide by tp).  Context
    parallel over a ``"seq"`` axis, ``tokens`` are this rank's
    ``(b, s / cp)`` rows and the logits theirs (with a ``"model"`` axis
    too, their ``vocab / tp`` columns)."""

    block_cls = Block

    def __init__(self, *, vocab_size: int = 32000, num_layers: int = 4,
                 num_heads: int = 8, hidden: int = 512, max_seq: int = 2048,
                 dtype: torch.dtype = torch.bfloat16,
                 sequence_parallel: bool = False, attn_impl: str = "einsum",
                 remat: bool = False, context_parallel: bool = False,
                 mesh=None) -> None:
        check_attn_impl(attn_impl)
        tp = tp_size(mesh)
        # context parallel over the mesh: s / cp rows a rank throughout
        cp_mesh = None
        heads_sharded = True
        if mesh is not None and SEQ_AXIS in mesh.axis_names:
            if not context_parallel:
                raise ValueError("a mesh with a 'seq' axis trains the "
                                 "context-parallel model: "
                                 "context_parallel=True")
            if attn_impl == "flash":
                raise ValueError(
                    "attn_impl='flash' over a 'seq' axis: context-parallel "
                    "attention is 'ring', 'ulysses' or 'einsum' (the "
                    "worker runs --attn-impl flash as ring)")
            cp_mesh = mesh
            heads_sharded = tp == 1 or cp_heads_sharded(
                num_heads, tp, cp_size(mesh), attn_impl)
        for what, n in (("num_heads", num_heads if heads_sharded else 0),
                        ("vocab_size", vocab_size), ("hidden", hidden)):
            if n % tp:
                raise ValueError(f"{what} {n} does not divide over tp={tp}")
        super().__init__(vocab_size=vocab_size, num_layers=num_layers,
                         num_heads=num_heads, hidden=hidden, max_seq=max_seq,
                         dtype=dtype, mesh=mesh)
        self.sequence_parallel = sequence_parallel
        self.attn_impl = attn_impl
        self.remat = remat
        self.tp = tp
        self.cp_mesh = cp_mesh
        # the residual stream lives on s / tp rows a rank (under context
        # parallelism it lives on the "seq" rows instead, as in JAX)
        self.seq_sharded = sequence_parallel and tp > 1 and cp_mesh is None
        for block in self.blocks():
            block.attn.attn_impl = attn_impl
            block.attn.cp_mesh = cp_mesh
            block.attn.heads_mesh = None if heads_sharded else mesh
            block.sequence_parallel = self.seq_sharded

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        s = tokens.shape[1]
        if self.seq_sharded and s % self.tp:
            raise ValueError(f"sequence parallelism: {s} positions do not "
                             f"divide over tp={self.tp}")
        # this rank's rows sit at their global positions
        first = (0 if self.cp_mesh is None
                 else self.cp_mesh.coord(SEQ_AXIS) * s)
        x = self.embed(tokens) + self.pos_embed(
            torch.arange(first, first + s, device=tokens.device)[None, :])
        if self.tp > 1:
            x = gather_hidden(x, self.mesh)
        if self.seq_sharded:
            x = split_seq(x, self.mesh)
        for block in self.blocks():
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_f(x)
        if self.seq_sharded:
            x = gather_seq(x, self.mesh)
        elif self.tp > 1:
            x = copy_to_model(x, self.mesh)
        return self.lm_head(x)
