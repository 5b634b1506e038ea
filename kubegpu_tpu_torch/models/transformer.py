"""The decoder-only LM the trainer runs: the port of
``kubegpu_tpu/models/transformer.py`` at one device and over a
``("data", "model")`` mesh.

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
``"ulysses"`` (context parallelism) wait for the long-context slice.
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
from kubegpu_tpu_torch.ops.attention import flash_attention
from kubegpu_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_hidden,
    gather_seq,
    reduce_from_model,
    scatter_seq,
    split_seq,
)
from kubegpu_tpu_torch.parallel.mesh import tp_size

ATTN_IMPLS = ("einsum", "flash")


def check_attn_impl(attn_impl: str) -> None:
    if attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} is context-parallel attention over a "
            "sequence mesh axis: it arrives with the long-context slice of "
            "the port; use 'flash' or 'einsum'")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: one of {ATTN_IMPLS}")


class CausalSelfAttention(nn.Module):
    """This rank's ``num_heads / tp`` heads (all of them at ``tp`` 1):
    column-parallel q/k/v, and ``o_proj``'s partial product, which the
    block sums over the ``"model"`` ranks."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 attn_impl: str = "einsum", tp: int = 1) -> None:
        super().__init__()
        check_attn_impl(attn_impl)
        self.num_heads = num_heads // tp
        self.head_dim = hidden // num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        for name in ("q_proj", "k_proj", "v_proj"):
            setattr(self, name, Dense(hidden, hidden // tp, dtype))
        self.o_proj = Dense(hidden // tp, hidden, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        q = self.q_proj(x).view(b, s, h, hd)
        k = self.k_proj(x).view(b, s, h, hd)
        v = self.v_proj(x).view(b, s, h, hd)
        if self.attn_impl == "flash":
            out = flash_attention(q, k, v, True)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / attn_scale(
                hd, self.dtype, x.device)
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=x.device).tril()
            scores = torch.where(mask, scores, torch.finfo(self.dtype).min)
            probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.o_proj(out.reshape(b, s, h * hd))


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
    (under sequence parallelism ``s`` must divide by tp)."""

    block_cls = Block

    def __init__(self, *, vocab_size: int = 32000, num_layers: int = 4,
                 num_heads: int = 8, hidden: int = 512, max_seq: int = 2048,
                 dtype: torch.dtype = torch.bfloat16,
                 sequence_parallel: bool = False, attn_impl: str = "einsum",
                 remat: bool = False, mesh=None) -> None:
        check_attn_impl(attn_impl)
        tp = tp_size(mesh)
        for what, n in (("num_heads", num_heads), ("vocab_size", vocab_size)):
            if n % tp:
                raise ValueError(f"{what} {n} does not divide over tp={tp}")
        super().__init__(vocab_size=vocab_size, num_layers=num_layers,
                         num_heads=num_heads, hidden=hidden, max_seq=max_seq,
                         dtype=dtype, mesh=mesh)
        self.sequence_parallel = sequence_parallel
        self.attn_impl = attn_impl
        self.remat = remat
        self.tp = tp
        # the residual stream lives on s / tp rows a rank
        self.seq_sharded = sequence_parallel and tp > 1
        for block in self.blocks():
            block.attn.attn_impl = attn_impl
            block.sequence_parallel = self.seq_sharded

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        s = tokens.shape[1]
        if self.seq_sharded and s % self.tp:
            raise ValueError(f"sequence parallelism: {s} positions do not "
                             f"divide over tp={self.tp}")
        x = self.embed(tokens) + self.pos_embed(
            torch.arange(s, device=tokens.device)[None, :])
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
