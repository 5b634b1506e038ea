"""The decoder-only LM the trainer runs: the port of
``kubegpu_tpu/models/transformer.py`` at one device.

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
``sequence_parallel`` only places activations on a tensor-parallel mesh
and does nothing at one device, in JAX as here.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubegpu_tpu_torch.models.decoding import (
    Dense,
    DecodeBlock,
    LMBase,
    attn_scale,
)
from kubegpu_tpu_torch.ops.attention import flash_attention

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
    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 attn_impl: str = "einsum") -> None:
        super().__init__()
        check_attn_impl(attn_impl)
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, Dense(hidden, hidden, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        hd = d // h
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
        return self.o_proj(out.reshape(b, s, d))


class Block(DecodeBlock):
    """flax ``Block``: pre-norm attention and a 4x tanh-GELU MLP, each
    added to the residual stream."""

    attn_cls = CausalSelfAttention


class TransformerLM(LMBase):
    """flax ``TransformerLM`` at one device: ``forward(tokens)`` with
    tokens ``(b, s)``, ``s <= max_seq``, returns float32 logits
    ``(b, s, vocab)``."""

    block_cls = Block

    def __init__(self, *, vocab_size: int = 32000, num_layers: int = 4,
                 num_heads: int = 8, hidden: int = 512, max_seq: int = 2048,
                 dtype: torch.dtype = torch.bfloat16,
                 sequence_parallel: bool = False, attn_impl: str = "einsum",
                 remat: bool = False) -> None:
        check_attn_impl(attn_impl)
        super().__init__(vocab_size=vocab_size, num_layers=num_layers,
                         num_heads=num_heads, hidden=hidden, max_seq=max_seq,
                         dtype=dtype)
        self.sequence_parallel = sequence_parallel
        self.attn_impl = attn_impl
        self.remat = remat
        for block in self.blocks():
            block.attn.attn_impl = attn_impl

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        s = tokens.shape[1]
        x = self.embed_rows(tokens,
                            torch.arange(s, device=tokens.device)[None, :])
        for block in self.blocks():
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return self.head(x)
