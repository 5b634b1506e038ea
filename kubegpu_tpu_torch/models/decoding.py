"""Autoregressive decoding with a dense KV cache: the port of
``kubegpu_tpu/models/decoding.py`` at full width.

``DecodeLM`` is the cached twin of the JAX package's ``TransformerLM``
with the same parameter tree (see ``models/params.py``).  Its numerics
mirror the JAX model step by step, because the paged batcher prefills
every prompt through it and greedy streams must match the reference at
float32: attention scores in the model dtype divided by ``sqrt(hd)``
cast to that dtype, a ``finfo.min`` mask, a float32 softmax cast back,
flax's LayerNorm (float32 statistics, ``E[x^2] - E[x]^2`` variance,
epsilon 1e-6), tanh-approximated GELU, and a float32 ``lm_head``.

Caches are ``(b, max_seq, h, hd)`` per layer and are written IN PLACE
(the JAX model returns new caches; updating them where they lie saves a
copy of every cache per call).  ``quant=True`` runs every Dense as the
weight-only int8 ``QuantDense`` over a :func:`quantize_params_int8`
tree, as the JAX package's ``quant`` flag does.

Sampling draws the JAX package's random bits (``ops/prng.py``):
``warp_logits`` scales by the temperature and truncates to the top k
(ties at the k-th value keep more than k), ``pick_tokens`` takes a
gumbel-max sample per row from that row's key or the argmax where the
row's temperature is 0, and ``position_key``/``block_keys`` derive the
seed-pinned keys ``fold_in(fold_in(PRNGKey(seed), position), tag)`` that
make a sampled stream a function of (seed, emitted prefix) alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from kubegpu_tpu_torch.models.params import (
    bind_params,
    meta_param,
    resolve_device,
    tree_map,
)
from kubegpu_tpu_torch.ops import prng

Caches = List[Tuple[torch.Tensor, torch.Tensor]]


class Dense(nn.Module):
    """flax ``nn.Dense(use_bias=False, dtype=dtype)``: ``kernel`` is
    ``(in, out)``; input and kernel are promoted to ``dtype``."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.kernel = meta_param(n_in, n_out)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class QuantDense(nn.Module):
    """Weight-only int8 Dense (the JAX package's ``QuantDense``):
    ``kernel_int8`` ``(in, out)`` int8 and ``qscale`` ``(out,)`` float32,
    one symmetric scale per output channel.  The weight is dequantized in
    the compute dtype (``w8.to(dtype) * scale.to(dtype)``, as the JAX
    module multiplies) and the product is one ``torch.matmul``; the
    activations stay in ``dtype``."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.kernel_int8 = meta_param(n_in, n_out)
        self.qscale = meta_param(n_out)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel_int8.to(self.dtype) * self.qscale.to(self.dtype)[None]
        return x.to(self.dtype) @ w


def dense_cls(quant: bool):
    return QuantDense if quant else Dense


def quantize_params_int8(tree: Mapping) -> Dict:
    """A serving tree in the ``QuantDense`` layout (the JAX package's
    ``quantize_params_int8``): every Dense kernel (a ``{"kernel": 2-D}``
    node) becomes per-output-channel int8 ``kernel_int8`` with float32
    ``qscale = amax / 127`` (1 where a column is all zero); embeddings
    and LayerNorms pass through untouched."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping) and set(v) == {"kernel"} and v["kernel"].dim() == 2:
            w = v["kernel"].float()
            scale = w.abs().amax(0) / 127.0
            scale = torch.where(scale == 0, 1.0, scale)
            out[k] = {"kernel_int8": torch.round(w / scale[None]).to(torch.int8),
                      "qscale": scale}
        elif isinstance(v, Mapping):
            out[k] = quantize_params_int8(v)
        else:
            out[k] = v
    return out


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)``: statistics in float32 with the
    fast variance ``E[x^2] - E[x]^2`` clipped at 0, epsilon 1e-6, scale
    and bias applied in float32, result cast to ``dtype``."""

    def __init__(self, hidden: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.scale = meta_param(hidden)
        self.bias = meta_param(hidden)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + 1e-6) * self.scale.float()
        y = (xf - mean) * mul + self.bias.float()
        return y.to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed(dtype=dtype)``: a row gather of ``embedding``."""

    def __init__(self, rows: int, hidden: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.embedding = meta_param(rows, hidden)
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()].to(self.dtype)


def attn_scale(hd: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``jnp.sqrt(hd).astype(dtype)``: the score divisor, rounded to the
    model dtype as the JAX model rounds it."""
    return torch.tensor(math.sqrt(hd), dtype=torch.float32,
                        device=device).to(dtype)


class DecodeAttention(nn.Module):
    """Chunked attention against a running KV cache: ``x`` is one token
    per sequence (a decode step) or a whole chunk (prefill in one causal
    pass)."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 quant: bool = False) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            setattr(self, name, dense_cls(quant)(hidden, hidden, dtype))

    def forward(self, x, cache_k, cache_v, pos):
        # x (b, L, d); cache_* (b, max_seq, h, hd), written in place at
        # rows pos + [0, L); pos (1,) when every sequence is aligned or
        # (b,) per-sequence positions (continuous batching)
        b, L, d = x.shape
        h = self.num_heads
        hd = d // h
        q = self.q_proj(x).view(b, L, h, hd)
        k = self.k_proj(x).view(b, L, h, hd)
        v = self.v_proj(x).view(b, L, h, hd)
        rows = pos.long()[:, None] + torch.arange(L, device=x.device)[None, :]
        rows = rows.expand(b, L)
        bidx = torch.arange(b, device=x.device)[:, None].expand(b, L)
        cache_k[bidx, rows] = k
        cache_v[bidx, rows] = v
        scores = torch.einsum("bqhd,bkhd->bhqk", q, cache_k) / attn_scale(
            hd, self.dtype, x.device
        )
        cols = torch.arange(cache_k.shape[1], device=x.device)
        causal = cols[None, None, None, :] <= rows[:, None, :, None]
        scores = torch.where(causal, scores,
                             torch.finfo(self.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, cache_v)
        return self.o_proj(out.reshape(b, L, d))


class DecodeBlock(nn.Module):
    attn_cls = DecodeAttention

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 quant: bool = False) -> None:
        super().__init__()
        self.ln1 = LayerNorm(hidden, dtype)
        # only the decode attentions take quant (training never does)
        self.attn = (self.attn_cls(hidden, num_heads, dtype, quant=True)
                     if quant else self.attn_cls(hidden, num_heads, dtype))
        self.ln2 = LayerNorm(hidden, dtype)
        self.mlp_up = dense_cls(quant)(hidden, 4 * hidden, dtype)
        self.mlp_down = dense_cls(quant)(4 * hidden, hidden, dtype)

    def forward(self, x, *cache_args):
        # cache_args: (cache_k, cache_v, pos) for the dense attention,
        # (k_pool, v_pool, table, pos) for the paged one
        x = x + self.attn(self.ln1(x), *cache_args)
        # flax nn.gelu is the tanh approximation
        y = F.gelu(self.mlp_up(self.ln2(x)), approximate="tanh")
        return x + self.mlp_down(y)


class LMBase(nn.Module):
    """Embeddings, final norm and float32 head shared by the dense and
    paged decode models (one parameter tree, two attention paths).
    ``quant=True`` takes the ``QuantDense`` layout for every Dense, the
    head included (run at float32)."""

    block_cls = DecodeBlock

    def __init__(self, *, vocab_size: int, num_layers: int, num_heads: int,
                 hidden: int, max_seq: int,
                 dtype: torch.dtype = torch.bfloat16,
                 all_logits: bool = False, quant: bool = False) -> None:
        super().__init__()
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.num_heads, self.hidden, self.max_seq = num_heads, hidden, max_seq
        self.dtype = dtype
        # every row's logits, not just the last: a speculative verify
        # scores all k+1 window positions from one forward
        self.all_logits = all_logits
        self.embed = Embed(vocab_size, hidden, dtype)
        self.pos_embed = Embed(max_seq, hidden, dtype)
        for i in range(num_layers):
            setattr(self, f"layer{i}",
                    self.block_cls(hidden, num_heads, dtype, quant))
        self.ln_f = LayerNorm(hidden, dtype)
        self.lm_head = dense_cls(quant)(hidden, vocab_size, torch.float32)

    def blocks(self):
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def embed_rows(self, tokens: torch.Tensor, pos_rows: torch.Tensor):
        return self.embed(tokens) + self.pos_embed(pos_rows)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_f(x))


class DecodeLM(LMBase):
    """Cached twin of ``TransformerLM``: ``forward(tokens, caches, pos)``
    with tokens ``(b, L)``, caches ``[(k, v)]`` per layer written in
    place, and pos the cache row of the first token — an int or ``()``
    tensor (aligned) or a ``(b,)`` tensor (per sequence).  Returns the
    last row's float32 logits ``(b, vocab)``, or every row's
    ``(b, L, vocab)`` when built with ``all_logits=True``."""

    def forward(self, tokens: torch.Tensor, caches: Caches,
                pos: Union[int, torch.Tensor]) -> torch.Tensor:
        x = self.fill(tokens, caches, pos)
        if self.all_logits:
            return self.head(x)
        return self.head(x[:, -1:])[:, -1]

    def fill(self, tokens: torch.Tensor, caches: Caches,
             pos: Union[int, torch.Tensor]) -> torch.Tensor:
        """Run the blocks only: write every row's K/V into ``caches`` and
        return the last block's output ``(b, L, hidden)`` — a prefill
        chunk whose logits nobody reads skips the head."""
        b, L = tokens.shape
        pos = torch.as_tensor(pos, device=tokens.device).reshape(-1)
        pos_rows = pos.long()[:, None] + torch.arange(
            L, device=tokens.device
        )[None, :]
        x = self.embed_rows(tokens, pos_rows)
        for block, (ck, cv) in zip(self.blocks(), caches):
            x = block(x, ck, cv, pos)
        return x


def head_f32(params: Mapping, quant: bool = False) -> Dict:
    """``params`` with the head's kernel cast to float32 once: the head
    computes in float32 whatever the weights' dtype, so a bf16 kernel
    would otherwise be cast on every call.  An int8 head (``quant``) is
    a ``QuantDense`` at float32 and keeps its tree."""
    if quant:
        return dict(params)
    return dict(params,
                lm_head={"kernel": params["lm_head"]["kernel"].float()})


def init_caches(batch: int, num_layers: int, num_heads: int, hidden: int,
                max_seq: int, dtype=torch.bfloat16, device="cpu") -> Caches:
    hd = hidden // num_heads
    return [
        (
            torch.zeros((batch, max_seq, num_heads, hd), dtype=dtype,
                        device=device),
            torch.zeros((batch, max_seq, num_heads, hd), dtype=dtype,
                        device=device),
        )
        for _ in range(num_layers)
    ]


NEG_INF_LOGIT = -1e9  # large-negative in f32; -inf breaks gumbel-max

# Seed-pinned key derivation: a request that pins a seed derives every
# random draw as fold_in(fold_in(PRNGKey(seed), absolute position), tag),
# a pure function of (seed, position, draw kind) — independent of batch
# composition, slot, replica and restart.  The tags separate the up to
# three draws speculative sampling makes at one position; plain sampled
# decode folds the position alone.  Generated token n sits at absolute
# position prompt_len + n.
KEY_TAG_DRAFT = 1    # draft proposal draw for this position
KEY_TAG_ACCEPT = 2   # accept-test uniform for this position
KEY_TAG_SAMPLE = 3   # residual resample / bonus / first-token draw


def position_key(base_keys, position, tag):
    """``fold_in(fold_in(base_keys, position), tag)``: ``base_keys``
    ``(*K, 2)``, ``position`` and ``tag`` ints or tensors broadcasting
    against ``K``."""
    return prng.fold_in(prng.fold_in(base_keys, position), tag)


def block_keys(base_keys, start_pos, n: int, tag):
    """``(b, n, 2)`` keys for the ``n`` positions from each row's
    ``start_pos`` (b,): the speculative step's draft, accept and
    resample key blocks.  ``tag`` may be a ``(T, 1, 1)`` tensor of tags,
    giving ``(T, b, n, 2)`` blocks from one position fold."""
    positions = start_pos[:, None] + torch.arange(n, device=start_pos.device)
    return position_key(base_keys[:, None, :], positions, tag)


def warp_logits(logits, temps, top_k: int = 0):
    """Temperature-scale and top-k-truncate logits along the last axis:
    the distribution sampled rows draw from.  Rejection-sampled
    speculation warps the target's p and the draft's q alike, or the
    accept ratio compares different measures.  ``temps`` broadcasts
    against the leading axes; 0 entries divide by 1 (their rows take the
    greedy path in the caller).  The top-k threshold keeps every logit
    ``>=`` the k-th largest, so ties at the k-th value keep more than
    k."""
    safe_t = torch.where(temps > 0.0, temps, 1.0)
    scaled = logits / safe_t[..., None]
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled >= kth, scaled, NEG_INF_LOGIT)
    return scaled


def pick_with_noise(logits, temps, noise, top_k: int = 0):
    """``pick_tokens`` with each row's gumbel noise drawn already:
    ``noise`` (b, vocab) is ``prng.gumbel(keys, vocab)``."""
    greedy = logits.argmax(-1)
    sampled = torch.argmax(noise + warp_logits(logits, temps, top_k), -1)
    return torch.where(temps > 0.0, sampled, greedy).to(torch.int32)


def pick_tokens(logits, temps, keys, top_k: int = 0):
    """The serving batchers' per-slot token choice: row i samples from
    ``softmax(logits_i / temps_i)`` (top-k truncated when ``top_k``)
    with its own key ``keys[i]`` where ``temps_i > 0``, and takes the
    argmax otherwise — mixed greedy and sampled rows in one pass.
    ``logits`` (b, vocab) float32, ``temps`` (b,) float32, ``keys``
    (b, 2); returns (b,) int32."""
    return pick_with_noise(logits, temps,
                           prng.gumbel(keys, logits.shape[-1:]), top_k)


@torch.no_grad()
def generate(params, prompt, num_steps: int, *, vocab_size: int,
             num_layers: int, num_heads: int, hidden: int, max_seq: int,
             dtype=torch.bfloat16, temperature: float = 0.0, top_k: int = 0,
             rng=None, quant: bool = False, device="cuda") -> torch.Tensor:
    """Decode: prefill the whole prompt in one causal pass, then take
    ``num_steps`` steps.  ``quant=True`` serves a
    :func:`quantize_params_int8` tree through ``QuantDense``, as the JAX
    function's ``quant`` does.  ``temperature=0`` is greedy argmax;
    ``temperature > 0`` samples from ``softmax(logits / temperature)``,
    truncated to the ``top_k`` largest when ``top_k > 0``, with step i
    drawing the whole batch's noise from key i of ``split(rng,
    num_steps)`` — the JAX package's draws.  ``rng`` is a ``(2,)`` key
    (``prng.PRNGKey``).  ``prompt`` (b, prompt_len) int; returns ``(b,
    prompt_len + num_steps)`` int32 on ``device``."""
    if temperature > 0.0 and rng is None:
        raise ValueError("sampling (temperature > 0) needs an rng key")
    if top_k > vocab_size:
        raise ValueError(f"top_k ({top_k}) exceeds vocab_size ({vocab_size})")
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt).to(dev, torch.int32)
    b, prompt_len = prompt.shape
    if prompt_len + num_steps > max_seq:
        raise ValueError(
            f"prompt ({prompt_len}) + steps ({num_steps}) exceeds "
            f"max_seq ({max_seq}); cache writes would run past the cache"
        )
    model = DecodeLM(vocab_size=vocab_size, num_layers=num_layers,
                     num_heads=num_heads, hidden=hidden, max_seq=max_seq,
                     dtype=dtype, quant=quant)
    bind_params(model, head_f32(tree_map(lambda t: t.to(dev), params), quant))
    caches = init_caches(b, num_layers, num_heads, hidden, max_seq, dtype,
                         dev)
    keys = (prng.split(torch.as_tensor(rng).to(dev, torch.int64), num_steps)
            if temperature > 0.0 else None)
    logits = model(prompt, caches, 0)
    out = [prompt]
    for i in range(num_steps):
        if keys is None:
            token = logits.argmax(-1).to(torch.int32)
        else:
            scaled = warp_logits(logits, logits.new_full((b,), temperature),
                                 top_k)
            # one key draws the whole batch's noise, as JAX's
            # categorical does over a (b, vocab) array
            token = prng.categorical(keys[i], scaled).to(torch.int32)
        out.append(token[:, None])
        if i + 1 < num_steps:
            logits = model(token[:, None], caches, prompt_len + i)
    return torch.cat(out, dim=1)


def greedy_generate(params, prompt, num_steps: int, **kw) -> torch.Tensor:
    """Greedy decode (temperature 0) — see :func:`generate`."""
    return generate(params, prompt, num_steps, temperature=0.0, **kw)
