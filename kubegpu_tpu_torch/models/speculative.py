"""Speculative decoding with a dense KV cache: the port of
``kubegpu_tpu/models/speculative.py``.

A small DRAFT model proposes ``k`` tokens autoregressively; the TARGET
scores all of them in ONE chunked forward against its KV cache and
accepts the longest prefix matching its own greedy choices, emitting one
extra token either way (its argmax at the first divergence, or the bonus
token after a fully accepted block).  Greedy speculative decoding is
LOSSLESS: the emitted sequence equals the target's plain greedy decode
exactly, for ANY draft — the draft only changes how many target forwards
the sequence costs.  This is the dense oracle of the paged speculative
batcher.

SAMPLED rows (temperature > 0) ride the same block structure with
per-position rejection sampling (:func:`rejection_sample_block`): a
proposal drawn from the warped draft distribution q is accepted with
probability min(1, p/q) against the equally warped target p; the first
rejection resamples from the normalized residual max(0, p - q), and
after a fully accepted block the bonus token samples from p.  Every draw
keys off ``position_key(request key, absolute position, tag)``, so a
seed-pinned stream is a function of (seed, emitted prefix) — and equal
to the JAX package's at float32, which draws the same bits.

No cache rollback exists or is needed: positions advance over the
accepted prefix only, and the next block's chunk overwrites every stale
row before a causal mask can expose it.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch.models.decoding import (
    KEY_TAG_DRAFT,
    KEY_TAG_SAMPLE,
    DecodeLM,
    block_keys,
    head_f32,
    init_caches,
    pick_tokens,
    pick_with_noise,
    position_key,
    warp_logits,
)
from kubegpu_tpu_torch.models.params import bind_params, resolve_device, tree_map
from kubegpu_tpu_torch.ops import prng


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, written as JAX computes it:
    exp of the max-shifted logits over their sum."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def rejection_sample_block(t_logits, d_logits, proposals, accept_keys,
                           sample_keys):
    """Per-position rejection sampling over one speculative block.

    ``t_logits`` (b, k+1, V) and ``d_logits`` (b, k, V) are the WARPED
    target and draft logits (:func:`warp_logits`, alike for both);
    ``proposals`` (b, k) were drawn from ``softmax(d_logits)``;
    ``accept_keys`` (b, k, 2) feed the accept-test uniforms,
    ``sample_keys`` (b, k+1, 2) the resample at each candidate emit slot
    (slot k is the bonus token, whose residual is p itself).

    Returns ``(block, accepted)``: ``accepted`` (b,) counts the accepted
    proposals; ``block`` (b, k+1) int32 holds them, then the resample at
    the first rejection (or the bonus sample); entries past
    ``accepted`` are junk, like the greedy block's tail.  Per slot,
    emit(x) = min(p, q) + (1 - sum min(p, q)) max(0, p - q) / Z = p."""
    b, kp1, _ = t_logits.shape
    k = kp1 - 1
    p = _softmax(t_logits)                                   # (b, k+1, V)
    q = _softmax(d_logits)                                   # (b, k, V)
    idx = proposals.long()[..., None]
    p_prop = torch.gather(p[:, :k], -1, idx)[..., 0]          # (b, k)
    q_prop = torch.gather(q, -1, idx)[..., 0]                 # (b, k)
    u = prng.uniform(accept_keys)                             # (b, k)
    # accept x_i w.p. min(1, p/q): u <= p/q cross-multiplied, so q = 0
    # cannot divide
    accept = u * q_prop <= p_prop
    accepted = torch.cat([accept, accept.new_zeros((b, 1))], 1).to(
        torch.int32).argmin(1)                                # (b,) in [0, k]
    # the residual at every candidate slot; the bonus slot pads q with 0,
    # so its residual is p
    q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], 1)
    resid = torch.clamp(p - q_pad, min=0.0)
    rsum = resid.sum(-1, keepdim=True)
    # rsum == 0 means p == q exactly: fall back to p
    dist = torch.where(rsum > 0.0, resid / torch.clamp(rsum, min=1e-30), p)
    resampled = prng.categorical(
        sample_keys, torch.log(torch.clamp(dist, min=1e-30)))
    prop_pad = torch.cat([proposals.long(),
                          proposals.new_zeros((b, 1)).long()], 1)
    cols = torch.arange(k + 1, device=t_logits.device)[None, :]
    block = torch.where(cols < accepted[:, None], prop_pad, resampled)
    return block.to(torch.int32), accepted.to(torch.int32)


def window_keys(base_keys, pos, k: int):
    """The key blocks of the speculative window whose first row is the
    committed-row cursor ``pos`` (b,): the draft's k+1 proposal keys,
    the k accept keys and the k+1 resample keys, at absolute positions
    ``pos + 1 + j`` — each ``block_keys(base_keys, pos + 1, n, tag)``,
    from one position fold and one tag fold."""
    # the tags DRAFT, ACCEPT, SAMPLE are 1, 2, 3: an arange where the keys
    # lie, so a step copies nothing from the host
    tags = torch.arange(KEY_TAG_DRAFT, KEY_TAG_SAMPLE + 1,
                        device=base_keys.device)[:, None, None]
    draft, accept, sample = block_keys(base_keys, pos + 1, k + 1, tags)
    return draft, accept[:, :k], sample


def sampled_verify(logits_all, d_logits, proposals, greedy_block,
                   greedy_accepted, temps, accept_keys, sample_keys,
                   top_k: int):
    """The verify's sampled rows: warp the target's window logits
    ``(b, k+1, V)`` and the draft's ``(b, k, V)`` alike, rejection-sample
    them, and select per row against the greedy accept (rows of
    temperature 0 keep the argmin-prefix path).  Returns ``(block,
    accepted)``."""
    t = temps[:, None]
    s_block, s_accepted = rejection_sample_block(
        warp_logits(logits_all.float(), t, top_k),
        warp_logits(d_logits.float(), t, top_k),
        proposals, accept_keys, sample_keys)
    row = temps > 0.0
    return (torch.where(row[:, None], s_block, greedy_block),
            torch.where(row, s_accepted, greedy_accepted))


@torch.no_grad()
def speculative_generate(
    target_params,
    draft_params,
    prompt,
    num_steps: int,
    *,
    k: int = 4,
    vocab_size: int,
    num_layers: int,
    num_heads: int,
    hidden: int,
    max_seq: int,
    draft_num_layers: int,
    draft_num_heads: int,
    draft_hidden: int,
    dtype=torch.bfloat16,
    quant: bool = False,
    temperatures=None,
    seeds=None,
    top_k: int = 0,
    device="cuda",
):
    """Speculative decode; returns ``(tokens, target_calls)``.

    Greedy (``temperatures=None``): ``tokens`` is ``(b, prompt_len +
    num_steps)`` int32 on ``device`` — identical to
    ``greedy_generate(target_params, ...)`` — and ``target_calls``
    counts verify iterations, the cost a draft is judged by.  The draft
    shares the target's vocab and ``max_seq`` with its own depth and
    width.  ``quant=True`` serves a :func:`quantize_params_int8` target
    (the draft stays full width), as the JAX function does; greedy
    output then equals ``greedy_generate(..., quant=True)``.

    Sampled (``temperatures`` a (b,) sequence, 0 entries greedy): sampled
    rows use per-position rejection sampling, lossless in distribution
    against plain sampling from the target at the same temperature and
    ``top_k``; ``seeds`` (b,) pin each row's stream (default: the row
    index) through ``position_key``."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt).to(dev, torch.int32)
    b, prompt_len = prompt.shape
    sampling = temperatures is not None
    if sampling:
        temps = torch.as_tensor(temperatures, dtype=torch.float32).to(dev)
        if tuple(temps.shape) != (b,):
            raise ValueError(
                f"temperatures must be shape ({b},), got "
                f"{tuple(temps.shape)}")
        if seeds is None:
            seeds = list(range(b))
        base_keys = torch.stack([prng.PRNGKey(s, dev) for s in seeds])
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    # the last iteration may write one full block past the budget
    if prompt_len + num_steps + k + 1 > max_seq:
        raise ValueError(
            f"prompt ({prompt_len}) + steps ({num_steps}) + k+1 ({k + 1}) "
            f"exceeds max_seq ({max_seq}); speculative blocks would clamp"
        )
    target = bind_params(
        DecodeLM(vocab_size=vocab_size, num_layers=num_layers,
                 num_heads=num_heads, hidden=hidden, max_seq=max_seq,
                 dtype=dtype, all_logits=True, quant=quant),
        head_f32(tree_map(lambda t: t.to(dev), target_params), quant),
    )
    draft = bind_params(
        DecodeLM(vocab_size=vocab_size, num_layers=draft_num_layers,
                 num_heads=draft_num_heads, hidden=draft_hidden,
                 max_seq=max_seq, dtype=dtype),
        head_f32(tree_map(lambda t: t.to(dev), draft_params)),
    )
    t_caches = init_caches(b, num_layers, num_heads, hidden, max_seq, dtype,
                           dev)
    d_caches = init_caches(b, draft_num_layers, draft_num_heads,
                           draft_hidden, max_seq, dtype, dev)
    # prefill both models on the whole prompt; the target's last-row
    # logits give the first token, as in plain greedy decode — or, for a
    # sampled row, a direct target sample at absolute position
    # prompt_len under the SAMPLE tag (no proposal precedes it)
    t_last = target(prompt, t_caches, 0)[:, -1]
    if sampling:
        first = pick_tokens(
            t_last, temps,
            position_key(base_keys, prompt_len, KEY_TAG_SAMPLE), top_k)
    else:
        first = t_last.argmax(-1).to(torch.int32)
    draft.fill(prompt, d_caches, 0)

    rows = torch.arange(b, device=dev)
    # room for the final block past the budget; rows past num_steps are
    # sliced off
    out = torch.zeros((b, num_steps + k + 1), dtype=torch.int32, device=dev)
    out[:, 0] = first
    # tokens emitted per row; the newest is emitted but not yet consumed
    # (its K/V enters the caches with the next chunk)
    n = torch.ones((b,), dtype=torch.int32, device=dev)
    calls = 0
    while int(n.min()) < num_steps:
        # done rows keep computing junk blocks while others finish; their
        # depth is clamped to the last real position so every cache
        # write stays inside max_seq
        n_eff = torch.clamp(n, max=num_steps)
        pos = prompt_len + n_eff - 1
        last = out[rows, n_eff - 1]
        if sampling:
            # draw step j's proposal noise at absolute position
            # pos + 1 + j up front: the bits depend on the key alone
            d_keys, a_keys, s_keys = window_keys(base_keys, pos, k)
            d_noise = prng.gumbel(d_keys, vocab_size)      # (b, k+1, V)
        # k+1 draft steps, not k: the extra proposal is discarded, but
        # its cache write consumes p_k (a k-step scan would leave row
        # pos + k a hole after a fully accepted block)
        tok, p, proposed, d_logits = last, pos, [], []
        for j in range(k + 1):
            logits = draft(tok[:, None], d_caches, p)
            if sampling:
                tok = pick_with_noise(logits, temps, d_noise[:, j], top_k)
                d_logits.append(logits)
            else:
                tok = logits.argmax(-1).to(torch.int32)
            proposed.append(tok)
            p = p + 1
        proposals = torch.stack(proposed[:k], 1)                 # (b, k)
        chunk = torch.cat([last[:, None], proposals], 1)
        logits_all = target(chunk, t_caches, pos)
        choices = logits_all.argmax(-1).to(torch.int32)
        match = proposals == choices[:, :k]
        accepted = torch.cat(
            [match, torch.zeros_like(match[:, :1])], 1
        ).to(torch.int32).argmin(1)
        # the emitted block IS choices: it agrees with the accepted
        # proposals, and at the divergence (or bonus) slot it is what
        # greedy emits; the tail past emit_len is junk the next block
        # overwrites
        if sampling:
            choices, accepted = sampled_verify(
                logits_all, torch.stack(d_logits[:k], 1), proposals,
                choices, accepted, temps, a_keys, s_keys, top_k)
        emit_len = (accepted + 1).to(torch.int32)
        done = n >= num_steps
        cols = n_eff.long()[:, None] + torch.arange(k + 1, device=dev)
        block = torch.where(done[:, None], out[rows[:, None], cols], choices)
        out[rows[:, None], cols] = block
        n = n + torch.where(done, 0, emit_len)
        calls += 1
    return torch.cat([prompt, out[:, :num_steps]], 1), calls
