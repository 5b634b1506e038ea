"""Speculative decoding with a dense KV cache: the port of
``kubegpu_tpu/models/speculative.py``'s greedy path.

A small DRAFT model proposes ``k`` tokens autoregressively; the TARGET
scores all of them in ONE chunked forward against its KV cache and
accepts the longest prefix matching its own greedy choices, emitting one
extra token either way (its argmax at the first divergence, or the bonus
token after a fully accepted block).  Greedy speculative decoding is
LOSSLESS: the emitted sequence equals the target's plain greedy decode
exactly, for ANY draft — the draft only changes how many target forwards
the sequence costs.  This is the dense oracle of the paged speculative
batcher.

No cache rollback exists or is needed: positions advance over the
accepted prefix only, and the next block's chunk overwrites every stale
row before a causal mask can expose it.  Sampled rows (per-position
rejection sampling, ``rejection_sample_block``) arrive with the sampling
slice of the port.
"""

from __future__ import annotations

import torch

from kubegpu_tpu_torch.models.decoding import DecodeLM, init_caches
from kubegpu_tpu_torch.models.params import bind_params, resolve_device, tree_map


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
    temperatures=None,
    device="cuda",
):
    """Greedy speculative decode; returns ``(tokens, target_calls)``.

    ``tokens`` is ``(b, prompt_len + num_steps)`` int32 on ``device`` —
    identical to ``greedy_generate(target_params, ...)`` — and
    ``target_calls`` counts verify iterations, the cost a draft is
    judged by.  The draft shares the target's vocab and ``max_seq`` with
    its own depth and width.  ``temperatures`` (sampled rows) raises
    ``NotImplementedError``: it arrives with the sampling slice."""
    if temperatures is not None:
        raise NotImplementedError(
            "sampled speculative decoding (temperatures) is not ported "
            "yet: it arrives with the sampling slice (rejection sampling)"
        )
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt).to(dev, torch.int32)
    b, prompt_len = prompt.shape
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
                 dtype=dtype, all_logits=True),
        tree_map(lambda t: t.to(dev), target_params),
    )
    draft = bind_params(
        DecodeLM(vocab_size=vocab_size, num_layers=draft_num_layers,
                 num_heads=draft_num_heads, hidden=draft_hidden,
                 max_seq=max_seq, dtype=dtype),
        tree_map(lambda t: t.to(dev), draft_params),
    )
    t_caches = init_caches(b, num_layers, num_heads, hidden, max_seq, dtype,
                           dev)
    d_caches = init_caches(b, draft_num_layers, draft_num_heads,
                           draft_hidden, max_seq, dtype, dev)
    # prefill both models on the whole prompt; the target's last-row
    # logits give the first token, as in plain greedy decode
    first = target(prompt, t_caches, 0)[:, -1].argmax(-1).to(torch.int32)
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
        # k+1 draft steps, not k: the extra proposal is discarded, but
        # its cache write consumes p_k (a k-step scan would leave row
        # pos + k a hole after a fully accepted block)
        tok, p, proposed = last, pos, []
        for _ in range(k + 1):
            tok = draft(tok[:, None], d_caches, p).argmax(-1).to(torch.int32)
            proposed.append(tok)
            p = p + 1
        proposals = torch.stack(proposed[:k], 1)                 # (b, k)
        chunk = torch.cat([last[:, None], proposals], 1)
        choices = target(chunk, t_caches, pos).argmax(-1).to(torch.int32)
        match = proposals == choices[:, :k]
        accepted = torch.cat(
            [match, torch.zeros_like(match[:, :1])], 1
        ).to(torch.int32).argmin(1)
        # the emitted block IS choices: it agrees with the accepted
        # proposals, and at the divergence (or bonus) slot it is what
        # greedy emits; the tail past emit_len is junk the next block
        # overwrites
        emit_len = (accepted + 1).to(torch.int32)
        done = n >= num_steps
        cols = n_eff.long()[:, None] + torch.arange(k + 1, device=dev)
        block = torch.where(done[:, None], out[rows[:, None], cols], choices)
        out[rows[:, None], cols] = block
        n = n + torch.where(done, 0, emit_len)
        calls += 1
    return torch.cat([prompt, out[:, :num_steps]], 1), calls
