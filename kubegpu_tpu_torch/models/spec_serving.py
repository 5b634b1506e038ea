"""Speculative continuous batching: the port of
``kubegpu_tpu/models/spec_serving.py``.

Each slot keeps its own depth (``pos``), so a speculative step
generalizes the dense batcher's: every slot drafts k proposals at its
own depth, one target forward verifies every slot's (k+1)-row window,
and each slot accepts its own prefix and emits one more token (the
target's choice at the first mismatch, or the bonus token).  A slot
that keeps rejecting still advances one token a step, so the batcher
never runs more target forwards than one-token stepping.

Two device programs, methods on tensors:

- ``_step``: k+1 single-token draft passes, then one (b, k+1) verify
  with every row's logits and the per-slot accept arithmetic on the
  device; it returns the emitted block, the per-slot emit lengths and
  the next ``last`` token.  ``pos`` is clamped to ``max_seq - (k + 1)``
  first, so a retired slot's junk window stays inside its cache (the
  admission headroom keeps every live slot below the clamp);
- ``_admit_program``: prefill the padded prompt through both models on
  fresh b=1 caches (then one single-token pass of each at ``plen - 1``;
  the target's gives the first token) and splice both into the slot.

``sampling=True`` adds per-position rejection sampling
(``models/speculative.py::rejection_sample_block``): sampled slots draw
proposals from the warped draft distribution, accept each with
probability min(1, p/q) against the equally warped target, and resample
the first rejection from the residual.  Greedy slots keep the argmin
prefix through a per-row select, so a mixed batch runs one step.  Every
draw folds the cache position ``pos + 1 + j`` under its tag (DRAFT,
ACCEPT, SAMPLE), which is the absolute token position: a seed-pinned
request replays its stream on any slot, batch or replica.  A batcher
built without ``sampling`` refuses sampled requests.

At float32 this batcher's greedy streams equal ``ContinuousBatcher``'s;
at bf16 the (b, k+1) verify rounds differently from the (b, 1) step, so
a near-tie may flip (the reference's measured drift class).  No TPU
kernel runs on this path: its attention is the dense model's einsum.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from kubegpu_tpu_torch.models.decoding import (
    KEY_TAG_SAMPLE,
    DecodeLM,
    head_f32,
    init_caches,
    pick_tokens,
    pick_with_noise,
    position_key,
)
from kubegpu_tpu_torch.models.params import bind_params, resolve_device, tree_map
from kubegpu_tpu_torch.models.speculative import sampled_verify, window_keys
from kubegpu_tpu_torch.ops import prng


@dataclass
class _Slot:
    seq_id: int = -1
    remaining: int = 0
    active: bool = False
    tokens: List[int] = field(default_factory=list)
    temperature: float = 0.0


class SpeculativeContinuousBatcher:
    """Continuous batching with per-slot speculative decoding — the JAX
    package's ``SpeculativeContinuousBatcher`` with its signature,
    streams and ``stats`` (``steps`` verify programs, ``admits``,
    ``tokens``).

    ``draft_*`` size the proposal model (``draft_params``); ``k`` is the
    speculation depth.  Greedy output equals ``ContinuousBatcher``'s for
    any draft; the draft only moves ``stats["steps"]``.  With
    ``sampling=True`` temperature > 0 requests rejection-sample (lossless
    in distribution); ``metrics`` observes
    ``serve_spec_accept_rate{mode=greedy|sampled}`` per slot per verify.
    ``quant=True`` takes a :func:`quantize_params_int8` target (the draft
    stays full width).  ``device`` defaults to ``"cuda"`` and raises
    without a card."""

    def __init__(
        self,
        params,
        draft_params,
        *,
        vocab_size: int,
        num_layers: int,
        num_heads: int,
        hidden: int,
        max_seq: int,
        draft_num_layers: int,
        draft_num_heads: int,
        draft_hidden: int,
        k: int = 4,
        slots: int = 8,
        prompt_pad: int = 128,
        eos_id: Optional[int] = None,
        dtype=torch.bfloat16,
        quant: bool = False,
        sampling: bool = False,
        top_k: int = 0,
        seed: int = 0,
        metrics=None,
        device="cuda",
    ) -> None:
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if prompt_pad > max_seq:
            raise ValueError(
                f"prompt_pad ({prompt_pad}) exceeds max_seq ({max_seq})"
            )
        if top_k > vocab_size:
            raise ValueError(
                f"top_k ({top_k}) exceeds vocab_size ({vocab_size})"
            )
        self.device = dev = resolve_device(device)
        self.stream = (torch.cuda.current_stream(dev)
                       if dev.type == "cuda" else None)
        self.k = k
        self.slots = slots
        self.prompt_pad = prompt_pad
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.sampling = sampling
        self.top_k = top_k
        self.metrics = metrics
        self.vocab_size = vocab_size
        self.dtype = dtype
        self._root_key = prng.PRNGKey(seed)
        self.model = bind_params(
            DecodeLM(vocab_size=vocab_size, num_layers=num_layers,
                     num_heads=num_heads, hidden=hidden, max_seq=max_seq,
                     dtype=dtype, quant=quant, all_logits=True),
            head_f32(tree_map(lambda t: t.to(dev), params), quant),
        )
        self.draft = bind_params(
            DecodeLM(vocab_size=vocab_size, num_layers=draft_num_layers,
                     num_heads=draft_num_heads, hidden=draft_hidden,
                     max_seq=max_seq, dtype=dtype),
            head_f32(tree_map(lambda t: t.to(dev), draft_params)),
        )
        self._cache_shapes = (
            (num_layers, num_heads, hidden),
            (draft_num_layers, draft_num_heads, draft_hidden),
        )
        self.caches = init_caches(slots, num_layers, num_heads, hidden,
                                  max_seq, dtype, dev)
        self.d_caches = init_caches(slots, draft_num_layers, draft_num_heads,
                                    draft_hidden, max_seq, dtype, dev)
        self._slots = [_Slot() for _ in range(slots)]
        self.stats = {"steps": 0, "admits": 0, "tokens": 0}
        self.pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._last = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._rows = torch.arange(slots, device=dev)
        # the active mask, pushed only when slot membership changes:
        # inactive slots' positions stay frozen
        self._active_host = np.zeros((slots,), bool)
        self._active_dev = torch.zeros((slots,), dtype=torch.bool,
                                       device=dev)
        # the sampling state, written at admission
        self._temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._base_keys = torch.zeros((slots, 2), dtype=torch.int64,
                                      device=dev)

    # -- the device programs -------------------------------------------------
    def _step(self, sampled: bool):
        """One speculative iteration for every slot: returns ``(block,
        emit_len, next_last)``, ``block`` (slots, k+1) of which each slot
        emits its first ``emit_len``.  The caches take rows ``[pos, pos +
        k]`` of both models (rejected rows are junk the next window
        overwrites before a causal mask exposes them)."""
        k = self.k
        pos = torch.clamp(self.pos, max=self.max_seq - (k + 1))
        last = self._last
        if sampled:
            # step j's proposal noise, at absolute position pos + 1 + j,
            # drawn up front: the bits depend on the key alone
            d_keys, a_keys, s_keys = window_keys(self._base_keys, pos, k)
            d_noise = prng.gumbel(d_keys, self.vocab_size)   # (b, k+1, V)
        # k+1 draft passes, not k: the last proposal is discarded, but
        # its cache write consumes p_k (a k-pass scan would leave row
        # pos + k a hole after a fully accepted window)
        tok, p, proposed, d_logits = last, pos, [], []
        for j in range(k + 1):
            logits = self.draft(tok[:, None], self.d_caches, p)
            if sampled:
                tok = pick_with_noise(logits, self._temps, d_noise[:, j],
                                      self.top_k)
                d_logits.append(logits)
            else:
                tok = logits.argmax(-1).to(torch.int32)
            proposed.append(tok)
            p = p + 1
        proposals = torch.stack(proposed[:k], 1)               # (b, k)
        window = torch.cat([last[:, None], proposals], 1)
        logits_all = self.model(window, self.caches, pos)      # (b, k+1, V)
        block = logits_all.argmax(-1).to(torch.int32)
        match = proposals == block[:, :k]
        accepted = torch.cat([match, torch.zeros_like(match[:, :1])], 1).to(
            torch.int32).argmin(1)
        if sampled:
            block, accepted = sampled_verify(
                logits_all, torch.stack(d_logits[:k], 1), proposals, block,
                accepted, self._temps, a_keys, s_keys, self.top_k)
        emit_len = accepted + 1
        next_last = block[self._rows, (emit_len - 1).long()]
        return block, emit_len.to(torch.int32), next_last

    def _admit_program(self, row: torch.Tensor, plen: int, slot: int,
                       temperature: float, key: torch.Tensor) -> int:
        """Prefill both models on fresh b=1 caches and splice both into
        the slot; the first token is the target's choice at the last real
        prompt row (a single-token pass at ``plen - 1``; the padded
        prefill's last row is padding)."""
        t_fresh, d_fresh = (
            init_caches(1, layers, heads, hidden, self.max_seq, self.dtype,
                        self.device)
            for layers, heads, hidden in self._cache_shapes)
        last_real = row[None, plen - 1:plen]
        self.model.fill(row[None], t_fresh, 0)
        logits = self.model(last_real, t_fresh, plen - 1)[:, -1]
        self.draft.fill(row[None], d_fresh, 0)
        self.draft.fill(last_real, d_fresh, plen - 1)
        if self.sampling and temperature > 0.0:
            # sample 0 at absolute position plen is a direct target
            # sample: the SAMPLE tag, as a bonus token's
            first = pick_tokens(logits, logits.new_full((1,), temperature),
                                key[None], self.top_k)[0]
        else:
            first = logits[0].argmax()
        for shared, new in ((self.caches, t_fresh), (self.d_caches, d_fresh)):
            for (ck, cv), (fk, fv) in zip(shared, new):
                ck[slot] = fk[0]
                cv[slot] = fv[0]
        self.pos[slot] = plen
        return int(first)

    # -- host-side orchestration -------------------------------------------
    def _admit_one(self, slot_idx: int, seq_id: int, prompt: np.ndarray,
                   max_new: int, temperature: float = 0.0,
                   seed: Optional[int] = None) -> None:
        plen = int(prompt.shape[0])
        if temperature > 0.0 and not self.sampling:
            raise ValueError(
                "greedy-only batcher: temperature "
                f"{temperature} needs rejection-sampled speculation — "
                "construct with sampling=True"
            )
        if plen < 1:
            raise ValueError("prompt must contain at least one token")
        if plen > self.prompt_pad:
            raise ValueError(
                f"prompt length {plen} exceeds prompt_pad {self.prompt_pad}"
            )
        if plen + max_new > self.max_seq:
            raise ValueError(
                f"prompt {plen} + max_new {max_new} exceeds max_seq "
                f"{self.max_seq}"
            )
        s = self._slots[slot_idx]
        if max_new <= 0:
            s.seq_id, s.active, s.tokens, s.remaining = seq_id, False, [], 0
            return
        # k rows of write headroom beyond the dense bound (a window writes
        # rows [pos, pos + k]): no write ever relies on index clamping
        if plen + max_new + self.k > self.max_seq:
            raise ValueError(
                f"prompt {plen} + max_new {max_new} + k {self.k} exceeds "
                f"max_seq {self.max_seq}: the speculative batcher needs k "
                "rows of cache headroom"
            )
        row = np.zeros((self.prompt_pad,), np.int32)
        row[:plen] = prompt
        # a pinned seed makes every key a function of (seed, position);
        # an unpinned request folds its seq_id into the batcher's root
        base_key = (prng.PRNGKey(int(seed)) if seed is not None
                    else prng.fold_in(self._root_key, seq_id))
        self._temps[slot_idx] = float(temperature)
        self._base_keys[slot_idx] = base_key.to(self.device)
        first = self._admit_program(
            torch.from_numpy(row).to(self.device), plen, slot_idx,
            float(temperature),
            position_key(base_key, plen, KEY_TAG_SAMPLE).to(self.device))
        s.seq_id, s.active = seq_id, True
        s.temperature = float(temperature)
        s.tokens = [first]
        s.remaining = max_new - 1
        self._last[slot_idx] = first
        if self.eos_id is not None and first == self.eos_id:
            s.remaining = 0
        if s.remaining <= 0:
            s.active = False

    @torch.no_grad()
    def run(self, prompts: List[np.ndarray], max_new_tokens: List[int],
            temperatures: Optional[List[float]] = None,
            seeds: Optional[List[Optional[int]]] = None,
            ) -> Dict[int, List[int]]:
        """Serve every prompt to completion; returns {seq_id: generated
        tokens}.  ``stats["steps"]`` counts verify programs and
        ``stats["tokens"]`` the tokens they emitted: their ratio is the
        speculative gain over one-token stepping.  ``temperatures`` is per
        request (0 greedy; > 0 needs ``sampling=True``); ``seeds`` pins a
        request's sampled stream."""
        if (temperatures is not None and any(t for t in temperatures)
                and not self.sampling):
            raise ValueError(
                "greedy-only batcher: lossless speculative sampling "
                "needs per-position rejection sampling — construct "
                "SpeculativeContinuousBatcher with sampling=True"
            )
        assert len(prompts) == len(max_new_tokens)
        temps = temperatures or [0.0] * len(prompts)
        seeds = seeds or [None] * len(prompts)
        queue = list(range(len(prompts)))
        done: Dict[int, List[int]] = {}
        self.stats = {"steps": 0, "admits": 0, "tokens": 0}

        def retire_and_admit():
            progress = True
            while progress:
                progress = False
                for i, s in enumerate(self._slots):
                    if s.seq_id >= 0 and not s.active:
                        done[s.seq_id] = s.tokens
                        s.seq_id = -1
                        progress = True
                    if s.seq_id < 0 and queue:
                        nxt = queue.pop(0)
                        self._admit_one(
                            i, nxt, np.asarray(prompts[nxt]),
                            max_new_tokens[nxt], temps[nxt], seeds[nxt],
                        )
                        self.stats["admits"] += 1
                        progress = True

        retire_and_admit()
        while any(s.active for s in self._slots):
            active = np.fromiter((s.active for s in self._slots), bool,
                                 self.slots)
            if not np.array_equal(active, self._active_host):
                self._active_host = active
                self._active_dev = torch.from_numpy(active).to(self.device)
            sampled = self.sampling and any(
                s.active and s.temperature > 0.0 for s in self._slots)
            block, emit_len, next_last = self._step(sampled)
            # inactive slots' junk windows advance nothing: their pos
            # stays frozen (admission replaces their rows wholesale)
            self.pos = self.pos + torch.where(self._active_dev, emit_len, 0)
            self._last = next_last
            self.stats["steps"] += 1
            block_h = block.cpu().numpy()
            emit_h = emit_len.cpu().numpy()
            for i, s in enumerate(self._slots):
                if not s.active:
                    continue
                if self.metrics is not None:
                    self.metrics.observe(
                        "serve_spec_accept_rate",
                        (int(emit_h[i]) - 1) / self.k,
                        mode="sampled" if s.temperature > 0 else "greedy",
                    )
                # the window may emit past the slot's budget (the surplus
                # is junk: the slot retires here) or past an EOS
                emitted = [int(t) for t in block_h[i, : emit_h[i]]]
                emitted = emitted[: s.remaining]
                if self.eos_id is not None and self.eos_id in emitted:
                    emitted = emitted[: emitted.index(self.eos_id) + 1]
                s.tokens.extend(emitted)
                s.remaining -= len(emitted)
                self.stats["tokens"] += len(emitted)
                if s.remaining <= 0 or (
                    self.eos_id is not None and emitted
                    and emitted[-1] == self.eos_id
                ):
                    s.active = False
            retire_and_admit()
        return done
