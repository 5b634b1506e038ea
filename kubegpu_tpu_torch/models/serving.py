"""The serving contract shared by the port's batchers and its worker, and
the dense slot batcher: the port of ``kubegpu_tpu/models/serving.py``.

Own copies of ``resolve_kv_dtype``, ``resolve_decode_page_cache``,
``_validate_request``, ``_Slot``, ``_SeqTrace``, ``_TracedBatcher``,
``_observe_emit``, ``record_quant_quality``,
``record_sampling_quality`` and ``load_draft_checkpoint`` from the JAX
module, with their semantics:
the pool stores the serving dtype at full width or int8 with per-page
scales, and retirement sealing of decode pages follows the policy's
numerics class (``"quantized"`` seals only on an int8 pool, ``"fp32"``
only on a full-width float32 pool, ``"all"`` always).  A traced
request's ``serve`` subtree opens at submit with its ``queue`` phase and
closes with exactly one ``retire`` event; the phase durations feed
``serve_phase_seconds{phase}`` at retirement, and every emitted token
feeds ``serve_ttft_seconds`` (the first) or ``serve_itl_seconds``.

:class:`ContinuousBatcher` is continuous batching over a dense per-slot
KV cache ``(slots, max_seq, h, hd)`` per layer: the moment a slot's
sequence retires, the next queued prompt takes it while the other slots
keep decoding.  Its three device programs are methods on tensors:

- ``_step``: one token for every slot at its own ``pos`` (the dense
  ``DecodeLM`` over the per-slot position vector); the keys are
  ``fold_in(base_key, count + offset)`` and last, pos and counts advance
  on the device from the active mask, so the steady loop uploads
  nothing and reads back one token vector;
- ``_chunk``: chunked prefill.  Every prefilling slot advances one
  ``prefill_chunk`` of its prompt per serving iteration, written at its
  own row offset.  Decode steps interleave between chunks, so a running
  sequence waits at most one chunk and one step for its next token.  The
  prompt's last token is never prefilled: the ordinary step writes row
  ``plen - 1`` and emits the first generated token;
- ``_admit_program``: the monolithic admit (``prefill_chunk=None``):
  prefill the padded prompt on a fresh b=1 cache, run one single-token
  pass at ``plen - 1`` for the first token, and splice the b=1 cache
  into the slot.

The caches are written in place (the port's ``DecodeAttention`` writes
every batch row's K/V at its position), so a chunk runs on the gathered
sub-batch of the slots it advances and writes their rows back: the
other slots' rows stay bit-identical, as JAX's masked merge keeps them.
Nothing relies on index clamping: a prefilling slot parks its step write
on row ``max_seq - 1`` and a chunk that would write past ``max_seq`` is
refused at construction.  No TPU kernel runs on this path: the JAX
module's attention is einsum, and so is the port's.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from kubegpu_tpu_torch.models.decoding import (
    DecodeLM,
    head_f32,
    init_caches,
    pick_tokens,
)
from kubegpu_tpu_torch.models.params import bind_params, resolve_device, tree_map
from kubegpu_tpu_torch.ops import prng
from kubegpu_tpu_torch.utils.tracing import SpanCtx, Tracer

DECODE_PAGE_CACHE_POLICIES = ("off", "fp32", "quantized", "all")
KV_DTYPES = ("bf16", "fp32", "int8")


def resolve_kv_dtype(kv_dtype, dtype) -> bool:
    """Resolve the page-pool storage knob against the serving dtype;
    returns whether the pool stores quantized (int8 + scales) pages.
    ``None`` or the full-width name matching the serving dtype is the
    full-width pool; a contradicting or unknown name raises
    ``ValueError``."""
    if kv_dtype is None:
        return False
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES} or None, got {kv_dtype!r}"
        )
    if kv_dtype == "int8":
        return True
    want = {"bf16": torch.bfloat16, "fp32": torch.float32}[kv_dtype]
    if dtype != want:
        raise ValueError(
            f"kv_dtype {kv_dtype!r} contradicts the serving dtype {dtype}: "
            "full-width pools store the compute dtype (pick the matching "
            "name, or 'int8')"
        )
    return False


def resolve_decode_page_cache(policy: str, dtype, kv_quant: bool = False) -> bool:
    """Resolve the decode-page sealing policy against the serving dtype
    and the pool's storage; returns whether decode-produced pages may
    enter the prefix cache.  Unknown policies raise ``ValueError``."""
    if policy not in DECODE_PAGE_CACHE_POLICIES:
        raise ValueError(
            f"decode_page_cache must be one of {DECODE_PAGE_CACHE_POLICIES}, "
            f"got {policy!r}"
        )
    if policy == "off":
        return False
    if policy == "all":
        return True
    if policy == "quantized":
        return kv_quant
    return dtype == torch.float32 and not kv_quant


def validate_request(prompt: np.ndarray, max_new: int, prompt_pad: int,
                     max_seq: int) -> int:
    """The admission contract: returns the prompt length or raises
    ``ValueError`` — checked before any ``max_new <= 0`` short-circuit,
    so an oversized prompt is refused whatever its budget."""
    plen = int(prompt.shape[0])
    if plen < 1:
        raise ValueError("prompt must contain at least one token")
    if plen > prompt_pad:
        raise ValueError(f"prompt length {plen} exceeds prompt_pad {prompt_pad}")
    if plen + max_new > max_seq:
        raise ValueError(
            f"prompt {plen} + max_new {max_new} exceeds max_seq {max_seq}"
        )
    return plen


def record_quant_quality(metrics, *, agreement: float,
                         margin: Optional[float] = None,
                         ppl_delta: Optional[float] = None) -> None:
    """Publish the int8 pool's measured quality as gauges: its token
    agreement with the full-width pool, the top-1/top-2 logit margin at
    the first divergence and the eval-ppl delta."""
    if metrics is None:
        return
    metrics.set_gauge("serve_kv_quant_agreement", float(agreement))
    if margin is not None:
        metrics.set_gauge("serve_kv_quant_divergence_margin", float(margin))
    if ppl_delta is not None:
        metrics.set_gauge("serve_kv_quant_ppl_delta", float(ppl_delta))


def record_sampling_quality(metrics, *, accept_rate: float,
                            nll_delta: Optional[float] = None,
                            unigram_agreement: Optional[float] = None,
                            lane: str = "dense") -> None:
    """Publish rejection-sampled speculation's measured quality gauges,
    one series per batcher lane (``"dense"`` or ``"paged"``): mean
    per-position acceptance, the teacher-forced NLL delta against
    unspeculated sampling and the unigram agreement of the two output
    populations (the gate is statistical, never per-token)."""
    if metrics is None:
        return
    metrics.set_gauge("serve_sampled_accept_rate", float(accept_rate),
                      lane=lane)
    if nll_delta is not None:
        metrics.set_gauge("serve_sampled_nll_delta", float(nll_delta),
                          lane=lane)
    if unigram_agreement is not None:
        metrics.set_gauge("serve_sampled_unigram_agreement",
                          float(unigram_agreement), lane=lane)


def load_draft_checkpoint(ckpt_dir: str, *, vocab_size: int,
                          num_layers: int, num_heads: int, hidden: int,
                          max_seq: int, device="cuda",
                          dtype=torch.bfloat16):
    """A DRAFT model's weights for speculative serving from the latest
    step under ``<ckpt_dir>/lm`` (the worker's layout; parameter leaves
    only, checked against the draft's dims), cast to bf16 on ``device``
    as the JAX package's ``load_draft_checkpoint`` casts it, whatever
    the target's serving dtype.  Returns None when the directory holds no
    checkpoint: callers fall back to a fresh draft (lossless either way;
    only the accept rate changes)."""
    import os

    from kubegpu_tpu_torch.models.checkpoint import (
        make_manager,
        restore_params,
    )

    mgr = make_manager(os.path.join(os.path.abspath(ckpt_dir), "lm"))
    restored = restore_params(
        mgr, dict(vocab_size=vocab_size, num_layers=num_layers,
                  num_heads=num_heads, hidden=hidden, max_seq=max_seq),
        device=device, dtype=dtype)
    return None if restored is None else restored[0]


@dataclass
class _Slot:
    seq_id: int = -1          # index into the submitted prompt list
    remaining: int = 0        # new tokens still owed
    active: bool = False
    tokens: List[int] = field(default_factory=list)
    # chunked-prefill state: prompt rows [0, prefill_pos) are in the
    # cache; the slot activates (joins the step) once prefill_pos
    # reaches plen - 1
    prompt: Optional[np.ndarray] = None
    prefill_pos: int = 0
    temperature: float = 0.0
    seed: Optional[int] = None   # pinned sample-stream seed (None: unpinned)
    submitted_at: float = 0.0
    last_emit_at: float = 0.0
    admit_seq: int = 0        # admission order (token-budget FIFO)
    # slot-owned trace state from admission to retirement (see
    # _TracedBatcher's ownership model); None when untraced
    trace: Optional["_SeqTrace"] = None


@dataclass
class _SeqTrace:
    """Per-request trace state a batcher keeps while the request lives:
    the ``serve`` span (the replica-side subtree root), the currently
    open phase spans, and the completed phase durations (observed into
    ``serve_phase_seconds{phase=...}`` at retirement)."""

    serve: SpanCtx
    open: Dict[str, SpanCtx] = field(default_factory=dict)
    phases: Dict[str, float] = field(default_factory=dict)


class _TracedBatcher:
    """Request-tracing plumbing of the batchers, as in the JAX package
    (the ``_observe_emit`` discipline applied to spans: one
    implementation, so phase semantics cannot diverge).

    Ownership model: a QUEUED request's trace lives in ``self._traces``
    (keyed by seq_id); at admission the batcher moves it onto the
    sequence's slot state (``s.trace``), so a later submit REUSING the
    seq_id while the old sequence still runs cannot cross wires — the
    old sequence closes its own trace at its own retirement, the new
    request's trace waits in ``_traces``.  Only a duplicate seq_id that
    is still QUEUED gets its stale trace closed (``resubmitted``).

    Requires the host class to provide ``self.tracer``
    (Optional[Tracer]), ``self._traces``, ``self.metrics``, and
    ``_trace_holders()`` (live slot states carrying ``.trace``).  Every
    method is a no-op for untraced requests — a batcher built without a
    tracer and fed no gateway context pays a dict lookup at most."""

    tracer: Optional[Tracer]
    _traces: Dict[int, "_SeqTrace"]

    def _trace_begin(self, seq_id: int, plen: int, max_new: int,
                     trace: Optional[SpanCtx]) -> None:
        """Open the ``serve`` subtree (under the caller's context —
        normally the gateway's dispatch span — or as a root trace of the
        batcher's own tracer) plus the ``queue`` admission-wait phase."""
        old = self._traces.pop(seq_id, None)
        if old is not None:
            # same seq_id submitted twice while still QUEUED: close the
            # stale subtree or its spans leak open forever (an id reused
            # after admission is not affected — that trace moved onto
            # the slot and retires with its own sequence)
            self._trace_close(old, "resubmitted")
        if trace is not None:
            ctx = trace.child("serve", seq_id=seq_id, plen=plen,
                              max_new=max_new)
        elif self.tracer is not None:
            ctx = self.tracer.start_trace("serve", seq_id=seq_id, plen=plen,
                                          max_new=max_new)
        else:
            return
        tr = _SeqTrace(serve=ctx)
        tr.open["queue"] = ctx.child("queue")
        self._traces[seq_id] = tr

    def _trace_phase_end(self, tr: "_SeqTrace", name: str,
                         t: Optional[float] = None) -> None:
        span = tr.open.pop(name, None)
        if span is not None:
            t = time.monotonic() if t is None else t
            span.end(t=t)
            tr.phases[name] = tr.phases.get(name, 0.0) + (t - span.start)

    def _trace_phase_start(self, tr: "_SeqTrace", name: str,
                           t: Optional[float] = None, **attrs) -> None:
        tr.open[name] = tr.serve.child(name, t=t, **attrs)

    def _trace_first_token(self, s) -> None:
        """Annotate the decode span with the first-token stamp and the
        INDEPENDENTLY-measured TTFT (``_observe_emit``'s submitted_at
        arithmetic), so the span sum and the TTFT histogram can
        cross-check each other."""
        tr = s.trace
        if tr is None:
            return
        decode = tr.open.get("decode")
        if decode is not None:
            decode.annotate(
                first_token_t=s.last_emit_at,
                measured_ttft=s.last_emit_at - s.submitted_at,
            )
            tr.phases["first_step"] = s.last_emit_at - decode.start

    def _trace_close(self, tr: "_SeqTrace", reason: str,
                     n_tokens: int = 0, **attrs) -> None:
        t = time.monotonic()
        for name in list(tr.open):
            self._trace_phase_end(tr, name, t=t)
        tr.serve.event("retire", t=t, reason=reason, n_tokens=n_tokens,
                       **attrs)
        tr.serve.end(t=t)
        if self.metrics is not None and tr.phases:
            phases = dict(tr.phases)
            if "first_step" in phases and "decode" in phases:
                # the decode PHASE starts at activation; first_step is
                # its leading slice (activation -> first token) — split
                # so the labeled series sum to the request's wall time
                phases["decode"] = max(
                    0.0, phases["decode"] - phases["first_step"]
                )
            for phase, d in phases.items():
                self.metrics.observe("serve_phase_seconds", d, phase=phase)

    def _trace_retire_queued(self, seq_id: int, reason: str) -> None:
        """Close a trace still in the QUEUED map (cancel-from-pending)."""
        tr = self._traces.pop(seq_id, None)
        if tr is not None:
            self._trace_close(tr, reason)

    def _trace_retire_slot(self, s, reason: str) -> None:
        """Close a slot-owned trace at retirement/cancel — the one
        place a live sequence's tree ends, so exactly one retire."""
        tr = s.trace
        if tr is not None:
            s.trace = None
            self._trace_close(tr, reason, n_tokens=len(s.tokens))

    def trace_shutdown(self, reason: str = "replica died") -> None:
        """The process-death epilogue (the serving loop's exit path):
        every queued and live request's spans close
        with a ``retire`` of reason ``died`` (the caller's detail kept
        as the ``note`` attribute) so the trace tree stays complete — a
        killed replica must end its spans the way a dead pod ends its
        connections, explicitly."""
        for seq_id in list(self._traces):
            tr = self._traces.pop(seq_id)
            self._trace_close(tr, "died", note=reason)
        for s in self._trace_holders():
            tr = s.trace
            if tr is not None:
                s.trace = None
                self._trace_close(tr, "died", n_tokens=len(s.tokens),
                                  note=reason)


def _observe_emit(metrics, s, first: bool) -> None:
    """Record TTFT (first token) or ITL on a slot's token emit, and stamp
    the slot's ``last_emit_at`` — one implementation, so what counts as
    "first" and which interval ITL measures cannot diverge."""
    now = time.monotonic()
    if metrics is not None:
        if first:
            metrics.observe("serve_ttft_seconds", now - s.submitted_at)
        else:
            metrics.observe("serve_itl_seconds", now - s.last_emit_at)
    s.last_emit_at = now


def resolve_prefill_chunk(prefill_chunk: Union[int, None, str],
                          prompt_pad: int, max_seq: int) -> Optional[int]:
    """The chunk size a dense batcher prefills with, or None (the
    monolithic admit).  ``"auto"`` picks 128 (or the whole ``prompt_pad``
    when shorter) when the last padded chunk fits the cache and the
    monolithic admit otherwise, so the default never refuses a
    configuration the monolithic batcher takes.  Chunk starts are
    multiples of the chunk size, so a chunk whose last padded window
    would write past ``max_seq`` raises ``ValueError``."""
    if prefill_chunk == "auto":
        c = min(128, prompt_pad)
        fits = c * (-(-(prompt_pad - 1) // c)) <= max_seq
        return c if fits else None
    if prefill_chunk is None:
        return None
    if prefill_chunk <= 0:
        raise ValueError(
            f"prefill_chunk must be positive or None, got {prefill_chunk}"
        )
    prefill_chunk = min(prefill_chunk, prompt_pad)
    last_end = prefill_chunk * (-(-(prompt_pad - 1) // prefill_chunk))
    if last_end > max_seq:
        raise ValueError(
            f"prefill_chunk {prefill_chunk} with prompt_pad {prompt_pad} "
            f"would write through row {last_end}, past max_seq {max_seq}; "
            "pick a chunk size whose last padded chunk fits"
        )
    return prefill_chunk


class ContinuousBatcher(_TracedBatcher):
    """Continuous batching over a dense per-slot KV cache — the JAX
    package's ``ContinuousBatcher`` with its signature, streams and
    ``stats`` (``steps``, ``admits``, ``prefill_chunks``).

    ``prompt_pad`` bounds a prompt's length (under the monolithic admit
    every prompt is padded to it).  ``prefill_chunk`` is the prompt rows
    prefilled per serving iteration: an int, ``None`` (the monolithic
    admit) or ``"auto"`` (:func:`resolve_prefill_chunk`).
    ``token_budget`` bounds the rows one iteration processes (active
    decode tokens plus chunk rows): the earliest-admitted prefilling slots
    chunk first and at least one chunk always runs; it needs chunked
    prefill.  A request ``submit``-ted with ``temperature > 0`` samples
    (truncated to the batcher's ``top_k``); ``seed`` pins its stream to
    (seed, absolute position), otherwise its keys derive from the
    batcher's ``seed`` and the request's seq_id.  ``quant=True`` takes a
    :func:`quantize_params_int8` tree.

    ``metrics`` receives ``serve_ttft_seconds``, ``serve_itl_seconds``
    and ``serve_prefill_chunks_total`` (``attach_metrics`` swaps the
    registry, e.g. after a warm-up); ``tracer``, or a ``trace`` context
    passed to ``submit``, gives each request a ``serve`` subtree (queue,
    prefill with one ``chunk`` child a chunk, decode, one retire).
    ``first_token_s`` maps each seq_id to the seconds from its submit to
    its first token.  ``device`` defaults to ``"cuda"`` and raises
    without a card; ``stream`` is the CUDA stream the batcher's work is
    ordered on (None on the CPU)."""

    def __init__(
        self,
        params,
        *,
        vocab_size: int,
        num_layers: int,
        num_heads: int,
        hidden: int,
        max_seq: int,
        slots: int = 8,
        prompt_pad: int = 128,
        prefill_chunk: Union[int, None, str] = "auto",
        token_budget: Optional[int] = None,
        eos_id: Optional[int] = None,
        dtype=torch.bfloat16,
        quant: bool = False,
        top_k: int = 0,
        seed: int = 0,
        metrics=None,
        tracer: Optional[Tracer] = None,
        device="cuda",
    ) -> None:
        if prompt_pad > max_seq:
            raise ValueError(
                f"prompt_pad ({prompt_pad}) exceeds max_seq ({max_seq}): "
                "the admit prefill could not fit its padded chunk in the "
                "cache"
            )
        prefill_chunk = resolve_prefill_chunk(prefill_chunk, prompt_pad,
                                              max_seq)
        self.prefill_chunk = prefill_chunk
        if token_budget is not None:
            if token_budget <= 0:
                raise ValueError(
                    f"token_budget ({token_budget}) must be positive or None"
                )
            if prefill_chunk is None:
                raise ValueError(
                    "token_budget requires chunked prefill: the "
                    "monolithic admit is one unsplittable program"
                )
        self.token_budget = token_budget
        if top_k > vocab_size:
            raise ValueError(
                f"top_k ({top_k}) exceeds vocab_size ({vocab_size})"
            )
        self.top_k = top_k
        self.device = dev = resolve_device(device)
        # the stream the batcher's work is ordered on; a serving thread
        # other than this one binds it before it steps the batcher
        self.stream = (torch.cuda.current_stream(dev)
                       if dev.type == "cuda" else None)
        self._admit_counter = 0
        self.metrics = metrics
        self.tracer = tracer
        self._traces: Dict[int, _SeqTrace] = {}
        self.slots = slots
        self.prompt_pad = prompt_pad
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.num_layers, self.num_heads, self.hidden = (num_layers, num_heads,
                                                        hidden)
        self.dtype = dtype
        # the root of unpinned requests' keys, on the host: a request's
        # base key is derived at admission and copied once
        self._root_key = prng.PRNGKey(seed)
        self.model = bind_params(
            DecodeLM(vocab_size=vocab_size, num_layers=num_layers,
                     num_heads=num_heads, hidden=hidden, max_seq=max_seq,
                     dtype=dtype, quant=quant),
            head_f32(tree_map(lambda t: t.to(dev), params), quant),
        )
        self.caches = init_caches(slots, num_layers, num_heads, hidden,
                                  max_seq, dtype, dev)
        self._slots = [_Slot() for _ in range(slots)]
        self._pending: deque = deque()
        self._reset_stats()

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # the loop state, resident on the device: the step advances last,
        # pos and counts (tokens emitted, the key index) from the active
        # mask, which is pushed only when slot membership changes
        self.pos = zeros(slots)
        self._last = zeros(slots)
        self._counts = zeros(slots)
        self._active_host = np.zeros((slots,), bool)
        self._active_dev = zeros(slots, dtype=torch.bool)
        # the sampling state, written at admission: temperature (0 =
        # greedy), base key and fold-index offset (0 unpinned, the
        # prompt length when the request pins a seed)
        self._temps = zeros(slots, dtype=torch.float32)
        self._base_keys = zeros(slots, 2, dtype=torch.int64)
        self._key_offsets = zeros(slots)

    def attach_metrics(self, metrics) -> None:
        """Send the batcher's ``serve_*`` series to ``metrics`` (None
        stops them): at construction, or after a warm-up whose requests
        the registry should not count."""
        self.metrics = metrics

    # -- the device programs -------------------------------------------------
    def _step(self, sampled: bool) -> torch.Tensor:
        """One decode step for every slot at its own depth (inactive
        slots compute junk nobody reads); returns the (slots,) tokens.
        A sampled step draws slot i's token with the key
        ``fold_in(base_i, count_i + offset_i)``: a sequence's n-th draw
        never depends on its neighbours or its slot."""
        logits = self.model(self._last[:, None], self.caches, self.pos)
        if sampled:
            keys = prng.fold_in(self._base_keys,
                                self._counts + self._key_offsets)
            toks = pick_tokens(logits, self._temps, keys, self.top_k)
        else:
            toks = logits.argmax(-1).to(torch.int32)
        act = self._active_dev.to(torch.int32)
        self._last = torch.where(self._active_dev, toks, self._last)
        self.pos = self.pos + act
        self._counts = self._counts + act
        return toks

    def _admit_program(self, row: torch.Tensor, plen: int, slot: int,
                       temperature: float, key: torch.Tensor) -> int:
        """The monolithic admit: prefill the padded row on a fresh b=1
        cache, take the first token from one more single-token pass at
        row ``plen - 1`` (the padded prefill's last row is padding), and
        splice the b=1 cache into the slot whole."""
        fresh = init_caches(1, self.num_layers, self.num_heads, self.hidden,
                            self.max_seq, self.dtype, self.device)
        self.model.fill(row[None], fresh, 0)
        logits = self.model(row[None, plen - 1:plen], fresh, plen - 1)
        if temperature > 0.0:
            first = pick_tokens(logits, logits.new_full((1,), temperature),
                                key[None], self.top_k)[0]
        else:
            first = logits[0].argmax()
        for (ck, cv), (fk, fv) in zip(self.caches, fresh):
            ck[slot] = fk[0]
            cv[slot] = fv[0]
        self.pos[slot] = plen
        return int(first)

    def _chunk(self, tokens: torch.Tensor, cpos: torch.Tensor,
               idx: torch.Tensor) -> None:
        """Chunked prefill of the slots ``idx``: slot ``idx[i]`` writes
        the C rows ``[cpos[i], cpos[i] + C)`` of its cache from
        ``tokens[i]``.  The model runs on the gathered sub-batch (the
        in-place attention writes every batch row it is given) and only
        those rows are written back; every other row of the cache keeps
        its bits.  The chunk's logits are never computed."""
        sub = [(ck[idx], cv[idx]) for ck, cv in self.caches]
        self.model.fill(tokens, sub, cpos)
        C = tokens.shape[1]
        rows = cpos.long()[:, None] + torch.arange(C, device=self.device)
        lanes = torch.arange(len(idx), device=self.device)[:, None]
        for (ck, cv), (sk, sv) in zip(self.caches, sub):
            ck[idx[:, None], rows] = sk[lanes, rows]
            cv[idx[:, None], rows] = sv[lanes, rows]

    # -- host-side orchestration -------------------------------------------
    def _trace_holders(self):
        return self._slots

    def _validate(self, prompt: np.ndarray, max_new: int) -> int:
        return validate_request(prompt, max_new, self.prompt_pad,
                                self.max_seq)

    def _reset_stats(self) -> None:
        self.stats = {"steps": 0, "admits": 0, "prefill_chunks": 0}
        self.first_token_s: Dict[int, float] = {}

    def _base_key_and_offset(self, seq_id: int, seed: Optional[int],
                             plen: int):
        """The (base key, fold offset) pair of one request's sample
        stream: a pinned seed gives ``PRNGKey(seed)`` with fold indices
        from the prompt length (position-absolute: the same stream on any
        replica, slot or batch); an unpinned request folds its seq_id
        into the batcher's root key and counts from 0."""
        if seed is not None:
            return prng.PRNGKey(int(seed)), plen
        return prng.fold_in(self._root_key, seq_id), 0

    def _set_sampling(self, slot: int, temperature: float, base_key,
                      offset: int) -> None:
        self._temps[slot] = float(temperature)
        self._base_keys[slot] = base_key.to(self.device)
        self._key_offsets[slot] = offset

    def _emit_first(self, s: _Slot) -> None:
        _observe_emit(self.metrics, s, first=True)
        self.first_token_s[s.seq_id] = s.last_emit_at - s.submitted_at
        self._trace_first_token(s)

    def _admit_one(self, slot_idx: int, seq_id: int, prompt: np.ndarray,
                   max_new: int, temperature: float = 0.0,
                   submitted_at: float = 0.0,
                   seed: Optional[int] = None) -> None:
        # the monolithic admit (prefill_chunk=None): one padded b=1
        # prefill spliced into the slot, first token included
        plen = self._validate(prompt, max_new)
        tr = self._traces.pop(seq_id, None)
        s = self._slots[slot_idx]
        if max_new <= 0:
            # generate(num_steps=0): nothing owed, nothing emitted
            s.seq_id, s.active, s.tokens, s.remaining = seq_id, False, [], 0
            s.trace = tr        # _sweep retires the no-op slot's trace
            return
        if tr is not None:
            t = time.monotonic()
            self._trace_phase_end(tr, "queue", t=t)
            self._trace_phase_start(tr, "prefill", t=t, monolithic=True)
        row = np.zeros((self.prompt_pad,), np.int32)
        row[:plen] = prompt
        base_key, offset = self._base_key_and_offset(seq_id, seed, plen)
        self._set_sampling(slot_idx, temperature, base_key, offset)
        first = self._admit_program(
            torch.from_numpy(row).to(self.device), plen, slot_idx,
            float(temperature),
            prng.fold_in(base_key, offset).to(self.device))
        s.seq_id, s.active = seq_id, True
        s.temperature = float(temperature)
        s.tokens = [first]
        s.remaining = max_new - 1
        s.submitted_at = submitted_at
        s.trace = tr
        if tr is not None:
            t = time.monotonic()
            self._trace_phase_end(tr, "prefill", t=t)
            self._trace_phase_start(tr, "decode", t=t)
        self._emit_first(s)
        self._last[slot_idx] = first
        # the admit consumed sample 0; the next step draws sample 1
        self._counts[slot_idx] = 1
        if self.eos_id is not None and first == self.eos_id:
            s.remaining = 0
        if s.remaining <= 0:
            s.active = False

    def _begin_prefill(self, slot_idx: int, seq_id: int, prompt: np.ndarray,
                       max_new: int, temperature: float,
                       submitted_at: float,
                       seed: Optional[int] = None) -> None:
        # chunked admit: reserve the slot, no device work yet — chunks
        # advance in serve_step, interleaved with decode
        self._validate(prompt, max_new)
        s = self._slots[slot_idx]
        tr = self._traces.pop(seq_id, None)
        s.trace = tr
        if max_new <= 0:
            s.seq_id, s.active, s.tokens, s.remaining = seq_id, False, [], 0
            s.prompt = None
            return
        if tr is not None:
            t = time.monotonic()
            self._trace_phase_end(tr, "queue", t=t)
            self._trace_phase_start(tr, "prefill", t=t)
        s.seq_id, s.active = seq_id, False
        s.tokens, s.remaining = [], max_new
        s.prompt, s.prefill_pos = prompt, 0
        s.temperature = temperature
        s.seed = seed
        s.submitted_at = submitted_at
        s.admit_seq = self._admit_counter
        self._admit_counter += 1
        # park the slot's step write on the LAST cache row while it
        # prefills: the step writes K/V for every slot, and that junk must
        # not land in rows a chunk filled.  Row max_seq - 1 is safe: a
        # sequence that ever attends it writes it first
        self.pos[slot_idx] = self.max_seq - 1

    def _activate(self, slot_idx: int) -> None:
        # prompt rows [0, plen - 1) are cached; the step program writes
        # row plen - 1 from the last prompt token and emits the first
        # generated token alongside every other active slot
        s = self._slots[slot_idx]
        plen = int(s.prompt.shape[0])
        base_key, offset = self._base_key_and_offset(s.seq_id, s.seed, plen)
        self._set_sampling(slot_idx, s.temperature, base_key, offset)
        self._last[slot_idx] = int(s.prompt[plen - 1])
        self.pos[slot_idx] = plen - 1
        self._counts[slot_idx] = 0
        s.active = True
        s.prompt = None
        tr = s.trace
        if tr is not None:
            t = time.monotonic()
            self._trace_phase_end(tr, "prefill", t=t)
            self._trace_phase_start(tr, "decode", t=t)

    def _advance_prefill(self) -> None:
        """One chunk over every prefilling slot within the token budget
        (earliest admissions first when the budget tapers), then activate
        the slots whose prompts are cached."""
        pref = [i for i, s in enumerate(self._slots)
                if s.seq_id >= 0 and s.prompt is not None]
        if not pref:
            return
        C = self.prefill_chunk
        if self.token_budget is None:
            chunking = set(pref)
        else:
            # the rows this iteration owes decode; the rest packs chunks
            # FIFO by admission, at least one so prefill never starves
            n_active = sum(1 for s in self._slots if s.active)
            allow = max(1, (self.token_budget - n_active) // C)
            by_admit = sorted(pref, key=lambda i: self._slots[i].admit_seq)
            chunking = set(by_admit[:allow])
        picked, ends = [], {}
        for i in pref:
            s = self._slots[i]
            start = s.prefill_pos
            end = (min(start + C, int(s.prompt.shape[0]) - 1)
                   if i in chunking else start)
            ends[i] = end
            if end > start:
                picked.append(i)
        if picked:
            tokens = np.zeros((len(picked), C), np.int32)
            cpos = np.zeros((len(picked),), np.int32)
            for j, i in enumerate(picked):
                s = self._slots[i]
                tokens[j, : ends[i] - s.prefill_pos] = s.prompt[
                    s.prefill_pos:ends[i]]
                cpos[j] = s.prefill_pos
            t0 = time.monotonic()
            self._chunk(torch.from_numpy(tokens).to(self.device),
                        torch.from_numpy(cpos).to(self.device),
                        torch.tensor(picked, dtype=torch.long,
                                     device=self.device))
            t1 = time.monotonic()
            self.stats["prefill_chunks"] += len(picked)
            if self.metrics is not None:
                self.metrics.inc("serve_prefill_chunks_total",
                                 float(len(picked)))
            if self._traces:
                # per-slot chunk spans share the batched chunk's wall
                # window: one call advanced them all.  As in the JAX
                # batcher, they are recorded only while some traced
                # request still queues
                for j, i in enumerate(picked):
                    tr = self._slots[i].trace
                    if tr is not None and "prefill" in tr.open:
                        tr.open["prefill"].child(
                            "chunk", t=t0, rows_start=int(cpos[j]),
                            rows_end=int(ends[i]),
                        ).end(t=t1)
        for i in pref:
            s = self._slots[i]
            s.prefill_pos = ends[i]
            if s.prefill_pos >= int(s.prompt.shape[0]) - 1:
                self._activate(i)

    # -- the incremental serving API (the replica loop's) -----------------
    def submit(self, seq_id: int, prompt: np.ndarray, max_new: int,
               temperature: float = 0.0,
               session_id: Optional[str] = None,
               trace: Optional[SpanCtx] = None,
               seed: Optional[int] = None) -> None:
        """Queue one request (seq_id a fresh non-negative int).  Shape
        limits are checked here, so a malformed request fails at submit
        and never mid-loop.  ``session_id`` is advisory (the dense
        batcher shares no state between requests).  ``trace`` is an
        optional caller span the request's ``serve`` subtree nests under;
        otherwise the batcher's own ``tracer``, if any, roots one.
        ``seed`` pins the sample stream to (seed, absolute token
        position)."""
        if seq_id < 0:
            raise ValueError(f"seq_id must be >= 0, got {seq_id}")
        prompt = np.asarray(prompt, np.int32)
        plen = self._validate(prompt, max_new)
        self._trace_begin(seq_id, plen, max_new, trace)
        self._pending.append(
            (seq_id, prompt, max_new, temperature, time.monotonic(), seed)
        )

    def cancel(self, seq_id: int) -> bool:
        """Withdraw a request: drop it from the queue, or free its slot
        mid-prefill or mid-decode (its rows are dead weight until the
        next admission overwrites them).  False if the request is
        unknown — retired already, or never submitted."""
        for i, item in enumerate(self._pending):
            if item[0] == seq_id:
                del self._pending[i]
                self._trace_retire_queued(seq_id, "cancelled")
                return True
        for s in self._slots:
            if s.seq_id == seq_id:
                self._trace_retire_slot(s, "cancelled")
                s.seq_id, s.active, s.tokens, s.remaining = -1, False, [], 0
                s.prompt = None
                return True
        return False

    def has_work(self) -> bool:
        return bool(self._pending) or any(s.seq_id >= 0 for s in self._slots)

    def live_tokens(self) -> Dict[int, List[int]]:
        """Committed tokens of every live sequence: the streaming surface
        the replica flushes after each ``serve_step``."""
        return {s.seq_id: list(s.tokens) for s in self._slots
                if s.seq_id >= 0}

    def _sweep(self, finished: Dict[int, List[int]]) -> None:
        # until a pass makes no progress: an admit can finish at once
        # (max_new 1, or a first token that is EOS), and its slot must
        # take the next queued prompt in the same pass
        progress = True
        while progress:
            progress = False
            for i, s in enumerate(self._slots):
                if s.seq_id >= 0 and not s.active and s.prompt is None:
                    finished[s.seq_id] = s.tokens
                    self._trace_retire_slot(s, "finished")
                    s.seq_id = -1
                    progress = True
                if s.seq_id < 0 and self._pending:
                    seq_id, prompt, max_new, temp, t0, seed = (
                        self._pending.popleft())
                    admit = (self._admit_one if self.prefill_chunk is None
                             else self._begin_prefill)
                    admit(i, seq_id, prompt, max_new, temp, t0, seed)
                    self.stats["admits"] += 1
                    progress = True

    @torch.no_grad()
    def serve_step(self) -> Dict[int, List[int]]:
        """One serving iteration: retire and admit, advance every
        prefilling slot by one chunk, run one decode step if a slot is
        active (its token vector is the iteration's one readback), retire
        again.  Returns the requests that finished ({seq_id: tokens})."""
        finished: Dict[int, List[int]] = {}
        self._sweep(finished)
        if self.prefill_chunk is not None:
            self._advance_prefill()
        if any(s.active for s in self._slots):
            active = np.fromiter((s.active for s in self._slots), bool,
                                 self.slots)
            if not np.array_equal(active, self._active_host):
                self._active_host = active
                self._active_dev = torch.from_numpy(active).to(self.device)
            sampled = any(s.active and s.temperature > 0.0
                          for s in self._slots)
            toks = self._step(sampled).cpu().numpy()
            self.stats["steps"] += 1
            for i, s in enumerate(self._slots):
                if not s.active:
                    continue
                t = int(toks[i])
                first = not s.tokens
                s.tokens.append(t)
                s.remaining -= 1
                if first:
                    self._emit_first(s)
                else:
                    _observe_emit(self.metrics, s, first=False)
                if s.remaining <= 0 or (
                    self.eos_id is not None and t == self.eos_id
                ):
                    s.active = False
            self._sweep(finished)
        return finished

    def run(self, prompts: List[np.ndarray], max_new_tokens: List[int],
            temperatures: Optional[List[float]] = None,
            seeds: Optional[List[Optional[int]]] = None,
            ) -> Dict[int, List[int]]:
        """Serve every prompt to completion; returns {seq_id: generated
        tokens}.  ``stats["steps"]`` then counts the step programs (the
        efficiency measure against static batching).  ``temperatures``
        is per request (0 greedy); ``seeds`` optionally pins each
        request's stream (see ``submit``)."""
        assert len(prompts) == len(max_new_tokens)
        temps = temperatures or [0.0] * len(prompts)
        assert len(temps) == len(prompts)
        seeds = seeds or [None] * len(prompts)
        self._reset_stats()
        for i, (p, m, t) in enumerate(zip(prompts, max_new_tokens, temps)):
            self.submit(i, np.asarray(p), m, t, seed=seeds[i])
        done: Dict[int, List[int]] = {}
        done.update(self.serve_step())
        while self.has_work():
            done.update(self.serve_step())
        return done
