"""The serving contract shared by the port's batchers and its worker: the
KV storage and decode-page-cache knobs, request validation, and the
request tracing and emit metrics every batcher shares.

Own copies of ``resolve_kv_dtype``, ``resolve_decode_page_cache``,
``_validate_request``, ``_SeqTrace``, ``_TracedBatcher`` and
``_observe_emit`` from ``kubegpu_tpu/models/serving.py``, with their
semantics: the pool stores the serving dtype at full width or int8 with
per-page scales, and retirement sealing of decode pages follows the
policy's numerics class (``"quantized"`` seals only on an int8 pool,
``"fp32"`` only on a full-width float32 pool, ``"all"`` always).  A
traced request's ``serve`` subtree opens at submit with its ``queue``
phase and closes with exactly one ``retire`` event; the phase durations
feed ``serve_phase_seconds{phase}`` at retirement, and every emitted
token feeds ``serve_ttft_seconds`` (the first) or ``serve_itl_seconds``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

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
