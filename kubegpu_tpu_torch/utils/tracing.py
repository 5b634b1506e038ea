"""Host-side request tracing of the port: its own copy of the span store
in the JAX package's ``utils/tracing.py``.

A served request's life (replica root, then the batcher's ``serve``
subtree: queue, prefix gather, station wait, prefill chunks, decode with
its speculative draft/verify children, one ``retire`` event) becomes
one tree of spans under a single trace.  A span is a dict with exactly
the keys ``trace``, ``span``, ``parent``, ``name``, ``start``, ``end``
(``time.monotonic()`` floats; ``end`` None while open) and ``attrs`` —
the shape a JAX gateway's ``Tracer.graft`` takes from the terminal SSE
event unchanged.  A trace completes when its root has ended and no span
in it is open; completed traces live in a bounded ring, and a leak
guard force-closes the oldest open trace past ``max_open``.

The oracles over span trees (``validate_trace``,
``serve_retire_violations``, ``phase_durations``) stay with the
reference: the port's tests hold its traces to the JAX ones.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional


def _span_dict(trace_id: str, span_id: int, parent_id: Optional[int],
               name: str, start: float) -> dict:
    return {
        "trace": trace_id, "span": span_id, "parent": parent_id,
        "name": name, "start": start, "end": None, "attrs": {},
    }


class SpanCtx:
    """Handle to one open span: the in-process trace context.

    Passed down the serving path (gateway request → dispatch attempt →
    batcher ``submit(trace=...)``) so replica-side spans nest under the
    gateway's tree.  All methods are idempotent-safe after the span
    ends (a late annotate/end on a closed span is a no-op — see
    ``Tracer.end_span``)."""

    __slots__ = ("tracer", "trace_id", "span_id", "start")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: int,
                 start: float) -> None:
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.start = start

    def child(self, name: str, t: Optional[float] = None,
              **attrs) -> "SpanCtx":
        return self.tracer.start_span(self, name, t=t, **attrs)

    def annotate(self, **attrs) -> None:
        self.tracer.annotate(self, **attrs)

    def end(self, t: Optional[float] = None, **attrs) -> None:
        self.tracer.end_span(self, t=t, **attrs)

    def event(self, name: str, t: Optional[float] = None, **attrs) -> None:
        """Point-in-time child span (start == end): retire markers,
        retry decisions — tree nodes, so the oracles see them."""
        t = time.monotonic() if t is None else t
        self.tracer.start_span(self, name, t=t, **attrs).end(t=t)


class Tracer:
    """Bounded in-memory span store; every method thread-safe."""

    def __init__(self, max_traces: int = 256, max_open: int = 4096) -> None:
        self._lock = threading.Lock()
        # trace_id -> {span_id: span dict}; insertion-ordered so the
        # leak guard evicts oldest-opened first
        self._open: "OrderedDict[str, Dict[int, dict]]" = OrderedDict()
        self._open_spans: Dict[str, int] = {}   # trace_id -> open span count
        self._completed: "OrderedDict[str, Dict[int, dict]]" = OrderedDict()
        self.max_traces = max_traces
        self.max_open = max_open
        self.evicted = 0          # completed traces dropped by the ring
        self.aborted = 0          # open traces force-completed (leak guard)
        self._next_span = 0
        self._next_trace = 0

    # -- span lifecycle ----------------------------------------------------
    def start_trace(self, name: str, trace_id: Optional[str] = None,
                    t: Optional[float] = None, **attrs) -> SpanCtx:
        t = time.monotonic() if t is None else t
        with self._lock:
            if trace_id is None:
                self._next_trace += 1
                trace_id = f"t{self._next_trace:08x}"
            self._next_span += 1
            sid = self._next_span
            span = _span_dict(trace_id, sid, None, name, t)
            span["attrs"].update(attrs)
            self._open[trace_id] = {sid: span}
            self._open_spans[trace_id] = 1
            while len(self._open) > self.max_open:
                victim, spans = self._open.popitem(last=False)
                self._open_spans.pop(victim, None)
                now = time.monotonic()
                for s in spans.values():
                    if s["end"] is None:
                        s["end"] = now
                        s["attrs"]["abandoned"] = True
                self.aborted += 1
                self._complete_locked(victim, spans)
        return SpanCtx(self, trace_id, sid, t)

    def start_span(self, parent: SpanCtx, name: str,
                   t: Optional[float] = None, **attrs) -> SpanCtx:
        t = time.monotonic() if t is None else t
        with self._lock:
            spans = self._open.get(parent.trace_id)
            self._next_span += 1
            sid = self._next_span
            if spans is None:
                # the trace already completed (e.g. a hedge loser's span
                # opening after the leak guard force-closed it): record
                # nothing, hand back an inert ctx — late arrivals must
                # never resurrect a completed trace
                return SpanCtx(self, parent.trace_id, -sid, t)
            span = _span_dict(parent.trace_id, sid, parent.span_id, name, t)
            span["attrs"].update(attrs)
            spans[sid] = span
            self._open_spans[parent.trace_id] += 1
        return SpanCtx(self, parent.trace_id, sid, t)

    def annotate(self, ctx: SpanCtx, **attrs) -> None:
        with self._lock:
            spans = self._open.get(ctx.trace_id)
            if spans is None:
                return
            span = spans.get(ctx.span_id)
            if span is not None:
                span["attrs"].update(attrs)

    def end_span(self, ctx: SpanCtx, t: Optional[float] = None,
                 **attrs) -> None:
        t = time.monotonic() if t is None else t
        with self._lock:
            spans = self._open.get(ctx.trace_id)
            if spans is None:
                return
            span = spans.get(ctx.span_id)
            if span is None or span["end"] is not None:
                return  # idempotent: double-end is a no-op, not a flap
            span["attrs"].update(attrs)
            span["end"] = t
            self._open_spans[ctx.trace_id] -= 1
            root = spans[min(spans)]
            if root["end"] is not None and self._open_spans[ctx.trace_id] == 0:
                del self._open[ctx.trace_id]
                del self._open_spans[ctx.trace_id]
                self._complete_locked(ctx.trace_id, spans)

    def graft(self, parent: SpanCtx, spans: Iterable[dict],
              offset: float = 0.0) -> int:
        """Stitch a FOREIGN trace's spans (a remote replica's, shipped
        back over the wire as dicts) under ``parent`` — the cross-process
        half of request tracing.  Span ids are renumbered into this
        tracer's id space, the remote root re-parents onto ``parent``,
        and ``offset`` maps the remote monotonic clock onto ours (the
        caller anchors the remote receive stamp at its own send time, so
        the subtree lands inside the parent's window).  Every grafted
        span arrives CLOSED — a remote span still open at dump time is
        force-closed at its start and marked ``remote_unclosed`` — so
        grafting never changes when the local trace completes.  Returns
        the span count grafted (0 when the parent's trace has already
        completed: a hedge loser's late stream must never resurrect a
        finished tree)."""
        spans = list(spans)
        with self._lock:
            target = self._open.get(parent.trace_id)
            if target is None or parent.span_id < 0 or not spans:
                return 0
            idmap: Dict[int, int] = {}
            for s in sorted(spans, key=lambda s: s["span"]):
                self._next_span += 1
                idmap[s["span"]] = self._next_span
            for s in sorted(spans, key=lambda s: s["span"]):
                attrs = dict(s.get("attrs") or {}, remote=True)
                end = s.get("end")
                if end is None:
                    end = s["start"]
                    attrs["remote_unclosed"] = True
                parent_id = s.get("parent")
                new = {
                    "trace": parent.trace_id,
                    "span": idmap[s["span"]],
                    # a remote orphan (its parent missing from the dump)
                    # re-parents onto the graft point too — the local
                    # tree must stay orphan-free whatever arrived
                    "parent": idmap.get(parent_id, parent.span_id)
                    if parent_id is not None else parent.span_id,
                    "name": s["name"],
                    "start": s["start"] + offset,
                    "end": end + offset,
                    "attrs": attrs,
                }
                target[new["span"]] = new
            return len(spans)

    def _complete_locked(self, trace_id: str, spans: Dict[int, dict]) -> None:
        self._completed[trace_id] = spans
        while len(self._completed) > self.max_traces:
            self._completed.popitem(last=False)
            self.evicted += 1

    # -- views -------------------------------------------------------------
    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def wait_quiescent(self, timeout: float = 5.0) -> bool:
        """True once no trace remains open — the settle the trace
        oracles need after a drain (hedge-loser cancels land async)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.open_count() == 0:
                return True
            time.sleep(0.005)
        return self.open_count() == 0

    def completed(self) -> List[List[dict]]:
        """Completed traces, oldest first, each a list of span dicts."""
        with self._lock:
            return [
                [dict(s, attrs=dict(s["attrs"])) for s in spans.values()]
                for spans in self._completed.values()
            ]

    def trace(self, trace_id: str) -> Optional[List[dict]]:
        with self._lock:
            spans = self._completed.get(trace_id) or self._open.get(trace_id)
            if spans is None:
                return None
            return [dict(s, attrs=dict(s["attrs"])) for s in spans.values()]
