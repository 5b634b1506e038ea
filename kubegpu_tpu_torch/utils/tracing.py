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

The gateway reads the ring through ``dump_traces`` (its ``/debug/trace``
body: nested trees, newest first) and ``dump_jsonl`` writes one span a
line, schema v1, which ``load_jsonl`` reads back.  The oracles over a
trace's span list are the JAX package's: ``validate_trace`` (one root,
no orphans, every span closed, children inside their parents but for
``overhang_ok`` subtrees), ``serve_retire_violations`` (exactly one
``retire`` under each ``serve``) and ``phase_durations`` (the TTFT
decomposition).
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional

SCHEMA_VERSION = 1

# containment slack: spans are stamped with separate time.monotonic()
# calls; a child opened "at the same moment" as its parent may read a
# tick earlier on coarse clocks
_EPS = 1e-6


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

    def dump_traces(self, limit: Optional[int] = None) -> List[dict]:
        """JSON-able trace trees, newest first: the /debug/trace body.
        Only the newest ``limit`` traces are copied — completed traces
        are immutable, so the lock is held for a pointer-list snapshot,
        never for the deep copy (a debug read must not stall span
        recording on a big ring)."""
        with self._lock:
            snapshot = list(self._completed.values())
        snapshot.reverse()
        if limit is not None:
            snapshot = snapshot[:limit]
        return [
            span_tree(
                [dict(s, attrs=dict(s["attrs"])) for s in spans.values()]
            )
            for spans in snapshot
        ]

    def dump_jsonl(self, path) -> int:
        """One span per line (schema v1; see README).  Returns the span
        count written.  ``path`` is a filesystem path or a file-like
        object with ``write``."""
        fh = path if hasattr(path, "write") else open(path, "w")
        n = 0
        try:
            for spans in self.completed():
                for s in sorted(spans, key=lambda s: s["span"]):
                    fh.write(json.dumps(dict(s, v=SCHEMA_VERSION)) + "\n")
                    n += 1
        finally:
            if fh is not path:
                fh.close()
        return n


def load_jsonl(path) -> Dict[str, List[dict]]:
    """Inverse of ``dump_jsonl``: {trace_id: [span dicts]}."""
    fh = path if hasattr(path, "read") else open(path)
    traces: Dict[str, List[dict]] = {}
    try:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            s = json.loads(line)
            traces.setdefault(s["trace"], []).append(s)
    finally:
        if fh is not path:
            fh.close()
    return traces


# ---------------------------------------------------------------------------
# Oracles: the span tree as a correctness artifact
# ---------------------------------------------------------------------------

def span_tree(spans: Iterable[dict]) -> dict:
    """Nest spans into {.., children: [...]} under the root; orphans
    (parent missing) attach under a synthetic "__orphans__" node so a
    broken trace still renders for debugging."""
    by_id = {
        s["span"]: dict(s, attrs=dict(s["attrs"]), children=[])
        for s in spans
    }
    root = None
    orphans = []
    for s in sorted(by_id.values(), key=lambda s: s["span"]):
        if s["parent"] is None:
            root = s
        elif s["parent"] in by_id:
            by_id[s["parent"]]["children"].append(s)
        else:
            orphans.append(s)
    tree = root if root is not None else {
        "trace": next(iter(by_id.values()))["trace"] if by_id else "",
        "name": "__no_root__", "children": [],
    }
    if orphans:
        tree = dict(tree)
        tree.setdefault("children", []).append(
            {"name": "__orphans__", "children": orphans}
        )
    return tree


def validate_trace(spans: List[dict]) -> List[str]:
    """Structural problems of one trace's span list ([] = sound):
    exactly one root, zero orphans, every span closed, end >= start,
    and children contained in their parents — except subtrees under a
    span with ``overhang_ok`` (async teardown: hedge losers cancelled
    after the winner's result already closed the gateway root)."""
    problems: List[str] = []
    by_id = {s["span"]: s for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    if len(roots) != 1:
        problems.append(f"{len(roots)} roots (want exactly 1)")
    for s in spans:
        label = f"span {s['span']} ({s['name']})"
        if s["parent"] is not None and s["parent"] not in by_id:
            problems.append(f"{label}: orphan (parent {s['parent']} missing)")
        if s["end"] is None:
            problems.append(f"{label}: never closed")
        elif s["end"] < s["start"] - _EPS:
            problems.append(f"{label}: ends before it starts")
        if s["attrs"].get("abandoned"):
            problems.append(f"{label}: abandoned (force-closed)")

    def overhang_exempt(s: dict) -> bool:
        seen = set()
        while s is not None:
            if s["attrs"].get("overhang_ok"):
                return True
            if s["span"] in seen:
                return True  # cycle: already reported via containment
            seen.add(s["span"])
            s = by_id.get(s["parent"]) if s["parent"] is not None else None
        return False

    for s in spans:
        if s["parent"] is None or s["parent"] not in by_id:
            continue
        p = by_id[s["parent"]]
        label = f"span {s['span']} ({s['name']})"
        if s["start"] < p["start"] - _EPS:
            problems.append(
                f"{label}: starts before its parent ({p['name']})"
            )
        if (
            s["end"] is not None and p["end"] is not None
            and s["end"] > p["end"] + _EPS
            and not overhang_exempt(s)
        ):
            problems.append(
                f"{label}: outlives its parent ({p['name']}) without "
                "overhang_ok"
            )
    return problems


def serve_retire_violations(spans: List[dict]) -> List[str]:
    """Every replica-side ``serve`` subtree must contain EXACTLY one
    ``retire`` span: zero means a sequence vanished without teardown
    (leaked slot/pages), two means double-teardown (the double-free
    class I5 hunts).  Returns one message per violating subtree."""
    by_parent: Dict[int, List[dict]] = {}
    for s in spans:
        if s["parent"] is not None:
            by_parent.setdefault(s["parent"], []).append(s)

    def count_retires(span_id: int) -> int:
        n = 0
        stack = [span_id]
        while stack:
            for c in by_parent.get(stack.pop(), []):
                if c["name"] == "retire":
                    n += 1
                stack.append(c["span"])
        return n

    out = []
    for s in spans:
        if s["name"] != "serve":
            continue
        n = count_retires(s["span"])
        if n != 1:
            out.append(
                f"serve span {s['span']} (trace {s['trace']}): {n} retire "
                f"spans (want exactly 1)"
            )
    return out


def phase_durations(spans: List[dict]) -> Dict[str, float]:
    """Per-phase wall seconds of one trace's FIRST serve subtree — the
    TTFT decomposition bench.py reports.  Keys: the phase span names
    present (queue/station_wait/prefill/decode/...), plus ``first_step``
    (decode start → first token) when the decode span carries a
    ``first_token_t`` annotation."""
    serve = next((s for s in spans if s["name"] == "serve"), None)
    if serve is None:
        return {}
    children = [s for s in spans if s["parent"] == serve["span"]]
    out: Dict[str, float] = {}
    for s in children:
        if s["end"] is None or s["name"] == "retire":
            continue
        if s["name"] == "decode" and "first_token_t" in s["attrs"]:
            # TTFT decomposition stops at the first token; the rest of
            # the decode span is post-TTFT serving time
            first_t = s["attrs"]["first_token_t"]
            out["first_step"] = first_t - s["start"]
            out["decode"] = out.get("decode", 0.0) + (s["end"] - first_t)
        else:
            out[s["name"]] = out.get(s["name"], 0.0) + (
                s["end"] - s["start"]
            )
    return out
