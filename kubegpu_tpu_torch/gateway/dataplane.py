"""The serving data plane over HTTP: the port's own copy of the JAX
package's ``gateway/dataplane.py``, both halves, wire schema byte for
byte, so either package's gateway (``HttpReplicaClient`` + ``Gateway``)
fronts either package's replica.  The replica half (``ReplicaServer``)
runs the port's batchers; the gateway half (``HttpReplicaClient``, the
``ReplicaClient`` over this protocol: TLS, the bearer token, probes,
wire cancel, migration dispatch and trace grafting into the gateway's
tracer) touches no tensor.

``ReplicaServer`` wraps any batcher speaking the incremental serving API
(``submit``/``serve_step``/``cancel``/``has_work``/``live_tokens``: the
port's ``PagedContinuousBatcher``, or a SimBatcher-style mill) behind a
small HTTP endpoint, driven by ONE serving thread that owns the batcher:

    POST /v1/submit   {"request_id", "prompt": [ints], "max_new_tokens",
                       "temperature", "session", "seed"?, "deadline_s"?,
                       "watermark"?}
        → 200 text/event-stream (chunked): one ``tokens`` event per
          committed token batch (under the pipelined loop the host
          learns tokens at its one readback point, so each flush IS a
          commit point), then a terminal ``done`` (full token list, the
          replica-side span dicts, the receive stamp) or ``error``
          event.  ``: ping`` comment frames keep the socket honest while
          a sequence waits; a client that vanishes mid-stream fails the
          next write and its sequence is CANCELLED (pages freed).
    POST /v1/cancel   {"request_id"} → {"cancelled": bool}: the
          sequence's pages go back to the pool now.
    POST /v1/export   {"request_id", "cursor"?}: export and detach a
          live sequence (its stream ends with a ``migrated`` error); with
          "delta": the pages sealed since "cursor", nothing detached;
          with "reclaim": N, release a parked sequence's first N pages;
          {"stream": [ints]}: the sealed-chain capture.  Answers
          {"payload": <encoded or null>, "pages": n}.
    POST /v1/import   {"payload"}: a sealed chain or a delta staged in
          the prefix cache ({"imported"|"staged": n}); with
          "request_id": a live import, whose response is the
          continuation's SSE stream (tokens past the exporter's, then
          ``done`` with the full list).
    POST /v1/role     {"role": "prefill"|"decode"|"flex"}: flip the
          serving role; "prefill" parks each sequence at its seal and
          its stream announces a non-terminal ``sealed`` event.
    GET  /v1/state    the serving contract: tp, role, slots, sealing
          policy, active streams, the batcher's ``stats``, the prefix
          cache economy, ``kv_dtype`` and the page economy of the last
          ledger row; ``?ledger=K`` adds the last K ledger rows.
    GET  /healthz     liveness ("ok"); 503 once the serving loop has
          failed.
    GET  /metrics     Prometheus text (``replica_http_*``,
          ``replica_migrate_*`` plus whatever the batcher observed into
          the shared registry).

The KV wire codec (``encode_kv_payload``/``decode_kv_payload``) is the
JAX package's byte for byte: each page array travels as base64 of its raw
bytes plus its shape, its dtype named by the payload's geometry.  A
bfloat16 pool's pages are their raw 16-bit patterns, so the codec needs
no bfloat16 numpy type: it decodes them as ``np.uint16``, which the
port's importer takes, and a JAX replica decodes the same bytes as its
own bfloat16.  The codec also carries a sampled speculative payload's
draft-ring lane, which the JAX codec cannot encode, under the wire key
``draft_wire``: a JAX replica decodes a payload without a ring and
re-admits the draft from the prompt (lossless in distribution), where a
ring section it cannot read would fail its import.
Exports and imports run on the serving thread as control ops; the
base64 work stays on the handler threads.

A batcher error on the serving thread is not carried past: the loop
ends every stream with an ``error`` event naming it, refuses new
submits, and ``/healthz`` turns 503.  The serving thread runs on the
batcher's device and stream (``batcher.stream``), which the batcher
captured where it was built.
"""

from __future__ import annotations

import base64
import hmac
import http.client
import json
import logging
import queue
import socket
import ssl
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubegpu_tpu_torch.gateway.client import (
    Attempt,
    AttemptResult,
    ReplicaClient,
    _sniff_takes,
    _sniff_takes_trace,
    sim_stream_seed,
)
from kubegpu_tpu_torch.utils.metrics import Metrics
from kubegpu_tpu_torch.utils.tracing import SpanCtx, Tracer

log = logging.getLogger(__name__)

# SSE keepalive cadence: a stream with no token progress writes a ping
# comment this often, so a vanished client is detected within one frame
PING_INTERVAL_S = 0.2
ROLES = ("prefill", "decode", "flex")


def sse_event(event: str, payload: dict) -> bytes:
    """One SSE frame (the JAX gateway parses exactly this framing)."""
    return f"event: {event}\ndata: {json.dumps(payload)}\n\n".encode()


def write_chunk(wfile, data: bytes) -> None:
    """One HTTP/1.1 chunked-transfer frame."""
    wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
    wfile.flush()


def end_chunks(wfile) -> None:
    """The chunked-transfer terminator: the connection stays reusable."""
    wfile.write(b"0\r\n\r\n")
    wfile.flush()


def _connect(addr: str, timeout: float) -> http.client.HTTPConnection:
    """The ONE "host:port" parse + connection constructor (probe, state,
    wire cancel and the stream pool all route through it)."""
    host, _, port = addr.rpartition(":")
    return http.client.HTTPConnection(host, int(port), timeout=timeout)




def _int_or(value, default: int) -> int:
    """Defensive wire-field parse: a malformed numeric from a client
    must degrade, never raise on the serving thread."""
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def _bind_device(batcher) -> None:
    """Run this thread on the batcher's device and stream: CUDA's current
    device and PyTorch's current stream are per thread, and the serving
    thread is not the one that built the batcher."""
    stream = getattr(batcher, "stream", None)
    if stream is not None:
        import torch

        torch.cuda.set_device(stream.device)
        torch.cuda.set_stream(stream)


# ---------------------------------------------------------------------------
# KV transfer payload codec (the export/import wire schema)
# ---------------------------------------------------------------------------

def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype a payload's page bytes decode as: bfloat16, which
    numpy lacks, as its raw 16-bit patterns."""
    return np.dtype(np.uint16 if name == "bfloat16" else name)


def _encode_pairs(pairs) -> list:
    return [
        {
            "k": base64.b64encode(
                np.ascontiguousarray(k).tobytes()).decode("ascii"),
            "v": base64.b64encode(
                np.ascontiguousarray(v).tobytes()).decode("ascii"),
            "shape": [int(d) for d in np.shape(k)],
        }
        for k, v in pairs
    ]


def _decode_pairs(entries, dtype) -> list:
    return [
        (
            np.frombuffer(base64.b64decode(e["k"]),
                          dtype=dtype).reshape(e["shape"]),
            np.frombuffer(base64.b64decode(e["v"]),
                          dtype=dtype).reshape(e["shape"]),
        )
        for e in entries
    ]


def encode_kv_payload(payload: dict) -> dict:
    """JSON-safe encoding of a KV transfer payload (identity on one
    without page arrays): ``layers`` and ``scales`` as base64 pairs, as
    the JAX codec writes them, and a draft-ring section as
    ``draft_wire`` with its ``rows`` and ``scales`` likewise."""
    out = {k: v for k, v in payload.items()
           if k not in ("layers", "scales", "draft")}
    if "layers" in payload:
        out["layers"] = _encode_pairs(payload["layers"])
    if "scales" in payload:
        out["scales"] = _encode_pairs(payload["scales"])
    draft = payload.get("draft")
    if draft is not None:
        out["draft_wire"] = {
            k: (_encode_pairs(v) if k in ("rows", "scales") else v)
            for k, v in draft.items()}
    return out


def decode_kv_payload(wire: dict) -> dict:
    """The inverse: base64 page arrays back to host numpy, as the
    geometry's storage dtype (``kv_dtype``, else ``dtype``; bfloat16 as
    ``np.uint16``); scales are always float32."""
    out = {k: v for k, v in wire.items()
           if k not in ("layers", "scales", "draft_wire")}
    if "layers" in wire:
        geom = wire["geometry"]
        out["layers"] = _decode_pairs(
            wire["layers"], _np_dtype(geom.get("kv_dtype") or geom["dtype"]))
    if "scales" in wire:
        out["scales"] = _decode_pairs(wire["scales"], np.float32)
    draft = wire.get("draft_wire")
    if draft is not None:
        out["draft"] = dict(draft)
        if "rows" in draft:
            out["draft"]["rows"] = _decode_pairs(
                draft["rows"], _np_dtype(draft["dtype"]))
        if "scales" in draft:
            out["draft"]["scales"] = _decode_pairs(draft["scales"],
                                                   np.float32)
    return out


class _Stream:
    """One in-flight request's server-side state: the event queue its
    HTTP handler drains, and the incremental-emit watermark."""

    __slots__ = ("request_id", "seq", "q", "emitted", "t_recv", "trace",
                 "cancelled", "closed")

    def __init__(self, request_id: str, t_recv: float) -> None:
        self.request_id = request_id
        self.seq: Optional[int] = None
        self.q: "queue.Queue[tuple]" = queue.Queue()
        self.emitted = 0
        self.t_recv = t_recv
        self.trace: Optional[SpanCtx] = None
        self.cancelled = False
        self.closed = False


class ReplicaServingLoop:
    """The serving thread that owns the batcher: drains submissions and
    cancels, drives ``serve_step``, and pushes token-batch events into
    per-request stream queues.  Exactly one thread touches the batcher,
    so HTTP handler threads never race the decode loop; the step (and
    its blocking token readback) runs outside the loop's lock.

    ``role`` is the disaggregation role: a ``"prefill"`` replica parks
    each sequence when its prompt pages seal, and its stream announces a
    non-terminal ``sealed`` event for the gateway's handoff.
    ``fail_migration`` (a chaos knob) refuses every import."""

    def __init__(self, batcher, metrics: Optional[Metrics] = None,
                 tracer: Optional[Tracer] = None,
                 step_delay_s: float = 0.0,
                 fail_migration: bool = False,
                 role: str = "flex") -> None:
        self.batcher = batcher
        self.metrics = metrics
        self.role = role if role in ROLES else "flex"
        prefill_fn = getattr(batcher, "set_prefill_only", None)
        if prefill_fn is not None:
            prefill_fn(self.role == "prefill")
        self.fail_migration = fail_migration
        # the replica's own tracer: every request serves under a local
        # root whose finished span dicts ride the terminal event back to
        # the gateway for grafting
        self.tracer = tracer if tracer is not None else Tracer(
            max_traces=64
        )
        self.step_delay_s = step_delay_s
        self._takes_trace = _sniff_takes_trace(batcher)
        self._takes_stream_seed = _sniff_takes(
            batcher, "submit", "stream_seed"
        )
        self._takes_seed = _sniff_takes(batcher, "submit", "seed")
        # RLock: _finish mutates stream maps from both the serving
        # thread (already holding the condition's lock on the shutdown
        # path) and the flush path
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._inbox: deque = deque()        # (_Stream, payload dict)
        self._cancels: List[str] = []       # request ids
        self._evicted: List[_Stream] = []   # duplicate-id losers
        # control ops: closures run ON the serving thread between steps
        self._ops: deque = deque()          # (fn, reply queue)
        self._streams: Dict[str, _Stream] = {}
        self._by_seq: Dict[int, _Stream] = {}
        self._next_seq = 0
        self.alive = True
        # set when a batcher error ended the loop: what every stream and
        # every later submit is told
        self.error: Optional[str] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- handler-facing surface (any thread) -------------------------------
    def submit(self, payload: dict, t_recv: float) -> _Stream:
        st = _Stream(str(payload.get("request_id") or ""), t_recv)
        with self._cond:
            if not self.alive:
                st.q.put(("error", self.error or "replica shutting down",
                          [], t_recv))
                st.closed = True
                return st
            # last-writer-wins on a duplicate id: the old stream errors
            # out, the new one owns the id (cancel routing needs one
            # owner)
            old = self._streams.get(st.request_id)
            if old is not None and not old.closed:
                old.cancelled = True
                self._evicted.append(old)
            self._streams[st.request_id] = st
            self._inbox.append((st, payload))
            self._cond.notify()
        return st

    def cancel(self, request_id: str,
               stream: Optional[_Stream] = None) -> bool:
        """Cancel by request id.  ``stream`` pins the cancel to ONE
        stream object: a disconnect handler for an evicted (resubmitted)
        stream must not cancel the newer live stream of the same id."""
        with self._cond:
            st = self._streams.get(request_id)
            if st is None or st.closed:
                return False
            if stream is not None and st is not stream:
                return False
            st.cancelled = True
            self._cancels.append(request_id)
            self._cond.notify()
            return True

    def active_streams(self) -> int:
        with self._lock:
            return sum(1 for s in self._streams.values() if not s.closed)

    def control(self, fn, timeout: float = 60.0):
        """Run a closure on the serving thread between steps; returns
        its value or re-raises its exception."""
        reply: "queue.Queue" = queue.Queue(1)
        with self._cond:
            if not self.alive:
                raise RuntimeError(self.error or "replica shutting down")
            self._ops.append((fn, reply))
            self._cond.notify()
        ok, val = reply.get(timeout=timeout)
        if not ok:
            raise val
        return val

    # -- migration verbs (control ops on the serving thread) --------------
    def _live_stream(self, request_id: str) -> _Stream:
        st = self._streams.get(request_id)
        if st is None or st.closed or st.seq is None:
            raise KeyError(f"no live stream {request_id!r}")
        return st

    def _refuse_if_armed(self, what: str = "migration") -> None:
        if self.fail_migration:
            raise RuntimeError(f"{what} refused (chaos knob)")

    def _batcher_fn(self, name: str, verbs: str = "migration"):
        fn = getattr(self.batcher, name, None)
        if fn is None:
            raise ValueError(f"batcher does not speak the {verbs} verbs")
        return fn

    def export_live(self, request_id: str, cursor: int = 0) -> dict:
        """Export and detach one live stream's sequence: the payload is
        taken, tokens the export's drain committed flush to the stream,
        the sequence's pages free, and the stream ends with a
        ``migrated`` error.  A nonzero ``cursor`` ships bytes only for
        pages from ``cursor`` on (the streamed handoff's last hop)."""
        def op():
            st = self._live_stream(request_id)
            export = self._batcher_fn("export_pages")
            payload = export(st.seq, cursor) if cursor else export(st.seq)
            self._flush({})   # the export's drain may have committed tokens
            self.batcher.cancel(st.seq)
            self._finish(st, "error", "migrated")
            return payload

        return self.control(op)

    def export_sealed(self, stream) -> Optional[dict]:
        def op():
            fn = getattr(self.batcher, "export_sealed_chain", None)
            return fn(stream) if fn is not None else None

        return self.control(op)

    def import_live(self, st: _Stream, payload: dict, trace_id: str = "",
                    span_id: str = "0") -> None:
        """Resume a migrated sequence here: import the payload, register
        the stream under its request id (a duplicate id evicts the older
        stream, as a submit does) and set its emit watermark past the
        tokens the exporter already streamed."""
        def op():
            self._refuse_if_armed()
            import_pages = self._batcher_fn("import_pages")
            seq = self._next_seq
            self._next_seq += 1
            root = None
            if self.tracer is not None:
                root = self.tracer.start_trace(
                    "replica_import", request_id=st.request_id,
                    remote_trace=str(trace_id or ""),
                    remote_span=_int_or(span_id, 0),
                )
            kwargs = ({"trace": root} if root is not None and
                      _sniff_takes_trace(self.batcher, "import_pages")
                      else {})
            try:
                import_pages(seq, payload, **kwargs)
            except Exception:
                if root is not None:
                    root.end(status="refused")
                raise
            old = self._streams.get(st.request_id)
            if old is not None and not old.closed:
                old.cancelled = True
                self._evicted.append(old)
            self._streams[st.request_id] = st
            st.seq = seq
            st.trace = root
            st.emitted = len(payload.get("tokens") or [])
            self._by_seq[seq] = st

        self.control(op)

    def import_sealed(self, payload: dict) -> int:
        def op():
            self._refuse_if_armed()
            return self._batcher_fn("import_sealed_chain")(payload)

        return self.control(op)

    def export_delta(self, request_id: str, cursor: int) -> Optional[dict]:
        """The pages sealed since ``cursor`` of a live stream's sequence,
        nothing detached; None when nothing new sealed."""
        def op():
            seq = self._live_stream(request_id).seq
            fn = getattr(self.batcher, "export_sealed_delta", None)
            return fn(seq, cursor) if fn is not None else None

        return self.control(op)

    def import_delta(self, payload: dict) -> int:
        def op():
            self._refuse_if_armed("delta import")
            return self._batcher_fn("import_sealed_delta",
                                    "streaming")(payload)

        return self.control(op)

    def reclaim(self, request_id: str, upto: int) -> int:
        """Release a parked sequence's first ``upto`` pages (the importer
        acked their deltas), so a queued prefill can admit during the
        handoff."""
        def op():
            seq = self._live_stream(request_id).seq
            fn = getattr(self.batcher, "reclaim_handoff_pages", None)
            return fn(seq, upto) if fn is not None else 0

        return self.control(op)

    def set_role(self, role: str) -> bool:
        """Flip the serving role on the serving thread (never mid-step).
        Leaving "prefill" unparks every parked sequence locally."""
        if role not in ROLES:
            return False

        def op():
            self.role = role
            fn = getattr(self.batcher, "set_prefill_only", None)
            if fn is not None:
                fn(role == "prefill")
            return True

        return bool(self.control(op))

    def state(self, ledger_limit: int = 0) -> dict:
        """The ``/v1/state`` body.  Runs on a handler thread while the
        serving thread owns the batcher, so it reads host-side fields
        only (``stats``, ``prefix_cache_stats``, ``kv_dtype``,
        ``ledger_rows``), never a device tensor."""
        b = self.batcher
        active_streams = self.active_streams()
        out = {
            "tp": int(getattr(b, "tp", 1)),
            "role": self.role,
            "slots": getattr(b, "slots", None),
            "decode_page_cache": getattr(b, "decode_page_cache", "off"),
            # the resolved sealing policy: gates the gateway's eager
            # sealed-export captures
            "seals_decode": bool(getattr(b, "_seal_decode", False)),
            "active_streams": active_streams,
        }
        stats = getattr(b, "stats", None)
        if isinstance(stats, dict):
            out["stats"] = {
                k: v for k, v in stats.items()
                if isinstance(v, (int, float, str, bool))
            }
        economy_fn = getattr(b, "prefix_cache_stats", None)
        if economy_fn is not None:
            try:
                out["prefix_cache"] = economy_fn()
            except Exception:  # noqa: BLE001 - state must always serve
                pass
        kv_dtype = getattr(b, "kv_dtype", None)
        if kv_dtype is not None:
            out["kv_dtype"] = kv_dtype
        rows_fn = getattr(b, "ledger_rows", None)
        if rows_fn is not None:
            rows = rows_fn(max(ledger_limit, 1))
            if rows:
                last = rows[-1]
                out["pages"] = {
                    "free": last.get("pages_free", 0),
                    "live": last.get("pages_live", 0),
                    "cached": last.get("pages_cached", 0),
                }
                if "kv_dtype" in last:
                    out["pages"]["kv_dtype"] = last["kv_dtype"]
                    out["pages"]["kv_bytes"] = last.get(
                        "pool_kv_bytes", 0
                    )
                    out["pages"]["scale_bytes"] = last.get(
                        "pool_scale_bytes", 0
                    )
            if ledger_limit > 0:
                out["ledger"] = rows[-ledger_limit:]
        return out

    def stop(self) -> None:
        with self._cond:
            self.alive = False
            self._cond.notify()
        self._thread.join(timeout=5.0)

    # -- the serving thread ------------------------------------------------
    def _run(self) -> None:
        try:
            _bind_device(self.batcher)
            self._serve()
        except Exception as e:  # noqa: BLE001 - ends the loop, see _fail
            log.exception("replica serving loop failed")
            self._fail(f"serving loop failed: {type(e).__name__}: {e}")

    def _serve(self) -> None:
        while True:
            with self._cond:
                while (self.alive and not self._inbox and not self._cancels
                       and not self._ops and not self.batcher.has_work()):
                    self._cond.wait(0.05)
                if not self.alive:
                    self._shutdown("replica shutting down")
                    return
                for st in self._evicted:
                    if not st.closed:
                        if st.seq is not None:
                            self.batcher.cancel(st.seq)
                        self._finish(st, "error", "resubmitted")
                        if self.metrics is not None:
                            # a duplicate-id eviction IS a wire-level
                            # cancel (the catalog counts both flavors)
                            self.metrics.inc("replica_http_cancels_total")
                self._evicted.clear()
                while self._inbox:
                    st, payload = self._inbox.popleft()
                    if st.cancelled:
                        self._finish(st, "error", "cancelled")
                        continue
                    self._admit(st, payload)
                for rid in self._cancels:
                    st = self._streams.get(rid)
                    if st is None or st.closed:
                        continue
                    if st.seq is not None:
                        self.batcher.cancel(st.seq)
                    self._finish(st, "error", "cancelled")
                    if self.metrics is not None:
                        self.metrics.inc("replica_http_cancels_total")
                self._cancels.clear()
                while self._ops:
                    fn, reply = self._ops.popleft()
                    try:
                        reply.put((True, fn()))
                    except Exception as e:  # noqa: BLE001 - op result
                        reply.put((False, e))
            # decode OUTSIDE the lock: a step (and its blocking token
            # readback) must not hold up submission or cancel delivery
            finished = (
                self.batcher.serve_step() if self.batcher.has_work() else {}
            )
            self._flush(finished)
            # prefill-only parking: a sequence whose prompt pages just
            # sealed announces it on its stream (non-terminal), for the
            # gateway's handoff
            drain = getattr(self.batcher, "drain_sealed", None)
            if drain is not None:
                for seq in drain():
                    st = self._by_seq.get(seq)
                    if st is not None and not st.closed:
                        st.q.put(("sealed",))
            if self.step_delay_s:
                time.sleep(self.step_delay_s)

    def _shutdown(self, reason: str) -> None:
        """End the loop: fail blocked control callers, close the
        batcher's spans first (every live serve subtree gets its
        ``died`` retire, so the error events ship complete subtrees),
        then end every stream with an ``error`` event."""
        with self._cond:
            self.alive = False
            while self._ops:
                _, reply = self._ops.popleft()
                reply.put((False, RuntimeError(reason)))
            shutdown = getattr(self.batcher, "trace_shutdown", None)
            if shutdown is not None:
                shutdown("replica server stopped")
            for st in self._evicted:
                if not st.closed:
                    self._finish(st, "error", "resubmitted")
            for st in list(self._streams.values()):
                if not st.closed:
                    self._finish(st, "error", reason)

    def _fail(self, reason: str) -> None:
        """A batcher error ended the loop: no further step runs, every
        stream ends with ``reason``, and so does every later submit."""
        with self._cond:
            self.error = reason
            self._inbox.clear()
            self._shutdown(reason)

    def _admit(self, st: _Stream, payload: dict) -> None:
        remaining = payload.get("deadline_s")
        if remaining is not None:
            try:
                remaining = float(remaining)
            except (TypeError, ValueError):
                remaining = None
        if remaining is not None and (
            time.monotonic() - st.t_recv >= remaining
        ):
            # shed-before-work: the request's remaining deadline (shipped
            # by the gateway) elapsed while it queued in this loop's
            # inbox — admitting it would burn prefill on an answer nobody
            # will wait for.  A counted, retryable refusal.
            if self.metrics is not None:
                self.metrics.inc("replica_http_expired_refusals_total")
            self._finish(
                st, "error",
                "deadline expired before admission (backpressure)",
            )
            return
        seq = self._next_seq
        self._next_seq += 1
        root = None
        if self.tracer is not None:
            # the replica-side root; the batcher's serve subtree nests
            # under it.  The remote parent ids ride as attributes (the
            # client-side graft re-parents under its dispatch span)
            root = self.tracer.start_trace(
                "replica_request", request_id=st.request_id,
                remote_trace=str(payload.get("trace_id") or ""),
                remote_span=_int_or(payload.get("span_id"), 0),
            )
        prompt = np.asarray(payload.get("prompt") or [], np.int32)
        kwargs = {"session_id": payload.get("session")}
        if self._takes_trace:
            kwargs["trace"] = root
        if self._takes_stream_seed:
            kwargs["stream_seed"] = sim_stream_seed(prompt)
        if self._takes_seed and payload.get("seed") is not None:
            kwargs["seed"] = int(payload["seed"])
        try:
            self.batcher.submit(
                seq,
                prompt,
                int(payload.get("max_new_tokens", 0)),
                float(payload.get("temperature", 0.0)),
                **kwargs,
            )
        except Exception as e:  # noqa: BLE001 - bad request is a result
            if root is not None:
                root.end(status="rejected")
            st.trace = root
            self._finish(st, "error", str(e))
            return
        st.seq = seq
        st.trace = root
        # resume watermark: the caller already holds this many tokens —
        # decode from 0 as always (greedy is deterministic) but emit only
        # past the watermark; the terminal done still carries the full
        # list
        wm = max(0, _int_or(payload.get("watermark"), 0))
        if wm:
            st.emitted = wm
            if self.metrics is not None:
                self.metrics.inc(
                    "replica_stream_fastforward_tokens_total", wm
                )
        self._by_seq[seq] = st

    def _flush(self, finished: Dict[int, List[int]]) -> None:
        """Emit token deltas for live sequences (one event per committed
        batch) and terminal events for finished ones."""
        live = getattr(self.batcher, "live_tokens", None)
        if live is not None:
            for seq, toks in live().items():
                st = self._by_seq.get(seq)
                if st is not None and len(toks) > st.emitted:
                    delta = list(toks[st.emitted:])
                    st.emitted = len(toks)
                    st.q.put(("tokens", delta))
        for seq, toks in finished.items():
            st = self._by_seq.pop(seq, None)
            if st is None or st.closed:
                continue
            if len(toks) > st.emitted:
                st.q.put(("tokens", list(toks[st.emitted:])))
            self._finish(st, "done", list(toks))

    def _finish(self, st: _Stream, kind: str, payload) -> None:
        """Terminal event: close the replica-side root, collect the
        completed span dicts, and hand the handler everything it needs
        for the wire."""
        st.closed = True
        with self._lock:
            if self._streams.get(st.request_id) is st:
                del self._streams[st.request_id]
        if st.seq is not None:
            self._by_seq.pop(st.seq, None)
        spans: List[dict] = []
        if st.trace is not None:
            st.trace.end(status=kind)
            got = self.tracer.trace(st.trace.trace_id)
            if got is not None:
                spans = got
        st.q.put((kind, payload, spans, st.t_recv))


def make_replica_handler(loop: ReplicaServingLoop,
                         metrics: Optional[Metrics],
                         auth_token: Optional[str] = None):
    """``auth_token``: optional bearer token required on every ``/v1/*``
    verb; ``/healthz`` and ``/metrics`` stay open (probes and scrapes
    are read-only, and gating them would drain replicas on token
    skew)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def setup(self):
            # TLS: the listening socket is wrapped with
            # do_handshake_on_connect=False, so the handshake happens
            # here, on this connection's own thread, under a deadline —
            # a silent client costs one worker thread for 10 s, never
            # the accept loop
            if hasattr(self.request, "do_handshake"):
                prev = self.request.gettimeout()
                self.request.settimeout(10.0)
                try:
                    self.request.do_handshake()
                finally:
                    self.request.settimeout(prev)
            super().setup()

        def log_message(self, fmt, *args):
            log.debug("replica http: " + fmt, *args)

        def _authorized(self, path: str) -> bool:
            if not auth_token or not path.startswith("/v1/"):
                return True
            sent = self.headers.get("Authorization", "")
            # constant-time compare: the token gates exactly the callers
            # a timing oracle would serve
            if hmac.compare_digest(sent, f"Bearer {auth_token}"):
                return True
            # the refused request's body was never read: close the
            # connection rather than let a pooling client's next request
            # be parsed out of the stale body bytes
            self.close_connection = True
            self._send_json(
                401, {"error": "unauthorized (bearer token required)"}
            )
            return False

        def _read_json(self) -> Optional[dict]:
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                return json.loads(raw) if raw else {}
            except (ValueError, json.JSONDecodeError):
                return None

        def _send_json(self, code: int, payload: dict) -> None:
            self._send_body(code, json.dumps(payload).encode())

        def _send_body(self, code: int, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if not self._authorized(path):
                return
            if metrics is not None:
                metrics.inc("replica_http_requests_total", verb="state"
                            if path == "/v1/state" else "get")
            if path == "/healthz":
                if loop.error is not None:
                    self._send_text(503, loop.error.encode())
                else:
                    self._send_text(200, b"ok")
            elif path == "/metrics" and metrics is not None:
                self._send_text(200, metrics.render().encode())
            elif path == "/v1/state":
                limit = 0
                for part in query.split("&"):
                    if part.startswith("ledger="):
                        try:
                            limit = max(0, int(part.split("=", 1)[1]))
                        except ValueError:
                            pass
                self._send_json(200, loop.state(ledger_limit=limit))
            else:
                self._send_json(404, {"error": f"no route {path}"})

        def do_POST(self):
            if not self._authorized(self.path):
                return
            if self.path == "/v1/cancel":
                if metrics is not None:
                    metrics.inc("replica_http_requests_total", verb="cancel")
                body = self._read_json()
                if body is None or not body.get("request_id"):
                    self._send_json(400, {"error": "request_id required"})
                    return
                ok = loop.cancel(str(body["request_id"]))
                self._send_json(200, {"cancelled": ok})
                return
            if self.path == "/v1/role":
                if metrics is not None:
                    metrics.inc("replica_http_requests_total", verb="role")
                body = self._read_json()
                role = str((body or {}).get("role") or "")
                if role not in ROLES:
                    self._send_json(
                        400, {"error": "role must be prefill|decode|flex"})
                    return
                loop.set_role(role)
                self._send_json(200, {"role": loop.role})
                return
            if self.path == "/v1/export":
                self._handle_export()
                return
            if self.path == "/v1/import":
                self._handle_import()
                return
            if self.path != "/v1/submit":
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            t_recv = time.monotonic()
            if metrics is not None:
                metrics.inc("replica_http_requests_total", verb="submit")
            body = self._read_json()
            if body is None:
                self._send_json(400, {"error": "malformed JSON body"})
                return
            body.setdefault("trace_id", self.headers.get("X-Trace-Id", ""))
            body.setdefault("span_id", self.headers.get("X-Span-Id", "0"))
            st = loop.submit(body, t_recv)
            self._serve_stream(st)

        def _migrated(self, direction: str, t0: float, pages: int,
                      wire_bytes: int) -> None:
            if metrics is not None:
                metrics.observe("replica_migrate_seconds",
                                time.monotonic() - t0, dir=direction)
                metrics.inc("replica_migrate_pages_total", pages,
                            dir=direction)
                metrics.inc("replica_migrate_wire_bytes_total", wire_bytes,
                            dir=direction)

        def _handle_export(self) -> None:
            """POST /v1/export: a live export and detach, a delta, a
            reclaim, or a sealed-chain capture (the module docstring has
            the bodies)."""
            if metrics is not None:
                metrics.inc("replica_http_requests_total", verb="export")
            body = self._read_json()
            if body is None:
                self._send_json(400, {"error": "malformed JSON body"})
                return
            t0 = time.monotonic()
            rid = str(body.get("request_id") or "")
            try:
                if rid and body.get("reclaim") is not None:
                    n = loop.reclaim(rid, int(body["reclaim"]))
                    self._send_json(200, {"reclaimed": n})
                    return
                if rid and body.get("delta"):
                    payload = loop.export_delta(
                        rid, int(body.get("cursor") or 0))
                    out = json.dumps({"payload": (
                        encode_kv_payload(payload)
                        if payload is not None else None)}).encode()
                    if metrics is not None and payload is not None:
                        metrics.inc("replica_migrate_wire_bytes_total",
                                    len(out), dir="export")
                    self._send_body(200, out)
                    return
                if rid:
                    payload = loop.export_live(
                        rid, int(body.get("cursor") or 0))
                elif body.get("stream") is not None:
                    payload = loop.export_sealed(
                        [int(t) for t in body["stream"]])
                else:
                    self._send_json(
                        400, {"error": "request_id or stream required"})
                    return
            except KeyError as e:
                self._send_json(404, {"error": str(e)})
                return
            except (ValueError, RuntimeError) as e:
                self._send_json(409, {"error": str(e)})
                return
            n_pages = len(payload.get("page_keys") or []) if payload else 0
            out = json.dumps({
                "payload": (encode_kv_payload(payload)
                            if payload is not None else None),
                "pages": n_pages}).encode()
            if payload is not None:
                self._migrated("export", t0, n_pages, len(out))
            self._send_body(200, out)

        def _handle_import(self) -> None:
            """POST /v1/import: a sealed chain or a delta into the prefix
            cache (JSON answer), or a live import whose answer is the
            continuation's SSE stream."""
            if metrics is not None:
                metrics.inc("replica_http_requests_total", verb="import")
            t_recv = time.monotonic()
            wire_bytes = _int_or(self.headers.get("Content-Length"), 0)
            body = self._read_json()
            if body is None or not isinstance(body.get("payload"), dict):
                self._send_json(400, {"error": "payload required"})
                return
            try:
                payload = decode_kv_payload(body["payload"])
            except Exception as e:  # noqa: BLE001 - wire junk is a 400
                self._send_json(400,
                                {"error": f"undecodable payload: {e}"})
                return
            t0 = time.monotonic()
            if payload.get("kind") == "delta":
                # the {"staged": n} ack licenses the source's reclaim
                try:
                    n = loop.import_delta(payload)
                except (ValueError, RuntimeError) as e:
                    self._send_json(503, {"error": str(e)})
                    return
                if metrics is not None:
                    metrics.inc("replica_migrate_wire_bytes_total",
                                wire_bytes, dir="import")
                self._send_json(200, {"staged": n})
                return
            if not body.get("request_id"):
                try:
                    n = loop.import_sealed(payload)
                except (ValueError, RuntimeError) as e:
                    self._send_json(503, {"error": str(e)})
                    return
                self._migrated("import", t0, n, wire_bytes)
                self._send_json(200, {"imported": n})
                return
            st = _Stream(str(body["request_id"]), t_recv)
            try:
                loop.import_live(
                    st, payload,
                    trace_id=self.headers.get("X-Trace-Id", ""),
                    span_id=self.headers.get("X-Span-Id", "0"),
                )
            except (KeyError, ValueError) as e:
                self._send_json(409, {"error": str(e)})
                return
            except RuntimeError as e:
                self._send_json(503, {"error": str(e)})
                return
            self._migrated("import", t0,
                           len(payload.get("page_keys") or []), wire_bytes)
            self._serve_stream(st)

        def _serve_stream(self, st: _Stream) -> None:
            """The chunked SSE stream of a submit or a live import;
            disconnect ⇒ cancel pinned to THIS stream object."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            if metrics is not None:
                metrics.set_gauge(
                    "replica_http_streams_active", loop.active_streams()
                )
            try:
                self._stream(st)
            except (BrokenPipeError, ConnectionResetError, OSError):
                # the client vanished mid-stream: its sequence must not
                # keep decoding into pages nobody will read
                if loop.cancel(st.request_id, stream=st):
                    if metrics is not None:
                        metrics.inc(
                            "replica_http_disconnect_cancels_total"
                        )
                self.close_connection = True
            finally:
                if metrics is not None:
                    metrics.set_gauge(
                        "replica_http_streams_active", loop.active_streams()
                    )

        def _stream(self, st: _Stream) -> None:
            while True:
                try:
                    ev = st.q.get(timeout=PING_INTERVAL_S)
                except queue.Empty:
                    write_chunk(self.wfile, b": ping\n\n")
                    continue
                kind = ev[0]
                if metrics is not None:
                    metrics.inc("replica_http_stream_events_total")
                if kind == "tokens":
                    write_chunk(self.wfile,
                                sse_event("tokens", {"tokens": ev[1]}))
                    continue
                if kind == "sealed":
                    # non-terminal: the prompt's pages sealed on a
                    # prefill-only replica and the sequence parked for
                    # its handoff
                    write_chunk(self.wfile, sse_event("sealed", {}))
                    continue
                if kind == "done":
                    write_chunk(self.wfile, sse_event("done", {
                        "tokens": ev[1], "spans": ev[2], "t_recv": ev[3],
                    }))
                else:
                    write_chunk(self.wfile, sse_event("error", {
                        "error": ev[1], "spans": ev[2], "t_recv": ev[3],
                    }))
                end_chunks(self.wfile)
                return

    return Handler


class _ReplicaHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def handle_error(self, request, client_address):
        log.debug("replica connection error from %s", client_address,
                  exc_info=True)


class ReplicaServer:
    """One replica's HTTP serving endpoint: the serving loop plus the
    threaded HTTP server in front of it.  ``listen`` port 0 picks an
    ephemeral port; ``stop()`` ends the serving loop first (live streams
    get an explicit error event), then the listener.  ``tls_cert`` and
    ``tls_key`` (together) serve HTTPS; ``auth_token`` gates ``/v1/*``
    behind a bearer token.  ``role`` and ``fail_migration`` go to the
    serving loop."""

    def __init__(self, batcher, listen: Tuple[str, int] = ("127.0.0.1", 0),
                 metrics: Optional[Metrics] = None,
                 tracer: Optional[Tracer] = None,
                 step_delay_s: float = 0.0,
                 fail_migration: bool = False,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 auth_token: Optional[str] = None,
                 role: str = "flex") -> None:
        if bool(tls_cert) != bool(tls_key):
            # checked before anything binds a socket, so the raise leaks
            # nothing
            raise ValueError(
                "tls_cert and tls_key must be given together"
            )
        self.metrics = metrics if metrics is not None else Metrics()
        self.loop = ReplicaServingLoop(
            batcher, metrics=self.metrics, tracer=tracer,
            step_delay_s=step_delay_s, fail_migration=fail_migration,
            role=role,
        )
        self.httpd = _ReplicaHTTPServer(
            listen,
            make_replica_handler(self.loop, self.metrics,
                                 auth_token=auth_token),
        )
        self.tls = bool(tls_cert and tls_key)
        if self.tls:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self.httpd.socket = ctx.wrap_socket(
                self.httpd.socket,
                server_side=True,
                do_handshake_on_connect=False,
            )
        self._thread: Optional[threading.Thread] = None

    @property
    def batcher(self):
        return self.loop.batcher

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def port(self) -> int:
        return self.address[1]

    @property
    def endpoint(self) -> str:
        host, port = self.address
        return f"{host}:{port}"

    def start(self) -> "ReplicaServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.loop.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


class HttpReplicaClient(ReplicaClient):
    """``ReplicaClient`` over the replica HTTP protocol.

    Endpoint resolution: explicit ``set_endpoint(key, "host:port")``
    entries win (tests, loopback soak); otherwise ``resolver(key)``
    (in-cluster: the registry's discovered pod IP + ``default_port``).
    A replica with no resolvable endpoint fails submissions immediately
    with an unreachable RESULT, like the in-memory client.

    Connection reuse: completed streams return their ``HTTPConnection``
    to a small per-replica pool; errors and cancels discard it (the
    socket state is unknowable mid-stream)."""

    def __init__(
        self,
        endpoints: Optional[Dict[str, str]] = None,
        resolver: Optional[Callable[[str], Optional[str]]] = None,
        default_port: int = 8700,
        timeout_s: float = 5.0,
        metrics: Optional[Metrics] = None,
        tls_ca: Optional[str] = None,
        auth_token: Optional[str] = None,
    ) -> None:
        self.resolver = resolver
        self.default_port = default_port
        self.timeout_s = timeout_s
        self.metrics = metrics
        # transport security, matching the replica server's knobs:
        # tls_ca = PEM bundle to verify replica certs against (HTTPS to
        # every endpoint); auth_token = bearer sent on every request
        # (the replica gates /v1/*).  Both None = plain loopback HTTP.
        self.auth_token = auth_token
        self._ssl_ctx = None
        if tls_ca is not None:
            import ssl

            self._ssl_ctx = ssl.create_default_context(cafile=tls_ca)
        self._lock = threading.Lock()
        self._endpoints: Dict[str, str] = dict(endpoints or {})
        self._pool: Dict[str, List[http.client.HTTPConnection]] = {}
        # replica key -> in-flight attempts (sync_live aborts these the
        # cycle a replica drains, so failover re-dispatches immediately
        # instead of waiting out a dead socket)
        self._inflight: Dict[str, set] = {}
        # request_id -> completed ok deliveries (soak's exactly-once and
        # wasted-hedge accounting — the in-memory client's `decodes`)
        self.decodes: Dict[str, int] = {}
        self._stopped = False

    # -- transport ---------------------------------------------------------
    def _connect(self, addr: str, timeout: float):
        """The one connection constructor for this client: plain HTTP,
        or HTTPS against the configured CA when ``tls_ca`` was given."""
        if self._ssl_ctx is None:
            return _connect(addr, timeout)
        host, _, port = addr.rpartition(":")
        return http.client.HTTPSConnection(
            host, int(port), timeout=timeout, context=self._ssl_ctx
        )

    def _headers(self, extra: Optional[dict] = None) -> dict:
        headers = dict(extra or {})
        if self.auth_token:
            headers["Authorization"] = f"Bearer {self.auth_token}"
        return headers

    # -- endpoints ---------------------------------------------------------
    def set_endpoint(self, key: str, addr: str) -> None:
        with self._lock:
            self._endpoints[key] = addr

    def drop_endpoint(self, key: str) -> None:
        with self._lock:
            self._endpoints.pop(key, None)
            for conn in self._pool.pop(key, []):
                conn.close()

    def endpoint_for(self, key: str) -> Optional[str]:
        with self._lock:
            addr = self._endpoints.get(key)
        if addr is None and self.resolver is not None:
            try:
                addr = self.resolver(key)
            except Exception:  # noqa: BLE001 - resolution is best-effort
                addr = None
        return addr

    def replicas(self) -> List[str]:
        with self._lock:
            return sorted(self._endpoints)

    def ready(self) -> bool:
        with self._lock:
            if self._stopped:
                return False
            return bool(self._endpoints) or self.resolver is not None

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            attempts = [a for s in self._inflight.values() for a in s]
            conns = [c for pool in self._pool.values() for c in pool]
            self._pool.clear()
        for conn in conns:
            conn.close()
        for attempt in attempts:
            self._abort(attempt, "client stopped")

    # -- registry subscription --------------------------------------------
    def sync_live(self, live) -> None:
        """A replica leaving the live set is its process dying: abort
        its in-flight attempts now (the socket may linger half-open) so
        failover re-routes this cycle, and drop its pooled sockets."""
        with self._lock:
            gone = [k for k in self._inflight if k not in live]
            attempts = [a for k in gone for a in self._inflight.get(k, ())]
            for k in [k for k in self._pool if k not in live]:
                for conn in self._pool.pop(k, []):
                    conn.close()
        for attempt in attempts:
            self._abort(attempt, f"replica {attempt.replica} left live set")

    # -- probes / advertisement -------------------------------------------
    def _addr_of(self, info) -> Optional[str]:
        addr = self.endpoint_for(getattr(info, "key", ""))
        if addr is None and getattr(info, "addr", None):
            addr = f"{info.addr}:{self.default_port}"
        return addr

    def probe(self, info) -> Tuple[bool, str]:
        """HTTP health probe for the registry (``ReplicaRegistry``'s
        ``probe=`` hook): GET /healthz on the replica's endpoint.  A
        replica the control plane believes healthy but whose serving
        process is gone must drain from the live set — this is what
        makes in-cluster ``/readyz`` REAL instead of fail-safe."""
        addr = self._addr_of(info)
        if addr is None:
            return False, "no data-plane endpoint (pod IP unknown)"
        conn = self._connect(addr, timeout=1.0)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            resp.read()
            if resp.status == 200:
                return True, ""
            return False, f"/healthz returned {resp.status}"
        except OSError as e:
            return False, f"/healthz unreachable: {e}"
        finally:
            conn.close()

    def _get_state(self, key: str, ledger: int = 0) -> Optional[dict]:
        addr = self.endpoint_for(key)
        if addr is None:
            return None
        conn = self._connect(addr, timeout=1.0)
        try:
            path = "/v1/state" + (f"?ledger={ledger}" if ledger else "")
            conn.request("GET", path, headers=self._headers())
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                return None
            return json.loads(resp.read())
        except (OSError, ValueError):
            return None
        finally:
            conn.close()

    def advertised(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for key in self.replicas():
            state = self._get_state(key)
            if state is not None:
                out[key] = {"tp": int(state.get("tp", 1))}
        return out

    def ledgers(self, limit: int = 32) -> Dict[str, List[dict]]:
        out: Dict[str, List[dict]] = {}
        for key in self.replicas():
            state = self._get_state(key, ledger=limit)
            if state is not None and state.get("ledger"):
                out[key] = state["ledger"]
        return out

    # -- KV-page migration -------------------------------------------------
    def inflight_on(self, replica_key: str) -> List[Attempt]:
        with self._lock:
            return list(self._inflight.get(replica_key, ()))

    def seals_decode(self, replica_key: str) -> bool:
        state = self._get_state(replica_key)
        return bool(state and state.get("seals_decode"))

    def _wire_export(self, addr: str, body: dict) -> Optional[dict]:
        """POST /v1/export; returns the (still-encoded) payload dict or
        None — the gateway relays it to /v1/import opaquely, so only
        replica processes pay the codec."""
        conn = self._connect(addr, timeout=self.timeout_s)
        try:
            conn.request(
                "POST", "/v1/export", json.dumps(body),
                self._headers({"Content-Type": "application/json"}),
            )
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                return None
            return json.loads(data).get("payload")
        except (OSError, ValueError):
            return None
        finally:
            conn.close()

    def export_sealed(self, replica_key: str, stream) -> Optional[dict]:
        addr = self.endpoint_for(replica_key)
        if addr is None:
            return None
        return self._wire_export(
            addr, {"stream": [int(t) for t in stream]}
        )

    def import_sealed(self, replica_key: str, payload) -> bool:
        addr = self.endpoint_for(replica_key)
        if addr is None or payload is None:
            return False
        conn = self._connect(addr, timeout=self.timeout_s)
        try:
            conn.request(
                "POST", "/v1/import", json.dumps({"payload": payload}),
                self._headers({"Content-Type": "application/json"}),
            )
            resp = conn.getresponse()
            resp.read()
            return resp.status == 200
        except (OSError, ValueError):
            return False
        finally:
            conn.close()

    # -- streamed seal-time handoff ------------------------------------
    def export_delta(self, attempt: Attempt, request,
                     cursor: int) -> Optional[dict]:
        """POST /v1/export {"delta": true}: pages sealed since
        ``cursor``, kept wire-encoded — like migrate's payload, the
        gateway relays deltas opaquely and only replicas pay the
        codec."""
        addr = self.endpoint_for(attempt.replica)
        if addr is None:
            return None
        return self._wire_export(addr, {
            "request_id": request.request_id,
            "delta": True, "cursor": int(cursor),
        })

    def import_delta(self, replica_key: str, payload) -> Optional[int]:
        addr = self.endpoint_for(replica_key)
        if addr is None or payload is None:
            return None
        conn = self._connect(addr, timeout=self.timeout_s)
        try:
            conn.request(
                "POST", "/v1/import", json.dumps({"payload": payload}),
                self._headers({"Content-Type": "application/json"}),
            )
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                return None
            staged = json.loads(data).get("staged")
            return int(staged) if staged is not None else None
        except (OSError, ValueError, TypeError):
            return None
        finally:
            conn.close()

    def reclaim(self, attempt: Attempt, request, upto: int) -> int:
        addr = self.endpoint_for(attempt.replica)
        if addr is None:
            return 0
        conn = self._connect(addr, timeout=self.timeout_s)
        try:
            conn.request(
                "POST", "/v1/export",
                json.dumps({"request_id": request.request_id,
                            "reclaim": int(upto)}),
                self._headers({"Content-Type": "application/json"}),
            )
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                return 0
            return int(json.loads(data).get("reclaimed") or 0)
        except (OSError, ValueError, TypeError):
            return 0
        finally:
            conn.close()

    def set_role(self, key: str, role: str) -> bool:
        """POST /v1/role: flip a replica's serving role at runtime (the
        fleet controller's ratio actuator, wire flavor)."""
        addr = self.endpoint_for(key)
        if addr is None:
            return False
        conn = self._connect(addr, timeout=2.0)
        try:
            conn.request(
                "POST", "/v1/role", json.dumps({"role": role}),
                self._headers({"Content-Type": "application/json"}),
            )
            resp = conn.getresponse()
            resp.read()
            return resp.status == 200
        except (OSError, ValueError):
            return False
        finally:
            conn.close()

    def migrate(self, attempt: Attempt, request, to_key: str,
                _between: Optional[Callable[[], None]] = None,
                fallback: bool = False, cursor: int = 0) -> bool:
        """Live migration over the wire: POST /v1/export on the source
        (which detaches the sequence — its stream ends ``migrated``,
        which the source's reader recognizes and leaves unresolved),
        re-home the attempt, then stream the continuation from POST
        /v1/import on the target.  The SAME attempt handle resolves
        with the full token list from the target; a refused or dead
        importer resolves it with an error so normal failover
        re-dispatches cold — graceful, never wrong.

        ``fallback=True`` (the disaggregation handoff contract): if the
        target refuses or dies BEFORE streaming, the held payload is
        re-imported into the SOURCE so the sequence resumes decode where
        it prefilled — counted, never a request error.  It also permits
        ``to_key == from_key``: detach-and-resume locally, the collapse
        path when no decode replica is available at all."""
        if attempt.done:
            return False
        from_key = attempt.replica
        from_addr = self.endpoint_for(from_key)
        to_addr = self.endpoint_for(to_key)
        if from_addr is None or to_addr is None or (
            from_key == to_key and not fallback
        ):
            return False
        trace = getattr(request, "trace", None)
        if not isinstance(trace, SpanCtx):
            trace = None
        # overhang_ok: a handoff's continuation (and its teardown) may
        # resolve after a hedge twin already closed the request root —
        # the same asynchrony the dispatch spans carry
        mspan = (
            trace.child("migrate", source=from_key, target=to_key,
                        overhang_ok=True)
            if trace is not None else None
        )
        attempt._migrating = True
        export_body = {"request_id": request.request_id}
        if cursor:
            # streamed handoff's final hop: layers below the cursor
            # were already delta-staged on the target
            export_body["cursor"] = int(cursor)
        wire = self._wire_export(from_addr, export_body)
        if wire is None:
            # nothing detached — or the export RESPONSE was lost after
            # the replica already detached.  Clear the flag first: a
            # "migrated" terminal arriving from now on resolves the
            # attempt as a plain error (failover re-dispatches cold).
            # If the reader ALREADY swallowed that terminal while the
            # flag was up (it records _migrated_terminal before checking
            # the flag — the handshake that closes the race), resolve
            # the attempt here: the sequence is detached and no
            # continuation is coming, and an unresolved attempt would
            # otherwise hang until the dispatcher's full deadline.
            attempt._migrating = False
            if getattr(attempt, "_migrated_terminal", False):
                attempt.finish(AttemptResult(
                    False,
                    error="migration export response lost: sequence "
                    "detached at the source",
                ))
            if self.metrics is not None:
                self.metrics.inc(
                    "gateway_migrations_total", outcome="export_failed"
                )
            if mspan is not None:
                mspan.end(outcome="export_failed")
            return False
        # re-home BEFORE any chaos can fire: if the source dies now,
        # sync_live must not abort an attempt it no longer owns
        with self._lock:
            self._inflight.setdefault(to_key, set()).add(attempt)
            bucket = self._inflight.get(from_key)
            if bucket is not None:
                bucket.discard(attempt)
        attempt.replica = to_key
        if fallback:
            # src==dst (the collapse rung's local unpark) crossed no
            # wire: it must not read as a disaggregated handoff
            attempt.handoff_outcome = (
                "fallback" if to_key == from_key else "ok"
            )
        if _between is not None:
            _between()   # fault injection: kill-mid-migration schedules
        t = threading.Thread(
            target=self._run_attempt,
            args=(attempt, request, to_addr, to_key),
            kwargs={
                "import_payload": wire,
                "fallback": (from_key, from_addr) if fallback else None,
            },
            daemon=True,
        )
        t.start()
        if self.metrics is not None:
            self.metrics.inc("gateway_migrations_total", outcome="ok")
        if mspan is not None:
            mspan.end(
                outcome="ok", pages=len(wire.get("page_keys") or [])
            )
        return True

    # -- ReplicaClient -----------------------------------------------------
    def submit(self, replica_key: str, request) -> Attempt:
        attempt = Attempt(replica_key, request.request_id)
        attempt.request = request
        addr = self.endpoint_for(replica_key)
        with self._lock:
            stopped = self._stopped
        if addr is None or stopped:
            attempt.finish(AttemptResult(
                False, error=f"replica {replica_key} unreachable"
            ))
            return attempt
        with self._lock:
            self._inflight.setdefault(replica_key, set()).add(attempt)
        t = threading.Thread(
            target=self._run_attempt,
            args=(attempt, request, addr, replica_key),
            daemon=True,
        )
        t.start()
        return attempt

    def cancel(self, attempt: Attempt) -> None:
        attempt.cancelled = True
        # wire-level cancel FIRST (frees the replica's pages even if the
        # stream socket lingers), then tear the stream down locally
        threading.Thread(
            target=self._wire_cancel,
            args=(attempt.replica, attempt.request_id),
            daemon=True,
        ).start()
        self._abort(attempt, "cancelled")

    # -- internals ---------------------------------------------------------
    def _abort(self, attempt: Attempt, error: str) -> None:
        attempt.finish(AttemptResult(False, error=error))
        conn = getattr(attempt, "_stream_conn", None)
        if conn is not None:
            try:
                conn.close()  # unblocks the reader thread mid-read
            except OSError:
                pass

    def _wire_cancel(self, replica_key: str, request_id: str) -> None:
        addr = self.endpoint_for(replica_key)
        if addr is None:
            return
        conn = self._connect(addr, timeout=2.0)
        try:
            conn.request(
                "POST", "/v1/cancel",
                json.dumps({"request_id": request_id}),
                self._headers({"Content-Type": "application/json"}),
            )
            conn.getresponse().read()
        except OSError:
            pass  # the replica may already be gone; its death frees pages
        finally:
            conn.close()

    def _checkout(self, key: str, addr: str) -> http.client.HTTPConnection:
        with self._lock:
            pool = self._pool.get(key)
            if pool:
                return pool.pop()
        return self._connect(addr, timeout=self.timeout_s)

    def _checkin(self, key: str, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if not self._stopped:
                self._pool.setdefault(key, []).append(conn)
                return
        conn.close()

    def _settle(self, attempt: Attempt, replica_key: str) -> None:
        # keyed by the replica THIS reader served, not attempt.replica:
        # a migration re-homes the attempt to its target mid-flight, and
        # the source's reader settling afterwards must not evict it from
        # the target's bucket
        with self._lock:
            bucket = self._inflight.get(replica_key)
            if bucket is not None:
                bucket.discard(attempt)
                if not bucket:
                    self._inflight.pop(replica_key, None)

    def _deadline_of(self, request) -> Optional[float]:
        deadline_s = getattr(request, "deadline_s", None)
        if deadline_s is None:
            return None
        anchor = getattr(request, "enqueued_at", 0.0) or time.monotonic()
        return anchor + deadline_s

    def _rescue(self, attempt: Attempt, request, import_payload,
                fallback) -> bool:
        """The handoff fallback: the decode-side import refused or died
        BEFORE streaming — re-import the held payload into the SOURCE
        replica so the sequence resumes decode where it prefilled.
        Counted, never a request error.  Runs the continuation inline on
        this reader thread (fallback=None below: one rescue, no loop)."""
        if import_payload is None or fallback is None or attempt.done:
            return False
        fb_key, fb_addr = fallback
        with self._lock:
            bucket = self._inflight.get(attempt.replica)
            if bucket is not None:
                bucket.discard(attempt)
            self._inflight.setdefault(fb_key, set()).add(attempt)
        attempt.replica = fb_key
        attempt.handoff_outcome = "fallback"
        if self.metrics is not None:
            self.metrics.inc(
                "gateway_migrations_total", outcome="fallback"
            )
        self._run_attempt(
            attempt, request, fb_addr, fb_key,
            import_payload=import_payload,
        )
        return True

    def _run_attempt(self, attempt: Attempt, request, addr: str,
                     replica_key: str,
                     import_payload: Optional[dict] = None,
                     fallback: Optional[Tuple[str, str]] = None) -> None:
        """Reader thread: stream the attempt to completion.  The
        terminal event's span dicts are grafted into the gateway's trace
        BEFORE the attempt resolves, so the winner's tree is complete
        when the dispatcher records the result.  With
        ``import_payload``, the attempt is a migration CONTINUATION:
        POST /v1/import carries the exported payload and the stream
        resumes mid-sequence on the target replica; ``fallback``
        ((key, addr) of the SOURCE) re-imports there if the target
        refuses or dies before streaming."""
        conn = self._checkout(replica_key, addr)
        trace = getattr(request, "trace", None)
        if not isinstance(trace, SpanCtx):
            trace = None
        deadline = self._deadline_of(request)
        reusable = False
        streaming = False
        try:
            if import_payload is not None:
                path = "/v1/import"
                body = json.dumps({
                    "request_id": request.request_id,
                    "payload": import_payload,
                })
                attempt.handoff_wire_bytes = len(body)
            else:
                path = "/v1/submit"
                payload = {
                    "request_id": request.request_id,
                    "prompt": [int(t) for t in request.prompt],
                    "max_new_tokens": int(request.max_new_tokens),
                    "temperature": float(
                        getattr(request, "temperature", 0.0)
                    ),
                    "session": getattr(request, "session", None),
                }
                if getattr(request, "seed", None) is not None:
                    payload["seed"] = int(request.seed)
                wm = int(getattr(request, "resume_watermark", 0) or 0)
                if wm > 0:
                    # hedge/retry fast-forward: the replica emits only
                    # past the caller's delivered prefix; stream_base
                    # tells the relay where this attempt's deltas start
                    payload["watermark"] = wm
                    attempt.stream_base = wm
                if deadline is not None:
                    # remaining deadline rides the wire: the replica can
                    # refuse a DOOMED admission (one that aged past its
                    # budget in the serving loop's inbox) before burning
                    # prefill compute on it — the shed-before-work rule,
                    # enforced on both ends
                    payload["deadline_s"] = max(
                        0.0, deadline - time.monotonic()
                    )
                body = json.dumps(payload)
            headers = self._headers({"Content-Type": "application/json"})
            if trace is not None:
                headers["X-Trace-Id"] = trace.trace_id
                headers["X-Span-Id"] = str(trace.span_id)
            attempt._stream_conn = conn
            t_send = time.monotonic()
            conn.request("POST", path, body, headers)
            resp = conn.getresponse()
            if resp.status != 200:
                err = resp.read()[:200].decode(errors="replace")
                if import_payload is not None and self.metrics is not None:
                    self.metrics.inc(
                        "gateway_migrations_total", outcome="import_refused"
                    )
                if self._rescue(attempt, request, import_payload, fallback):
                    return
                attempt.finish(AttemptResult(
                    False, error=f"replica {replica_key} refused "
                    f"({resp.status}): {err}"
                ))
                return
            streaming = True
            reusable = self._read_stream(
                attempt, request, resp, trace, t_send, deadline
            )
        except socket.timeout:
            if not streaming and self._rescue(
                attempt, request, import_payload, fallback
            ):
                return
            self._wire_cancel(replica_key, request.request_id)
            attempt.finish(AttemptResult(
                False, error="attempt timed out on the wire"
            ))
        except (OSError, ValueError, AttributeError,
                http.client.HTTPException) as e:
            # AttributeError: http.client reading a connection that
            # cancel() closed under us (fp already torn down).
            # The rescue only fires pre-stream: once the target has
            # emitted tokens, a re-import would replay them — normal
            # failover owns that path.
            if not streaming and self._rescue(
                attempt, request, import_payload, fallback
            ):
                return
            attempt.finish(AttemptResult(
                False,
                error=f"replica {replica_key} connection failed: {e}",
            ))
        finally:
            attempt._stream_conn = None
            self._settle(attempt, replica_key)
            if reusable:
                self._checkin(replica_key, conn)
            else:
                conn.close()

    def _read_stream(self, attempt: Attempt, request, resp, trace,
                     t_send: float, deadline: Optional[float]) -> bool:
        """Parse SSE events off the response.  Returns True when the
        stream terminated cleanly (connection reusable)."""
        on_tokens = getattr(request, "on_tokens", None)
        tokens: List[int] = []
        event, data = "", ""
        terminal = None
        while True:
            if (terminal is None and deadline is not None
                    and time.monotonic() >= deadline):
                # per-attempt deadline: cancel ON THE WIRE so the
                # replica frees the sequence's pages now — an expired
                # attempt must not keep decoding server-side.  Not
                # enforced during the post-terminal drain-to-EOF: the
                # request already resolved, and a spurious cancel there
                # would only discard a cleanly-reusable connection
                self._wire_cancel(attempt.replica, request.request_id)
                attempt.finish(AttemptResult(
                    False, error="attempt deadline expired"
                ))
                return False
            line = resp.readline()
            if not line:
                if terminal is not None:
                    return True  # chunked terminator after the event
                attempt.finish(AttemptResult(
                    False,
                    error=f"replica {attempt.replica} closed mid-stream",
                ))
                return False
            line = line.strip().decode(errors="replace")
            if terminal is not None:
                continue  # drain to EOF for connection reuse
            if line.startswith(":"):
                continue  # keepalive ping
            if line.startswith("event:"):
                event = line[6:].strip()
                continue
            if line.startswith("data:"):
                data = line[5:].strip()
                continue
            if line:
                continue
            # blank line: dispatch the buffered event
            if not event:
                continue
            try:
                payload = json.loads(data) if data else {}
            except json.JSONDecodeError:
                payload = {}
            if event == "sealed":
                # non-terminal: the prompt's pages sealed on a
                # prefill-only replica — wake the dispatcher's handoff
                attempt.sealed.set()
            elif event == "tokens":
                delta = payload.get("tokens") or []
                tokens.extend(delta)
                if on_tokens is not None and delta:
                    try:
                        on_tokens(attempt, list(delta))
                    except Exception:  # noqa: BLE001 - sink is advisory
                        log.exception("on_tokens callback failed")
            elif event in ("done", "error"):
                terminal = event
                self._graft(trace, payload, t_send)
                if event == "done":
                    final = payload.get("tokens")
                    result = AttemptResult(
                        True,
                        tokens=list(final) if final is not None else tokens,
                    )
                    if attempt.finish(result) and result.ok:
                        with self._lock:
                            self.decodes[request.request_id] = (
                                self.decodes.get(request.request_id, 0) + 1
                            )
                elif str(payload.get("error", "")) == "migrated":
                    # the exporter detached this sequence.  Record that
                    # FIRST (migrate()'s export-failure path checks it:
                    # a lost /v1/export response must still resolve the
                    # attempt — see the flag handshake there), THEN
                    # decide: mid-migration the import continuation owns
                    # the attempt's resolution, so leave it unresolved
                    # (the exporter's spans were still grafted above and
                    # the drain below leaves the connection reusable);
                    # otherwise surface it as a plain error so failover
                    # re-dispatches cold.
                    attempt._migrated_terminal = True
                    if not attempt._migrating:
                        attempt.finish(AttemptResult(
                            False, error="migrated"
                        ))
                else:
                    attempt.finish(AttemptResult(
                        False, error=str(payload.get("error", "error"))
                    ))
            event, data = "", ""

    def _graft(self, trace, payload: dict, t_send: float) -> None:
        """Stitch the replica-side spans under the gateway's dispatch
        span.  The offset maps the replica's monotonic clock onto ours:
        anchored at send time, so the whole remote subtree lands inside
        the dispatch span's window (network time on either side only
        widens the containment margin)."""
        if trace is None:
            return
        spans = payload.get("spans") or []
        t_recv = payload.get("t_recv")
        if not spans or t_recv is None:
            return
        try:
            trace.tracer.graft(trace, spans, t_send - float(t_recv))
        except Exception:  # noqa: BLE001 - tracing must never break serving
            log.exception("span graft failed")
