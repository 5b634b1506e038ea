"""The replica side of the serving data plane: the port's own copy of the
replica half of the JAX package's ``gateway/dataplane.py``, wire schema
byte for byte, so an unmodified JAX gateway (``HttpReplicaClient`` +
``Gateway``) fronts a torch replica as it fronts a JAX one.

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
    GET  /v1/state    the serving contract: tp, role, slots, sealing
          policy, active streams, the batcher's ``stats``, the prefix
          cache economy, ``kv_dtype`` and the page economy of the last
          ledger row; ``?ledger=K`` adds the last K ledger rows.
    GET  /healthz     liveness ("ok"); 503 once the serving loop has
          failed.
    GET  /metrics     Prometheus text (``replica_http_*`` plus whatever
          the batcher observed into the shared registry).

The migration verbs (``POST /v1/export``, ``/v1/import``, ``/v1/role``)
answer 501 naming the migration slice, which brings them with the KV
wire codec; the JAX client reads a non-200 export or role answer as "no
payload" or "not flipped".  The role stays ``"flex"``.

A batcher error on the serving thread is not carried past: the loop
ends every stream with an ``error`` event naming it, refuses new
submits, and ``/healthz`` turns 503.  The serving thread runs on the
batcher's device and stream (``batcher.stream``), which the batcher
captured where it was built.
"""

from __future__ import annotations

import hmac
import json
import logging
import queue
import ssl
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kubegpu_tpu_torch.gateway.client import (
    _sniff_takes,
    _sniff_takes_trace,
    sim_stream_seed,
)
from kubegpu_tpu_torch.models.paging import MIGRATION_SLICE
from kubegpu_tpu_torch.utils.metrics import Metrics
from kubegpu_tpu_torch.utils.tracing import SpanCtx, Tracer

log = logging.getLogger(__name__)

# SSE keepalive cadence: a stream with no token progress writes a ping
# comment this often, so a vanished client is detected within one frame
PING_INTERVAL_S = 0.2


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
        torch.cuda.set_device(stream.device)
        torch.cuda.set_stream(stream)


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
    its blocking token readback) runs outside the loop's lock."""

    role = "flex"

    def __init__(self, batcher, metrics: Optional[Metrics] = None,
                 tracer: Optional[Tracer] = None,
                 step_delay_s: float = 0.0) -> None:
        self.batcher = batcher
        self.metrics = metrics
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
            body = json.dumps(payload).encode()
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
            if self.path in ("/v1/export", "/v1/import", "/v1/role"):
                verb = self.path[len("/v1/"):]
                if metrics is not None:
                    metrics.inc("replica_http_requests_total", verb=verb)
                # the body is read so a pooling client's next request
                # parses cleanly off this connection
                self._read_json()
                self._send_json(501, {
                    "error": f"POST {self.path} is not ported yet: it "
                             f"arrives with {MIGRATION_SLICE}",
                })
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

        def _serve_stream(self, st: _Stream) -> None:
            """The chunked SSE stream of one submit; disconnect ⇒ cancel
            pinned to THIS stream object."""
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
    behind a bearer token."""

    def __init__(self, batcher, listen: Tuple[str, int] = ("127.0.0.1", 0),
                 metrics: Optional[Metrics] = None,
                 tracer: Optional[Tracer] = None,
                 step_delay_s: float = 0.0,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 auth_token: Optional[str] = None) -> None:
        if bool(tls_cert) != bool(tls_key):
            # checked before anything binds a socket, so the raise leaks
            # nothing
            raise ValueError(
                "tls_cert and tls_key must be given together"
            )
        self.metrics = metrics if metrics is not None else Metrics()
        self.loop = ReplicaServingLoop(
            batcher, metrics=self.metrics, tracer=tracer,
            step_delay_s=step_delay_s,
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
