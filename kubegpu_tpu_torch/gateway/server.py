"""The port's copy of the JAX package's ``gateway/server.py``.

Gateway HTTP frontend (the data-plane twin of scheduler/server.py).

Thin codec over ``gateway/core.py`` — every routing/admission/failover
behavior is testable without sockets; this module only translates HTTP:

    POST /v1/generate   {"prompt": [ints], "max_new_tokens": n,
                         "tenant": "...", "session": "...",
                         "temperature": t, "deadline_s": s,
                         "stream": bool}
        → 200 {"tokens": [...], "replica": "...", "attempts": n,
               "hedged": bool}
        → 200 text/event-stream when "stream": true — committed token
          batches relayed from the replica as ``tokens`` events, then a
          terminal ``done`` (the authoritative full result) or ``error``
          event; a caller that disconnects mid-stream cancels the
          request all the way down to the replica's page pool
        → 429 {"error": ...}   explicit backpressure (queue full)
        → 502 {"error": ...}   all attempts failed
        → 504 {"error": ...}   deadline exceeded
    GET  /healthz       liveness (the process serves)
    GET  /readyz        readiness (≥1 routable — live, not draining —
                        replica to route new admissions to)
    GET  /metrics       Prometheus text (TTFT/queue-wait histograms,
                        queue-depth/live-replica gauges)
    GET  /state         debug dump (replicas, queue, outcome counts)
    GET  /debug/trace   recent completed request span trees (admission
                        wait → route → dispatch → replica-side serve
                        phases) + per-replica serving-ledger rows;
                        ?n=K caps the trace count (default 32).  See
                        README "Observability" for a worked example
                        explaining a slow TTFT from this endpoint.

Run self-hosted on a fabricated cluster for demos/tests (no k8s, no cards):
    python -m kubegpu_tpu_torch.gateway.server --fake-cluster h100-8 --replicas 3

The port's ``--fake-cluster`` fabricates GPU hosts (the presets of the
port's ``scheduler.server.build_fake_cluster``: ``h100-1|2|4|8`` with an
optional ``Nx-`` prefix) and refuses the JAX package's TPU presets.
``--autoscale`` and its ``--autoscale-*`` flags parse as in the JAX
gateway, but the fleet controller they start is not in the port yet:
``--autoscale`` exits at start, before any listener opens.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from kubegpu_tpu_torch.gateway.core import Gateway, GatewayRequest
from kubegpu_tpu_torch.gateway.queue import AdmissionQueue
from kubegpu_tpu_torch.gateway.registry import ReplicaRegistry

log = logging.getLogger(__name__)

_STATUS_HTTP = {"ok": 200, "rejected": 429, "error": 502, "timeout": 504}


def make_handler(gateway: Gateway, registry: ReplicaRegistry):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _read_json(self) -> Optional[dict]:
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                return json.loads(raw) if raw else {}
            except (ValueError, json.JSONDecodeError):
                return None

        def _send(self, code: int, payload,
                  content_type="application/json") -> None:
            body = (
                json.dumps(payload).encode()
                if content_type == "application/json"
                else payload.encode()
            )
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if code == 429:
                # every 429 is RETRYABLE backpressure by contract —
                # queue-full, brownout shed, deadline shed-before-work —
                # and well-behaved clients honor Retry-After instead of
                # hammering a browned-out fleet
                self.send_header("Retry-After", "1")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            log.debug("http: " + fmt, *args)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, "ok", content_type="text/plain")
            elif self.path == "/readyz":
                # ready ⇔ THIS instance is accepting (dispatcher pool
                # up, not draining — a SIGTERM'd pod must drop out of
                # the Service while it finishes its in-flight streams)
                # AND at least one replica to route NEW work to AND a
                # data plane that can reach it; any gap means a gateway
                # in the Service would eat traffic into guaranteed 5xx.
                # ROUTABLE, not live: a fleet that is entirely DRAINING
                # still serves its in-flight streams but can admit
                # nothing — the load balancer must fast-fail instead of
                # feeding requests into deadline-exceeded
                if not gateway.accepting:
                    self._send(503, "draining" if gateway.draining
                               else "not accepting (no dispatcher pool)",
                               content_type="text/plain")
                elif not gateway.client.ready():
                    self._send(503, "data plane not wired "
                               "(no replica client)",
                               content_type="text/plain")
                elif registry.routable():
                    self._send(200, "ok", content_type="text/plain")
                else:
                    self._send(503, "no routable replicas",
                               content_type="text/plain")
            elif self.path == "/metrics":
                self._send(200, gateway.metrics.render(),
                           content_type="text/plain")
            elif self.path == "/state":
                self._send(200, _debug_state(gateway, registry))
            elif self.path.split("?", 1)[0] == "/debug/trace":
                self._send(200, _debug_trace(gateway, self.path))
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._send(404, {"error": f"no route {self.path}"})
                return
            body = self._read_json()
            if body is None:
                self._send(400, {"error": "malformed JSON body"})
                return
            try:
                request = GatewayRequest(
                    prompt=[int(t) for t in body.get("prompt") or []],
                    max_new_tokens=int(body.get("max_new_tokens", 0)),
                    tenant=str(body.get("tenant", "")),
                    session=body.get("session"),
                    temperature=float(body.get("temperature", 0.0)),
                    seed=(
                        int(body["seed"])
                        if body.get("seed") is not None else None
                    ),
                    deadline_s=(
                        float(body["deadline_s"])
                        if body.get("deadline_s") is not None else None
                    ),
                )
            except (TypeError, ValueError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            if not request.prompt:
                self._send(400, {"error": "bad request: empty prompt"})
                return
            if body.get("stream"):
                try:
                    resume = max(0, int(body.get("resume_watermark", 0)))
                except (TypeError, ValueError):
                    resume = 0
                if body.get("request_id"):
                    # a RESUMED stream keeps its identity: the sibling
                    # retry after a gateway crash re-submits the SAME
                    # request_id (replica-side duplicate-id eviction
                    # keeps at most one live stream tier-wide)
                    request.request_id = str(body["request_id"])
                self._stream_generate(request, resume=resume)
                return
            # blocking unary call: the handler thread IS the caller's
            # connection; backpressure resolves instantly, decode blocks
            # until the dispatcher delivers
            result = gateway.submit_and_wait(request)
            code = _STATUS_HTTP.get(result.status, 500)
            payload = {
                "request_id": result.request_id,
                "status": result.status,
            }
            if result.status == "ok":
                payload.update(
                    tokens=result.tokens, replica=result.replica,
                    attempts=result.attempts, hedged=result.hedged,
                )
            else:
                payload["error"] = result.error
            self._send(code, payload)

        # -- streaming pass-through ------------------------------------
        def _chunk(self, data: bytes) -> None:
            # the replica endpoint's framing helpers, shared so the two
            # SSE surfaces cannot drift apart
            from kubegpu_tpu_torch.gateway.dataplane import write_chunk

            write_chunk(self.wfile, data)

        def _stream_generate(self, request, resume: int = 0) -> None:
            """SSE pass-through: committed token batches relayed from
            the data plane as they stream off the replica, then the
            terminal result.  The done event's token list is
            AUTHORITATIVE.  GREEDY streams hedge: the StreamRelay dedups
            by absolute token index (greedy decode is deterministic, so
            a hedge twin's stream is the primary's), and the relay's
            emitted watermark rides down to the twin so it fast-forwards
            past tokens the caller already has — each token arrives
            exactly once whichever attempt supplies it.  SEED-PINNED
            sampled streams (temperature > 0 with a request seed) get
            the same treatment: position-keyed sample keys make every
            replica's stream byte-identical, so they hedge, dedup and
            resume exactly like greedy.  Only UNPINNED sampled streams
            keep the one-attempt pin: without a seed, replicas do not
            emit identical sampled streams.  A vanished caller fails the
            next write, which sets the request's abort event: the
            dispatcher cancels every in-flight attempt wire-level, so
            the replica frees the sequence's pages."""
            import queue as _queue

            from kubegpu_tpu_torch.gateway.core import StreamRelay
            from kubegpu_tpu_torch.gateway.dataplane import end_chunks, sse_event

            greedy = float(getattr(request, "temperature", 0.0)) == 0.0
            # deterministic = every replica reproduces the same stream:
            # greedy always; sampled when the request pins a seed
            deterministic = (
                greedy or getattr(request, "seed", None) is not None
            )
            # ``resume``: tokens the CALLER already holds — a client
            # resuming a crashed sibling gateway's stream passes its
            # received count as "resume_watermark", the relay skips
            # that prefix, and the dispatcher ships it down the wire so
            # the replica fast-forwards emission (deterministic streams
            # only; decode still runs from 0 and determinism keeps it
            # token-identical)
            relay = StreamRelay(gateway.metrics, dedup=deterministic,
                                base=resume if deterministic else 0)
            request.on_tokens = relay.on_tokens
            request.stream_watermark = relay.emitted
            request.abort = threading.Event()
            # unpinned sampled streams never hedge (incoherent twin
            # streams); greedy and seed-pinned streams hedge through
            # the relay's dedup
            request.no_hedge = not deterministic
            gateway.metrics.inc("gateway_stream_requests_total")
            pending = gateway.submit(request)
            # ONLY a refusal short-circuits to plain JSON (429): any
            # other instantly-resolved result (a fast completion racing
            # this check) must still stream its terminal event, tokens
            # included — the SSE contract the caller asked for
            if pending.wait(0.0) and pending.result().status == "rejected":
                result = pending.result()
                self._send(_STATUS_HTTP.get(result.status, 500), {
                    "request_id": result.request_id,
                    "status": result.status, "error": result.error,
                })
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                while not pending.wait(0.0):
                    try:
                        delta = relay.q.get(timeout=0.2)
                    except _queue.Empty:
                        self._chunk(b": ping\n\n")
                        continue
                    gateway.metrics.inc(
                        "gateway_stream_tokens_total", len(delta)
                    )
                    self._chunk(sse_event("tokens", {"tokens": delta}))
                # late deltas queued between the winner's resolution and
                # this check still belong to the caller's stream
                tail = relay.drain()
                if tail:
                    gateway.metrics.inc(
                        "gateway_stream_tokens_total", len(tail)
                    )
                    self._chunk(sse_event("tokens", {"tokens": tail}))
                result = pending.result()
                payload = {
                    "request_id": result.request_id,
                    "status": result.status,
                }
                if result.status == "ok":
                    payload.update(
                        tokens=result.tokens, replica=result.replica,
                        attempts=result.attempts, hedged=result.hedged,
                    )
                    event = "done"
                else:
                    payload["error"] = result.error
                    event = "error"
                self._chunk(sse_event(event, payload))
                end_chunks(self.wfile)
            except (BrokenPipeError, ConnectionResetError, OSError):
                # the caller vanished: propagate the cancel downstream
                # (dispatcher counts gateway_stream_disconnects_total)
                request.abort.set()
                self.close_connection = True

    return Handler


def _debug_state(gateway: Gateway, registry: ReplicaRegistry) -> dict:
    outcomes: dict = {}
    for r in gateway.results().values():
        outcomes[r.status] = outcomes.get(r.status, 0) + 1
    return {
        "replicas": [
            {
                "key": r.key, "group": r.group, "node": r.node,
                "slice": r.slice_id, "chips": sorted(map(list, r.coords)),
                "healthy": r.healthy, "reason": r.reason,
            }
            for r in registry.all()
        ],
        "queue_depth": gateway.queue.depth(),
        "in_flight": gateway.in_flight(),
        "outstanding": dict(gateway.dispatcher.outstanding),
        # the overload ladder rung the controller holds this instance at
        # (0 = none): operators see a browned-out gateway at a glance
        "brownout": gateway.brownout_level,
        "draining_replicas": sorted(registry.draining_keys()),
        "outcomes": outcomes,
        "completed_by_replica": dict(gateway.completed_by_replica),
        # each wired replica's advertised serving mesh (tensor-parallel
        # width; duck-typed off the data-plane client so third-party
        # clients without the surface degrade to {})
        "replica_mesh": (
            gateway.client.advertised()
            if hasattr(gateway.client, "advertised") else {}
        ),
    }


def _debug_trace(gateway: Gateway, path: str) -> dict:
    """The ``GET /debug/trace`` body: recent completed span trees
    (newest first) plus each reachable replica's per-iteration serving
    ledger — the one page that answers "where did that request's TTFT
    go" and "what is the pool doing" without touching the replica."""
    limit = 32
    if "?" in path:
        from urllib.parse import parse_qs

        qs = parse_qs(path.split("?", 1)[1])
        try:
            limit = max(1, int(qs.get("n", ["32"])[0]))
        except ValueError:
            pass
    tracer = gateway.tracer
    ledgers = getattr(gateway.client, "ledgers", None)
    return {
        "tracing": tracer is not None,
        "open_traces": tracer.open_count() if tracer is not None else 0,
        "evicted_traces": tracer.evicted if tracer is not None else 0,
        "traces": (
            tracer.dump_traces(limit=limit) if tracer is not None else []
        ),
        "ledgers": ledgers() if ledgers is not None else {},
    }


class _GatewayHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        log.debug("connection error from %s", client_address, exc_info=True)


class GatewayServer:
    """Owns the HTTP server + registry refresh loop + node/pod watches +
    the gateway dispatcher pool (the ExtenderServer shape)."""

    def __init__(
        self,
        gateway: Gateway,
        listen: Tuple[str, int] = ("127.0.0.1", 8600),
        refresh_interval_s: float = 10.0,
        watch: bool = True,
    ) -> None:
        self.gateway = gateway
        self.registry = gateway.registry
        self.httpd = _GatewayHTTPServer(
            listen, make_handler(gateway, self.registry)
        )
        self.refresh_interval_s = refresh_interval_s
        self.watch = watch
        self._stop = threading.Event()
        self._threads = []

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> None:
        self.registry.refresh()
        self.gateway.start()
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        r = threading.Thread(target=self._refresh_loop, daemon=True)
        r.start()
        self._threads.append(r)
        if self.watch:
            # event-driven drain: a chip death propagates the same cycle
            self._threads.extend(self.registry.start_watches(self._stop))

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.refresh_interval_s):
            try:
                self.registry.refresh()
            except Exception:  # noqa: BLE001
                log.exception("registry refresh failed; keeping stale set")

    def begin_graceful_shutdown(self, grace_s: float = 30.0,
                                done=None) -> None:
        """The SIGTERM path: flip /readyz to 503 and refuse new
        admissions NOW (``Gateway.begin_drain`` — the load balancer
        stops sending, racing submits get the retryable shutdown
        error), let in-flight requests — live streams included — finish
        within ``grace_s``, then stop the process.  ``done`` (an Event)
        is set after the final stop, so a caller blocked on it exits
        cleanly."""
        self.gateway.begin_drain()
        log.info("SIGTERM: draining (readyz=503, %.0fs grace)", grace_s)

        def _drain_then_stop():
            drained = self.gateway.drain(grace_s)
            log.info(
                "drain %s; stopping",
                "complete" if drained else f"timed out after {grace_s}s",
            )
            self.stop()
            if done is not None:
                done.set()

        t = threading.Thread(target=_drain_then_stop, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        close = getattr(self.registry.api, "close_watches", None)
        if close is not None:
            close()
        self.gateway.stop()
        self.httpd.shutdown()
        self.httpd.server_close()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _build_fake_serving_cluster(preset: str, replicas: int, group: str,
                                token_budget=None, speculate_k=None,
                                decode_page_cache="off", kv_dtype=None,
                                tp=1, priority=None):
    """Fabricated cluster of GPU hosts + scheduled decode replicas +
    SimBatcher-backed in-memory data plane: the full serving path with
    zero dependencies.  A TPU preset exits, as the port's extender
    refuses it."""
    from kubegpu_tpu_torch.gateway.client import InMemoryReplicaClient, SimBatcher
    from kubegpu_tpu_torch.scheduler import Scheduler
    from kubegpu_tpu_torch.scheduler.server import build_fake_cluster
    from kubegpu_tpu_torch.testing.fake_serving import schedule_decode_replicas

    api = build_fake_cluster(preset)
    sched = Scheduler(api)
    sched.cache.refresh()
    try:
        schedule_decode_replicas(
            api, sched, replicas, group, name_prefix=group,
            priority=priority,
        )
    except AssertionError as e:
        raise SystemExit(str(e))
    registry = ReplicaRegistry(api, group=group)
    # a realistic per-step decode latency: with instant decode the
    # outstanding counts never build and least-outstanding degenerates to
    # its name tiebreak — the demo should demonstrate load spreading
    client = InMemoryReplicaClient(
        batcher_factory=lambda key: SimBatcher(
            slots=8, token_budget=token_budget, speculate_k=speculate_k,
            decode_page_cache=decode_page_cache, kv_dtype=kv_dtype,
            tp=tp,
        ),
        step_delay_s=0.002,
    )
    registry.subscribe(client.sync_live)
    registry.refresh()
    return api, sched, registry, client


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--listen", default="127.0.0.1:8600")
    ap.add_argument(
        "--group", default="decode",
        help="serving group to route for (kubegpu-tpu/serving-group value)",
    )
    ap.add_argument(
        "--fake-cluster", metavar="PRESET",
        help="serve a fabricated in-memory cluster of GPU hosts + "
        "SimBatcher replicas (e.g. h100-8, 2x-h100-8) instead of "
        "connecting to a real API server",
    )
    ap.add_argument("--replicas", type=int, default=3,
                    help="replica count for --fake-cluster mode")
    ap.add_argument(
        "--replica-endpoint", action="append", default=None,
        metavar="HOST:PORT",
        help="repeatable: dispatch to these replica HTTP serving "
        "endpoints (models.worker --serve-http) over a fabricated "
        "registry instead of discovering pods from a cluster — the "
        "multi-process deployment smoke (make dryrun's "
        "dryrun_gateway_pods) and any no-k8s bring-up.  Endpoints map "
        "to fabricated replica keys in sorted order, identically in "
        "every gateway process, so N gateways over the same endpoint "
        "list route sessions identically",
    )
    ap.add_argument(
        "--session-store", default=None, metavar="URL",
        help="external session-KV store (python -m "
        "kubegpu_tpu_torch.gateway.sessionstore; deploy/session-store.yaml), "
        "e.g. http://session-store:8650 — sealed-KV failover insurance "
        "then survives THIS gateway pod's death, which is what makes "
        "deploy/gateway.yaml replicas: 2 a real deployment.  Store "
        "outages degrade sessions to cold prefill (counted as "
        "gateway_session_store_degraded_total), never request errors.  "
        "Default: in-process store (single-pod semantics)",
    )
    ap.add_argument(
        "--router", default="least-outstanding",
        choices=("least-outstanding", "consistent-hash", "affinity",
                 "prefix-locality"),
        help="routing policy: least-outstanding (default), "
        "consistent-hash (the tier policy — N gateway pods route every "
        "session identically with zero shared state; required for "
        "multi-gateway deployments), affinity (sticky per-instance "
        "pins), or prefix-locality (route by longest locally-cached "
        "prefix, consistent-hash fallback; requires --prefix-tier)",
    )
    ap.add_argument(
        "--prefix-tier", action="store_true",
        help="fleet-wide shared-prefix KV tier (gateway/prefixtier): "
        "sealed chains publish to the store keyed by cumulative "
        "content hash (popularity-weighted LRU, payload bytes "
        "refcounted/deduped); cold dispatch targets import the longest "
        "stored prefix before prefill, so a hot system prompt "
        "prefills ONCE fleet-wide.  Uses --session-store when given "
        "(the same store serves both key classes), else an in-process "
        "backend.  Tier outages degrade to counted cold prefill "
        "(gateway_prefix_tier_degraded_total), never request errors",
    )
    ap.add_argument(
        "--prefix-page", type=int, default=8,
        help="KV page size the prefix tier hashes prompts at — must "
        "match the replicas' --page-size or probes never hit",
    )
    ap.add_argument(
        "--drain-grace", type=float, default=30.0,
        help="SIGTERM grace: /readyz flips to 503 and new admissions "
        "refuse immediately; in-flight requests (live streams "
        "included) get this long to finish before the process exits",
    )
    ap.add_argument(
        "--autoscale", action="store_true",
        help="run the serving↔scheduling FleetController in this "
        "process (the fleet controller; not in the port yet: the flag "
        "exits at start, before any listener opens): reconcile ticks "
        "watch SLO "
        "pressure (admission backlog + TTFT, EWMA-smoothed with "
        "hysteresis/cooldowns) and reshape the fleet — scale-ups "
        "gang-schedule new serving pods through grpalloc, preempting "
        "batch jobs with checkpoint-and-requeue; scale-downs drain "
        "(KV migrates) before releasing chips; overload walks the "
        "brownout ladder instead of failing.  Run it on exactly ONE "
        "gateway instance of a deployment (a sidecar leader elector "
        "gates the flag; two controllers would race reshape "
        "decisions).  Works in-cluster and with --fake-cluster; "
        "incompatible with --replica-endpoint (no cluster to reshape)",
    )
    ap.add_argument("--autoscale-min", type=int, default=1,
                    help="replica floor for --autoscale")
    ap.add_argument("--autoscale-max", type=int, default=4,
                    help="replica ceiling for --autoscale")
    ap.add_argument(
        "--autoscale-queue-target", type=float, default=8.0,
        help="backlog (queued + in-flight) per replica the pressure "
        "signal normalizes against",
    )
    ap.add_argument(
        "--autoscale-ttft-target", type=float, default=0.5,
        help="TTFT SLO target (seconds) the pressure signal "
        "normalizes against",
    )
    ap.add_argument("--autoscale-interval", type=float, default=2.0,
                    help="seconds between reconcile ticks")
    ap.add_argument(
        "--autoscale-ratio", action="store_true",
        help="let the controller also steer the prefill:decode role "
        "RATIO (disaggregated serving): sustained TTFT pressure "
        "converts a flex replica to a dedicated prefill front-end, "
        "sustained ITL pressure converts it back, and a failing "
        "handoff path collapses the fleet to co-located serving "
        "until it clears",
    )
    ap.add_argument(
        "--autoscale-itl-target", type=float, default=0.05,
        help="--autoscale-ratio: inter-token-latency SLO target "
        "(seconds) — the decode-side pressure term",
    )
    ap.add_argument(
        "--autoscale-chips-per-replica", type=int, default=1,
        help="chip request stamped on scale-up pods",
    )
    ap.add_argument(
        "--autoscale-priority", type=int, default=100,
        help="priority of scale-up serving pods — must out-rank the "
        "batch jobs they may preempt, and EXISTING serving replicas "
        "must be deployed at it too (a replica below it reads as a "
        "preemption victim)",
    )
    ap.add_argument(
        "--autoscale-requeue-file", default=None, metavar="PATH",
        help="durable write-ahead requeue ledger (a PVC path): a "
        "controller restarted between a preemption's eviction and its "
        "checkpoint-and-requeue replays the snapshot instead of "
        "losing the batch job.  Default: in-memory (single-process "
        "lifetimes)",
    )
    ap.add_argument(
        "--autoscale-shed-tenants", default="", metavar="T1,T2",
        help="lowest-priority tenants the brownout ladder's rung 3 "
        "sheds first (comma list)",
    )
    ap.add_argument(
        "--sim-data-plane", action="store_true",
        help="in-cluster mode: wire an in-process SimBatcher data "
        "plane instead of the real HTTP one (fabricated tokens — "
        "cluster smoke only)",
    )
    ap.add_argument(
        "--replica-port", type=int, default=8700,
        help="in-cluster mode: the port each replica pod's HTTP serving "
        "endpoint listens on (models.worker --serve-http).  The gateway "
        "dispatches to podIP:port, health-checks replicas over it "
        "(/readyz goes live from real replica health), and propagates "
        "trace context across the wire",
    )
    ap.add_argument(
        "--token-budget", type=int, default=None,
        help="per-step token budget for replica batchers: bounds the "
        "rows (decode tokens + prefill chunk rows) one serving "
        "iteration processes.  Paged/dense batchers pack multi-"
        "admission prefill under it; the SimBatcher data planes here "
        "model it as a per-step advance cap.  Default: unbounded",
    )
    ap.add_argument(
        "--speculate-k", type=int, default=None,
        help="draft-then-verify speculation depth for replica batchers "
        "(OFF by default).  Requires --draft-checkpoint: greedy "
        "speculative decode is lossless for any draft, but without "
        "trained draft weights it is pure overhead.  Real paged/dense "
        "batchers verify k+1-token windows per program and bill k+1 "
        "budget rows per speculative slot; the SimBatcher data planes "
        "here model exactly that accounting",
    )
    from kubegpu_tpu_torch.gateway.client import (
        DECODE_PAGE_CACHE_POLICIES,
        KV_DTYPES,
    )

    ap.add_argument(
        "--decode-page-cache", default="off",
        choices=list(DECODE_PAGE_CACHE_POLICIES),
        help="replica batchers' session-KV-reuse policy: seal retired "
        "sequences' DECODE-produced pages into the shared prefix cache "
        "so a session's turn 2 (same session id — the affinity router "
        "pins it to the replica holding the pages) skips re-prefilling "
        "turn 1's output.  off = prompt pages only (default); fp32 = "
        "share only at float32 serving precision (property-tested "
        "greedy-token-identical); all = any dtype (bf16 may flip "
        "near-tie argmaxes — measured in bench.py serving_multiturn).  "
        "Consumed replica-side by the real paged batchers; the "
        "in-process SimBatcher planes here only validate the contract",
    )
    ap.add_argument(
        "--kv-dtype", default=None, choices=list(KV_DTYPES),
        help="replica batchers' KV page-pool STORAGE format: int8 = "
        "per-page per-head-scaled int8 pages (half the resting pool "
        "bytes, ~2x the pool rows per byte budget, half the migration "
        "wire bytes per page; agreement/margins measured by bench.py "
        "serving_quantized_pool), bf16/fp32 = explicit full width "
        "(must match the serving dtype).  Consumed replica-side by the "
        "real paged batchers (models.worker --kv-dtype); the in-process "
        "SimBatcher planes here validate the contract, advertise the "
        "format, and refuse dtype-mismatched migrations like the real "
        "geometry check.  Default: full width at the serving dtype",
    )
    ap.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel width of each serving replica's mesh: a "
        "TP replica shards its KV page pool / prefill station / draft "
        "ring on heads over a 'model' mesh (models/worker.py --tp on "
        "the paged path), serving tp x the pool rows per replica for "
        "the same per-device HBM.  Consumed replica-side; the gateway "
        "validates the contract, and wired replicas advertise their "
        "width at /state (replica_mesh).  Default 1 (no TP)",
    )
    ap.add_argument(
        "--draft-checkpoint", default=None, metavar="DIR",
        help="orbax checkpoint directory holding the draft model's "
        "weights; required when --speculate-k is set and must exist.  "
        "Consumed REPLICA-side (models.serving.load_draft_checkpoint / "
        "worker --draft-ckpt-dir) once a real data plane is wired; the "
        "in-process SimBatcher planes here model only the multi-token "
        "step and its k+1-row budget accounting",
    )
    ap.add_argument(
        "--replica-tls-ca", default=None, metavar="PEM",
        help="CA bundle to verify replica serving endpoints against: "
        "the data plane dispatches over HTTPS instead of plain HTTP "
        "(replicas run models.worker --serve-http-tls-cert/key).  "
        "Omit for plain HTTP (loopback / single-tenant)",
    )
    ap.add_argument(
        "--replica-auth-token-file", default=None, metavar="FILE",
        help="bearer token (file contents) sent on every replica "
        "data-plane request; replicas started with "
        "--serve-http-auth-token-file gate /v1/* on it",
    )
    ap.add_argument("--queue-capacity", type=int, default=256)
    ap.add_argument("--per-tenant-cap", type=int, default=None)
    ap.add_argument("--deadline", type=float, default=30.0,
                    help="per-request end-to-end deadline (seconds)")
    ap.add_argument("--hedge-after", type=float, default=1.0,
                    help="straggler threshold before a hedged dispatch")
    ap.add_argument("--dispatchers", type=int, default=8)
    ap.add_argument("--refresh-interval", type=float, default=10.0)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.token_budget is not None and args.token_budget <= 0:
        ap.error(f"--token-budget must be positive, got {args.token_budget}")
    if args.tp < 1:
        ap.error(f"--tp must be >= 1, got {args.tp}")
    if args.speculate_k is not None:
        # the --token-budget pattern: malformed serving knobs die at
        # argparse time, never mid-serve-loop
        if args.speculate_k < 1:
            ap.error(
                f"--speculate-k must be >= 1, got {args.speculate_k}"
            )
        if args.draft_checkpoint is None:
            ap.error(
                "--speculate-k requires --draft-checkpoint: greedy "
                "speculation is lossless for any draft, but an untrained "
                "draft is pure overhead — point at trained draft weights"
            )
        if not os.path.isdir(args.draft_checkpoint):
            ap.error(
                f"--draft-checkpoint {args.draft_checkpoint!r} is not a "
                "directory: the draft restore would fail replica-side — "
                "a typo'd path must die here, not after deployment"
            )
    if args.autoscale:
        # the fleet controller (the JAX package's controller/) is not in
        # the port yet: refuse the flag before any listener opens rather
        # than serve without the controller it asks for
        raise SystemExit(
            "--autoscale: the fleet controller is not in the port yet; "
            "run the gateway without --autoscale"
        )
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    if args.replica_endpoint:
        # explicit-endpoint mode: a fabricated registry (the shared
        # fake-cluster bring-up, so replica keys are DETERMINISTIC —
        # every gateway process over the same endpoint list agrees) in
        # front of REAL replica HTTP serving endpoints.  This is the
        # multi-process deployment smoke: N gateway processes + one
        # worker + one session store, no k8s.
        from kubegpu_tpu_torch.gateway.dataplane import HttpReplicaClient
        from kubegpu_tpu_torch.testing.fake_serving import (
            build_fake_serving_stack,
        )

        # SORTED endpoints: replica keys are assigned in sorted order,
        # so the key→endpoint binding must not depend on CLI argument
        # order — two gateways given the same endpoints in different
        # order would otherwise route one session to different workers
        endpoints = sorted(args.replica_endpoint)
        stack = build_fake_serving_stack(
            len(endpoints), group=args.group
        )
        registry = stack.registry
        client = HttpReplicaClient()
        registry.refresh()
        keys = sorted(r.key for r in registry.all())
        for key, addr in zip(keys, endpoints):
            client.set_endpoint(key, addr)
        # real data-plane health: the fabricated annotations say every
        # replica is fine forever; the probe is what drains a replica
        # whose serving process died (and re-admits it after a cold
        # restart on the same endpoint)
        registry.probe = client.probe
        registry.subscribe(client.sync_live)
        registry.refresh()
        log.info(
            "explicit-endpoint data plane: %s",
            dict(zip(keys, endpoints)),
        )
    elif args.fake_cluster:
        _, _, registry, client = _build_fake_serving_cluster(
            args.fake_cluster, args.replicas, args.group,
            token_budget=args.token_budget,
            speculate_k=args.speculate_k,
            decode_page_cache=args.decode_page_cache,
            kv_dtype=args.kv_dtype, tp=args.tp,
        )
    else:
        from kubegpu_tpu_torch.utils.apiserver import KubeApiServer

        registry = ReplicaRegistry(KubeApiServer(), group=args.group)
        from kubegpu_tpu_torch.gateway.client import InMemoryReplicaClient

        if not args.sim_data_plane:
            # the REAL in-cluster data plane: stream from each replica
            # pod's HTTP serving endpoint (models.worker --serve-http) at
            # its discovered podIP.  The registry additionally
            # health-checks every replica's /healthz each refresh, so
            # /readyz is live serving capacity, not just annotation
            # bookkeeping — the 503 fail-safe this flag-day retires.
            from kubegpu_tpu_torch.gateway.dataplane import HttpReplicaClient

            def _resolve(key, _port=args.replica_port):
                # one snapshot read: the refresh thread swaps the
                # registry table concurrently
                info = registry.get(key)
                if info is None or not info.addr:
                    return None
                return f"{info.addr}:{_port}"

            replica_token = None
            if args.replica_auth_token_file:
                with open(args.replica_auth_token_file) as f:
                    replica_token = f.read().strip()
            client = HttpReplicaClient(
                resolver=_resolve,
                default_port=args.replica_port,
                tls_ca=args.replica_tls_ca,
                auth_token=replica_token,
            )
            registry.probe = client.probe
            registry.subscribe(client.sync_live)
            log.info(
                "HTTP data plane: dispatching to replica pods on port "
                "%d (podIP discovery + /healthz probes)",
                args.replica_port,
            )
        else:
            # OPT-IN in-process data plane (cluster smoke tests): every
            # replica the registry discovers gets a worker driving a
            # local SimBatcher, so the gateway is live end to end and
            # /readyz goes 200 the moment a replica is wired — 503
            # again only when the registry drains to zero.  Tokens are
            # fabricated; never expose this to real clients.
            from kubegpu_tpu_torch.gateway.client import SimBatcher

            client = InMemoryReplicaClient(
                batcher_factory=lambda key: SimBatcher(
                    slots=8, token_budget=args.token_budget,
                    speculate_k=args.speculate_k,
                    decode_page_cache=args.decode_page_cache,
                    kv_dtype=args.kv_dtype,
                    tp=args.tp,
                ),
                step_delay_s=0.002,
            )
            registry.subscribe(client.sync_live)
            log.warning(
                "--sim-data-plane: serving FABRICATED tokens from "
                "in-process SimBatchers — cluster smoke only"
            )
    from kubegpu_tpu_torch.gateway.failover import FailoverPolicy, SessionKVStore
    from kubegpu_tpu_torch.utils.metrics import default_metrics

    session_store = None
    if args.session_store:
        # the external insurance store: sealed-KV captures survive this
        # pod's death.  Short per-op deadlines + breaker: with the
        # store down, every session degrades to cold prefill at full
        # speed (one fast-fail per op, never a connect timeout per
        # request)
        from kubegpu_tpu_torch.gateway.sessionstore import HttpStoreClient

        session_store = SessionKVStore(
            backend=HttpStoreClient(
                args.session_store, metrics=default_metrics
            ),
            metrics=default_metrics,
        )
        log.info("external session store: %s", args.session_store)

    prefix_tier = None
    if args.prefix_tier:
        # the SAME external store serves both key classes (session
        # leases + prefix chains) when --session-store is given; else
        # an in-process backend (single-pod semantics)
        from kubegpu_tpu_torch.gateway.prefixtier import PrefixTier

        if args.session_store:
            from kubegpu_tpu_torch.gateway.sessionstore import HttpStoreClient

            tier_backend = HttpStoreClient(
                args.session_store, metrics=default_metrics
            )
        else:
            from kubegpu_tpu_torch.gateway.sessionstore import (
                InProcessStoreBackend,
            )

            tier_backend = InProcessStoreBackend()
        prefix_tier = PrefixTier(
            backend=tier_backend, page=args.prefix_page,
            metrics=default_metrics,
        )
        log.info(
            "prefix tier: page=%d store=%s", args.prefix_page,
            args.session_store or "in-process",
        )

    router = None
    if args.router == "consistent-hash":
        from kubegpu_tpu_torch.gateway.router import ConsistentHashRouter

        router = ConsistentHashRouter()
    elif args.router == "affinity":
        from kubegpu_tpu_torch.gateway.router import SessionAffinityRouter

        router = SessionAffinityRouter()
    elif args.router == "prefix-locality":
        if prefix_tier is None:
            raise SystemExit("--router prefix-locality needs --prefix-tier")
        from kubegpu_tpu_torch.gateway.router import PrefixLocalityRouter

        router = PrefixLocalityRouter(prefix_tier)

    gateway = Gateway(
        registry, client,
        router=router,
        queue=AdmissionQueue(args.queue_capacity, args.per_tenant_cap),
        policy=FailoverPolicy(
            deadline_s=args.deadline, hedge_after_s=args.hedge_after
        ),
        dispatchers=args.dispatchers,
        session_store=session_store,
        prefix_tier=prefix_tier,
    )
    host, _, port = args.listen.rpartition(":")
    server = GatewayServer(
        gateway,
        listen=(host or "127.0.0.1", int(port)),
        refresh_interval_s=args.refresh_interval,
    )
    server.start()
    log.info("gateway listening on http://%s:%d", *server.address)
    # a parseable announce line (the worker's REPLICA_HTTP_SERVING
    # shape): subprocess harnesses bind port 0 and read the real one
    print(f"GATEWAY_HTTP_SERVING port={server.address[1]}", flush=True)
    import signal

    shutdown = threading.Event()
    # SIGTERM = GRACEFUL: readyz 503 + refuse new admissions, finish
    # in-flight streams within --drain-grace, then exit 0 — the
    # per-instance lifecycle a load balancer can act on
    signal.signal(
        signal.SIGTERM,
        lambda *_: server.begin_graceful_shutdown(
            args.drain_grace, done=shutdown
        ),
    )
    try:
        # wait in a timeout LOOP: a bare Event.wait() parks the main
        # thread in an uninterruptible lock acquire and the SIGTERM
        # handler never runs — the graceful drain needs the main thread
        # to keep servicing signals
        while not shutdown.wait(0.2):
            pass
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
