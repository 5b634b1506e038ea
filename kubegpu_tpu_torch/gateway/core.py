"""The port's copy of the JAX package's ``gateway/core.py``.

Gateway core: admit → route → dispatch → deliver, no sockets.

The cluster front door as pure orchestration (the scheduler split applied
to the data plane: this module is to ``gateway/server.py`` what
``scheduler/core.py`` is to ``scheduler/server.py``).  A request's life:

    submit() ── bounded AdmissionQueue (QueueFull → "rejected", HTTP 429)
             ── dispatcher thread picks it up (queue-wait histogram)
             ── Dispatcher drives route → attempt → hedge/retry (failover)
             ── exactly-once result recording (duplicate deliveries from
                hedge races are counted and DROPPED, never surfaced)

Every admitted request reaches exactly one terminal result — "ok",
"error" or "timeout" — and a refused one is rejected explicitly at
submission.  That accounting IS the soak invariant I5; the gateway
enforces it structurally (single-writer result slot) rather than hoping
the failover logic never races.

Latency metrics: responses are unary (the ReplicaClient returns the full
completion), so time-to-first-token and time-to-last-token coincide;
``gateway_ttft_seconds`` records enqueue → response.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubegpu_tpu_torch.gateway.client import ReplicaClient
from kubegpu_tpu_torch.gateway.failover import (
    Dispatcher,
    FailoverPolicy,
    SessionKVStore,
)
from kubegpu_tpu_torch.gateway.queue import AdmissionQueue, QueueClosed, QueueFull
from kubegpu_tpu_torch.gateway.registry import ReplicaRegistry
from kubegpu_tpu_torch.gateway.router import LeastOutstandingRouter, Router
from kubegpu_tpu_torch.utils.metrics import Metrics, default_metrics
from kubegpu_tpu_torch.utils.tracing import Tracer

log = logging.getLogger(__name__)


@dataclass
class GatewayRequest:
    prompt: list
    max_new_tokens: int
    request_id: str = ""
    tenant: str = ""
    session: Optional[str] = None
    temperature: float = 0.0
    # seed-pinned sampling: replicas derive sample keys from
    # (seed, absolute token position) — any replica/slot/batch/restart
    # reproduces the same stream, so hedging, resume dedup, migration
    # and disaggregated handoff stay sound for sampled traffic
    seed: Optional[int] = None
    deadline_s: Optional[float] = None   # per-request override
    enqueued_at: float = 0.0             # stamped by submit()
    # runtime trace context (utils.tracing.SpanCtx), stamped by submit()
    # when the gateway traces; carried down through queue -> dispatch ->
    # replica batcher so the whole request is ONE span tree
    trace: Optional[object] = field(default=None, repr=False, compare=False)
    # streaming sink: a data-plane client that streams (HttpReplicaClient)
    # calls on_tokens(attempt, delta) for every committed token batch —
    # the gateway's SSE pass-through feeds its caller from this.  The
    # terminal result's token list remains authoritative (a hedge's
    # winner may differ from the attempt that streamed).
    on_tokens: Optional[object] = field(default=None, repr=False,
                                        compare=False)
    # caller-abort signal (threading.Event): set when the downstream
    # client vanished mid-stream; the dispatcher cancels every in-flight
    # attempt (wire-level, pages freed replica-side) and resolves the
    # request with an explicit error
    abort: Optional[object] = field(default=None, repr=False, compare=False)
    # streaming requests never hedge: one caller follows one attempt's
    # stream (retries still re-dispatch a failed one)
    no_hedge: bool = field(default=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        if not self.request_id:
            self.request_id = uuid.uuid4().hex


@dataclass
class GatewayResult:
    request_id: str
    status: str                          # ok | rejected | error | timeout
    tokens: List[int] = field(default_factory=list)
    replica: str = ""
    error: str = ""
    attempts: int = 0
    hedged: bool = False
    queue_wait_s: float = 0.0
    total_s: float = 0.0


class PendingRequest:
    """Caller-side handle: resolves exactly once."""

    def __init__(self, request_id: str) -> None:
        self.request_id = request_id
        self._done = threading.Event()
        self._result: Optional[GatewayResult] = None
        self._trace = None  # root SpanCtx; closed by Gateway._record
        self._tenant = ""   # stamped by submit; keys the quota release

    def _resolve(self, result: GatewayResult) -> None:
        self._result = result
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self) -> Optional[GatewayResult]:
        return self._result


class StreamRelay:
    """Token-prefix-dedup fan-in for streaming delivery: every attempt's
    ``on_tokens`` deltas flow through one relay that forwards each token
    INDEX exactly once, whichever attempt supplies it first.

    This is what makes hedged STREAMING sound: greedy decode is
    deterministic, so a hedge twin's stream is byte-identical to the
    primary's — the relay tracks a global emitted watermark and slices
    every delta against it, so the caller's stream never duplicates a
    token and never gaps, no matter how the two streams interleave (or
    which one wins the terminal result).  The same watermark is what a
    hedge/retry ships to the replica (``resume_watermark``) so the twin
    fast-forwards its EMISSION past tokens the caller already has; an
    attempt that was fast-forwarded declares its start offset in
    ``attempt.stream_base``.

    ``dedup=False`` is the UNPINNED-sampled mode (temperature > 0 with
    no request seed: replicas do NOT emit identical streams, so mixing
    them would be incoherent): only the first attempt to deliver a
    delta may stream — the pre-tier behavior — and the terminal result
    stays authoritative.  Seed-PINNED sampled requests keep
    ``dedup=True``: position-keyed sample keys make every replica's
    stream byte-identical, the same invariant greedy gets for free.
    """

    def __init__(self, metrics: Optional[Metrics] = None,
                 dedup: bool = True, base: int = 0) -> None:
        import queue as _queue

        self.metrics = metrics
        self.dedup = dedup
        self.q: "_queue.Queue[list]" = _queue.Queue()
        self._lock = threading.Lock()
        # keyed by the ATTEMPT OBJECT (identity hash), not id(): keeping
        # the attempt referenced means a dead attempt's address can
        # never be recycled into a new attempt that would inherit its
        # position instead of its own stream_base.  Bounded by the
        # attempts of one request.
        self._positions: Dict[object, int] = {}  # attempt -> abs end
        # ``base``: tokens the CALLER already holds — a stream resumed
        # on a sibling gateway after its home died starts its relay at
        # the caller-supplied resume watermark, so the dispatcher ships
        # it down the wire and dedup skips the delivered prefix
        self._emitted = int(base)
        self._pinned: Optional[object] = None  # dedup=False: the streamer

    def on_tokens(self, attempt, delta) -> None:
        """Deltas enqueue UNDER the lock: the dedup watermark decides
        order, so the put must be atomic with it — two attempts racing
        the queue after releasing the lock could deliver the caller's
        stream out of order despite each token arriving exactly once."""
        if not delta:
            return
        with self._lock:
            if not self.dedup:
                if self._pinned is None:
                    self._pinned = attempt
                if self._pinned is not attempt:
                    return
                self._emitted += len(delta)
                self.q.put(list(delta))
                return
            start = self._positions.get(
                attempt, int(getattr(attempt, "stream_base", 0) or 0)
            )
            end = start + len(delta)
            self._positions[attempt] = end
            if end <= self._emitted:
                # a slower twin re-delivering tokens the caller has:
                # drop, count — this is the "zero double-served" half
                if self.metrics is not None:
                    self.metrics.inc(
                        "gateway_stream_dedup_tokens_total", len(delta)
                    )
                return
            fresh = list(delta[max(self._emitted - start, 0):])
            dropped = len(delta) - len(fresh)
            if dropped and self.metrics is not None:
                self.metrics.inc(
                    "gateway_stream_dedup_tokens_total", dropped
                )
            self._emitted = end
            self.q.put(fresh)

    def emitted(self) -> int:
        """Tokens delivered so far — the resume watermark a hedge, a
        retry, or a sibling-gateway failover carries so the replica
        fast-forwards emission past them."""
        with self._lock:
            return self._emitted

    def drain(self) -> List[int]:
        """Everything queued right now (non-blocking), flattened."""
        import queue as _queue

        out: List[int] = []
        while True:
            try:
                out.extend(self.q.get_nowait())
            except _queue.Empty:
                return out


class Gateway:
    def __init__(
        self,
        registry: ReplicaRegistry,
        client: ReplicaClient,
        router: Optional[Router] = None,
        queue: Optional[AdmissionQueue] = None,
        policy: Optional[FailoverPolicy] = None,
        metrics: Optional[Metrics] = None,
        dispatchers: int = 4,
        max_results: int = 65536,
        tracer: Optional[Tracer] = None,
        trace: bool = True,
        session_store: Optional[SessionKVStore] = None,
        prefix_tier=None,
        gateway_id: str = "",
    ) -> None:
        self.registry = registry
        self.client = client
        self.queue = queue or AdmissionQueue()
        self.metrics = metrics or default_metrics
        # the tier's name for this instance (rides trace roots and drain
        # stats); empty for a standalone gateway
        self.gateway_id = gateway_id
        # request tracing is ON by default (bounded ring, a handful of
        # dict ops per request): every request yields one span tree —
        # admission_wait / route / dispatch / replica-side serve phases
        # — served at /debug/trace.  trace=False opts out entirely.
        self.tracer = tracer if tracer is not None else (
            Tracer() if trace else None
        )
        # a metrics-capable router (SessionAffinityRouter's repin
        # counter) that wasn't given its own registry reports into the
        # gateway's, so /metrics shows KV-loss re-pins next to the
        # serve_* histograms the replica batchers feed
        if router is not None and getattr(router, "metrics", False) is None:
            router.metrics = self.metrics
        # sealed-session KV insurance: completed sessionful turns are
        # recorded (and, when the serving replica seals decode pages,
        # eagerly exported ASYNCHRONOUSLY) so a later replica death or
        # drain re-pins the session WITH its KV — the dispatcher
        # restores the payload into the new target before the turn-2
        # attempt opens.  A tier passes ONE shared store into all its
        # gateways; a multi-process deployment passes a store backed by
        # the external StoreServer (gateway/sessionstore.py), which is
        # what makes the insurance survive THIS pod's death.
        self.session_store = session_store or SessionKVStore(
            metrics=self.metrics
        )
        self._seals_cache: Dict[str, bool] = {}
        # fleet-wide shared-prefix tier (gateway/prefixtier.PrefixTier):
        # sealed chains from ok completions publish to the store under
        # their content hash, and cold dispatch targets import the
        # longest stored prefix before prefill.  Optional — None keeps
        # the pre-tier behavior exactly.  A GatewayTier passes ONE
        # shared tier into all its gateways, same as the session store.
        self.prefix_tier = prefix_tier
        if prefix_tier is not None and getattr(
            prefix_tier, "metrics", False
        ) is None:
            prefix_tier.metrics = self.metrics
        self.dispatcher = Dispatcher(
            client,
            router or LeastOutstandingRouter(),
            policy or FailoverPolicy(),
            metrics=self.metrics,
            session_store=self.session_store,
            prefix_tier=self.prefix_tier,
        )
        self.n_dispatchers = dispatchers
        self._stop = threading.Event()
        # DRAINING (graceful shutdown, SIGTERM): new admissions refuse
        # with the retryable shutdown error, in-flight work finishes,
        # /readyz reports 503 so the load balancer stops sending —
        # distinct from _stop (the dispatchers keep running until the
        # drain completes)
        self._draining = threading.Event()
        # overload BROWNOUT ladder (the fleet controller's degrade-don't-
        # fail surface, applied when capacity cannot arrive in time):
        #   0 none; 1 hedging disabled; 2 + speculation shrunk;
        #   3 + lowest-priority/over-quota tenants shed with retryable
        #   429s, every shed counted in gateway_shed_total{reason}
        self._brownout_level = 0
        self._shed_tenants: frozenset = frozenset()
        # tenant -> outstanding (submitted, not yet terminal): the
        # over-quota shed rule's input, maintained under _lock
        self._tenant_outstanding: Dict[str, int] = {}
        self._started = False
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._pending: Dict[str, PendingRequest] = {}
        # requests currently INSIDE a dispatcher thread (dequeued, not
        # yet terminal), keyed by id: kill() sets their abort events so
        # a dying gateway's in-flight attempts cancel wire-level — the
        # in-process analog of a crashed pod's sockets closing
        self._live_requests: Dict[str, GatewayRequest] = {}
        # FIFO-bounded: a long-lived gateway must not retain every result
        # (token lists included) for the life of the process
        self._results: "OrderedDict[str, GatewayResult]" = OrderedDict()
        self.max_results = max_results
        self._in_flight = 0
        # drain accounting: submitted counts BEFORE submit() returns and
        # resolved counts at _record(), so "submitted == resolved" has no
        # window where a dequeued-but-uncounted request looks quiescent
        # (queue depth and _in_flight alone have exactly that gap)
        self._n_submitted = 0
        self._n_resolved = 0
        # per-replica completed-request counts (the routing-balance
        # acceptance check reads this)
        self.completed_by_replica: Dict[str, int] = {}
        registry.subscribe(self._on_live_change)
        # seed the gauge from the current set: the subscription only fires
        # on CHANGE, and the registry may already be refreshed
        self._on_live_change(registry.live_keys())

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._started = True
        for i in range(self.n_dispatchers):
            t = threading.Thread(
                target=self._dispatch_loop, name=f"gw-dispatch-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        self.registry.unsubscribe(self._on_live_change)
        for t in self._threads:
            t.join(timeout=5.0)
        # still-queued requests and any stragglers a wedged dispatcher
        # left behind resolve with an explicit shutdown error — a client
        # blocked in submit_and_wait must not wait out its whole deadline
        # for an answer that can never come.  (_record drops duplicates,
        # so racing a late dispatcher result is safe.)
        while True:
            request = self.queue.get(timeout=0)
            if request is None:
                break
            self._record(GatewayResult(
                request.request_id, "error", error="gateway shutting down",
            ))
        with self._lock:
            leftovers = list(self._pending)
        for rid in leftovers:
            self._record(GatewayResult(
                rid, "error", error="gateway shutting down",
            ))

    def kill(self) -> None:
        """Abrupt death — the tier's chaos surface, distinct from the
        graceful ``stop()``: no joins, no waiting.  Every in-flight
        request's abort event fires (the dispatcher cancels its attempts
        WIRE-LEVEL, so replicas free the sequences' pages — exactly what
        a crashed gateway pod's closed sockets would cause via the
        replica's disconnect⇒cancel path), queued and pending requests
        resolve with an explicit "gateway died" error (the tier client's
        retry-on-a-sibling trigger), and the registry subscription
        detaches so the corpse stops observing the shared live set."""
        self._stop.set()
        self.queue.close()
        self.registry.unsubscribe(self._on_live_change)
        with self._lock:
            live = list(self._live_requests.values())
        for request in live:
            abort = getattr(request, "abort", None)
            if abort is not None:
                abort.set()
        while True:
            request = self.queue.get(timeout=0)
            if request is None:
                break
            self._record(GatewayResult(
                request.request_id, "error", error="gateway died",
            ))
        with self._lock:
            leftovers = list(self._pending)
        for rid in leftovers:
            self._record(GatewayResult(
                rid, "error", error="gateway died",
            ))

    @property
    def alive(self) -> bool:
        return not self._stop.is_set()

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    @property
    def accepting(self) -> bool:
        """Is this instance willing to take NEW admissions?  The
        per-instance half of /readyz: alive, dispatcher pool started,
        not draining.  (The other half — ≥1 routable replica and a wired
        data plane — is the server's to check.)"""
        return self.alive and self._started and not self.draining

    def begin_drain(self) -> None:
        """Graceful shutdown, step 1 (SIGTERM): stop accepting new
        admissions (submit refuses with the RETRYABLE shutdown error, so
        a tier client or load balancer re-routes to a sibling) while
        in-flight requests — live streams included — run to completion.
        The caller then waits on ``drain()`` and calls ``stop()``."""
        self._draining.set()

    # -- overload brownout (the controller's degrade surface) --------------
    @property
    def brownout_level(self) -> int:
        return self._brownout_level

    def set_brownout(self, level: int,
                     shed_tenants=frozenset()) -> None:
        """Apply one rung of the overload brownout ladder.  Level 1
        disables hedged dispatch (a browned-out fleet must not amplify
        its own load 2x); level 2 additionally shrinks speculation on
        replicas that support a live cap (the verify window's extra
        budget rows go back to admissions; greedy output is lossless
        for ANY draft, so tokens are unchanged); level 3 additionally
        sheds lowest-priority (``shed_tenants``) and over-quota tenants
        at ADMISSION with retryable 429s — every shed counted and
        auditable in ``gateway_shed_total{reason="brownout"}``.  Level
        0 restores everything.  Idempotent; the controller re-reads
        ``brownout_level`` after a restart."""
        level = max(0, min(3, int(level)))
        prev = self._brownout_level
        self._brownout_level = level
        self._shed_tenants = frozenset(shed_tenants)
        self.dispatcher.hedge_disabled = level >= 1
        if (level >= 2) != (prev >= 2):
            shrink = getattr(self.client, "set_speculation", None)
            if shrink is not None:
                try:
                    shrink(1 if level >= 2 else None)
                except Exception:  # noqa: BLE001 - advisory knob
                    log.exception("speculation shrink failed")
        self.metrics.set_gauge("gateway_brownout_level", level)

    def set_disaggregation(self, enabled: bool) -> None:
        """Collapse (or restore) prefill/decode disaggregation — the
        brownout ladder's handoff rung.  Disabled, the dispatcher still
        reacts to sealed announcements (a parked sequence must decode
        SOMEWHERE) but resolves them locally on the prefill replica
        instead of shipping KV to a decode peer; the controller flips
        the replicas' roles back to flex alongside, so new admissions
        stop sealing at all."""
        self.dispatcher.disaggregation = bool(enabled)

    def _shed_locked(self, request: GatewayRequest) -> bool:
        """Level-3 admission shed (called under _lock, BEFORE this
        request's own outstanding count lands): lowest-priority tenants
        always; otherwise a tenant already holding at least its fair
        share of the queue's capacity (capacity // active tenants,
        floor 1) is over quota — the hog pays for the brownout, the
        light tenants keep flowing."""
        tenant = request.tenant
        if not tenant:
            return False
        if tenant in self._shed_tenants:
            return True
        mine = self._tenant_outstanding.get(tenant, 0)
        if mine == 0:
            return False
        quota = max(
            1, self.queue.capacity // max(1, len(self._tenant_outstanding))
        )
        return mine >= quota

    # -- submission (the HTTP handler's surface) ---------------------------
    def submit(self, request: GatewayRequest) -> PendingRequest:
        """Admit or refuse NOW.  Refusal still resolves the handle — with
        an explicit "rejected" result — so callers have ONE code path."""
        pending = PendingRequest(request.request_id)
        with self._lock:
            if (request.request_id in self._pending
                    or request.request_id in self._results):
                raise ValueError(
                    f"duplicate request_id {request.request_id}"
                )
            # brownout shed decided BEFORE this request's own count
            # lands (the quota judges what the tenant already holds)
            shed = (self._brownout_level >= 3
                    and self._shed_locked(request))
            self._pending[request.request_id] = pending
            self._n_submitted += 1
            pending._tenant = request.tenant
            if request.tenant:
                self._tenant_outstanding[request.tenant] = (
                    self._tenant_outstanding.get(request.tenant, 0) + 1
                )
        if self.tracer is not None:
            attrs = dict(request_id=request.request_id,
                         tenant=request.tenant)
            if self.gateway_id:
                attrs["gateway"] = self.gateway_id
            request.trace = self.tracer.start_trace(
                "gateway_request", **attrs
            )
            pending._trace = request.trace
        if self._draining.is_set():
            # graceful shutdown: refuse with the RETRYABLE death error
            # (the tier client's re-submit trigger, and the analog of a
            # pod whose /readyz already went 503 but that a racing
            # client still reached) — in-flight work keeps serving
            self.metrics.inc("gateway_requests_total", outcome="error")
            self._record(GatewayResult(
                request.request_id, "error",
                error="gateway shutting down (draining)",
            ))
            return pending
        if shed:
            # brownout load-shed: an explicit, RETRYABLE 429 — the
            # degrade-don't-fail half of the controller's contract when
            # capacity cannot arrive in time.  Counted and auditable.
            self.metrics.inc("gateway_requests_total", outcome="rejected")
            self.metrics.inc("gateway_shed_total", reason="brownout")
            self._record(GatewayResult(
                request.request_id, "rejected",
                error="brownout: lowest-priority/over-quota traffic "
                "shed; retry with backoff",
            ))
            return pending
        request.enqueued_at = time.monotonic()
        try:
            self.queue.put(request)
        except QueueFull as e:
            self.metrics.inc("gateway_requests_total", outcome="rejected")
            self._record(GatewayResult(
                request.request_id, "rejected", error=str(e),
            ))
            return pending
        except QueueClosed as e:
            # NOT backpressure: the queue only closes when this gateway
            # is dying — a submit racing kill()/stop() must resolve with
            # the RETRYABLE death error so a tier client re-submits on a
            # sibling instead of surfacing a spurious rejection
            self.metrics.inc("gateway_requests_total", outcome="error")
            self._record(GatewayResult(
                request.request_id, "error", error=f"gateway died: {e}",
            ))
            return pending
        self.metrics.set_gauge("gateway_queue_depth", self.queue.depth())
        return pending

    def submit_and_wait(self, request: GatewayRequest,
                        timeout: Optional[float] = None) -> GatewayResult:
        pending = self.submit(request)
        deadline = timeout or (
            (request.deadline_s or self.dispatcher.policy.deadline_s) + 5.0
        )
        if not pending.wait(deadline):
            return GatewayResult(
                request.request_id, "timeout",
                error="gateway did not resolve in time",
            )
        return pending.result()

    # -- dispatch ----------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            request = self.queue.get(timeout=0.05)
            self.metrics.set_gauge("gateway_queue_depth", self.queue.depth())
            if request is None:
                continue
            with self._lock:
                self._in_flight += 1
                self._live_requests[request.request_id] = request
            try:
                started = time.monotonic()
                queue_wait = started - request.enqueued_at
                self.metrics.observe("gateway_queue_wait_seconds", queue_wait)
                # ROUTABLE, not live: a DRAINING replica keeps serving
                # its in-flight work but takes no new admissions
                outcome = self.dispatcher.dispatch(
                    request, self.registry.routable
                )
                total = time.monotonic() - request.enqueued_at
                if outcome.status == "ok" and request.session:
                    self._record_session(request, outcome)
                if outcome.status == "ok" and (
                    self.prefix_tier is not None and outcome.replica
                ):
                    # ANY ok completion may have sealed a publishable
                    # chain (sessionless agent scaffolds included) —
                    # queue it off the result path; the tier dedups
                    self.prefix_tier.publish_async(
                        self.client, outcome.replica,
                        list(request.prompt) + list(outcome.tokens),
                    )
                if outcome.status == "ok":
                    # both the unlabeled aggregate (the FleetObserver's
                    # window diffs read it) AND the role-split series:
                    # "disaggregated" = prefilled on one replica, decoded
                    # on another; the handoff-fallback path counts as
                    # colocated (one replica did all the work)
                    role = (
                        "disaggregated" if outcome.handed_off
                        else "colocated"
                    )
                    self.metrics.observe("gateway_ttft_seconds", total)
                    self.metrics.observe(
                        "gateway_ttft_seconds", total, role=role
                    )
                    if outcome.tokens:
                        itl = total / max(1, len(outcome.tokens))
                        self.metrics.observe("gateway_itl_seconds", itl)
                        self.metrics.observe(
                            "gateway_itl_seconds", itl, role=role
                        )
                self.metrics.inc(
                    "gateway_requests_total", outcome=outcome.status
                )
                self._record(GatewayResult(
                    request.request_id, outcome.status,
                    tokens=outcome.tokens, replica=outcome.replica,
                    error=outcome.error, attempts=outcome.attempts,
                    hedged=outcome.hedged, queue_wait_s=queue_wait,
                    total_s=total,
                ))
            except Exception as e:  # noqa: BLE001 - dispatcher must survive
                log.exception("dispatch failed for %s", request.request_id)
                self._record(GatewayResult(
                    request.request_id, "error",
                    error=f"internal dispatch error: {e}",
                ))
            finally:
                with self._lock:
                    self._in_flight -= 1
                    self._live_requests.pop(request.request_id, None)

    def _record_session(self, request: GatewayRequest, outcome) -> None:
        """A sessionful turn completed ok: record the session's home +
        stream, and — when that replica actually seals decode pages —
        queue a sealed-export capture (the failover insurance premium,
        paid while the replica is alive).  The capture runs
        ASYNCHRONOUSLY off the result path (bounded queue, drop-oldest
        — capture is insurance, never admission-blocking); the tiny
        record itself is synchronous so the very next turn's restore
        sees the session's home.  Best-effort and gated per replica so
        SimBatcher/policy-off lanes never pay a round-trip."""
        try:
            self.session_store.record(
                request.session, outcome.replica,
                list(request.prompt) + list(outcome.tokens),
            )
            seals = self._seals_cache.get(outcome.replica)
            if seals is None:
                seals = bool(self.client.seals_decode(outcome.replica))
                self._seals_cache[outcome.replica] = seals
            if seals:
                self.session_store.capture_async(
                    self.client, request.session
                )
        except Exception:  # noqa: BLE001 - insurance must never fail serving
            log.exception("sealed-session capture failed")

    # -- replica lifecycle (DRAINING → released) ---------------------------
    def drain_replica(self, key: str, migrate: bool = True) -> dict:
        """The graceful half of the replica lifecycle: mark the replica
        DRAINING (routing stops sending new admissions the same cycle),
        capture sealed exports for the sessions it last served, migrate
        its live in-flight sequences to healthy replicas, and unpin its
        sessions (a planned move, not a KV loss — their next turn
        restores from the captured exports).  Returns drain stats; the
        caller releases the replica (deletes the pod) afterwards.
        Everything degrades gracefully: a sequence that cannot migrate
        keeps serving on the draining replica until it finishes or the
        release kills it (normal failover then retries it cold)."""
        self.registry.set_draining(key, True)
        self.metrics.inc("gateway_replica_drains_total")
        captured = 0
        if self._seals_cache.get(key) or self.client.seals_decode(key):
            for session in self.session_store.sessions_on(key):
                if self.session_store.capture(self.client, session):
                    captured += 1
        migrated = failed = 0
        if migrate:
            targets = [
                r for r in self.registry.routable() if r.key != key
            ]
            for attempt in self.client.inflight_on(key):
                if attempt.done or not targets:
                    continue
                request = attempt.request
                if request is None:
                    failed += 1
                    continue
                target = min(
                    targets,
                    key=lambda r: self.dispatcher.outstanding.get(r.key, 0),
                )
                if self.client.migrate(attempt, request, target.key):
                    migrated += 1
                else:
                    failed += 1
        # planned unpin: the affinity router's next pick re-pins by load
        # and the restored export keeps the KV warm
        self.session_store.mark_lost(key)
        if self.prefix_tier is not None:
            self.prefix_tier.forget_replica(key)
        forget = getattr(self.dispatcher.router, "forget_replica", None)
        if forget is not None:
            forget(key)
        return {
            "replica": key, "migrated": migrated, "failed": failed,
            "captured": captured,
        }

    # -- exactly-once delivery --------------------------------------------
    def _record(self, result: GatewayResult) -> None:
        with self._lock:
            if result.request_id in self._results:
                # a hedge race or a stale retry produced a second terminal
                # result: count it, DROP it — the first answer stands
                self.metrics.inc("gateway_duplicate_results_total")
                return
            self._results[result.request_id] = result
            while len(self._results) > self.max_results:
                self._results.popitem(last=False)
            pending = self._pending.pop(result.request_id, None)
            self._n_resolved += 1
            if pending is not None and pending._tenant:
                n = self._tenant_outstanding.get(pending._tenant, 1) - 1
                if n <= 0:
                    self._tenant_outstanding.pop(pending._tenant, None)
                else:
                    self._tenant_outstanding[pending._tenant] = n
            if result.status == "ok" and result.replica:
                self.completed_by_replica[result.replica] = (
                    self.completed_by_replica.get(result.replica, 0) + 1
                )
        if pending is not None:
            if pending._trace is not None:
                # the root closes with the terminal result; a hedge
                # loser's serve spans may still be draining — the trace
                # completes once they close (tracing.Tracer's
                # completion rule), dispatch spans carry overhang_ok
                pending._trace.end(
                    status=result.status, attempts=result.attempts,
                    replica=result.replica,
                )
            pending._resolve(result)

    # -- views -------------------------------------------------------------
    def results(self) -> Dict[str, GatewayResult]:
        with self._lock:
            return dict(self._results)

    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait for quiescence: every submitted request has a terminal
        result.  (Counter equality, not queue-depth + in-flight: those two
        have a window where a dequeued request is counted by neither.)"""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._n_submitted == self._n_resolved:
                    return True
            time.sleep(0.01)
        return False

    def _on_live_change(self, live) -> None:
        self.metrics.set_gauge("gateway_live_replicas", len(live))
        # a replica leaving the live set strands its sessions' KV: mark
        # them restorable (the dispatcher imports any captured sealed
        # export into the re-pin target), and forget its sealing policy
        # (a revived pod may come back configured differently)
        self.session_store.sync_live(live)
        if self.prefix_tier is not None:
            self.prefix_tier.sync_live(live)
        for key in [k for k in self._seals_cache if k not in live]:
            self._seals_cache.pop(key, None)
