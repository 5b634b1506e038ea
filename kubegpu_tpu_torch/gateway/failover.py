"""The port's copy of the JAX package's ``gateway/failover.py``.

Failover: deadlines, retry-with-budget, hedged dispatch.

One request's dispatch lifecycle, run on a gateway dispatcher thread:

    pick primary → submit → (straggling? submit ONE hedge elsewhere)
                 → first completion wins, losers cancelled
                 → error? retry on a different replica, if budget allows
                 → deadline passed? cancel everything, fail explicitly

Both hedges and retries are BUDGETED (the classic retry-budget shape:
issued extra attempts may not exceed ``ratio`` of requests seen, with a
small burst floor) — without the budget, a brown-out replica turns every
request into 2-3 requests and the gateway amplifies its own overload
into a full outage.  The winner's result is delivered exactly once; a
hedge loser's completion is cancelled and discarded, never surfaced —
the soak's I5 invariant (served exactly once) leans on this.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from kubegpu_tpu_torch.gateway.client import Attempt, ReplicaClient
from kubegpu_tpu_torch.gateway.registry import ReplicaInfo
from kubegpu_tpu_torch.gateway.router import Router, handoff_rank_key
# SessionKVStore moved to gateway/sessionstore.py when it grew pluggable
# backends (the external HTTP store); re-exported here because this
# module is its historical home and half the stack imports it from here.
from kubegpu_tpu_torch.gateway.sessionstore import SessionKVStore  # noqa: F401
from kubegpu_tpu_torch.utils.metrics import Metrics

log = logging.getLogger(__name__)

_POLL_S = 0.002  # attempt-completion poll; decode steps are >> this


class _TraceView:
    """Request view carrying per-attempt trace context (and, for
    routing, the open route span) without mutating the caller's request
    — the router's ``_with_hint`` pattern: attempts race, so the shared
    request object must never hold attempt-scoped state."""

    def __init__(self, request, **attrs) -> None:
        self._request = request
        for k, v in attrs.items():
            setattr(self, k, v)

    def __getattr__(self, name):
        return getattr(self._request, name)


@dataclass
class FailoverPolicy:
    deadline_s: float = 30.0        # end-to-end cap per request
    hedge_after_s: float = 1.0      # straggler threshold before hedging
    max_attempts: int = 3           # primary + retries (hedges NOT counted)
    retry_budget_ratio: float = 0.2  # retries ≤ ratio · requests + floor
    hedge_budget_ratio: float = 0.1  # hedges  ≤ ratio · requests + floor
    budget_floor: int = 10           # burst allowance while requests ≈ 0


class _Budget:
    """issued ≤ ratio · seen + floor — cheap, lock-protected, monotonic."""

    def __init__(self, ratio: float, floor: int) -> None:
        self.ratio = ratio
        self.floor = floor
        self.seen = 0
        self.issued = 0
        self._lock = threading.Lock()

    def observe(self) -> None:
        with self._lock:
            self.seen += 1

    def try_spend(self) -> bool:
        with self._lock:
            if self.issued < self.ratio * self.seen + self.floor:
                self.issued += 1
                return True
            return False


class Dispatcher:
    """Drives one request through attempts against the ReplicaClient.

    Shared across gateway dispatcher threads: the budgets and outstanding
    counts are global on purpose (a per-thread budget would defeat the
    amplification bound).
    """

    def __init__(
        self,
        client: ReplicaClient,
        router: Router,
        policy: Optional[FailoverPolicy] = None,
        metrics: Optional[Metrics] = None,
        outstanding=None,
        outstanding_lock: Optional[threading.Lock] = None,
        session_store: Optional[SessionKVStore] = None,
        prefix_tier=None,
    ) -> None:
        self.client = client
        self.router = router
        self.policy = policy or FailoverPolicy()
        self.metrics = metrics
        # sealed-export restore at dispatch: when a routed session lost
        # its home replica, its captured KV is imported into the target
        # BEFORE the attempt opens — the re-pin becomes a transfer.
        # Mispin restores (away-dispatch with the home still healthy)
        # only make sense when the router MEANS its away-dispatches —
        # affinity/ring routers (duck-typed on forget_replica, which
        # both define for the drain path).  A plain load balancer
        # bounces sessions by design; restoring per bounce would ship
        # the payload every turn.
        self.session_store = session_store
        # fleet-wide prefix tier (prefixtier.PrefixTier): before a cold
        # attempt opens, import the longest fleet-published prefix of the
        # prompt into the target, so a hot system prompt prefills once
        # fleet-wide instead of once per replica.
        self.prefix_tier = prefix_tier
        self._mispin_restore = hasattr(router, "forget_replica")
        self.retry_budget = _Budget(
            self.policy.retry_budget_ratio, self.policy.budget_floor
        )
        self.hedge_budget = _Budget(
            self.policy.hedge_budget_ratio, self.policy.budget_floor
        )
        # replica key -> in-flight count, shared with the router's callers
        self.outstanding = outstanding if outstanding is not None else {}
        self._out_lock = outstanding_lock or threading.Lock()
        # brownout rung 1 (Gateway.set_brownout): a browned-out fleet
        # must not amplify its own overload with duplicate dispatches
        self.hedge_disabled = False
        # prefill/decode disaggregation: when a prefill-only replica
        # announces a sequence SEALED (parked, zero tokens emitted), the
        # loop below hands it off to a decode replica over the migration
        # verbs.  The controller's brownout ladder flips this off
        # (collapse to co-located) when handoff capacity is the
        # bottleneck; sealed events still arriving from a replica whose
        # role hasn't flipped yet MUST still be handled — a parked
        # sequence decodes nowhere until a handoff (or the local
        # fallback) lands, so the collapse only changes the TARGET
        # ranking, never whether we act.
        self.disaggregation = True
        # streamed seal-time handoff: the dispatcher loop ships pages
        # sealed so far to the adjacency-picked decode target DURING the
        # remaining prefill compute, so only the final delta + cursor
        # handoff rides the TTFT critical path.  ``stream_handoff=False``
        # forces the one-shot transfer (the bench's comparison lane);
        # ``delta_poll_s`` bounds seal-watch poll pressure on the
        # source's serving thread.
        self.stream_handoff = True
        self.delta_poll_s = 0.01

    # -- outstanding bookkeeping ------------------------------------------
    def _inc(self, key: str) -> None:
        with self._out_lock:
            self.outstanding[key] = self.outstanding.get(key, 0) + 1

    def _dec(self, key: str) -> None:
        with self._out_lock:
            n = self.outstanding.get(key, 1) - 1
            if n <= 0:
                self.outstanding.pop(key, None)
            else:
                self.outstanding[key] = n

    def _submit(self, replica: ReplicaInfo, request, attempt_n: int = 1,
                hedge: bool = False) -> Attempt:
        self._inc(replica.key)
        trace = getattr(request, "trace", None)
        restored = False
        if self.session_store is not None and not hedge:
            # restore-before-dispatch: a session dispatching away from
            # its recorded KV home (lost home, or a ring-rebalance
            # mispin) gets its sealed export imported into THIS target
            # first, so the very request that moves already hits warm
            # pages.  NOT for hedge twins: the primary (usually on the
            # healthy home) would make the multi-megabyte transfer pure
            # waste — and if the twin wins, the session's NEXT dispatch
            # routes to it and restores then.
            try:
                if self.session_store.restore_for(
                    request, replica.key, self.client,
                    mispin_restore=self._mispin_restore,
                ):
                    restored = True
                    if self.metrics:
                        self.metrics.inc("gateway_session_restores_total")
                    if trace is not None:
                        trace.event("session_restore", replica=replica.key)
            except Exception:  # noqa: BLE001 - restore is best-effort
                log.exception("sealed-session restore failed")
        if self.prefix_tier is not None and not hedge and not restored:
            # tier probe + pre-prefill import: skipped for hedge twins
            # (the primary usually lands on warm pages already) and when
            # a session restore just shipped the same chain.  Best-effort
            # under the full degradation contract — a tier outage means a
            # counted cold prefill, never a request error.
            try:
                if self.prefix_tier.ensure_warm(
                    request, replica.key, self.client
                ) and trace is not None:
                    trace.event("prefix_tier_import", replica=replica.key)
            except Exception:  # noqa: BLE001 - tier import is best-effort
                log.exception("prefix-tier import failed")
        attrs: dict = {}
        # streaming resume watermark: an attempt opened after the caller
        # already received N tokens — a hedge twin, a retry, or a
        # sibling gateway resuming a crashed gateway's stream — carries
        # N down the wire, so the replica fast-forwards EMISSION past
        # the already-delivered prefix (it still decodes it — greedy
        # decode is deterministic, which is also why the relay's dedup
        # is sound).  A fresh request's watermark is 0 and ships nothing.
        wm_fn = getattr(request, "stream_watermark", None)
        if wm_fn is not None:
            try:
                wm = int(wm_fn())
            except Exception:  # noqa: BLE001 - watermark is advisory
                wm = 0
            if wm > 0:
                attrs["resume_watermark"] = wm
        span = None
        if trace is not None:
            # one dispatch span per attempt; the replica's serve subtree
            # nests under it (the worker passes the view's .trace into
            # batcher.submit).  overhang_ok: a hedge loser's teardown
            # legitimately lands after the gateway already recorded the
            # winner and closed the root.
            span = trace.child(
                "dispatch", replica=replica.key, attempt=attempt_n,
                hedge=hedge, overhang_ok=True,
            )
            attrs["trace"] = span
        if attrs:
            request = _TraceView(request, **attrs)
        attempt = self.client.submit(replica.key, request)
        if span is not None:
            attempt._dispatch_span = span
        attempt._routed_key = replica.key
        return attempt

    # -- post-prefill handoff (disaggregation) -----------------------------
    def _pick_handoff_target(self, src: str,
                             replicas: List[ReplicaInfo]) -> Optional[str]:
        """Best decode-side peer for a handoff from ``src``, by the
        shared adjacency score (same slice → mesh distance → load).
        None = no peer at all (the caller co-locates on the source)."""
        if not self.disaggregation:
            return None
        anchor = next((r for r in replicas if r.key == src), None)
        cand = [
            r for r in replicas
            if r.key != src and getattr(r, "role", "flex") != "prefill"
        ] or [r for r in replicas if r.key != src]
        if not cand:
            return None
        return min(
            cand,
            key=lambda r: handoff_rank_key(r, anchor, self.outstanding),
        ).key

    def _stream_deltas(self, attempt: Attempt, request, replicas_fn,
                       force: bool = False) -> None:
        """Seal-watch step: ship pages sealed since the last poll to the
        pre-picked handoff target, overlapping the wire with remaining
        prefill compute.  Strictly best-effort — a refused or lost delta
        abandons streaming and the seal-time one-shot handoff takes
        over (nothing was reclaimed yet: reclaim only runs at seal,
        against the acked watermark).  ``force`` skips the poll rate
        limit (the seal-time drain of whatever never got streamed)."""
        if not self.stream_handoff or not self.disaggregation:
            return
        client = self.client
        if getattr(client, "export_delta", None) is None:
            return
        st = getattr(attempt, "_handoff_stream", None)
        now = time.monotonic()
        if st is None:
            replicas = (
                replicas_fn() if callable(replicas_fn) else replicas_fn
            )
            src = next(
                (r for r in replicas if r.key == attempt.replica), None
            )
            target = (
                self._pick_handoff_target(attempt.replica, replicas)
                if src is not None
                and getattr(src, "role", "flex") == "prefill"
                else None
            )
            st = attempt._handoff_stream = {
                # failed=True doubles as "don't stream": non-prefill
                # source (nothing parks → nothing seals early) or no
                # decode peer to stream toward
                "target": target, "cursor": 0, "acked": 0, "deltas": 0,
                "overlap_s": 0.0, "failed": target is None,
                "next_poll": 0.0,
            }
        if st["failed"] or (not force and now < st["next_poll"]):
            return
        st["next_poll"] = now + self.delta_poll_s
        sealed_already = attempt.sealed.is_set()
        t0 = time.monotonic()
        try:
            payload = client.export_delta(attempt, request, st["cursor"])
        except Exception:  # noqa: BLE001 - streaming is best-effort
            payload = None
        if payload is None:
            return
        n = len(payload.get("page_keys") or [])
        if n == 0:
            return
        try:
            staged = client.import_delta(st["target"], payload)
        except Exception:  # noqa: BLE001 - refusal = fall back
            staged = None
        if staged is None:
            # target refused or died: its staged prefix is unreliable,
            # so forget the acked watermark and let the one-shot
            # handoff ship everything (no reclaim has happened yet)
            st["failed"] = True
            st["acked"] = 0
            return
        st["cursor"] += n
        st["acked"] = st["cursor"]
        st["deltas"] += 1
        if not sealed_already:
            st["overlap_s"] += time.monotonic() - t0
        if self.metrics:
            self.metrics.inc("gateway_phase_handoff_deltas_total")

    def _do_handoff(self, attempt: Attempt, request,
                    replicas: List[ReplicaInfo]) -> None:
        """The sequence's prompt pages sealed on a prefill-only replica
        and it PARKED (zero tokens emitted): hand it off to a decode
        replica through the migration verbs — adjacency-scored (slice
        locality first: ICI beats DCN on handoff wire time, then mesh
        distance, then load).  If the seal-watch streamed deltas, drain
        the tail, RECLAIM the acked pages on the source (they admit a
        queued prefill during this very roundtrip), and ship only the
        cursor remainder.  With no decode peer (or disaggregation
        collapsed), the source itself is the target: detach-and-resume
        locally through the same verb pair, so a parked sequence NEVER
        decodes nowhere."""
        attempt._handed_off = True
        migrate = getattr(self.client, "migrate", None)
        if migrate is None:
            return
        src = attempt.replica
        st = getattr(attempt, "_handoff_stream", None)
        cursor = 0
        target_key = None
        if st is not None and not st["failed"]:
            # final drain: everything sealed since the last poll goes
            # now, so the critical-path hop carries only the cursor
            self._stream_deltas(attempt, request, replicas, force=True)
            if not st["failed"] and st["acked"] > 0:
                cursor = st["acked"]
                target_key = st["target"]
                try:
                    self.client.reclaim(attempt, request, cursor)
                except Exception:  # noqa: BLE001 - reclaim best-effort
                    log.exception("early reclaim failed")
        if target_key is None:
            target_key = self._pick_handoff_target(src, replicas) or src
        attempt._handoff_mode = "streamed" if cursor else "oneshot"
        trace = getattr(request, "trace", None)
        if trace is not None:
            trace.event(
                "phase_handoff", source=src, target=target_key,
                mode=attempt._handoff_mode, cursor=cursor,
            )
        t0 = time.monotonic()
        ok = False
        try:
            ok = migrate(
                attempt, request, target_key, fallback=True,
                cursor=cursor,
            )
        except Exception:  # noqa: BLE001 - handoff is best-effort
            log.exception("phase handoff failed")
        if not ok and target_key != src and not attempt.done:
            # the decode-side leg never started (export lost, target
            # unresolvable): unpark locally instead.  The cursor still
            # applies — reclaimed pages re-resolve from the source's
            # own prefix cache on the fallback import.
            try:
                ok = migrate(
                    attempt, request, src, fallback=True, cursor=cursor,
                )
            except Exception:  # noqa: BLE001 - same contract
                log.exception("local handoff fallback failed")
        if self.metrics:
            self.metrics.observe(
                "gateway_phase_handoff_seconds", time.monotonic() - t0
            )
            if cursor and st is not None:
                self.metrics.observe(
                    "gateway_phase_handoff_overlap_seconds",
                    st["overlap_s"],
                )
        if not ok:
            attempt.handoff_outcome = "failed"

    def _record_handoff(self, attempt: Attempt) -> None:
        """Once per handed-off attempt, at settlement (the HTTP client
        resolves the fallback-vs-ok outcome on its reader thread, so
        the counts are only authoritative when the attempt is done)."""
        if not getattr(attempt, "_handed_off", False):
            return
        if getattr(attempt, "_handoff_recorded", False):
            return
        attempt._handoff_recorded = True
        if self.metrics:
            outcome = getattr(attempt, "handoff_outcome", "") or "failed"
            self.metrics.inc(
                "gateway_phase_handoff_total", outcome=outcome
            )
            wire = int(getattr(attempt, "handoff_wire_bytes", 0) or 0)
            if wire:
                self.metrics.inc(
                    "gateway_phase_handoff_wire_bytes_total", wire,
                    mode=getattr(attempt, "_handoff_mode", "oneshot"),
                )

    def _settle(self, attempt: Attempt) -> None:
        # the key the _inc above charged — attempt.replica may have been
        # re-homed by a live migration mid-flight
        self._dec(getattr(attempt, "_routed_key", attempt.replica))
        self._record_handoff(attempt)
        span = getattr(attempt, "_dispatch_span", None)
        if span is not None:
            res = attempt.result()
            span.end(
                outcome=(
                    "cancelled" if attempt.cancelled
                    else "ok" if (res is not None and res.ok)
                    else "error"
                ),
            )

    # -- the dispatch loop -------------------------------------------------
    def dispatch(
        self,
        request,
        live: Callable[[], List[ReplicaInfo]],
    ) -> "DispatchOutcome":
        """Run one request to a terminal outcome.  ``live`` re-reads the
        registry so retries see post-failure membership.

        The deadline is anchored at ENQUEUE (request.enqueued_at), not at
        dequeue: "end-to-end budget" includes queue wait, and the caller's
        submit_and_wait times out relative to submission — a request that
        aged out in the queue must fail fast here, not burn a replica
        decoding an answer its client already abandoned."""
        policy = self.policy
        self.retry_budget.observe()
        self.hedge_budget.observe()
        start = getattr(request, "enqueued_at", 0.0) or time.monotonic()
        deadline = start + (
            getattr(request, "deadline_s", None) or policy.deadline_s
        )
        if time.monotonic() >= deadline:
            # shed-before-work: the deadline already expired while this
            # request sat in the admission queue — dispatching it would
            # burn prefill compute on an answer its caller has abandoned.
            # Resolve as a COUNTED, RETRYABLE backpressure result (the
            # 429 shape, not a timeout: nothing was attempted).
            if self.metrics:
                self.metrics.inc(
                    "gateway_shed_total", reason="deadline_expired"
                )
            return DispatchOutcome(
                "rejected",
                error="deadline expired in queue; retry with backoff",
            )
        tried = set()
        attempts: List[Attempt] = []
        n_attempts = 0
        hedged = False
        hedge_at: Optional[float] = None
        last_error = "no live replicas"

        trace = getattr(request, "trace", None)
        route_spans_left = [16]  # a zero-replica outage polls pick in a
        # loop; the tree records the first N routing decisions, not one
        # span per poll tick

        def routed_pick(exclude: frozenset,
                        hedge: bool = False) -> Optional[ReplicaInfo]:
            # every routing decision is a span: the router annotates it
            # (session pin state, re-pins) via the request view's
            # route_span, so "why did this land there" is in the tree
            replicas = live()
            span = None
            req = request
            if trace is not None and route_spans_left[0] > 0:
                route_spans_left[0] -= 1
                # overhang_ok: a gateway kill (or caller abort) closes
                # the ROOT the instant it records the terminal result —
                # this microsecond span may legitimately still be open
                # on the dispatcher thread at that moment, like the
                # dispatch spans below
                span = trace.child("route", hedge=hedge, overhang_ok=True)
                req = _TraceView(request, route_span=span)
            target = self.router.pick(
                req, replicas, self.outstanding, exclude
            )
            if span is not None:
                span.end(
                    replica=target.key if target is not None else "",
                    live=len(replicas),
                )
                if target is not None:
                    route_spans_left[0] = max(route_spans_left[0], 4)
            return target

        def pick_target() -> Optional[ReplicaInfo]:
            # prefer a replica this request hasn't touched; fall back to
            # re-trying one (it may have recovered) rather than failing
            target = routed_pick(frozenset(tried))
            if target is None and tried:
                target = routed_pick(frozenset())
            return target

        abort = getattr(request, "abort", None)

        while True:
            now = time.monotonic()
            if abort is not None and abort.is_set():
                # the caller vanished (streaming disconnect): cancel
                # every in-flight attempt — wire-level, so the replica
                # frees the sequence's pages — and fail explicitly; a
                # request nobody will read must not keep decoding
                for a in attempts:
                    if not a.done:
                        self.client.cancel(a)
                    self._settle(a)
                # the disconnect metric is about STREAMING callers that
                # vanished; the tier attaches abort events to unary
                # requests too (a gateway kill fires them), and those
                # must not inflate the caller-disconnect signal
                if self.metrics and (
                    getattr(request, "on_tokens", None) is not None
                ):
                    self.metrics.inc("gateway_stream_disconnects_total")
                return DispatchOutcome(
                    "error", error="cancelled: caller disconnected",
                    attempts=n_attempts, hedged=hedged,
                )
            if now >= deadline:
                for a in attempts:
                    if not a.done:
                        self.client.cancel(a)
                    self._settle(a)
                if self.metrics:
                    self.metrics.inc("gateway_deadline_exceeded_total")
                return DispatchOutcome(
                    "timeout", error=f"deadline exceeded after "
                    f"{n_attempts} attempt(s): {last_error}",
                    attempts=n_attempts, hedged=hedged,
                )

            if not attempts:
                # nothing in flight — the ONE place attempts are opened
                # (first admission and every post-failure re-admission),
                # so the budget rules live in one place: charged only for
                # re-admissions, and only once a concrete replica exists
                # (a cluster mid-failover may have zero live replicas for
                # a cycle; polling while nobody is routable must not
                # drain the budget — the request waits, bounded by the
                # deadline above).
                if n_attempts > 0 and n_attempts >= policy.max_attempts:
                    if self.metrics:
                        self.metrics.inc("gateway_failures_total")
                    return DispatchOutcome(
                        "error", error=f"{n_attempts} attempt(s) failed: "
                        f"{last_error}",
                        attempts=n_attempts, hedged=hedged,
                    )
                candidate = pick_target()
                if candidate is None:
                    time.sleep(_POLL_S * 5)
                    continue
                if n_attempts > 0:
                    if not self.retry_budget.try_spend():
                        if self.metrics:
                            self.metrics.inc(
                                "gateway_retry_budget_exhausted_total"
                            )
                        return DispatchOutcome(
                            "error", error="retry budget exhausted: "
                            + last_error,
                            attempts=n_attempts, hedged=hedged,
                        )
                    if self.metrics:
                        self.metrics.inc("gateway_retries_total")
                    if trace is not None:
                        # the retry decision itself is a tree node: the
                        # re-admission after a failed attempt, with the
                        # error it is retrying past
                        trace.event(
                            "retry", attempt=n_attempts + 1,
                            after_error=last_error,
                        )
                tried.add(candidate.key)
                attempts.append(
                    self._submit(candidate, request, n_attempts + 1)
                )
                n_attempts += 1
                hedge_at = time.monotonic() + policy.hedge_after_s
                continue

            # seal-watch: ship pages sealed so far toward the handoff
            # target while the rest of the prefill still computes —
            # the streamed half of the disaggregation pipeline
            if self.stream_handoff and self.disaggregation:
                for a in list(attempts):
                    if not a.done and not getattr(a, "_handed_off", False):
                        self._stream_deltas(a, request, live)

            # post-prefill handoff: a sealed announcement means the
            # sequence is PARKED on a prefill-only replica — act on it
            # unconditionally (it decodes nowhere until this lands)
            for a in list(attempts):
                if (a.sealed.is_set() and not a.done
                        and not getattr(a, "_handed_off", False)):
                    self._do_handoff(a, request, live())

            winner = None
            for a in attempts:
                if a.wait(_POLL_S / max(len(attempts), 1)):
                    winner = a
                    break
            if winner is not None:
                res = winner.result()
                if res is not None and res.ok and not winner.cancelled:
                    for a in attempts:
                        if a is not winner:
                            if not a.done:
                                self.client.cancel(a)
                            if self.metrics:
                                self.metrics.inc("gateway_hedge_wasted_total")
                        self._settle(a)
                    return DispatchOutcome(
                        "ok", tokens=res.tokens, replica=winner.replica,
                        attempts=n_attempts, hedged=hedged,
                        handed_off=(
                            getattr(winner, "handoff_outcome", "") == "ok"
                        ),
                    )
                # failed (replica died / refused / cancelled): drop it;
                # if nothing else is in flight the empty-attempts branch
                # above owns the (budgeted) re-admission
                last_error = res.error if res else "unknown"
                attempts.remove(winner)
                self._settle(winner)
                continue

            # no completion yet: is the in-flight attempt straggling?
            # Pick the hedge target BEFORE spending the budget — a token
            # burned with nowhere to hedge to throttles future hedges
            # without ever issuing one.
            if (
                not hedged
                and not self.hedge_disabled
                and len(attempts) == 1
                and hedge_at is not None
                and now >= hedge_at
                # no_hedge: UNPINNED sampled streams (temperature > 0,
                # no request seed) never hedge — replicas do not emit
                # identical unpinned sampled streams, so a twin's
                # tokens could not be deduped coherently.  Greedy AND
                # seed-pinned sampled streams DO hedge: position-keyed
                # sample keys (or determinism) make every replica's
                # stream byte-identical, the StreamRelay dedups by
                # token index and the resume watermark fast-forwards
                # the twin, so tail latency is hedged exactly for the
                # requests users watch token by token.
                and not getattr(request, "no_hedge", False)
            ):
                target = routed_pick(frozenset(tried), hedge=True)
                if target is None:
                    hedge_at = None  # nowhere to hedge to; stop trying
                elif self.hedge_budget.try_spend():
                    tried.add(target.key)
                    attempts.append(
                        self._submit(target, request, n_attempts + 1,
                                     hedge=True)
                    )
                    hedged = True
                    if self.metrics:
                        self.metrics.inc("gateway_hedges_total")
                        if getattr(request, "on_tokens", None) is not None:
                            # a STREAMING hedge — only safe because the
                            # relay's prefix dedup keeps the caller's
                            # stream exactly-once
                            self.metrics.inc(
                                "gateway_stream_hedges_total"
                            )
                        if float(getattr(request, "temperature", 0.0)) > 0:
                            # a SAMPLED hedge can only be seed-pinned
                            # (unpinned sampled sets no_hedge) — count
                            # it so the determinism contract's payoff
                            # is visible on dashboards
                            self.metrics.inc("gateway_sampled_hedges_total")
                else:
                    hedge_at = None  # budget denied; stop re-checking


@dataclass
class DispatchOutcome:
    status: str          # "ok" | "error" | "timeout" | "rejected" (shed)
    tokens: List[int] = None         # type: ignore[assignment]
    replica: str = ""
    error: str = ""
    attempts: int = 0
    hedged: bool = False
    # served disaggregated: prefilled on one replica, decoded on another
    # (False covers co-located AND the handoff-fallback path, where the
    # prefill replica ended up decoding after a refused import)
    handed_off: bool = False

    def __post_init__(self) -> None:
        if self.tokens is None:
            self.tokens = []
