"""The port's copy of the JAX package's ``gateway/tier.py``.

GatewayTier: N gateways, zero single points of failure.

One ``Gateway`` process was both the bottleneck and the SPOF fronting
the whole serving stack.  The tier removes both without adding a
coordination service, leaning on three facts:

- **shared registry view**: every gateway reads the same pod/node
  annotations (and the same data-plane probes), so membership agreement
  is the cluster's, not the tier's;
- **consistent-hash routing** (``ConsistentHashRouter``): session →
  replica is a pure function of (session_id, routable set), so any
  gateway routes any session identically — a client can hit any
  gateway and land on the session's KV;
- **shared ``SessionKVStore``**: sealed-KV insurance one gateway
  captured survives that gateway's death, so a sibling taking over a
  session restores its pages instead of cold-prefilling (in a real
  multi-process deployment this store is the external piece — a small
  KV service; in-process the tier shares one instance, which models
  exactly the same contract).

Failure contract (the client side of the tier): a request is homed on a
gateway by consistent hashing over the gateway ids (sessionless traffic
round-robins) — the stand-in for a load balancer every client agrees
with.  If the home gateway dies mid-request, the submission resolves
with an explicit "gateway died" error and ``submit_and_wait`` retries
the SAME request_id on the next gateway clockwise: the replica-side
duplicate-id eviction guarantees at most one live stream per request
tier-wide (no double-serve), the session restore re-warms the KV, and
for streaming callers the resume watermark fast-forwards the sibling's
stream past the tokens already delivered — the caller's stream is each
token exactly once, across a gateway crash.

Degradation rules when a sibling dies: nothing re-routes eagerly — the
dead gateway's in-flight work aborts (attempts cancel wire-level, so no
replica decodes for a corpse), its queued/pending requests fail fast
with the retryable error, and the survivors simply absorb the keyspace
(the gateway ring moves only the dead gateway's share).  Replica
routing does NOT change: sessions stay on their replicas because the
replica ring never saw the gateway die.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, FrozenSet, List, Optional

from kubegpu_tpu_torch.gateway.client import ReplicaClient
from kubegpu_tpu_torch.gateway.core import (
    Gateway,
    GatewayRequest,
    GatewayResult,
    PendingRequest,
)
from kubegpu_tpu_torch.gateway.failover import FailoverPolicy, SessionKVStore
from kubegpu_tpu_torch.gateway.hashring import ConsistentHashRing
from kubegpu_tpu_torch.gateway.registry import ReplicaRegistry
from kubegpu_tpu_torch.gateway.router import ConsistentHashRouter, Router
from kubegpu_tpu_torch.utils.metrics import Metrics, default_metrics

# terminal errors that mean "this GATEWAY is gone", not "this request
# failed": the tier client's retry-on-a-sibling triggers.  "cancelled:
# caller disconnected" joins them only when the gateway is dead — a
# kill() aborts in-flight requests through the same abort event a
# vanished caller would use, and the two records race.
_DEATH_ERRORS = ("gateway died", "gateway shutting down")


def is_gateway_death(result: Optional[GatewayResult],
                     gateway: Optional[Gateway] = None) -> bool:
    """Should the tier client retry this result on a sibling?"""
    if result is None or result.status != "error":
        return False
    if any(err in result.error for err in _DEATH_ERRORS):
        return True
    return gateway is not None and not gateway.alive


class GatewayTier:
    """N ``Gateway`` instances over one registry, one data-plane client
    and one session store.  In production each instance is its own pod
    behind a load balancer; in-process the tier is the test/bench/chaos
    surface for everything the multi-gateway contract promises."""

    def __init__(
        self,
        registry: ReplicaRegistry,
        client: ReplicaClient,
        n_gateways: int = 2,
        gateway_ids: Optional[List[str]] = None,
        policy: Optional[FailoverPolicy] = None,
        metrics: Optional[Metrics] = None,
        dispatchers: int = 4,
        queue_factory: Optional[Callable[[], object]] = None,
        router_factory: Optional[Callable[[], Router]] = None,
        tracer_factory: Optional[Callable[[str], object]] = None,
        session_store: Optional[SessionKVStore] = None,
        prefix_tier=None,
        trace: bool = True,
    ) -> None:
        if gateway_ids is None:
            gateway_ids = [f"gw{i}" for i in range(n_gateways)]
        if len(gateway_ids) < 1:
            raise ValueError("a tier needs at least one gateway")
        self.registry = registry
        self.client = client
        self.metrics = metrics or default_metrics
        self.policy = policy
        self.dispatchers = dispatchers
        self.queue_factory = queue_factory
        # every gateway gets its OWN router instance of the SAME policy:
        # consistent hashing makes the instances agree without sharing
        # state — which is the whole point
        self.router_factory = router_factory or (
            lambda: ConsistentHashRouter()
        )
        self.tracer_factory = tracer_factory
        self.trace = trace
        # ONE store across the tier: insurance captured by any gateway
        # restores through any sibling.  In-process that is one shared
        # instance; a real multi-pod tier passes a store backed by the
        # external StoreServer (sessionstore.HttpStoreClient) instead.
        self.session_store = session_store or SessionKVStore(
            metrics=self.metrics
        )
        # ONE prefix tier across the tier, same shape: a chain published
        # by any gateway imports through any sibling (and the advisory
        # warmth map every PrefixLocalityRouter scores by is shared).
        self.prefix_tier = prefix_tier
        self._lock = threading.Lock()
        self._rr = 0
        self._ring = ConsistentHashRing(gateway_ids)
        self.gateway_ids = list(gateway_ids)
        self.gateways: Dict[str, Gateway] = {
            gid: self._build(gid) for gid in gateway_ids
        }
        self._started = False
        # tier-wide brownout state: applied to every alive gateway, and
        # re-applied to revived replacements (a fresh pod joining a
        # browned-out tier must not hedge while its siblings shed)
        self._brownout: int = 0
        self._shed_tenants: frozenset = frozenset()

    def _build(self, gid: str) -> Gateway:
        kwargs: dict = {}
        if self.queue_factory is not None:
            kwargs["queue"] = self.queue_factory()
        if self.tracer_factory is not None:
            kwargs["tracer"] = self.tracer_factory(gid)
        return Gateway(
            self.registry, self.client,
            router=self.router_factory(),
            policy=self.policy,
            metrics=self.metrics,
            dispatchers=self.dispatchers,
            trace=self.trace,
            session_store=self.session_store,
            prefix_tier=self.prefix_tier,
            gateway_id=gid,
            **kwargs,
        )

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "GatewayTier":
        for gw in self.gateways.values():
            if gw.alive and not gw._threads:
                gw.start()
        self._started = True
        self._publish_gauge()
        return self

    def stop(self) -> None:
        for gw in self.gateways.values():
            if gw.alive:
                gw.stop()

    def alive_ids(self) -> List[str]:
        return sorted(
            gid for gid, gw in self.gateways.items() if gw.alive
        )

    def _publish_gauge(self) -> None:
        self.metrics.set_gauge(
            "gateway_tier_gateways", len(self.alive_ids())
        )

    def kill(self, gid: str) -> None:
        """Chaos surface: one gateway dies abruptly (its in-flight work
        aborts + cancels wire-level; its pendings resolve with the
        retryable death error).  The survivors absorb its keyspace."""
        gw = self.gateways[gid]
        if gw.alive:
            gw.kill()
            self.metrics.inc("gateway_tier_deaths_total")
        self._publish_gauge()

    def revive(self, gid: str) -> Gateway:
        """A replacement gateway process under the same id (fresh
        queues, fresh dispatcher pool, clean result table — nothing of
        the corpse survives except what was DESIGNED to be shared: the
        registry view and the session store)."""
        old = self.gateways.get(gid)
        if old is not None and old.alive:
            return old
        gw = self._build(gid)
        self.gateways[gid] = gw
        if self._started:
            gw.start()
        if self._brownout:
            gw.set_brownout(self._brownout,
                            shed_tenants=self._shed_tenants)
        self._publish_gauge()
        return gw

    # -- overload brownout (controller surface, fanned tier-wide) ----------
    @property
    def brownout_level(self) -> int:
        return self._brownout

    def set_brownout(self, level: int,
                     shed_tenants=frozenset()) -> None:
        """Apply a brownout rung to every alive gateway (see
        ``Gateway.set_brownout``); remembered so revived gateways join
        at the tier's current level."""
        self._brownout = max(0, min(3, int(level)))
        self._shed_tenants = frozenset(shed_tenants)
        for gid in self.alive_ids():
            self.gateways[gid].set_brownout(
                self._brownout, shed_tenants=self._shed_tenants
            )

    # -- routing (the load-balancer stand-in) ------------------------------
    def gateway_for(self, request,
                    exclude: FrozenSet[str] = frozenset()) -> Optional[str]:
        """The request's home gateway: consistent hash of the session
        over the ALIVE gateway ids (so every client agrees, and a
        session keeps hitting the gateway that holds its admission
        context), round-robin for sessionless traffic."""
        with self._lock:
            alive = frozenset(
                gid for gid, gw in self.gateways.items() if gw.alive
            ) - exclude
            if not alive:
                return None
            session = getattr(request, "session", None)
            if session:
                self._ring.rebuild(alive)
                return self._ring.lookup(session)
            order = sorted(alive)
            self._rr += 1
            return order[self._rr % len(order)]

    # -- submission --------------------------------------------------------
    def submit(self, request: GatewayRequest,
               via: Optional[str] = None):
        """Admit through the home gateway (or ``via`` — any gateway can
        route any session).  Returns ``(gateway_id, PendingRequest)``.
        Attaches an abort event when the request has none: a gateway
        death must be able to cancel the request's attempts wire-level."""
        gid = via if via is not None else self.gateway_for(request)
        if gid is None:
            pending = PendingRequest(request.request_id)
            pending._resolve(GatewayResult(
                request.request_id, "error", error="no alive gateways",
            ))
            return "", pending
        if getattr(request, "abort", None) is None:
            request.abort = threading.Event()
        return gid, self.gateways[gid].submit(request)

    @staticmethod
    def _clone(request: GatewayRequest) -> GatewayRequest:
        """A fresh request object for a sibling retry: same identity and
        payload, NEW abort event (the dead gateway set the old one) and
        clean trace slot.  The streaming relay hooks carry over — the
        sibling continues the same caller's stream, and the relay's
        watermark rides ``stream_watermark`` so the dispatcher
        fast-forwards the resumed attempt."""
        clone = GatewayRequest(
            prompt=list(request.prompt),
            max_new_tokens=request.max_new_tokens,
            request_id=request.request_id,
            tenant=request.tenant,
            session=request.session,
            temperature=request.temperature,
            seed=request.seed,
            deadline_s=request.deadline_s,
        )
        clone.on_tokens = request.on_tokens
        clone.no_hedge = request.no_hedge
        clone.abort = threading.Event()
        wm = getattr(request, "stream_watermark", None)
        if wm is not None:
            clone.stream_watermark = wm
        return clone

    def submit_and_wait(self, request: GatewayRequest,
                        timeout: Optional[float] = None) -> GatewayResult:
        """The tier client contract: submit to the home gateway; on a
        GATEWAY death (not a request failure — those already failed over
        across replicas inside the gateway) retry the same request_id on
        the next gateway clockwise.  Exactly-once delivery holds because
        only this caller holds the handle chain, and the replica-side
        duplicate-id eviction keeps at most one live stream per
        request_id."""
        import time

        policy = self.policy or FailoverPolicy()
        deadline = time.monotonic() + (
            timeout
            if timeout is not None
            else (request.deadline_s or policy.deadline_s) + 5.0
        )
        tried: List[str] = []
        req = request
        last: Optional[GatewayResult] = None
        while True:
            gid = self.gateway_for(req, exclude=frozenset(tried))
            if gid is None:
                return last or GatewayResult(
                    request.request_id, "error",
                    error="no alive gateways",
                )
            gid, pending = self.submit(req, via=gid)
            remaining = deadline - time.monotonic()
            if not pending.wait(max(remaining, 0.0)):
                return GatewayResult(
                    request.request_id, "timeout",
                    error="gateway tier did not resolve in time",
                )
            result = pending.result()
            if is_gateway_death(result, self.gateways.get(gid)):
                tried.append(gid)
                last = result
                self.metrics.inc("gateway_tier_retries_total")
                req = self._clone(req)
                continue
            return result

    # -- views / delegation ------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        ok = True
        for gw in self.gateways.values():
            if gw.alive:
                ok = gw.drain(timeout) and ok
        return ok

    def drain_replica(self, key: str, migrate: bool = True) -> dict:
        """Replica lifecycle through any alive gateway (the verbs act on
        the shared registry/client/store, so the choice is arbitrary)."""
        for gid in self.alive_ids():
            return self.gateways[gid].drain_replica(key, migrate=migrate)
        raise RuntimeError("no alive gateway to drain through")

    def results(self) -> Dict[str, GatewayResult]:
        """Merged terminal results, ALIVE gateways only — a real crash
        loses the dead process's result table, and the tier must not
        pretend otherwise (the client-side retry is the answer)."""
        out: Dict[str, GatewayResult] = {}
        for gid in self.alive_ids():
            out.update(self.gateways[gid].results())
        return out
