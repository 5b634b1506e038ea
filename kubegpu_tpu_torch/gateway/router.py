"""The port's copy of the JAX package's ``gateway/router.py``.

Routing policies: pick a replica for a request.

Pluggable (the scheduler's plugin-registry spirit applied to the data
plane): a ``Router`` sees the live replica set, the gateway's outstanding
per-replica request counts, and an exclude set (replicas this request
already failed or hedged on), and returns one replica or None.

- ``LeastOutstandingRouter`` (default): classic least-outstanding-requests.
  Queue depth at the replica is the best cheap congestion signal a gateway
  has (better than round-robin under heterogeneous request cost, no
  replica-side cooperation needed).  Ties break by ICI slice locality —
  prefer the slice the session's KV history lives on (a same-slice re-route
  after failover keeps any future KV migration on ICI instead of DCN),
  then by mesh distance within the slice, then by name for determinism.
- ``SessionAffinityRouter``: sticky session → replica mapping for KV
  reuse (a replica that served a session's earlier turns still holds the
  conversation's cache pages).  Falls back to least-outstanding — with the
  dead replica's slice as the locality hint — when the pinned replica
  drains, and re-pins to the new choice.
- ``PrefixLocalityRouter``: route by longest LOCALLY-cached prefix (PR
  16's fleet-wide prefix tier keeps an advisory warmth map of which
  sealed chains live on which replica), so an agent fleet sharing one
  scaffold packs onto warm replicas instead of spraying cold imports.
  Ties break by least-outstanding among the equally-warm; no warmth at
  all falls back to the consistent-hash ring — which keeps session
  routing deterministic across gateways, and keeps follow turns sticky
  anyway (the session's own replica holds its longest chain).
- ``ConsistentHashRouter``: the multi-gateway tier's affinity policy —
  session → replica via a consistent-hash ring over the routable replica
  keys.  Routing is a pure function of (session, membership), so N
  gateways sharing one registry view route every session IDENTICALLY
  with zero coordination: any gateway can route any session, and a
  sibling taking over a crashed gateway's sessions lands them on the
  same replicas.  Membership changes move only the ring-bounded key
  fraction; each moved session is a "mispin" the dispatcher's
  SessionKVStore restore turns into a KV transfer.
"""

from __future__ import annotations

import threading
from typing import Dict, FrozenSet, List, Mapping, Optional

from kubegpu_tpu_torch.gateway.hashring import ConsistentHashRing
from kubegpu_tpu_torch.gateway.registry import ReplicaInfo
from kubegpu_tpu_torch.types.topology import coords_bounding_box
from kubegpu_tpu_torch.utils.metrics import Metrics


class Router:
    def pick(
        self,
        request,
        replicas: List[ReplicaInfo],
        outstanding: Mapping[str, int],
        exclude: FrozenSet[str] = frozenset(),
    ) -> Optional[ReplicaInfo]:
        raise NotImplementedError


def _phase_candidates(candidates: List[ReplicaInfo]) -> List[ReplicaInfo]:
    """Phase-aware narrowing for FRESH submissions (= the prefill
    phase) in a role-split fleet: prefill-role replicas take them when
    any are routable (shortest-queue/warmth ranking then applies WITHIN
    the prefill pool), and decode-role replicas are avoided while a
    flex replica stands — decode capacity is reserved for handed-off
    sequences.  An all-decode candidate set still serves (availability
    over purity: a lone surviving replica takes the request co-located
    rather than refusing it).  Uniform fleets (every role "flex", the
    default) pass through unchanged."""
    pref = [r for r in candidates
            if getattr(r, "role", "flex") == "prefill"]
    if pref:
        return pref
    flex = [r for r in candidates
            if getattr(r, "role", "flex") != "decode"]
    return flex or candidates


def _mesh_distance(a: ReplicaInfo, b: ReplicaInfo) -> int:
    """Manhattan distance between the two replicas' chip-block origins —
    the ICI hop-count proxy the contiguity scorer uses; only meaningful
    within one slice."""
    if not a.coords or not b.coords:
        return 0
    ao, _ = coords_bounding_box(a.coords)
    bo, _ = coords_bounding_box(b.coords)
    return sum(abs(x - y) for x, y in zip(ao, bo))


def handoff_rank_key(candidate: ReplicaInfo,
                     anchor: Optional[ReplicaInfo],
                     outstanding: Mapping[str, int]):
    """Adjacency score for prefill→decode pair selection (grpalloc-style
    locality from the registry's topology annotations): same slice as
    the anchor first — handoff bytes ride ICI, not DCN — then mesh
    distance within the slice, then load, then key for determinism.
    Lower sorts first; shared between the dispatcher's pre-seal target
    pick (the delta stream's destination) and the seal-time handoff
    rank, so the streamed target and the final-hop target agree."""
    same_slice = (
        anchor is not None and candidate.slice_id == anchor.slice_id
    )
    return (
        0 if same_slice else 1,
        _mesh_distance(candidate, anchor) if same_slice else 0,
        outstanding.get(candidate.key, 0),
        candidate.key,
    )


class LeastOutstandingRouter(Router):
    def pick(self, request, replicas, outstanding, exclude=frozenset()):
        candidates = _phase_candidates(
            [r for r in replicas if r.key not in exclude]
        )
        if not candidates:
            return None
        hint_slice = getattr(request, "preferred_slice", None)
        hint_replica = getattr(request, "preferred_replica", None)
        anchor = next(
            (r for r in replicas if r.key == hint_replica), None
        )

        def rank(r: ReplicaInfo):
            # smaller is better on every component; name last makes the
            # whole ordering total and deterministic
            return (
                outstanding.get(r.key, 0),
                0 if (hint_slice and r.slice_id == hint_slice) else 1,
                _mesh_distance(r, anchor) if (
                    anchor is not None and r.slice_id == anchor.slice_id
                ) else 0,
                r.key,
            )

        return min(candidates, key=rank)


class SessionAffinityRouter(Router):
    """Sticky sessions over a fallback router (LeastOutstanding default).

    The pin map is bounded: entries for sessions nobody re-requests age
    out FIFO past ``max_sessions`` — an affinity table must not grow with
    total session history.

    ``metrics``: a re-pin after a pinned replica dies is a KV-loss event
    (the session's cached prefix pages die with the replica, and the new
    replica's ``prefix_hit_tokens`` start from zero) — counted as
    ``gateway_session_repin_total`` so operators see affinity churn next
    to the hit-rate it costs.  ``Gateway`` wires its own registry in when
    the caller didn't.
    """

    def __init__(self, fallback: Optional[Router] = None,
                 max_sessions: int = 65536,
                 metrics: Optional[Metrics] = None) -> None:
        self.fallback = fallback or LeastOutstandingRouter()
        self.max_sessions = max_sessions
        self.metrics = metrics
        self._lock = threading.Lock()
        self._pins: Dict[str, str] = {}  # session -> replica key
        # each pinned replica's slice, so a DEAD pin can still hint
        # locality (the dead replica no longer appears in `replicas`).
        # Same FIFO bound as the pins: one entry per replica key ever
        # pinned would otherwise leak across replica pod churn
        self._last_slices: Dict[str, Optional[str]] = {}

    def pick(self, request, replicas, outstanding, exclude=frozenset()):
        session = getattr(request, "session", None)
        # the dispatcher's open route span, when tracing: the pin
        # decision lands in the request's tree (pinned hit vs re-pin is
        # exactly the "why was turn-2 TTFT cold" answer)
        route_span = getattr(request, "route_span", None)
        if not session:
            return self.fallback.pick(request, replicas, outstanding, exclude)
        with self._lock:
            pinned = self._pins.get(session)
        by_key = {r.key: r for r in replicas}
        if pinned and pinned in by_key and pinned not in exclude:
            if route_span is not None:
                route_span.annotate(session=session, pinned=pinned,
                                    repin=False)
            return by_key[pinned]
        # pinned replica drained (or first sighting): route by load, with
        # the old pin as the locality hint so the replacement stays on the
        # slice the session's KV lived on where possible
        if pinned is not None:
            request = _with_hint(request, pinned, self._slice_of(pinned))
        choice = self.fallback.pick(request, replicas, outstanding, exclude)
        if choice is not None:
            if route_span is not None:
                route_span.annotate(
                    session=session, repin=pinned is not None,
                    lost_pin=pinned or "",
                )
            if pinned is not None and self.metrics is not None:
                # the session HAD a pin and lost it: its KV history is
                # gone wherever the old replica went
                self.metrics.inc("gateway_session_repin_total")
            with self._lock:
                self._pins[session] = choice.key
                self._last_slices[choice.key] = choice.slice_id
                while len(self._pins) > self.max_sessions:
                    self._pins.pop(next(iter(self._pins)))
                while len(self._last_slices) > self.max_sessions:
                    self._last_slices.pop(next(iter(self._last_slices)))
        return choice

    def _slice_of(self, replica_key: str) -> Optional[str]:
        return self._last_slices.get(replica_key)

    def forget(self, session: str) -> None:
        with self._lock:
            self._pins.pop(session, None)

    def pins_on(self, replica_key: str) -> List[str]:
        """Sessions currently pinned to one replica — the drain path's
        capture list (their sealed KV should be exported before the
        replica is released)."""
        with self._lock:
            return [
                s for s, k in self._pins.items() if k == replica_key
            ]

    def forget_replica(self, replica_key: str) -> None:
        """Drop every pin to a draining/released replica.  A PLANNED
        unpin: the next turn re-pins by load (with the sealed-export
        restore making the move a transfer) and is not counted as a
        KV-loss re-pin — the loss metric is for replicas that die out
        from under their sessions."""
        with self._lock:
            for s in [
                s for s, k in self._pins.items() if k == replica_key
            ]:
                del self._pins[s]


class ConsistentHashRouter(Router):
    """Session → replica by consistent hashing over routable replicas.

    Stateless where it matters: the ring is rebuilt from whatever
    replica list the dispatcher passes (the shared registry view), so
    every gateway instance holding its own ``ConsistentHashRouter``
    computes the same route — the tier's no-coordination guarantee.
    The only retained state is a bounded last-route memo used to COUNT
    movement (``gateway_session_repin_total`` when a session's ring
    target changed — the KV either moved with it via the sealed-export
    restore or re-prefills cold) and to annotate route spans.

    Sessionless requests fall back (LeastOutstanding default); the
    exclude set walks the ring clockwise, so retries/hedges visit
    replicas in the same deterministic order on every gateway.
    """

    def __init__(self, fallback: Optional[Router] = None,
                 vnodes: int = 64, max_sessions: int = 65536,
                 metrics: Optional[Metrics] = None) -> None:
        self.fallback = fallback or LeastOutstandingRouter()
        self.metrics = metrics
        self.max_sessions = max_sessions
        self._lock = threading.Lock()
        self._ring = ConsistentHashRing(vnodes=vnodes)
        self._last_route: Dict[str, str] = {}  # session -> replica key

    def pick(self, request, replicas, outstanding, exclude=frozenset()):
        session = getattr(request, "session", None)
        if not session:
            return self.fallback.pick(request, replicas, outstanding,
                                      exclude)
        by_key = {r.key: r for r in replicas}
        route_span = getattr(request, "route_span", None)
        # an exclude-walk (hedge twin, retry probe) is NOT a route
        # change: the session's ring home is unchanged — it must
        # neither overwrite the movement memo nor count as a repin
        probing = bool(exclude)
        with self._lock:
            self._ring.rebuild(by_key)
            target = self._ring.lookup(session, exclude=frozenset(exclude))
            prev = self._last_route.get(session)
            if target is not None and not probing:
                self._last_route[session] = target
                while len(self._last_route) > self.max_sessions:
                    self._last_route.pop(next(iter(self._last_route)))
        if target is None:
            return None
        moved = not probing and prev is not None and prev != target
        if route_span is not None:
            route_span.annotate(session=session, ring=True,
                                repin=moved, lost_pin=prev or "")
        if moved and self.metrics is not None:
            # the ring target changed (membership churn): the session's
            # KV is elsewhere — the sealed-export restore decides
            # whether that is a transfer or a cold prefill
            self.metrics.inc("gateway_session_repin_total")
        return by_key[target]

    def forget_replica(self, replica_key: str) -> None:
        """Drain bookkeeping parity with SessionAffinityRouter: drop the
        movement memos pointing at a released replica so its eventual
        ring re-entry (same pod name, fresh process) is not counted as
        a second move."""
        with self._lock:
            for s in [
                s for s, k in self._last_route.items() if k == replica_key
            ]:
                del self._last_route[s]


class PrefixLocalityRouter(Router):
    """Prefix-locality routing over the fleet-wide prefix tier.

    Scores every routable replica by how many pages of the request's
    prompt are already warm there (``PrefixTier.locality_scores`` — the
    advisory warmth map fed by sealed-here/imported-here events) and
    routes to the warmest; equal warmth breaks by least-outstanding,
    zero warmth falls back (``ConsistentHashRouter`` default, so
    sessionful traffic stays ring-deterministic tier-wide).

    The warmth map is ADVISORY: a stale score routes one request to a
    replica that then probes the tier or prefills cold — a perf blip,
    never wrong tokens, because the replica's content-keyed cache is
    the ground truth at admission.  ``forget_replica`` drops both the
    tier's warmth and the fallback's memos, which also keeps the
    dispatcher's mispin-restore duck-typing intact."""

    def __init__(self, tier, fallback: Optional[Router] = None,
                 metrics: Optional[Metrics] = None) -> None:
        self.tier = tier
        self.fallback = fallback or ConsistentHashRouter(metrics=metrics)
        self.metrics = metrics

    def pick(self, request, replicas, outstanding, exclude=frozenset()):
        candidates = _phase_candidates(
            [r for r in replicas if r.key not in exclude]
        )
        if not candidates:
            return None
        prompt = getattr(request, "prompt", None)
        scores: Mapping[str, int] = {}
        if prompt:
            scores = self.tier.locality_scores(
                prompt, [r.key for r in candidates]
            )
        best = max(scores.values(), default=0)
        if best > 0:
            warm = [r for r in candidates if scores.get(r.key, 0) == best]
            choice = min(
                warm, key=lambda r: (outstanding.get(r.key, 0), r.key)
            )
            route_span = getattr(request, "route_span", None)
            if route_span is not None:
                route_span.annotate(prefix_locality=True,
                                    warm_pages=best)
            if self.metrics is not None:
                self.metrics.inc("gateway_prefix_route_warm_total")
            return choice
        return self.fallback.pick(request, replicas, outstanding, exclude)

    def forget_replica(self, replica_key: str) -> None:
        self.tier.forget_replica(replica_key)
        forget = getattr(self.fallback, "forget_replica", None)
        if forget is not None:
            forget(replica_key)


class _with_hint:
    """Request view carrying a routing hint without mutating the caller's
    request object (dispatch may retry with the original)."""

    def __init__(self, request, preferred_replica, preferred_slice):
        self._request = request
        self.preferred_replica = preferred_replica
        self.preferred_slice = preferred_slice

    def __getattr__(self, name):
        return getattr(self._request, name)
