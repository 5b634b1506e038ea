"""The port's copy of the JAX package's ``gateway/registry.py``.

Replica discovery: which decode replicas exist and which are routable.

The control plane already publishes everything discovery needs — the bind
writes each replica pod's chip assignment into its annotations, and the
advertiser re-publishes per-chip health into node annotations every cycle
(SURVEY.md §1: annotations ARE the durable state).  The registry is a pure
read-side join of the two:

    replica is LIVE  ⇔  pod carries kubegpu-tpu/serving-group
                     ∧  pod is bound with an assignment annotation
                     ∧  pod is not terminal / terminating
                     ∧  every assigned chip is currently advertised healthy

so a chip death drains its replica in the SAME advertise cycle the
scheduler sees it — no separate health prober, no lag between "scheduler
evicts the pod" and "gateway stops routing to it".  Watches (node + pod)
make the drain event-driven; a periodic refresh is the consistency
backstop, exactly the scheduler's informer/resync split.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Set

from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.topology import Coord
from kubegpu_tpu_torch.utils.apiserver import ApiServer

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class ReplicaInfo:
    """One routable decode replica (a bound serving pod)."""

    key: str                      # "namespace/pod" — the routing identity
    pod: str
    namespace: str
    group: str
    node: str
    slice_id: Optional[str]
    coords: FrozenSet[Coord] = field(default_factory=frozenset)
    healthy: bool = True
    reason: str = ""              # why not healthy (operator-facing)
    # data-plane address (status.podIP): where the replica's HTTP serving
    # endpoint lives — the HttpReplicaClient resolves "addr:port" from
    # this.  None until kubelet reports the IP (the HTTP probe then
    # holds the replica out of the live set, which is correct: a replica
    # without a routable address cannot serve)
    addr: Optional[str] = None
    # DRAINING: still healthy and serving its in-flight work (the data
    # plane keeps its connections), but the router must not place new
    # admissions on it — the graceful half of the replica lifecycle:
    # DRAINING → (sessions migrated / sealed exports captured) → released
    draining: bool = False
    # serving ROLE in a disaggregated fleet (POD_ROLE annotation):
    # "prefill" | "decode" | "flex".  The router prefers prefill replicas
    # for fresh admissions and keeps new work OFF pure-prefill replicas'
    # decode path; absent annotation = flex (co-located, the default)
    role: str = "flex"


class ReplicaRegistry:
    """Read-side join of pod assignments and advertiser health.

    ``subscribe`` observers fire on every live-set CHANGE with the new
    frozenset of live replica keys — the gateway uses this to fail over
    in-flight work the moment a replica drains, and the in-memory replica
    client uses it to model the pod's process dying with its chips.
    """

    def __init__(self, api: ApiServer, group: Optional[str] = None,
                 probe=None, clock: Optional[Callable[[], float]] = None,
                 probe_backoff_base_s: float = 0.5,
                 probe_backoff_cap_s: float = 30.0) -> None:
        self.api = api
        self.group = group  # None = every serving group
        # optional DATA-PLANE health probe: called with each replica the
        # annotation join believes healthy; (False, why) drains it.  The
        # HTTP data plane wires HttpReplicaClient.probe here so in-cluster
        # liveness is the serving endpoint answering /healthz, not just
        # the control plane's chip-health join.  Probes run serially
        # inside the refresh (bounded ~1 s timeout each) — fine for the
        # replica counts a gateway fronts; sample or parallelize before
        # pointing this at hundreds of replicas.
        self.probe = probe
        # probe BACKOFF: a failing replica's probe retries exponentially
        # (base * 2^(fails-1), capped) with per-try jitter in [0.5, 1.5)x
        # instead of re-probing a dead address every refresh cycle — with
        # watches coalescing refreshes, a dead pod would otherwise eat a
        # connect timeout per cluster event.  A probe success resets the
        # backoff; the clock is injectable for fake-clock unit tests.
        self._clock = clock if clock is not None else time.monotonic
        self.probe_backoff_base_s = probe_backoff_base_s
        self.probe_backoff_cap_s = probe_backoff_cap_s
        self._backoff_rng = random.Random(0)
        # key -> {"fails", "next", "why"}; guarded by _refresh_lock (the
        # only writer is the refresh cycle)
        self._probe_backoff: Dict[str, dict] = {}
        # keys an operator (or Gateway.drain_replica) marked DRAINING
        self._draining: Set[str] = set()
        self._lock = threading.Lock()
        # serializes whole refresh cycles (LIST → join → swap): the watch
        # handlers and the periodic loop both call refresh(), and an older
        # cycle's snapshot must not land AFTER a newer one resurrected —
        # briefly — a replica the newer cycle had drained
        self._refresh_lock = threading.Lock()
        self._replicas: Dict[str, ReplicaInfo] = {}
        self._observers: List[Callable[[FrozenSet[str]], None]] = []
        self._last_live: FrozenSet[str] = frozenset()
        # watch-event coalescing: with a refresher thread running, event
        # handlers set this flag instead of refreshing inline — an
        # advertise cycle over N nodes folds into ~one refresh, not N
        # serialized full LISTs
        self._dirty = threading.Event()
        self._refresher_running = False

    # -- discovery ---------------------------------------------------------
    def refresh(self) -> None:
        """Full LIST resync: rebuild the replica table from pod + node
        annotations.  Cheap (one pod LIST + one node LIST) and idempotent;
        the watch handlers call it too, so event and resync paths cannot
        diverge."""
        with self._refresh_lock:
            self._refresh_locked()

    def _probe_with_backoff(self, key: str, info: "ReplicaInfo"):
        """One backoff-gated probe attempt.  Inside the backoff window
        the cached failure stands (no network touch); outside it the
        probe runs — success clears the state, failure doubles the
        window (jittered, capped)."""
        now = self._clock()
        st = self._probe_backoff.get(key)
        if st is not None and now < st["next"]:
            return False, (
                f"{st['why']} (probe backing off, {st['fails']} fails)"
            )
        ok, why = self.probe(info)
        if ok:
            self._probe_backoff.pop(key, None)
            return True, ""
        fails = (st["fails"] + 1) if st is not None else 1
        delay = min(
            self.probe_backoff_cap_s,
            self.probe_backoff_base_s * 2 ** (fails - 1),
        ) * (0.5 + self._backoff_rng.random())
        self._probe_backoff[key] = {
            "fails": fails, "next": now + delay, "why": why,
        }
        return False, why

    def _refresh_locked(self) -> None:
        chip_health: Dict[tuple, bool] = {}
        advertised_slices = set()
        for node_obj in self.api.list_nodes():
            info = annotations.node_from_k8s(node_obj)
            if info.slice_id is None:
                continue
            advertised_slices.add(info.slice_id)
            for ch in info.chips:
                chip_health[(info.slice_id, ch.coords)] = ch.healthy

        with self._lock:
            draining = set(self._draining)

        replicas: Dict[str, ReplicaInfo] = {}
        for obj in self.api.list_pods():
            meta = obj.get("metadata", {}) or {}
            ann = dict(meta.get("annotations") or {})
            group = ann.get(annotations.POD_SERVING_GROUP)
            if not group or (self.group is not None and group != self.group):
                continue
            ns = meta.get("namespace", "default")
            name = meta.get("name", "")
            key = f"{ns}/{name}"
            # adopt the durable DRAINING mark: a restarted process's
            # fresh registry must not re-admit a half-drained replica
            # (the in-memory set dies with the process; the annotation
            # doesn't — and a recreated pod starts without it)
            if ann.get(annotations.POD_DRAINING) == "true":
                draining.add(key)
                with self._lock:
                    self._draining.add(key)
            node = (obj.get("spec") or {}).get("nodeName") or ""
            a = annotations.assignment_from_pod(obj)
            status = obj.get("status") or {}
            phase = (status.get("phase") or "")
            addr = status.get("podIP") or None
            healthy, reason = True, ""
            coords: FrozenSet[Coord] = frozenset()
            slice_id = None
            if not node or a is None:
                healthy, reason = False, "unscheduled (no assignment yet)"
            elif phase in ("Succeeded", "Failed"):
                healthy, reason = False, f"terminal ({phase})"
            elif meta.get("deletionTimestamp"):
                healthy, reason = False, "terminating"
            else:
                slice_id = a.slice_id
                coords = frozenset(c.coords for c in a.all_chips())
                if slice_id is not None and slice_id not in advertised_slices:
                    healthy, reason = False, f"slice {slice_id} not advertised"
                else:
                    dead = sorted(
                        c for c in coords
                        if not chip_health.get((slice_id, c), False)
                    )
                    if dead:
                        healthy, reason = False, f"dead chips {dead}"
            role = ann.get(annotations.POD_ROLE) or "flex"
            if role not in ("prefill", "decode", "flex"):
                role = "flex"   # unknown role values degrade to co-located
            info = ReplicaInfo(
                key=key, pod=name, namespace=ns, group=group, node=node,
                slice_id=slice_id, coords=coords, healthy=healthy,
                reason=reason, addr=addr, draining=key in draining,
                role=role,
            )
            if healthy and self.probe is not None:
                ok, why = self._probe_with_backoff(key, info)
                if not ok:
                    info = ReplicaInfo(
                        key=key, pod=name, namespace=ns, group=group,
                        node=node, slice_id=slice_id, coords=coords,
                        healthy=False, reason=f"data plane: {why}",
                        addr=addr, draining=key in draining, role=role,
                    )
            replicas[key] = info

        # prune state for replicas that left the cluster: a recreated
        # pod under the same name starts with a clean slate (no stale
        # backoff window, no inherited DRAINING mark)
        self._probe_backoff = {
            k: v for k, v in self._probe_backoff.items() if k in replicas
        }
        with self._lock:
            self._draining &= set(replicas)
            self._replicas = replicas
            live = frozenset(k for k, r in replicas.items() if r.healthy)
            changed = live != self._last_live
            self._last_live = live
            observers = list(self._observers)
        if changed:
            for fn in observers:
                try:
                    fn(live)
                except Exception:  # noqa: BLE001 - observers are best-effort
                    log.exception("replica-set observer failed")

    # -- replica lifecycle (DRAINING → released) ---------------------------
    def set_draining(self, key: str, draining: bool = True) -> None:
        """Mark a replica DRAINING (or clear it).  A draining replica
        stays HEALTHY — its data-plane connections and in-flight
        sequences keep serving, and the live-set observers do NOT fire
        (firing would make clients abort the very streams a graceful
        drain is migrating) — but ``routable()`` excludes it, so no new
        admissions land there.  Refreshes immediately so routing sees
        the state this cycle."""
        with self._lock:
            if draining:
                self._draining.add(key)
            else:
                self._draining.discard(key)
        # persist the mark on the pod (best-effort): the in-memory set
        # dies with this process, and a restarted controller adopts an
        # in-progress drain from the annotation at its first refresh
        patch = getattr(self.api, "patch_pod_annotations", None)
        if patch is not None:
            ns, _, name = key.partition("/")
            try:
                patch(ns, name, {
                    annotations.POD_DRAINING: "true" if draining else "",
                })
            except Exception:  # noqa: BLE001 - the mark still holds
                log.debug("draining annotation patch failed for %s", key,
                          exc_info=True)
        self.refresh()

    def draining_keys(self) -> FrozenSet[str]:
        with self._lock:
            return frozenset(self._draining)

    def set_role(self, key: str, role: str) -> None:
        """Reassign a replica's serving role (the FleetController's
        prefill:decode ratio actuator).  Persisted on the pod like the
        DRAINING mark — a restarted gateway adopts the fleet's current
        role split from annotations at its first refresh — then
        refreshed immediately so routing sees the new role this cycle.
        In-flight sequences are untouched: a prefill→flex flip only
        changes where NEW admissions land and whether the replica's
        batcher parks post-seal."""
        if role not in ("prefill", "decode", "flex"):
            raise ValueError(f"unknown role {role!r}")
        patch = getattr(self.api, "patch_pod_annotations", None)
        if patch is not None:
            ns, _, name = key.partition("/")
            try:
                patch(ns, name, {
                    annotations.POD_ROLE: "" if role == "flex" else role,
                })
            except Exception:  # noqa: BLE001 - best-effort, like draining
                log.debug("role annotation patch failed for %s", key,
                          exc_info=True)
        self.refresh()

    # -- views -------------------------------------------------------------
    def live(self) -> List[ReplicaInfo]:
        """Healthy replicas (DRAINING included — their data plane is
        alive), name-sorted for deterministic iteration."""
        with self._lock:
            return sorted(
                (r for r in self._replicas.values() if r.healthy),
                key=lambda r: r.key,
            )

    def routable(self) -> List[ReplicaInfo]:
        """Replicas new admissions may land on: healthy AND not
        draining — the router's view of the world."""
        return [r for r in self.live() if not r.draining]

    def all(self) -> List[ReplicaInfo]:
        with self._lock:
            return sorted(self._replicas.values(), key=lambda r: r.key)

    def get(self, key: str) -> Optional[ReplicaInfo]:
        with self._lock:
            return self._replicas.get(key)

    def live_keys(self) -> FrozenSet[str]:
        with self._lock:
            return self._last_live

    def subscribe(self, fn: Callable[[FrozenSet[str]], None]) -> None:
        with self._lock:
            self._observers.append(fn)

    def unsubscribe(self, fn: Callable[[FrozenSet[str]], None]) -> None:
        """Detach an observer (idempotent).  A registry is SHARED across
        a gateway tier; a killed gateway must stop observing the live
        set — a corpse mutating the shared session store (or publishing
        gauges) on every membership change is the kind of half-dead
        process a real crash never leaves behind."""
        with self._lock:
            try:
                self._observers.remove(fn)
            except ValueError:
                pass

    # -- event plumbing ----------------------------------------------------
    def _request_refresh(self) -> None:
        """Refresh now, or mark dirty for the coalescing refresher if one
        is running (start_watches) — a burst of events then costs one
        refresh instead of one per event."""
        if self._refresher_running:
            self._dirty.set()
        else:
            self.refresh()

    def on_pod_event(self, event: str, obj: dict) -> None:
        ann = ((obj.get("metadata") or {}).get("annotations") or {})
        if annotations.POD_SERVING_GROUP in ann:
            self._request_refresh()

    def on_node_event(self, event: str, obj: dict) -> None:
        # only advertiser-annotated nodes affect replica health
        ann = ((obj.get("metadata") or {}).get("annotations") or {})
        if annotations.NODE_TOPOLOGY in ann or event == "node-deleted":
            self._request_refresh()

    def start_watches(self, stop: threading.Event) -> List[threading.Thread]:
        """Spawn the node + pod watch threads (the event-driven drain
        path) plus the coalescing refresher that serves their dirty
        flags; callers keep the periodic refresh as backstop."""
        self._refresher_running = True

        def refresher():
            while not stop.is_set():
                if not self._dirty.wait(0.05):
                    continue
                self._dirty.clear()
                try:
                    self.refresh()
                except Exception:  # noqa: BLE001
                    log.exception("coalesced refresh failed; will retry")

        threads = []
        for target in (
            lambda: self.api.watch_nodes(self.on_node_event, stop),
            lambda: self.api.watch_pods(self.on_pod_event, stop),
            refresher,
        ):
            t = threading.Thread(target=self._guard(target), daemon=True)
            t.start()
            threads.append(t)
        return threads

    @staticmethod
    def _guard(target):
        def run():
            try:
                target()
            except NotImplementedError:
                log.info("api server has no watch; relying on refresh loop")
            except Exception:  # noqa: BLE001
                log.exception("registry watch died; relying on refresh loop")
        return run
