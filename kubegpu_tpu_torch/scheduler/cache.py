"""The port's copy of the JAX package's ``scheduler/cache.py``.

ClusterCache: the extender's only mutable state — rebuilt from the API
server at any time.

Parity with the reference's in-memory cluster cache (SURVEY.md §2 #4, §3.5):
nodes' device trees decoded from annotations; in-flight + bound allocations
replayed into per-node used-trees.  Because every allocation is durably
recorded in pod annotations at bind time, a restarted scheduler calls
``refresh()`` and is exactly where it left off — no database (§1 data-flow
contract).  Thread-safe: filter/prioritize run concurrently; mutations are
serialized (SURVEY.md §7 hard part (c)).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from kubegpu_tpu_torch.grpalloc import (
    SliceView,
    build_slice_views,
    return_pod_resources,
    take_pod_resources,
)
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.info import Assignment, NodeInfo
from kubegpu_tpu_torch.utils.apiserver import ApiServer, NotFound

log = logging.getLogger(__name__)


def _live_assignment(obj: dict) -> Optional[Assignment]:
    """A pod's assignment FOR CHARGING purposes: terminal-phase pods
    (Succeeded/Failed) hold nothing — their containers are done and will
    never run again, so their chips are free the moment the phase lands,
    annotation lingering or not (standard kube-scheduler accounting).
    The annotation itself is left in place: it is history, not a claim."""
    phase = ((obj.get("status") or {}).get("phase") or "")
    if phase in ("Succeeded", "Failed"):
        return None
    return annotations.assignment_from_pod(obj)


class ClusterCache:
    def __init__(self, api: ApiServer) -> None:
        self.api = api
        self._lock = threading.RLock()
        self._nodes: Dict[str, NodeInfo] = {}
        # pod key -> Assignment, both bound (from annotations) and assumed
        # (bind in flight); the used-trees of _nodes are derived from this
        self._assignments: Dict[str, Assignment] = {}
        # keys reserved in memory but not yet durably annotated (gang plans,
        # binds in flight).  refresh() must carry these over — wiping them
        # would let the resync loop double-allocate chips under a live plan.
        self._assumed: set = set()
        # pod key -> node name, for annotated pods whose node was NOT in the
        # last refresh's LIST.  These never enter _assignments (no tree to
        # charge), but the failure detector must still see them: a vanished
        # node (dead advertiser, deregistered VM) is precisely the case
        # where no future advertisement will ever evict the pod.
        self._orphaned: Dict[str, str] = {}
        # pod key -> node name, for records whose chips CONFLICTED at the
        # last refresh (another record holds the charge).  Usually a
        # transient race that the next refresh clears; if it persists, two
        # live annotations claim one chip — a pathological durable state
        # the scheduler's conflict sweep resolves by evicting the uncharged
        # claimant after a grace window.  Tracked so the pod is never
        # invisible to every detector while bound+annotated.
        self._conflicted: Dict[str, str] = {}

    # -- building ---------------------------------------------------------
    def refresh(self) -> None:
        """Reconcile with API-server state (startup + resync): rebuild the
        NODE views from fresh advertisements, keep the LIVE in-memory
        assignments (re-charged onto the fresh nodes), and use the pod LIST
        only to NOMINATE divergence candidates — each confirmed with a
        fresh per-pod GET before anything is adopted or removed.

        Why not rebuild assignments from the LIST (the obvious design, and
        round 1's): the LISTs happen BEFORE the lock (a slow API server
        must not stall every verb), so the snapshot is stale against
        concurrent binds/deletes, and every rebuild-from-snapshot variant
        the threaded soak was pointed at leaked a double-allocation — a
        committed bind wiped because its annotation post-dated the LIST, a
        deleted pod's ghost replayed over the new owner's chips, a ghost
        eviction returning chips the real owner charged.  Reconciliation
        kills the class: stale data can never displace live memory, and
        nothing enters or leaves the assignment map without a
        fresh-as-of-now GET agreeing.  Races that remain only make chips
        look USED one cycle too long (the safe direction) — the next
        refresh converges.

        On a cold start the memory is empty, every annotated pod is a
        nominee, and the GET-confirmed adoptions ARE the restart replay
        (SURVEY.md §3.5 — what makes restarts safe with no database)."""
        from kubegpu_tpu_torch.grpalloc.allocator import clear_fit_caches

        clear_fit_caches()  # bound memo retention to one resync period
        nodes_raw = self.api.list_nodes()
        pods_raw = self.api.list_pods()
        with self._lock:
            self._nodes = {}
            for obj in nodes_raw:
                try:
                    node = annotations.node_from_k8s(obj)
                except Exception:  # noqa: BLE001 - one bad annotation must not
                    log.exception("ignoring undecodable node annotation")
                    continue
                self._nodes[node.name] = node
            # re-charge LIVE memory onto the fresh nodes (never wiped by
            # stale snapshot data); _carry routes vanished-node records to
            # _orphaned and conflicting records to _conflicted
            prev = self._assignments
            prev_assumed = set(self._assumed)
            self._assignments = {}
            self._assumed = set()
            self._orphaned = {}
            self._conflicted = {}
            for key, a in prev.items():
                self._carry(key, a, key in prev_assumed)
            # nominate divergences vs the (stale) snapshot
            listed: Dict[str, Optional[Assignment]] = {}
            for obj in pods_raw:
                meta = obj.get("metadata", {})
                key = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
                try:
                    listed[key] = _live_assignment(obj)
                except Exception:  # noqa: BLE001
                    log.exception("ignoring undecodable pod assignment")
                    listed[key] = None
            adopt = sorted(
                key
                for key, a in listed.items()
                if a is not None
                and (a.all_chips() or a.grouped)
                and key not in self._assignments
                and key not in self._orphaned
            )
            # memory entries the snapshot does not back: confirmed ones
            # whose annotation is unlisted/cleared (deletion or eviction
            # may have won a race), assumed ones whose pod is unlisted
            # (may simply post-date the LIST — existence decides)
            drop_check = {
                key: (key in self._assumed)
                for key in sorted(self._assignments)
                if (key in self._assumed and key not in listed)
                or (key not in self._assumed and listed.get(key) is None)
            }
            prev_ids = {k: self._assignments[k] for k in drop_check}
        if not adopt and not drop_check:
            return
        # fresh-as-of-now confirmation, UNLOCKED (network; see docstring)
        adopt_now: Dict[str, Assignment] = {}
        for key in adopt:
            cur = self._get_current_assignment(key)
            if isinstance(cur, Assignment):
                adopt_now[key] = cur
        remove_now: Dict[str, Optional[Assignment]] = {}
        for key, assumed in drop_check.items():
            cur = self._get_current_assignment(key)
            if cur == "gone":
                remove_now[key] = None  # pod positively deleted
            elif assumed or cur == "unknown":
                continue  # in-flight pod exists / transient error: keep
            elif not isinstance(cur, Assignment):
                remove_now[key] = None  # annotation cleared: eviction won
            elif (
                annotations.encode_assignment(cur)
                != annotations.encode_assignment(prev_ids[key])
            ):
                remove_now[key] = cur  # re-planned meanwhile: adopt truth
        if not adopt_now and not remove_now:
            return
        with self._lock:
            for key, cur in remove_now.items():
                if self._assignments.get(key) is not prev_ids.get(key):
                    continue  # replaced meanwhile (new bind/plan): theirs wins
                self.remove_pod(key)
                if cur is not None:
                    self._carry(key, cur, False)
            for key, cur in adopt_now.items():
                if key in self._assignments or key in self._orphaned:
                    continue  # bound/planned meanwhile: memory is fresher
                self._carry(key, cur, False)

    def _get_current_assignment(self, key: str):
        """Fresh GET verdict for one pod: an Assignment (live annotation),
        None (exists, no device annotation), "gone" (NotFound), or
        "unknown" (transient error / undecodable — treat conservatively)."""
        ns, name = key.split("/", 1)
        try:
            obj = self.api.get_pod(ns, name)
        except NotFound:
            return "gone"
        except Exception:  # noqa: BLE001
            return "unknown"
        try:
            cur = _live_assignment(obj)
        except Exception:  # noqa: BLE001
            return "unknown"
        if cur is not None and (cur.all_chips() or cur.grouped):
            return cur
        return None

    def _carry(self, key: str, a: Assignment, assumed: bool) -> bool:
        """Charge one adopted/kept assignment (lock held)."""
        node = self._nodes.get(a.node)
        if node is None:
            # node vanished from the LIST: hand the record to the orphan
            # sweep (grace-window eviction owns this case), nothing to charge
            self._orphaned.setdefault(key, a.node)
            return False
        try:
            take_pod_resources(node, a, skip_missing=True)
            self._assignments[key] = a
            if assumed:
                self._assumed.add(key)
            return True
        except ValueError as e:
            # another record holds the charge: track for the conflict
            # sweep instead of letting the pod vanish from every detector
            log.warning("uncharged conflicting record for %s: %s", key, e)
            self._conflicted.setdefault(key, a.node)
            return False

    def update_node(self, obj: dict) -> None:
        """Apply a node watch event: re-decode and re-apply the assignments
        that live on it (a died chip falls out of capacity here)."""
        try:
            node = annotations.node_from_k8s(obj)
        except Exception:  # noqa: BLE001
            log.exception("ignoring undecodable node annotation")
            return
        with self._lock:
            self._nodes[node.name] = node
            for key, a in self._assignments.items():
                if a.node == node.name:
                    try:
                        take_pod_resources(node, a, skip_missing=True)
                    except ValueError as e:
                        log.warning("re-apply of %s on %s: %s", key, node.name, e)

    def remove_pod(self, key: str) -> None:
        """Pod deleted/finished: return its chips — and drop it from EVERY
        detector (a pod deleted while orphan- or conflict-tracked must not
        keep accruing strikes toward evicting an already-deleted pod)."""
        with self._lock:
            self._assumed.discard(key)
            self._orphaned.pop(key, None)
            self._conflicted.pop(key, None)
            a = self._assignments.pop(key, None)
            if a is None:
                return
            node = self._nodes.get(a.node)
            if node is not None:
                return_pod_resources(node, a)

    # -- allocation bookkeeping -------------------------------------------
    def assume(self, key: str, assignment: Assignment) -> None:
        """Reserve an in-flight allocation.  Raises ValueError on any chip
        already taken (bind race) with no state change."""
        with self._lock:
            if key in self._assignments:
                raise ValueError(f"pod {key} already has an assignment")
            node = self._nodes.get(assignment.node)
            if node is None:
                raise KeyError(f"unknown node {assignment.node}")
            take_pod_resources(node, assignment)
            self._assignments[key] = assignment
            self._assumed.add(key)

    def confirm(self, key: str) -> None:
        """Mark a reservation durable (its assignment annotation is written):
        refresh() will from now on rebuild it from the API server."""
        with self._lock:
            self._assumed.discard(key)

    def forget(self, key: str) -> None:
        """Undo a failed bind (SURVEY.md §3.1 failure containment)."""
        self.remove_pod(key)

    # -- queries ----------------------------------------------------------
    def node(self, name: str) -> Optional[NodeInfo]:
        with self._lock:
            return self._nodes.get(name)

    def node_names(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    def views(self) -> Dict[str, SliceView]:
        with self._lock:
            return build_slice_views(self._nodes.values())

    def assignment_of(self, key: str) -> Optional[Assignment]:
        with self._lock:
            return self._assignments.get(key)

    def assignments_snapshot(self) -> Dict[str, Assignment]:
        with self._lock:
            return dict(self._assignments)

    def assumed_keys(self) -> List[str]:
        """Locked snapshot of in-flight (reserved, unconfirmed) pod keys."""
        with self._lock:
            return sorted(self._assumed)

    def orphaned_assignments(self) -> Dict[str, str]:
        """pod key -> vanished node name, as of the last refresh()."""
        with self._lock:
            return dict(self._orphaned)

    def conflicted_assignments(self) -> Dict[str, str]:
        """pod key -> node name of records whose chips another record holds
        (uncharged, tracked for the scheduler's conflict sweep)."""
        with self._lock:
            return dict(self._conflicted)

    @property
    def lock(self) -> threading.RLock:
        """Callers that must fit+assume atomically (bind) hold this."""
        return self._lock
