"""The port's copy of the JAX package's ``scheduler/podgroup.py``.

Gang scheduling: pod-group plans with all-or-nothing reservation.

The scheduler-extender API is one-pod-at-a-time, which deadlocks naive gang
placement (SURVEY.md §7 hard part (b): partial placements strand chips).
Solution: when the FIRST member of a group reaches filter, gather the whole
group from the API server, run ``grpalloc.fit_gang`` over a slice, and if it
fits **reserve every member's chips in the cache immediately** (assume).
Later members hit the existing plan; bind just confirms.  If the group never
fully arrives or binds stall, the plan expires and its uncommitted
reservations are returned — no leaked chips.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from kubegpu_tpu_torch.grpalloc import fit_gang_multislice
from kubegpu_tpu_torch.grpalloc.multislice import fit_gang_into_layout
from kubegpu_tpu_torch.scheduler.cache import ClusterCache
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.info import Assignment, PodInfo, TpuRequest
from kubegpu_tpu_torch.utils.apiserver import NotFound

log = logging.getLogger(__name__)


def consensus_str(values: List[str]) -> str:
    """Most-common string, ties toward the lexicographically smaller —
    one member carrying a stale pod-group-uid must not move which
    incarnation the gang is judged as.  Lives here (not core) because
    gang_arithmetic applies it for BOTH the planner and the stranded
    sweep — the incarnation is derived identically at every call site."""
    if not values:
        return ""
    counts: Dict[str, int] = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    top = max(counts.values())
    return min(v for v, c in counts.items() if c == top)


def _incarnations_of(pod: "PodInfo", pending, scheduled) -> List[str]:
    """The uid list the planner hands gang_arithmetic — NON-terminating
    members only, mirroring the stranded sweep's ``g["incarnations"]``
    (which skips terminal AND terminating pods before recording a uid).
    During a name-reuse transition the old run's members are exactly the
    terminating ones; including them could flip the consensus to the old
    incarnation and shrink the new run's denominator by the old run's
    completions.  Falls back to the triggering pod's own uid when every
    gathered member is terminating (the sweep would not judge such a gang
    at all, so no divergence is possible there)."""
    uids = [
        p.pod_group_uid for p in pending + scheduled if not p.terminating
    ]
    return uids or [pod.pod_group_uid]


def fold_layout(sched_slices, sched_coords):
    """(layout counts, occupied coords per slice) from a gang's scheduled
    members — the ONE aggregation both planning (try_plan) and preemption
    simulation (layout_and_occupancy_of) consume, so they can never
    drift."""
    layout: Dict[str, int] = {}
    occupied: Dict[str, frozenset] = {}
    for key, sid in sched_slices.items():
        if not sid:
            continue
        layout[sid] = layout.get(sid, 0) + 1
        if key in sched_coords:
            occupied[sid] = occupied.get(sid, frozenset()) | sched_coords[key]
    return layout, occupied


@dataclass
class GangPlan:
    group: str                       # namespace/groupname
    created: float
    per_pod: Dict[str, Assignment]   # pod key -> assignment
    committed: Set[str] = field(default_factory=set)
    score: float = 0.0


class PodGroupRegistry:
    def __init__(self, cache: ClusterCache, plan_ttl_s: float = 120.0) -> None:
        self.cache = cache
        self.plan_ttl_s = plan_ttl_s
        self._lock = threading.RLock()
        self._plans: Dict[str, GangPlan] = {}
        # keys whose bind verb is between reservation-check and durable
        # commit RIGHT NOW: drop_plan must not forget their reservations —
        # the in-flight bind will land a durable annotation, and freeing
        # the chips under it would let another pod double-claim them for
        # a conflict-sweep-length window
        self._binding: Set[str] = set()
        # gang key -> incarnation id -> member keys ever seen Succeeded.
        # Completed members owe no replacement, so they shrink BOTH the
        # planner's "all members created" requirement and the stranded
        # sweep's denominator — and the memory must survive their GC
        # deletion (a TTL controller removes them between LISTs).  One
        # shared record keeps planner and sweep from ever disagreeing on
        # gang arithmetic.  Scoped by the POD_GROUP_UID annotation
        # (incarnation id, e.g. the owning Job's UID; "" when unset): a
        # NEW run reusing a gang name starts clean instead of inheriting
        # the old run's done count (ADVICE r3 medium — inherited memory
        # pinned outstanding at 0 and wedged the gang until restart).
        # (Lost on scheduler restart; the no-progress grace window is the
        # remaining protection then.)
        self._done: Dict[str, Dict[str, Set[str]]] = {}

    # -- completed-member memory ------------------------------------------
    def note_done(self, gk: str, member_key: str, incarnation: str = "") -> None:
        with self._lock:
            self._done.setdefault(gk, {}).setdefault(incarnation, set()).add(
                member_key
            )

    def note_live(self, gk: str, member_key: str) -> None:
        """A live pod reusing a remembered name must not double-count
        (once live, once as remembered-done) — in ANY incarnation: a
        recreated name supersedes every older memory of it."""
        with self._lock:
            for members in self._done.get(gk, {}).values():
                members.discard(member_key)

    def done_count(self, gk: str, incarnation: str = "") -> int:
        with self._lock:
            return len(self._done.get(gk, {}).get(incarnation, ()))

    def gang_arithmetic(
        self, gk: str, size: int, n_live: int, incarnations: List[str]
    ) -> Tuple[int, bool]:
        """(outstanding, suspect) — the ONE formula the planner
        (try_plan/planned_members) and the stranded-gang sweep share, so
        their gang arithmetic can never diverge: outstanding = the
        declared size minus every member of THIS incarnation remembered
        Succeeded (work done, no replacement owed).

        ``incarnations`` is the live members' pod-group-uids; the judged
        incarnation is their consensus, computed HERE so planner and
        sweep cannot derive it differently (ADVICE r4: the planner used
        to pass the triggering pod's own uid while the sweep took the
        consensus over all live members — with mixed-uid members during
        a name-reuse transition the two could judge different
        incarnations and disagree).

        `suspect` flags over-subscription: MORE live (non-terminal)
        members than the arithmetic leaves room for.  With incarnation
        ids that only happens in pathological flows; without them it is
        the signature of a gang name reused by a new run while the old
        run's Succeeded pods are still listed or remembered — the done
        memory belongs to the old run, and judging the new one by it
        would pin outstanding at 0 and make _select_members reject every
        member forever (the gang wedges until scheduler restart).  On
        suspicion the planner falls back to the FULL declared size (a
        forming run must WAIT for all members, never plan a premature
        sub-gang), and the sweep declines to roll anything back (the
        arithmetic is ambiguous; deleting running pods on ambiguity is
        the one unacceptable direction)."""
        done = self.done_count(gk, consensus_str(incarnations))
        out = size - done
        suspect = n_live > out
        if suspect:
            out = size
        return out, suspect

    def prune_done(self, live_gangs) -> None:
        """Forget gangs no longer listed at all (fully GC'd): nothing is
        left to judge, and a later gang reusing the name starts clean."""
        with self._lock:
            self._done = {
                gk: v for gk, v in self._done.items() if gk in live_gangs
            }

    @staticmethod
    def group_key(pod: PodInfo) -> Optional[str]:
        if not pod.pod_group:
            return None
        return f"{pod.namespace}/{pod.pod_group}"

    # -- plan lifecycle ---------------------------------------------------
    def plan_for(self, pod: PodInfo, now: Optional[float] = None) -> Optional[GangPlan]:
        """Return a live plan covering this pod, if any (expiring stale
        plans on the way)."""
        gk = self.group_key(pod)
        if gk is None:
            return None
        now = time.monotonic() if now is None else now
        with self._lock:
            plan = self._plans.get(gk)
            if plan is None:
                return None
            if now - plan.created > self.plan_ttl_s and len(plan.committed) < len(plan.per_pod):
                self._expire(gk, plan)
                return None
            return plan if pod.key in plan.per_pod else None

    def _expire(self, gk: str, plan: GangPlan) -> None:
        log.warning(
            "gang plan %s expired with %d/%d committed; returning reservations",
            gk,
            len(plan.committed),
            len(plan.per_pod),
        )
        for key in plan.per_pod:
            if key not in plan.committed and key not in self._binding:
                # same mid-bind guard as drop_plan: a member whose durable
                # commit is in flight keeps its reservation (its bind
                # confirms or forgets it)
                self.cache.forget(key)
        del self._plans[gk]

    def plans_snapshot(self) -> Dict[str, dict]:
        """Locked, JSON-ready view of the in-flight plans (observability)."""
        with self._lock:
            return {
                gk: {
                    "members": sorted(p.per_pod),
                    "committed": sorted(p.committed),
                    "score": round(p.score, 1),
                }
                for gk, p in self._plans.items()
            }

    def mark_binding(self, key: str) -> None:
        with self._lock:
            self._binding.add(key)

    def unmark_binding(self, key: str) -> None:
        with self._lock:
            self._binding.discard(key)

    def drop_plan(self, gk: str) -> None:
        with self._lock:
            plan = self._plans.pop(gk, None)
            if plan:
                for key in plan.per_pod:
                    if key not in plan.committed and key not in self._binding:
                        # mid-bind members keep their reservation: their
                        # bind confirms it (success) or forgets it itself
                        # (failure path handles the planless case)
                        self.cache.forget(key)

    def reconcile(self, listed_keys, get_pod) -> None:
        """Resync backstop for MISSED DELETED events (the pod watch is the
        fast path, but a watch race can skip one): a plan covering an
        uncommitted member that is positively gone can never complete —
        it only shields its gang from re-planning and holds reservations
        until TTL.  Same discipline as the cache's reconciliation: the
        (stale) LIST only nominates; a fresh per-pod GET confirms before
        anything is dropped."""
        with self._lock:
            suspects = [
                (gk, key, plan)
                for gk, plan in self._plans.items()
                for key in plan.per_pod
                if key not in plan.committed and key not in listed_keys
            ]
        for gk, key, plan in suspects:
            ns, name = key.split("/", 1)
            try:
                get_pod(ns, name)
                continue  # exists — the LIST was just stale
            except NotFound:
                pass
            except Exception:  # noqa: BLE001 - transient: next resync retries
                continue
            with self._lock:
                # the GETs run unlocked (network): a concurrent filter may
                # have re-planned the gang meanwhile — tearing down THAT
                # fresh plan would spuriously roll back a healthy
                # admission.  Only the exact plan that nominated the
                # vanished member may be dropped.
                cur = self._plans.get(gk)
                if cur is not plan or key in cur.committed:
                    continue
                log.warning(
                    "dropping gang plan %s: planned member %s is gone and "
                    "its DELETED event was never seen (watch race); the "
                    "gang re-plans its remainder",
                    gk, key,
                )
                self.drop_plan(gk)

    def has_live_plan(self, gk: str, now: Optional[float] = None) -> bool:
        """True iff an unexpired plan covers the gang — members are still
        actively binding (the stranded-gang sweep must not count these
        resyncs as stalled)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            plan = self._plans.get(gk)
            if plan is None:
                return False
            if now - plan.created > self.plan_ttl_s and len(plan.committed) < len(plan.per_pod):
                self._expire(gk, plan)
                return False
            return True

    def try_plan(self, pod: PodInfo, now: Optional[float] = None) -> "PlanOutcome":
        """Gather the group, fit it, reserve it.  Called from filter when no
        live plan covers the pod.

        The (blocking) API-server LIST happens *before* the registry lock is
        taken — one slow list must not stall every other gang's verbs — and
        the plan covers only the group's still-unscheduled members, so a
        partially-bound gang (or a deleted-and-recreated member) re-plans
        the remainder instead of deadlocking on its own bound members."""
        gk = self.group_key(pod)
        assert gk is not None
        pending, scheduled, sched_slices, sched_coords = self._gather_members(pod)
        with self._lock:
            existing = self.plan_for(pod, now=now)
            if existing:
                return PlanOutcome(plan=existing)
            # Succeeded members owe no replacement: the outstanding size is
            # the declared size minus every member of this incarnation ever
            # seen Succeeded — matching the stranded sweep's denominator,
            # so a gang the sweep judges healthy can always re-plan its
            # remainder.  (gang_arithmetic also guards gang-name reuse by
            # a new run, which would otherwise wedge at outstanding=0.)
            outstanding, _ = self.gang_arithmetic(
                gk,
                pod.pod_group_size,
                len(pending) + len(scheduled),
                _incarnations_of(pod, pending, scheduled),
            )
            if len(pending) + len(scheduled) < outstanding:
                return PlanOutcome(
                    reason=(
                        f"gang {gk}: waiting for members "
                        f"({len(pending) + len(scheduled)}/{outstanding} "
                        "outstanding created)"
                    )
                )
            members = self._select_members(pod, pending, scheduled, outstanding)
            if members is None:
                # deterministic membership: first N by name; this pod lost
                return PlanOutcome(
                    reason=f"gang {gk}: pod {pod.key} not in first {pod.pod_group_size} members"
                )
            # fit on the best slice — or, for opted-in gangs no single slice
            # holds, across DCN-connected slices (grpalloc.multislice); cache
            # lock held through reserve so the view cannot go stale under us
            with self.cache.lock:
                views = self.cache.views()
                if pod.slice_selector is not None:
                    # tenant pinning: planning only ever sees the allowed
                    # slices (the selector is gang-wide — members share it
                    # via the same annotation)
                    views = {
                        sid: v
                        for sid, v in views.items()
                        if sid in pod.slice_selector
                    }
                    if not views:
                        return PlanOutcome(
                            reason=(
                                f"gang {gk}: no advertised slice matches "
                                f"slice-selector {sorted(pod.slice_selector)}"
                            )
                        )
                layout, occupied = fold_layout(sched_slices, sched_coords)
                # Anchored-refit math assumes every scheduled CHIP member is
                # counted in the layout.  A member whose slice cannot be
                # recovered (assignment annotation cleared mid-eviction, no
                # cache reservation) would silently undercount — and when
                # ALL scheduled members are unrecoverable (scheduler restart
                # mid-gang-eviction) the layout is empty and a fresh plan
                # would bind replacements to arbitrary slices, diverging
                # from the still-Terminating siblings' baked-in env.  Fail
                # with the real reason in both cases so the operator sees
                # why replacements are not being placed.
                lost = sorted(
                    p.key
                    for p in scheduled
                    if sched_slices.get(p.key) is None
                    and TpuRequest.from_pod(p).total_chips > 0
                )
                if lost:
                    return PlanOutcome(
                        reason=(
                            f"gang {gk}: scheduled member(s) "
                            f"{', '.join(lost)} have no recoverable "
                            "slice (assignment cleared mid-eviction?); "
                            "replacements wait until they fully disappear"
                        )
                    )
                if layout:
                    # partially-bound gang: replacements must rejoin the
                    # existing slice layout — the running siblings'
                    # rendezvous/megascale env is already baked in — and,
                    # where the survivors' coords are recoverable, restore
                    # the gang's rectangular union (exact-hole refit)
                    g = fit_gang_into_layout(views, members, layout, occupied)
                else:
                    g = fit_gang_multislice(
                        views, members, allow_multislice=pod.allow_multislice
                    )
                if not g.success:
                    return PlanOutcome(
                        reason=f"gang {gk} does not fit: {g.reason}",
                        capacity_failure=bool(views),
                    )
                taken = []
                for key, a in g.per_pod.items():
                    if not a.all_chips():
                        # chipless member (coordinator/sidecar): nothing to
                        # reserve, and it binds plain — outside the plan
                        continue
                    try:
                        self.cache.assume(key, a)
                        taken.append(key)
                    except (ValueError, KeyError) as e:
                        for k2 in taken:
                            self.cache.forget(k2)
                        return PlanOutcome(reason=f"gang {gk} reservation race: {e}")
            plan = GangPlan(
                group=gk,
                created=time.monotonic() if now is None else now,
                per_pod={k: a for k, a in g.per_pod.items() if a.all_chips()},
                score=g.score,
            )
            # NOTE on overwriting an existing plan for this gang (one that
            # did not cover this pod): its uncommitted members with LIVE
            # reservations were counted as scheduled above and keep them —
            # they bind via the assignment_of fallback.  Members that are
            # GONE (missed DELETED event) are handled by reconcile() at
            # resync with a GET-confirm; forgetting here by set-difference
            # would free chips a mid-bind member still relies on.
            self._plans[gk] = plan
            log.info(
                "gang %s planned on slice(s) %s score=%.1f%s",
                gk,
                ",".join(g.slice_ids),
                g.score,
                f" multislice shape={g.slice_shape}" if g.num_slices > 1 else "",
            )
            return PlanOutcome(plan=plan)

    @staticmethod
    def _select_members(
        pod: PodInfo, pending, scheduled, outstanding: int
    ) -> Optional[List[PodInfo]]:
        """The single source of truth for which pending pods a plan covers:
        first (outstanding - already_scheduled) by name; None if this pod
        is not among them."""
        want = outstanding - len(scheduled)
        members = sorted(pending, key=lambda p: p.key)[:want]
        if pod.key not in {p.key for p in members}:
            return None
        return members

    def layout_and_occupancy_of(self, pod: PodInfo):
        """(layout counts, occupied coords per slice) of the pod's gang —
        the full anchored-refit inputs, so preemption can simulate exactly
        the fit_gang_into_layout call try_plan will make after eviction.
        Performs a (blocking) pod LIST; call it OUTSIDE the cache lock."""
        _, _, sched_slices, sched_coords = self._gather_members(pod)
        return fold_layout(sched_slices, sched_coords)

    def planned_members(self, pod: PodInfo) -> Optional[List[PodInfo]]:
        """The member set try_plan would plan for this pod right now (used
        by preemption simulation so it can never diverge from planning)."""
        pending, scheduled, _, _ = self._gather_members(pod)
        outstanding, _ = self.gang_arithmetic(
            self.group_key(pod),
            pod.pod_group_size,
            len(pending) + len(scheduled),
            _incarnations_of(pod, pending, scheduled),
        )
        if len(pending) + len(scheduled) < outstanding:
            return None
        return self._select_members(pod, pending, scheduled, outstanding)

    def _gather_members(self, pod: PodInfo):
        """Group members split into (pending, already_scheduled), plus each
        scheduled member's bind-time slice (pod annotation, else cache
        reservation) so a re-plan can anchor replacements to the gang's
        existing slice layout.  A member is scheduled if it is bound
        (spec.nodeName) or holds a reservation in the cache — those keep
        their chips and are NOT re-planned."""
        pending = {}
        scheduled = {}
        seen = {}
        slices = {}
        coords = {}
        for obj in self.cache.api.list_pods(namespace=pod.namespace):
            try:
                p = annotations.pod_from_k8s(obj)
            except Exception:  # noqa: BLE001
                # strict parse failed.  An ALREADY-PLACED sibling must stay
                # VISIBLE (lenient) or the running gang wedges; but a
                # PENDING sibling with a malformed quantity must stay
                # INVISIBLE — it can never pass its own strict filter, so
                # planning around it (as a 0-chip ghost) would bind the
                # rest of the gang and strand those chips forever.
                try:
                    p = annotations.pod_from_k8s(obj, strict=False)
                except Exception:  # noqa: BLE001 - hopeless neighbour
                    continue
                meta = obj.get("metadata", {}) or {}
                placed = bool((obj.get("spec") or {}).get("nodeName")) or bool(
                    (meta.get("annotations") or {}).get(annotations.POD_ASSIGNMENT)
                )
                if not placed:
                    continue
            if p.pod_group != pod.pod_group:
                continue
            if p.terminal:
                # Succeeded/Failed: uncharged (ClusterCache treats terminal
                # pods as holding nothing) — neither a pending member to
                # plan nor a scheduled member anchoring slices.  Succeeded
                # additionally shrinks the outstanding size (work done, no
                # replacement owed); Failed still owes one.
                if p.phase == "Succeeded":
                    self.note_done(
                        self.group_key(pod), p.key, p.pod_group_uid
                    )
                continue
            self.note_live(self.group_key(pod), p.key)
            seen[p.key] = p
            a = annotations.assignment_from_pod(obj)
            if a is not None and a.slice_id and a.all_chips():
                slices[p.key] = a.slice_id
                coords[p.key] = frozenset(c.coords for c in a.all_chips())
        seen.setdefault(pod.key, pod)
        for key, p in seen.items():
            ca = self.cache.assignment_of(key)
            if ca is not None and ca.slice_id and ca.all_chips():
                slices.setdefault(key, ca.slice_id)
                coords.setdefault(
                    key, frozenset(c.coords for c in ca.all_chips())
                )
            if p.node_name or (key != pod.key and ca is not None):
                scheduled[key] = p
            else:
                pending[key] = p
        sched_slices = {k: slices.get(k) for k in scheduled}
        sched_coords = {k: coords[k] for k in scheduled if k in coords}
        return (
            list(pending.values()),
            list(scheduled.values()),
            sched_slices,
            sched_coords,
        )

    def mark_committed(self, pod_key: str, group_key: str) -> None:
        with self._lock:
            plan = self._plans.get(group_key)
            if plan and pod_key in plan.per_pod:
                plan.committed.add(pod_key)
                if plan.committed >= set(plan.per_pod):
                    # fully bound: the plan has served its purpose; durable
                    # state lives in pod annotations now.  Keeping it would
                    # leak memory and hand stale placements to same-named
                    # recreated pods.
                    del self._plans[group_key]

    def on_pod_deleted(self, pod: PodInfo) -> None:
        gk = self.group_key(pod)
        if gk is None:
            return
        with self._lock:
            plan = self._plans.get(gk)
            if plan and pod.key in plan.per_pod and pod.key not in plan.committed:
                # a member died before binding: the gang cannot complete
                self.drop_plan(gk)


@dataclass
class PlanOutcome:
    plan: Optional[GangPlan] = None
    reason: str = ""
    # capacity-shaped failure (preemption could fix it); never probe reason
    # strings for this
    capacity_failure: bool = False
