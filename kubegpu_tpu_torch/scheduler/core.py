"""The port's copy of the JAX package's ``scheduler/core.py``.

Scheduler core: the filter / prioritize / bind verbs (SURVEY.md §3.1).

Pure-ish orchestration over ClusterCache + grpalloc + PodGroupRegistry; the
HTTP layer (server.py) is a thin codec around this so every scheduling
behavior is testable without sockets (SURVEY.md §4 "multi-node without a
cluster").

Flow per verb:
- filter: non-TPU pods pass everywhere (BASELINE config 1); gang pods pass
  only on their plan's node (planning + reservation happen here); plain TPU
  pods pass where pod_fits_group_constraints fits.
- prioritize: placement score per node, rescaled to the extender's 0-10.
- bind: re-fit under the cache lock (assume-then-commit), write the
  assignment annotation, then the binding; any API failure rolls the
  reservation back (SURVEY.md §3.1 failure containment).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubegpu_tpu_torch.scheduler.cache import ClusterCache
from kubegpu_tpu_torch.scheduler.plugins import (
    DeviceSchedulerPlugin,
    PluginRegistry,
    default_registry,
)
from kubegpu_tpu_torch.scheduler.podgroup import PodGroupRegistry
from kubegpu_tpu_torch.scheduler.preemption import collect_units, find_victims
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.info import Assignment, PodInfo, TpuRequest
from kubegpu_tpu_torch.types.topology import is_contiguous_submesh
from kubegpu_tpu_torch.utils.apiserver import ApiServer, Conflict, NotFound
from kubegpu_tpu_torch.utils.events import EventRecorder
from kubegpu_tpu_torch.utils.metrics import Metrics, default_metrics

log = logging.getLogger(__name__)


@dataclass
class FilterResult:
    nodes: List[str] = field(default_factory=list)
    failed: Dict[str, str] = field(default_factory=dict)
    error: str = ""
    # at least one node failed for a capacity-shaped reason (internal;
    # not part of the HTTP response)
    capacity_failure: bool = False


def _scale_scores(raw: List[Tuple[str, Optional[float]]]) -> List[Tuple[str, int]]:
    """Map grpalloc's 0-100 scores onto the extender's 0-10 rank-preserving
    PER CANDIDATE SET: min-max stretch the fitting nodes across 1..10, so
    the aspect/anti-fragmentation distinctions (weights 15/25 of the raw
    score) survive the 11-bucket quantization instead of vanishing in a
    global round(/10).  Non-fitting nodes score 0, strictly below every
    fitting node; the best fitting node always scores 10."""
    fitting = [s for _, s in raw if s is not None]
    if not fitting:
        return [(n, 0) for n, _ in raw]
    lo, hi = min(fitting), max(fitting)
    span = hi - lo

    def scale(s: Optional[float]) -> int:
        if s is None:
            return 0
        if span <= 0:
            return 10
        return 1 + round(9 * (s - lo) / span)

    return [(n, scale(s)) for n, s in raw]


def _consensus_size(sizes: List[int]) -> int:
    """Gang cardinality by member consensus: the most common declared
    pod-group-size wins; ties break toward the SMALLER size (the direction
    that avoids rolling back a healthy gang).  Never last-write-wins — one
    recreated member with a stale annotation must not move the
    denominator the stranded-gang rollback is judged against."""
    if not sizes:
        return 0
    counts: Dict[int, int] = {}
    for s in sizes:
        counts[s] = counts.get(s, 0) + 1
    top = max(counts.values())
    return min(s for s, c in counts.items() if c == top)


# incarnation consensus (_consensus_size's string analog) lives in
# podgroup.gang_arithmetic now, applied inside the one shared formula


class Scheduler:
    def __init__(
        self,
        api: ApiServer,
        cache: Optional[ClusterCache] = None,
        metrics: Optional[Metrics] = None,
        gang_plan_ttl_s: float = 120.0,
        plugins: Optional[PluginRegistry] = None,
        evict_on_chip_failure: bool = True,
        absent_grace: int = 2,
        stranded_grace: int = 5,
        active_preemption: bool = True,
        preemption_min_runtime_s: float = 0.0,
    ) -> None:
        self.api = api
        self.cache = cache or ClusterCache(api)
        self.groups = PodGroupRegistry(self.cache, plan_ttl_s=gang_plan_ttl_s)
        self.metrics = metrics or default_metrics
        # operator-facing decision records (kubectl describe pod), the
        # kube-scheduler convention: best-effort, deduped, never failing
        # a verb (utils/events.py)
        self.events = EventRecorder(api)
        # device-type dispatch (SURVEY.md §2 #5): TPU built-in; more device
        # plugins via PluginRegistry.load (the Go-plugin .so analog)
        self.plugins = plugins or default_registry()
        # elastic recovery (SURVEY.md §5.3): a pod whose chips die is
        # evicted so its controller recreates it and it re-schedules onto
        # healthy chips (gang members rejoin their gang's slice layout)
        self.evict_on_chip_failure = evict_on_chip_failure
        # True: filter evicts lower-priority victims itself and re-plans in
        # the same verb (fastest admission).  False: filter only REPORTS
        # capacity failure and nominations flow through the advisory
        # /preemption verb — kube-scheduler performs the evictions (the
        # classic extender division of labor its preemptVerb config exists
        # for).  Both are deployed modes; deploy/device-scheduler.yaml
        # documents the flag.
        self.active_preemption = active_preemption
        # Anti-starvation min-runtime shield: a unit (pod or whole gang)
        # whose newest member durably bound within this window is
        # NON-preemptible — two higher-priority tenants alternately
        # preempting a low-priority gang would otherwise starve it
        # forever; the shield guarantees every admission this much
        # runtime, bounding starvation to admission-rate x window.  The
        # bind time rides the assignment annotation, so the shield
        # survives scheduler restarts.  0 disables (every admitted unit
        # is immediately preemptible — the pre-r4 behavior).
        self.preemption_min_runtime_s = preemption_min_runtime_s
        # HA fencing re-check (set by ExtenderServer when leader election
        # is on): consulted immediately before bind's durable annotation
        # write, so a verb that slipped through the gate as the lease
        # window closed aborts instead of committing over a promoted
        # standby's allocations.  A Lease is not a true fencing token — a
        # PATCH already in flight can still land late; the conflict
        # sweep's AssignmentConflict eviction resolves that residue.
        self.serving_gate = None
        # Eviction is irreversible, but "chip absent from an advertisement"
        # and "node missing from a LIST" are not — a restarting advertiser
        # or one truncated enumeration must not destroy a healthy running
        # gang.  An explicitly-Unhealthy chip evicts immediately (positive
        # signal); a merely-ABSENT chip or a vanished node must stay
        # absent/vanished for `absent_grace` consecutive observations first.
        self.absent_grace = max(1, absent_grace)
        # Incomplete-gang rollback: a gang holding SOME bound members but
        # not all for this many consecutive resyncs leaks capacity (its
        # pending members may never fit again once other tenants take the
        # chips) — all-or-nothing applies to the admission OUTCOME, so the
        # bound members are rolled back and the controller re-admits the
        # whole gang atomically.  Longer than the plan TTL (120 s / 30 s
        # resyncs) so an actively-binding gang is never rolled back.
        self.stranded_grace = max(1, stranded_grace)
        # (pod key, node, device_index) -> (strikes, advertisement fingerprint)
        self._absent_chip_strikes: Dict[tuple, Tuple[int, str]] = {}
        # (pod key, node) -> consecutive resyncs the node was missing
        self._missing_node_strikes: Dict[tuple, int] = {}
        # pod key -> consecutive resyncs its record stayed conflict-dropped
        self._conflict_strikes: Dict[str, int] = {}
        # gang key -> (consecutive no-progress resyncs, bound-member set)
        self._stranded_strikes: Dict[str, tuple] = {}
        # gangs already warned about over-subscribed done arithmetic: the
        # condition persists across resyncs and must not log every tick
        self._suspect_warned: set = set()
        # serializes the failure-detector entry points: the resync thread
        # and the node-watch thread both mutate the strike maps and run the
        # eviction sweep — unserialized, the watch can resize a dict mid-
        # iteration or double-evict one victim
        self._lifecycle_lock = threading.Lock()

    # -- filter -----------------------------------------------------------
    def filter(self, pod_obj: dict, node_names: List[str]) -> FilterResult:
        t0 = time.monotonic()
        try:
            pod = annotations.pod_from_k8s(pod_obj)
        except Exception as e:  # noqa: BLE001 - a malformed pod must not 500
            return FilterResult(error=f"unparseable pod: {e}")
        try:
            result = self._filter(pod, node_names)
            return result
        finally:
            self.metrics.inc("kubegpu_filter_total")
            self.metrics.observe("kubegpu_filter_seconds", time.monotonic() - t0)

    # -- plugin dispatch ---------------------------------------------------
    def _owning_plugin(self, pod: PodInfo):
        """(plugin, error): the single plugin serving this pod.  A pod mixing
        device types is an error — fitting only one type would silently
        over-commit the others."""
        owners = self.plugins.plugins_for(pod)
        if not owners:
            return None, None
        if len(owners) > 1:
            names = "+".join(p.name for p in owners)
            return None, (
                f"pod requests multiple device types ({names}); "
                "one device type per pod is supported"
            )
        return owners[0], None

    @staticmethod
    def _is_tpu_gang(pod: PodInfo) -> bool:
        """Gang planning is TPU-only (it reasons in mesh rectangles); a
        generic-device pod with gang annotations schedules plain.  The ONE
        definition used by filter, prioritize and bind — they must agree."""
        return bool(pod.pod_group) and pod.total_tpu_chips() > 0

    def _filter(self, pod: PodInfo, node_names: List[str]) -> FilterResult:
        plugin, err = self._owning_plugin(pod)
        if err:
            return FilterResult(failed={n: err for n in node_names})
        if plugin is None:
            # no device request any plugin owns: every node is fine by us
            return FilterResult(nodes=list(node_names))

        if self._is_tpu_gang(pod):
            outcome = self.groups.plan_for(pod) or None
            if outcome is None:
                planned = self.groups.try_plan(pod)
                if (
                    planned.plan is None
                    and planned.capacity_failure
                    and self.active_preemption
                ):
                    # multi-tenant path (BASELINE config 5): evict strictly
                    # lower-priority units, then re-plan once
                    if self._attempt_preemption(pod, self._slices_of(node_names)):
                        planned = self.groups.try_plan(pod)
                if planned.plan is None:
                    self.events.pod_event(
                        pod.namespace, pod.name, "GangUnschedulable",
                        planned.reason, type_="Warning", uid=pod.uid,
                    )
                    return FilterResult(
                        failed={n: planned.reason for n in node_names},
                        error="",
                    )
                outcome = planned.plan
                self.events.pod_event(
                    pod.namespace, pod.name, "GangPlanned",
                    (
                        f"gang {outcome.group} planned: "
                        f"{len(outcome.per_pod)} member(s) reserved, "
                        f"score {outcome.score:.1f}"
                    ),
                    uid=pod.uid,
                )
            planned_slice = outcome.per_pod[pod.key].slice_id
            if pod.slice_selector is not None and (
                planned_slice is None
                or planned_slice not in pod.slice_selector
            ):
                # planning used the FIRST member's selector; a member whose
                # OWN selector excludes the planned slice (mixed-selector
                # gang, or a recreated member with a new annotation) must
                # fail loudly, never bind outside its pin
                return FilterResult(
                    failed={
                        n: (
                            f"gang plan places {pod.key} on slice "
                            f"{planned_slice}, outside its slice-selector "
                            f"{sorted(pod.slice_selector)}"
                        )
                        for n in node_names
                    }
                )
            target = outcome.per_pod[pod.key].node
            failed = {n: f"gang plan places {pod.key} on {target}" for n in node_names if n != target}
            nodes = [n for n in node_names if n == target]
            if not nodes:
                # planned node isn't in the candidate list (e.g. cordoned):
                # drop the plan so the gang can re-plan elsewhere
                self.groups.drop_plan(self.groups.group_key(pod))
                return FilterResult(
                    failed={n: f"planned node {target} not in candidate list" for n in node_names}
                )
            return FilterResult(nodes=nodes, failed=failed)

        result = self._filter_plain(pod, plugin, node_names)
        if (
            not result.nodes
            and result.capacity_failure
            and plugin.name == "tpu"
            and self.active_preemption
        ):
            # preemption reasons in chip units; generic devices don't preempt
            if self._attempt_preemption(pod, self._slices_of(node_names)):
                result = self._filter_plain(pod, plugin, node_names)
        return result

    def _filter_plain(
        self, pod: PodInfo, plugin: DeviceSchedulerPlugin, node_names: List[str]
    ) -> FilterResult:
        views = self.cache.views()
        result = FilterResult()
        for name in node_names:
            node = self.cache.node(name)
            if node is None:
                result.failed[name] = "node not in scheduler cache"
                continue
            if pod.slice_selector is not None and (
                node.slice_id is None
                or node.slice_id not in pod.slice_selector
            ):
                # fail CLOSED: a slice-less node is outside every allowed
                # slice — placing a pinned pod there would violate the
                # tenant contract silently
                result.failed[name] = (
                    f"slice {node.slice_id} not in pod's slice-selector "
                    f"{sorted(pod.slice_selector)}"
                )
                continue
            view = views.get(node.slice_id) if node.slice_id else None
            fit = plugin.fit(node, pod, view)
            if fit.fits:
                result.nodes.append(name)
            else:
                result.failed[name] = fit.reason
                result.capacity_failure = result.capacity_failure or fit.capacity_failure
        return result

    def _slices_of(self, node_names: List[str]) -> set:
        """Slice ids reachable from a candidate node list — preemption must
        never evict on a slice the scheduler excluded."""
        out = set()
        for name in node_names:
            node = self.cache.node(name)
            if node is not None and node.slice_id:
                out.add(node.slice_id)
        return out

    # -- preemption -------------------------------------------------------
    def _members_for_preemption(self, pod: PodInfo) -> Optional[List[PodInfo]]:
        if not pod.pod_group:
            return [pod]
        # shared helper so the simulation can never diverge from what
        # try_plan would actually place
        return self.groups.planned_members(pod)

    def _attempt_preemption(self, pod: PodInfo, allowed_slices: set) -> bool:
        """Evict strictly-lower-priority units so `pod` (or its gang) fits.
        Returns True if anything was evicted (caller retries placement)."""
        if pod.priority <= 0 or not allowed_slices:
            return False
        members = self._members_for_preemption(pod)
        if members is None:
            return False
        layout, occupied = self._layout_occupancy(pod)
        allowed_slices = self._restrict_to_layout(pod, allowed_slices, layout)
        if not allowed_slices:
            return False
        decision, _ = self._find_victim_decision(
            pod, members, allowed_slices, layout, occupied
        )
        if decision is None or not decision.victims:
            return False
        uid_by_key = {
            k: u.uids.get(k) for u in decision.victims for k in u.pod_keys
        }
        for u in decision.victims:
            if u.unit_id.startswith("gang:"):
                self.groups.drop_plan(u.unit_id[len("gang:"):])
        evicted = 0
        for key in decision.victim_pod_keys():
            self._evict_pod(
                key,
                reason="Preempted",
                message=(
                    f"preempted by higher-priority {pod.key} "
                    f"(priority {pod.priority})"
                ),
                uid=uid_by_key.get(key),
            )
            evicted += 1
        self.metrics.inc("kubegpu_preemptions_total")
        self.metrics.inc("kubegpu_preempted_pods_total", evicted)
        log.warning(
            "preempted %d pods (units: %s) for %s (priority %d)",
            evicted,
            [u.unit_id for u in decision.victims],
            pod.key,
            pod.priority,
        )
        return True

    def _layout_occupancy(self, pod: PodInfo):
        """The gang's anchored-refit inputs, computed ONCE per preemption
        attempt and outside any lock (it LISTs pods)."""
        if not pod.pod_group:
            return {}, {}
        return self.groups.layout_and_occupancy_of(pod)

    def _restrict_to_layout(self, pod: PodInfo, allowed: Optional[set],
                            layout: Dict[str, int]):
        """Align eviction simulation with anchored re-planning: a
        partially-bound gang can only use its existing slice layout
        (podgroup.fit_gang_into_layout), so victims elsewhere would die for
        zero benefit.  The search is restricted to the layout's slices —
        one or many; multi-slice layouts take the joint cross-slice victim
        search in _find_victim_decision."""
        if pod.slice_selector is not None:
            allowed = (
                set(pod.slice_selector)
                if allowed is None
                else allowed & pod.slice_selector
            )
        if not layout:
            return allowed
        if allowed is None:
            return set(layout)
        return allowed & set(layout)

    def _find_victim_decision(self, pod: PodInfo, members, allowed,
                              layout, occupied):
        """Victim search shaped to how the gang would actually re-place:

        - anchored MULTI-slice gang → joint cross-slice search judged by
          the same fit_gang_into_layout call try_plan will make;
        - everything else → the per-slice find_victims;
        - fresh multislice-opted gang that no single slice can host even
          with eviction → joint search judged by fit_gang_multislice.

        Returns (decision, assignments snapshot) from ONE cache-lock
        acquisition so callers map victims to nodes from the same state
        the decision was computed against."""
        from kubegpu_tpu_torch.grpalloc.multislice import (
            fit_gang_into_layout,
            fit_gang_multislice,
        )
        from kubegpu_tpu_torch.scheduler.preemption import find_victims_joint

        pods_raw = self.api.list_pods()
        selector = pod.slice_selector
        with self.cache.lock:
            assignments = self.cache.assignments_snapshot()
            units = self._shield_fresh(collect_units(pods_raw, assignments))
            views = self.cache.views()
            if len(layout) > 1:
                def fits_layout(trial):
                    # mirror try_plan exactly: views are filtered by the
                    # pod's slice selector BEFORE the anchored refit, so a
                    # recreated member whose selector excludes a layout
                    # slice fails here too — never evict for a re-plan
                    # that is guaranteed to refuse
                    tv = {
                        sid: v
                        for sid, v in trial.items()
                        if selector is None or sid in selector
                    }
                    return fit_gang_into_layout(
                        tv, members, layout, occupied
                    ).success

                return (
                    find_victims_joint(
                        views, units, pod.priority, fits_layout, allowed
                    ),
                    assignments,
                )
            decision = find_victims(views, units, members, pod.priority, allowed)
            if decision is not None:
                return decision, assignments
            if pod.allow_multislice and not layout:
                def fits_ms(trial):
                    tv = {
                        sid: v
                        for sid, v in trial.items()
                        if allowed is None or sid in allowed
                    }
                    return fit_gang_multislice(
                        tv, members, allow_multislice=True
                    ).success

                return (
                    find_victims_joint(
                        views, units, pod.priority, fits_ms, allowed
                    ),
                    assignments,
                )
            return None, assignments

    def _shield_fresh(self, units):
        """Anti-starvation: drop units still inside their min-runtime
        window from the victim candidate set (both preemption modes flow
        through _find_victim_decision, so active filter-evictions and the
        advisory /preemption verb honor the same shield)."""
        if self.preemption_min_runtime_s <= 0:
            return units
        now = time.time()
        out = []
        for u in units:
            age = now - u.last_bound_at
            if u.last_bound_at and age < self.preemption_min_runtime_s:
                log.info(
                    "unit %s shielded from preemption (admitted %.0fs ago, "
                    "min runtime %.0fs)",
                    u.unit_id, age, self.preemption_min_runtime_s,
                )
                continue
            out.append(u)
        return out

    def preemption_victims(
        self, pod_obj: dict, candidate_nodes: Optional[List[str]] = None
    ) -> Dict[str, List[str]]:
        """The extender /preemption verb (advisory: kube-scheduler performs
        the eviction): node name -> victim pod keys on that node, restricted
        to the nodes kube-scheduler nominated (when provided)."""
        try:
            pod = annotations.pod_from_k8s(pod_obj)
        except Exception:  # noqa: BLE001
            return {}
        members = self._members_for_preemption(pod)
        if members is None:
            return {}
        allowed = (
            self._slices_of(candidate_nodes) if candidate_nodes is not None else None
        )
        if candidate_nodes is not None and not allowed:
            return {}
        layout, occupied = self._layout_occupancy(pod)
        allowed = self._restrict_to_layout(pod, allowed, layout)
        if allowed is not None and not allowed:
            return {}
        decision, assignments = self._find_victim_decision(
            pod, members, allowed, layout, occupied
        )
        if decision is None:
            return {}
        by_node: Dict[str, List[str]] = {}
        for key in decision.victim_pod_keys():
            a = assignments.get(key)
            if a is None:
                continue
            # victims are restricted to candidate slices above, but NOT
            # filtered per candidate node: gangs are evicted whole, and a
            # gang's members may sit on sibling (non-nominated) nodes of
            # the same slice
            by_node.setdefault(a.node, []).append(key)
        return by_node

    # -- prioritize -------------------------------------------------------
    def prioritize(self, pod_obj: dict, node_names: List[str]) -> List[Tuple[str, int]]:
        """(host, score 0-10) per extender API."""
        t0 = time.monotonic()
        try:
            pod = annotations.pod_from_k8s(pod_obj)
        except Exception:  # noqa: BLE001
            return [(n, 0) for n in node_names]
        try:
            plugin, _ = self._owning_plugin(pod)
            if plugin is None:  # no device request, or mixed-type error
                return [(n, 0) for n in node_names]
            if self._is_tpu_gang(pod):
                plan = self.groups.plan_for(pod)
                target = plan.per_pod[pod.key].node if plan else None
                return [(n, 10 if n == target else 0) for n in node_names]
            views = self.cache.views()
            raw = []
            for name in node_names:
                node = self.cache.node(name)
                if node is None:
                    raw.append((name, None))
                    continue
                view = views.get(node.slice_id) if node.slice_id else None
                fit = plugin.fit(node, pod, view)
                raw.append((name, fit.score if fit.fits else None))
            return _scale_scores(raw)
        finally:
            self.metrics.inc("kubegpu_prioritize_total")
            self.metrics.observe("kubegpu_prioritize_seconds", time.monotonic() - t0)

    # -- bind -------------------------------------------------------------
    def bind(self, namespace: str, name: str, node_name: str) -> Optional[str]:
        """Commit placement; returns an error string or None on success."""
        t0 = time.monotonic()
        try:
            return self._bind(namespace, name, node_name)
        finally:
            self.metrics.inc("kubegpu_bind_total")
            self.metrics.observe("kubegpu_bind_seconds", time.monotonic() - t0)

    def _bind(self, namespace: str, name: str, node_name: str) -> Optional[str]:
        key = f"{namespace}/{name}"
        try:
            pod_obj = self.api.get_pod(namespace, name)
        except NotFound:
            return f"pod {key} not found"
        try:
            pod = annotations.pod_from_k8s(pod_obj)
        except Exception as e:  # noqa: BLE001
            return f"unparseable pod {key}: {e}"
        plugin, plugin_err = self._owning_plugin(pod)
        if plugin_err:
            return f"cannot bind {key}: {plugin_err}"

        assignment: Optional[Assignment] = None
        reserved_here = False
        gk = self.groups.group_key(pod)
        is_tpu_gang = self._is_tpu_gang(pod) and gk is not None

        # Gang pods are marked mid-bind for the WHOLE verb — from before
        # the reservation check through the durable commit: a concurrent
        # drop_plan (reconcile, sibling's bind failure) must not forget a
        # reservation this bind is about to rely on (TOCTOU), and an
        # unexpected exception ANYWHERE in between must not leave the key
        # marked forever (which would shield its reservation from
        # drop_plan/expiry and leak its chips until GET-confirmed
        # divergence).  Hence one try/finally around everything from the
        # first mark.
        if is_tpu_gang:
            self.groups.mark_binding(key)
        try:
            if plugin is None:
                assignment = None  # plain bind, no device commitment
            elif is_tpu_gang:
                plan = self.groups.plan_for(pod)
                if plan is not None and pod.key in plan.per_pod:
                    assignment = plan.per_pod[pod.key]
                else:
                    # plan may have been dropped (fully committed) while the
                    # scheduler retries this bind: fall back to the live
                    # reservation
                    assignment = self.cache.assignment_of(key)
                    if assignment is None:
                        return f"gang pod {key} has no live plan (re-run filter)"
                if assignment.node != node_name:
                    # Mid-bind marking cuts both ways: a drop_plan/expiry
                    # racing this verb skipped the marked key when it freed
                    # the plan's other reservations.  If the plan is gone
                    # NOW and the reservation is still merely assumed,
                    # nothing else will ever free it (no plan owner, no
                    # TTL) — forget it before erroring out, or the chips
                    # stay charged until GET-confirmed divergence.  A
                    # still-live plan keeps ownership: its expiry/drop
                    # frees the key once the finally below unmarks it.
                    if (
                        self.groups.plan_for(pod) is None
                        and key in self.cache.assumed_keys()
                    ):
                        self.cache.forget(key)
                    return (
                        f"gang plan places {key} on {assignment.node}, "
                        f"but bind requested {node_name}"
                    )
                # The plan's reservation can be GONE by now: a chip-death
                # eviction of this (unbound) member released it between
                # planning and bind.  Annotating without a live charge
                # writes a durable claim on chips another pod may
                # legitimately take — double-allocation (found by the
                # gang-churn chaos soak).  Re-acquire or refuse.  (The key
                # is already marked mid-bind, so a drop_plan landing
                # between this check and the commit cannot forget the
                # reservation.)
                reacquire_err = None
                with self.cache.lock:
                    if self.cache.assignment_of(key) is None:
                        try:
                            self.cache.assume(key, assignment)
                            reserved_here = True
                        except (ValueError, KeyError) as e:
                            reacquire_err = e
                if reacquire_err is not None:
                    self.metrics.inc("kubegpu_bind_conflicts_total")
                    # the plan is UNEXECUTABLE — its chips are durably held
                    # elsewhere.  Drop it now: a live plan shields the gang
                    # from both re-planning and the stranded sweep, so
                    # keeping it would wedge the gang until plan-TTL expiry
                    # (found by the chaos soak).  Called OUTSIDE the cache
                    # lock: drop_plan takes groups-lock-then-cache-lock,
                    # and taking it under the cache lock would be the
                    # reverse order of every other path (ABBA deadlock).
                    # The finally below unmarks mid-bind AFTER this drop,
                    # so the drop itself cannot free the reservation — the
                    # planless-forget in the commit-failure path never
                    # applies here (nothing was durably written).
                    self.groups.drop_plan(gk)
                    return (
                        f"gang reservation for {key} was released and "
                        f"cannot be reacquired (plan dropped, re-run "
                        f"filter): {reacquire_err}"
                    )
            else:
                with self.cache.lock:
                    node = self.cache.node(node_name)
                    if node is None:
                        return f"unknown node {node_name}"
                    view = self.cache.views().get(node.slice_id) if node.slice_id else None
                    fit = plugin.fit(node, pod, view)
                    if not fit.fits:
                        self.metrics.inc("kubegpu_bind_conflicts_total")
                        return f"no longer fits on {node_name}: {fit.reason}"
                    assignment = fit.assignment
                    try:
                        self.cache.assume(key, assignment)
                        reserved_here = True
                    except (ValueError, KeyError) as e:
                        self.metrics.inc("kubegpu_bind_conflicts_total")
                        return f"reservation race on {node_name}: {e}"

            # durable commit: assignment annotation first, then the
            # binding — a crash between the two leaves an annotated-unbound
            # pod that refresh() replays correctly (state lives in the API
            # server).
            if self.serving_gate is not None and not self.serving_gate():
                # leadership lapsed since the HTTP gate: a promoted
                # standby may already own these chips — abort BEFORE
                # anything durable is written and roll the local
                # reservation back (nothing to clear in the API server)
                if reserved_here or (
                    is_tpu_gang and self.groups.plan_for(pod) is None
                ):
                    self.cache.forget(key)
                self.metrics.inc("kubegpu_bind_conflicts_total")
                return (
                    f"lost leadership before committing {key}; bind "
                    "aborted (kube-scheduler retries against the leader)"
                )
            try:
                if assignment is not None:
                    # stamped on the SHARED object (plan/cache hold the
                    # same one) so cache and annotation agree; drives the
                    # preemption min-runtime shield across restarts
                    assignment.bound_at = time.time()
                    self.api.patch_pod_annotations(
                        namespace,
                        name,
                        {annotations.POD_ASSIGNMENT: annotations.encode_assignment(assignment)},
                    )
                self.api.bind_pod(namespace, name, node_name)
            except (Conflict, NotFound, OSError) as e:
                if reserved_here:
                    self.cache.forget(key)
                elif is_tpu_gang and self.groups.plan_for(pod) is None:
                    # the plan vanished mid-bind (dropped/expired): this
                    # reservation has no owner left to expire it — forget,
                    # or the chips leak until a GET-confirmed divergence
                    self.cache.forget(key)
                if assignment is not None:
                    # clear the annotation for gang pods too: leaving it
                    # would let a later refresh() replay a ghost placement
                    # for a pod that never bound (stranding its chips)
                    try:
                        self.api.patch_pod_annotations(
                            namespace, name, {annotations.POD_ASSIGNMENT: ""}
                        )
                    except Exception:  # noqa: BLE001
                        pass
                return f"bind of {key} to {node_name} failed: {e}"

            if assignment is not None:
                # annotation + binding both durable: refresh() now rebuilds
                # this reservation from the API server
                self.cache.confirm(key)
            if is_tpu_gang:
                self.groups.mark_committed(key, gk)
        finally:
            if is_tpu_gang:
                self.groups.unmark_binding(key)
        if assignment is not None:
            self._record_placement_metrics(assignment)
            chips = assignment.all_chips()
            if chips:
                self.events.pod_event(
                    namespace, name, "DeviceAssigned",
                    (
                        f"assigned {len(chips)} TPU chip(s) on {node_name} "
                        f"(slice {assignment.slice_id}, coords "
                        f"{sorted(c.coords for c in chips)})"
                    ),
                    uid=pod.uid,
                )
        log.info("bound %s -> %s", key, node_name)
        return None

    def _record_placement_metrics(self, a: Assignment) -> None:
        chips = a.all_chips()
        if not chips:
            if a.grouped:
                self.metrics.inc("kubegpu_placements_total")
                self.metrics.inc(
                    "kubegpu_grouped_allocated_total",
                    sum(a.grouped_totals().values()),
                )
            return
        node = self.cache.node(a.node)
        contiguous = False
        if node is not None and node.mesh_shape is not None:
            coords = {c.coords for c in chips}
            wrap = node.wrap or tuple(False for _ in node.mesh_shape)
            contiguous = is_contiguous_submesh(coords, node.mesh_shape, wrap)
        self.metrics.inc("kubegpu_placements_total")
        if contiguous:
            self.metrics.inc("kubegpu_placements_contiguous_total")
        self.metrics.inc("kubegpu_chips_allocated_total", len(chips))

    # -- lifecycle events -------------------------------------------------
    def resync(self) -> None:
        """Periodic resync (ExtenderServer loop): reconcile the cache with
        the API server, then sweep for assignments referencing died chips —
        the consistency backstop behind the node watch (and the only
        failure detector when the API server offers no watch).  One
        snapshot indexed by host keeps the sweep O(assignments), not
        O(nodes x assignments).

        The refresh AND the sweep's LISTs run OUTSIDE the lifecycle lock:
        they are network I/O, and holding the lock across them would stall
        the node-watch fast path — the very evictions the watch exists to
        accelerate — behind API-server round-trips.  refresh() has its own
        locking and tolerates concurrent watch updates."""
        self.cache.refresh()
        nodes_raw = self.api.list_nodes()
        pods_raw = self.api.list_pods()
        # plan reconciliation (missed-DELETED backstop): network GETs, so
        # outside the lifecycle lock like the other I/O here
        self.groups.reconcile(
            {
                f"{(o.get('metadata') or {}).get('namespace', 'default')}/"
                f"{(o.get('metadata') or {}).get('name', '')}"
                for o in pods_raw
            },
            self.api.get_pod,
        )
        with self._lifecycle_lock:
            self._resync_locked(nodes_raw)
            self._sweep_stranded_gangs(pods_raw)

    def _resync_locked(self, nodes_raw: List[dict]) -> None:
        if self.evict_on_chip_failure:
            self._sweep_chip_health(nodes_raw)
        # The conflict sweep runs REGARDLESS of evict_on_chip_failure —
        # durable double-annotation is an accounting pathology, not a
        # chip-health event (same reasoning as the stranded-gang sweep).
        conflicted = self.cache.conflicted_assignments()
        self._conflict_strikes = {
            k: v for k, v in self._conflict_strikes.items() if k in conflicted
        }
        for key in sorted(conflicted):
            strikes = self._conflict_strikes.get(key, 0) + 1
            self._conflict_strikes[key] = strikes
            if strikes < self.absent_grace:
                continue
            del self._conflict_strikes[key]
            self._drop_gang_plan_of(key)
            self._evict_pod(
                key,
                reason="AssignmentConflict",
                message=(
                    "annotated chips are held by another assignment "
                    f"({strikes} consecutive resyncs): durable double-"
                    "annotation resolved toward the charged owner"
                ),
            )
            self.metrics.inc("kubegpu_health_evictions_total")
            log.warning(
                "evicted %s: its annotated chips are held by another "
                "assignment (%d consecutive resyncs) — durable "
                "double-annotation resolved toward the charged owner",
                key, strikes,
            )

    def _sweep_chip_health(self, nodes_raw: List[dict]) -> None:
        by_host: Dict[str, list] = {}
        for key, a in self.cache.assignments_snapshot().items():
            for r in a.all_chips():
                by_host.setdefault(r.host, []).append((key, r))
        # prune strike entries whose assignment is gone, so the maps stay
        # O(live assignments) across a long-lived server
        valid = {
            (key, r.host, r.device_index)
            for host_refs in by_host.values()
            for key, r in host_refs
        }
        self._absent_chip_strikes = {
            k: v for k, v in self._absent_chip_strikes.items() if k in valid
        }
        live = {(obj.get("metadata") or {}).get("name", "") for obj in nodes_raw}
        for obj in nodes_raw:
            name = (obj.get("metadata") or {}).get("name", "")
            if name in by_host:
                self._evict_on_dead_chips(obj, by_host[name])
        # Total-failure mode the per-node sweep can never see: the node (or
        # its advertiser) is GONE from the LIST entirely, so no future
        # advertisement ever re-marks its chips unhealthy and its gangs
        # would stay wedged forever.  refresh() records such pods as
        # orphaned; evict them after the same grace window, since a node
        # can blip out of one LIST.  A node that IS listed but whose
        # topology annotation failed to decode also orphans its pods in the
        # cache — that is version skew / corruption, not node loss, and
        # must stay a warning, never an eviction.
        orphans = {
            key: host
            for key, host in self.cache.orphaned_assignments().items()
            if host not in live
        }
        self._missing_node_strikes = {
            k: v
            for k, v in self._missing_node_strikes.items()
            if orphans.get(k[0]) == k[1]
        }
        for key, host in sorted(orphans.items()):
            strikes = self._missing_node_strikes.get((key, host), 0) + 1
            self._missing_node_strikes[(key, host)] = strikes
            if strikes < self.absent_grace:
                continue
            del self._missing_node_strikes[(key, host)]
            self._drop_gang_plan_of(key)
            self._evict_pod(
                key,
                reason="NodeLost",
                message=(
                    f"node {host} is no longer advertised "
                    f"({strikes} consecutive resyncs)"
                ),
            )
            self.metrics.inc("kubegpu_health_evictions_total")
            log.warning(
                "evicted %s: its node %s is no longer advertised "
                "(%d consecutive resyncs)",
                key, host, strikes,
            )
    def _sweep_stranded_gangs(self, pods_raw: List[dict]) -> None:
        """Incomplete-gang rollback (all-or-nothing applies to the
        admission OUTCOME, not just planning): a gang that keeps SOME
        members bound but not all for `stranded_grace` consecutive resyncs
        WITHOUT PROGRESS is leaking capacity — mid-admission disruption
        (chip death, preemption of a sibling) stranded it, and other
        tenants may have taken the chips its pending members need,
        possibly forever.  Roll the bound members back; the controller
        recreates them and the whole gang re-admits atomically when
        capacity allows.

        Strikes count only STALLED partiality: they reset whenever the
        bound set changes (admission converging, replacements landing)
        and never accrue while a live plan covers the gang (members are
        actively binding).  Runs regardless of evict_on_chip_failure —
        capacity-leak rollback is not a chip-health feature.

        Because rollback deletes running pods, the partiality verdict is
        hardened against three ways a HEALTHY gang can look partial:

        - **Succeeded members** (e.g. garbage-collected one at a time by a
          TTL controller): their work is done and no replacement is owed,
          so they leave the bound set AND shrink the denominator —
          including after GC deletes them (the sweep remembers every
          member it ever saw Succeeded, per `_gang_done`).  Their chips
          are already uncharged: the cache treats terminal-phase pods as
          holding nothing (ClusterCache.refresh).
        - **Terminating members**: they hold spec.nodeName but are
          leaving, so they never count as bound — the gang still owes a
          replacement, so the denominator keeps them.  Their stale
          assignment annotations are evicted along with a rollback so a
          rolled-back gang frees ALL its chips.  (Failed members are
          excluded from bound the same way; their chips are uncharged by
          the terminal-phase rule, no eviction needed.)
        - **Size disagreement** (a recreated member carrying a stale
          pod-group-size annotation): the denominator is the CONSENSUS of
          the members' declared sizes — most common wins, ties toward the
          smaller (the direction that avoids rolling back a healthy
          gang) — never last-write-wins."""
        gangs: Dict[str, Dict[str, list]] = {}
        for obj in pods_raw:
            try:
                p = annotations.pod_from_k8s(obj, strict=False)
            except Exception:  # noqa: BLE001
                continue
            if not p.pod_group or TpuRequest.from_pod(p).total_chips == 0:
                continue
            gk = f"{p.namespace}/{p.pod_group}"
            g = gangs.setdefault(
                gk, {"sizes": [], "bound": [], "releasable": [], "live": 0,
                     "uids": {}, "incarnations": []}
            )
            g["uids"][p.key] = p.uid
            if p.phase == "Succeeded":
                # remembered in the registry (shared with the planner, so
                # sweep denominator and re-plan requirement never diverge)
                # because a TTL controller may GC the pod before the next
                # resync — and a vanished Succeeded member must KEEP
                # shrinking the denominator.  Scoped to the member's own
                # incarnation: an old run's completions never shrink a new
                # run's denominator.
                self.groups.note_done(gk, p.key, p.pod_group_uid)
                continue
            # a name reused by a live recreation must not double-count
            # (once as bound, once as remembered-done)
            self.groups.note_live(gk, p.key)
            g["sizes"].append(p.pod_group_size)
            if p.terminal or p.terminating:
                if p.terminating and not p.terminal and (
                    annotations.assignment_from_pod(p.annotations) is not None
                ):
                    g["releasable"].append(p.key)
                continue
            g["live"] += 1
            g["incarnations"].append(p.pod_group_uid)
            if p.node_name:
                g["bound"].append(p.key)
        # forget completed-member memory for gangs no longer listed at all
        # (fully GC'd): nothing is left to judge, and a later gang reusing
        # the name must start clean
        self.groups.prune_done(gangs)
        self._suspect_warned &= set(gangs)
        stranded = {}
        outstanding = {}
        for gk, g in gangs.items():
            # shared formula with the planner (gang_arithmetic), judged
            # against the LIVE members' incarnation (consensus, computed
            # inside gang_arithmetic like the planner's): an old run's
            # remembered completions must not shrink a new run's denominator
            size, suspect = self.groups.gang_arithmetic(
                gk, _consensus_size(g["sizes"]), g["live"], g["incarnations"]
            )
            if suspect:
                # over-subscribed arithmetic (gang name reused without
                # pod-group-uid, or stray extra members): whose gang the
                # bound members belong to is ambiguous, and rollback
                # DELETES running pods — decline to judge.  The planner's
                # full-size fallback still lets the new run form; worst
                # case is a capacity leak an operator can see, never a
                # healthy gang destroyed.  Warned once per episode — the
                # condition persists across resyncs.
                if gk not in self._suspect_warned:
                    self._suspect_warned.add(gk)
                    log.warning(
                        "gang %s: completed-member arithmetic over-"
                        "subscribed (name reused without %s?); skipping "
                        "stranded-gang judgment while it persists",
                        gk, annotations.POD_GROUP_UID,
                    )
                continue
            self._suspect_warned.discard(gk)
            if 0 < len(g["bound"]) < size:
                stranded[gk] = tuple(sorted(g["bound"]))
                outstanding[gk] = size
        self._stranded_strikes = {
            k: v for k, v in self._stranded_strikes.items() if k in stranded
        }
        for gk, bound in sorted(stranded.items()):
            if self.groups.has_live_plan(gk):
                self._stranded_strikes.pop(gk, None)
                continue  # actively binding: not stalled
            strikes, prev_bound = self._stranded_strikes.get(gk, (0, bound))
            if prev_bound != bound:
                strikes = 0  # progress (or churn): restart the window
            strikes += 1
            self._stranded_strikes[gk] = (strikes, bound)
            if strikes < self.stranded_grace:
                continue
            del self._stranded_strikes[gk]
            self.groups.drop_plan(gk)
            for key in (*bound, *sorted(gangs[gk]["releasable"])):
                self._evict_pod(
                    key,
                    reason="GangRollback",
                    message=(
                        f"gang {gk} stayed partially bound for {strikes} "
                        "resyncs without progress; rolling back so the "
                        "whole gang can re-admit atomically"
                    ),
                    uid=gangs[gk]["uids"].get(key),
                )
            self.metrics.inc("kubegpu_stranded_gang_rollbacks_total")
            log.warning(
                "rolled back incomplete gang %s (%d bound of %d outstanding "
                "for %d consecutive resyncs without progress): freeing its "
                "chips so the whole gang can re-admit atomically",
                gk, len(bound), outstanding[gk], strikes,
            )

    def on_pod_deleted(self, pod_obj: dict) -> None:
        # lenient parse, like every LIST-path consumer: a malformed device
        # quantity must not make a DELETED event invisible — dropping it
        # would leak the pod's chips and keep its gang plan live until the
        # next resync, exactly the wait the pod watch exists to remove
        try:
            pod = annotations.pod_from_k8s(pod_obj, strict=False)
        except Exception:  # noqa: BLE001
            return
        # Stale-event guard: the watch delivers by NAME, and a controller
        # can recreate the name before a delayed DELETED event drains.
        # Acting on it then would free the RECREATED pod's live
        # reservation (double-allocation).  Only a fresh NotFound proves
        # the name is really gone; on existence or transient error, skip —
        # chips merely look used one resync longer (the safe direction,
        # same discipline as the cache's GET-confirmed reconciliation).
        try:
            self.api.get_pod(pod.namespace, pod.name)
            return  # exists (recreated or not-yet-deleted): stale event
        except NotFound:
            pass
        except Exception:  # noqa: BLE001 - transient: resync will converge
            return
        self.cache.remove_pod(pod.key)
        self.groups.on_pod_deleted(pod)

    def on_node_updated(self, node_obj: dict) -> None:
        with self._lifecycle_lock:
            self.cache.update_node(node_obj)
            if self.evict_on_chip_failure:
                self._evict_on_dead_chips(node_obj)

    def _evict_pod(
        self,
        key: str,
        reason: str = "Evicted",
        message: str = "",
        uid: Optional[str] = None,
    ) -> None:
        """The one eviction sequence (preemption AND health eviction):
        clear the assignment annotation BEFORE deleting — a victim
        lingering in Terminating (graceful deletion on a real cluster)
        must not be replayed by the next cache refresh onto chips a new
        placement may own — then delete and release the cache entry.
        The Warning Event (kubectl describe matches it by
        involvedObject.uid) is emitted AFTER the delete call so it records
        what actually happened — a failed or moot delete must not leave a
        record claiming the pod was evicted.  Callers that already hold
        the uid (preemption victims, sweep-parsed pods) thread it in;
        otherwise one GET fetches it before the pod vanishes (evictions
        are rare)."""
        ns, name = key.split("/", 1)
        if uid is None:
            try:
                uid = (self.api.get_pod(ns, name).get("metadata") or {}).get(
                    "uid", ""
                )
            except Exception:  # noqa: BLE001 - already gone / transient
                uid = ""
        try:
            self.api.patch_pod_annotations(
                ns, name, {annotations.POD_ASSIGNMENT: ""}
            )
        except (NotFound, OSError):
            pass
        deleted = True
        try:
            self.api.delete_pod(ns, name)
        except NotFound:
            deleted = False  # already gone: nothing evicted, no record owed
        self.cache.remove_pod(key)
        if deleted:
            self.events.pod_event(
                ns, name, reason,
                message or "evicted by kubegpu-tpu-scheduler",
                type_="Warning", uid=uid,
            )

    def _evict_on_dead_chips(self, node_obj: dict, host_refs=None) -> None:
        """Failure detection → elastic recovery (SURVEY.md §5.3): when the
        advertiser reports a chip unhealthy (or gone), the pods holding it
        are dead weight — their process lost its device and cannot recover
        in place.  Evict them (controller recreates; the replacement
        re-schedules onto healthy chips, gang members anchored to their
        gang's existing slice layout by the re-plan path).  Healthy
        siblings on other chips are untouched."""
        try:
            node = annotations.node_from_k8s(node_obj)
        except Exception:  # noqa: BLE001
            return
        if node.slice_id is None:
            return
        if host_refs is None:
            host_refs = [
                (key, r)
                for key, a in self.cache.assignments_snapshot().items()
                for r in a.all_chips()
                if r.host == node.name
            ]
        present = {ch.device_index for ch in node.chips}
        dead = {ch.device_index for ch in node.chips if not ch.healthy}
        # strikes count distinct ADVERTISEMENTS showing the chip absent, not
        # observations: the resync loop re-reading one stale truncated
        # annotation (or a watch event plus the next resync double-counting
        # the same write) must not accumulate toward eviction.  The
        # advertiser bumps NODE_ADVERT_SEQ every cycle; fall back to the
        # topology payload itself for third-party advertisers.
        ann = (node_obj.get("metadata") or {}).get("annotations") or {}
        fingerprint = ann.get(
            annotations.NODE_ADVERT_SEQ, ann.get(annotations.NODE_TOPOLOGY, "")
        )
        victim_set = set()
        for key, r in host_refs:
            strike_key = (key, node.name, r.device_index)
            if r.device_index in dead:
                # explicit Unhealthy report: positive signal, evict now
                victim_set.add(key)
                self._absent_chip_strikes.pop(strike_key, None)
            elif r.device_index not in present:
                # absence is ambiguous (advertiser restart, truncated
                # enumeration): require absent_grace distinct advertisements
                strikes, last_fp = self._absent_chip_strikes.get(
                    strike_key, (0, None)
                )
                if last_fp != fingerprint:
                    strikes += 1
                    self._absent_chip_strikes[strike_key] = (strikes, fingerprint)
                if strikes >= self.absent_grace:
                    victim_set.add(key)
                    del self._absent_chip_strikes[strike_key]
            else:
                self._absent_chip_strikes.pop(strike_key, None)
        victims = sorted(victim_set)
        for key in victims:
            # invalidate the victim's live gang plan FIRST: a stale plan
            # would rebind the recreated member onto the exact dead chip,
            # producing an endless evict/recreate/rebind loop
            self._drop_gang_plan_of(key)
            self._evict_pod(
                key,
                reason="ChipFailure",
                message=(
                    f"assigned TPU chip(s) on {node.name} died "
                    f"(dead device indices: {sorted(dead)}); controller "
                    "recreates onto healthy chips"
                ),
            )
            self.metrics.inc("kubegpu_health_evictions_total")
            log.warning(
                "evicted %s: its chip(s) on %s died (dead=%s)",
                key, node.name, sorted(dead),
            )

    def _drop_gang_plan_of(self, key: str) -> None:
        ns, name = key.split("/", 1)
        try:
            pod = annotations.pod_from_k8s(self.api.get_pod(ns, name), strict=False)
        except Exception:  # noqa: BLE001 - pod already gone: nothing to drop
            return
        if pod.pod_group:
            self.groups.drop_plan(f"{ns}/{pod.pod_group}")
