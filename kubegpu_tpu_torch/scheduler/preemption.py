"""The port's copy of the JAX package's ``scheduler/preemption.py``.

Priority preemption: make room for a higher-priority job (BASELINE
config 5: multi-tenant bin-packing + preemption on a v5e-16).

The reference had no preemption (SURVEY.md §7 build-plan delta); the north
star's multi-tenant config requires it.  Semantics:

- Victims are chosen in **units**: a gang is evicted whole or not at all
  (evicting one member of a data-parallel job kills the job anyway — taking
  half its chips would strand the rest).
- Only units whose priority is strictly lower than the incoming pod's are
  candidates; least-valuable (lowest priority, then fewest chips) first.
- Selection is simulate-then-minimize: greedily free units until the
  incoming gang fits, then drop any unit whose chips turn out not to be
  needed.  Pure function over cache state — the Scheduler executes the
  eviction through the API server.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from kubegpu_tpu_torch.grpalloc import fit_gang
from kubegpu_tpu_torch.grpalloc.view import SliceView
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.info import Assignment, PodInfo

log = logging.getLogger(__name__)


@dataclass
class VictimUnit:
    """One evictable unit: a whole gang, or a single non-gang pod."""

    unit_id: str                  # gang key or pod key
    priority: int
    pod_keys: List[str] = field(default_factory=list)
    coords_by_slice: Dict[str, Set[Tuple[int, ...]]] = field(default_factory=dict)
    # pod key -> uid, threaded through to eviction events so they attach
    # without a per-victim GET round-trip
    uids: Dict[str, str] = field(default_factory=dict)
    # newest member's durable-bind time (epoch s, from the assignment
    # annotation — survives scheduler restarts); 0.0 when unknown.  Drives
    # the min-runtime anti-starvation shield: a gang's admission completes
    # with its LAST member, so the shield window starts there.
    last_bound_at: float = 0.0

    @property
    def total_chips(self) -> int:
        return sum(len(c) for c in self.coords_by_slice.values())


@dataclass
class PreemptionDecision:
    slice_id: str
    victims: List[VictimUnit]

    def victim_pod_keys(self) -> List[str]:
        out: List[str] = []
        for v in self.victims:
            out.extend(v.pod_keys)
        return sorted(out)


def collect_units(pods_raw: Sequence[dict], assignments: Dict[str, Assignment]) -> List[VictimUnit]:
    """Group currently-assigned pods into eviction units (gangs whole)."""
    units: Dict[str, VictimUnit] = {}
    for obj in pods_raw:
        try:
            # lenient: an already-bound pod's chips must stay reclaimable
            # even if one of its quantities no longer parses
            pod = annotations.pod_from_k8s(obj, strict=False)
        except Exception:  # noqa: BLE001 - unparseable pods aren't candidates
            continue
        a = assignments.get(pod.key)
        if a is None or not a.all_chips():
            continue
        unit_id = f"gang:{pod.namespace}/{pod.pod_group}" if pod.pod_group else f"pod:{pod.key}"
        u = units.get(unit_id)
        if u is None:
            u = VictimUnit(unit_id=unit_id, priority=pod.priority)
            units[unit_id] = u
        # a unit is as valuable as its most valuable member
        u.priority = max(u.priority, pod.priority)
        u.pod_keys.append(pod.key)
        u.uids[pod.key] = pod.uid
        u.last_bound_at = max(u.last_bound_at, a.bound_at)
        if a.slice_id:
            u.coords_by_slice.setdefault(a.slice_id, set()).update(
                c.coords for c in a.all_chips()
            )
    return list(units.values())


def find_victims(
    views: Dict[str, SliceView],
    units: Sequence[VictimUnit],
    incoming: Sequence[PodInfo],
    incoming_priority: int,
    allowed_slices: Optional[Set[str]] = None,
) -> Optional[PreemptionDecision]:
    """Smallest least-valuable victim set that lets `incoming` fit on some
    slice; None if no such set exists.

    allowed_slices restricts the search to slices the scheduler's candidate
    node list can actually reach — evicting victims on a slice whose nodes
    were excluded by earlier predicates would kill workloads for zero
    benefit."""
    candidates = sorted(
        (u for u in units if u.priority < incoming_priority),
        key=lambda u: (u.priority, u.total_chips, u.unit_id),
    )
    best: Optional[PreemptionDecision] = None
    for sid in sorted(views):
        if allowed_slices is not None and sid not in allowed_slices:
            continue
        view = views[sid]
        usable = [u for u in candidates if sid in u.coords_by_slice]
        chosen: List[VictimUnit] = []
        freed: Set[Tuple[int, ...]] = set()

        def fits() -> bool:
            trial = dataclasses.replace(view, used=frozenset(view.used - freed))
            return fit_gang(trial, incoming).success

        if fits():
            # fits without preemption; caller shouldn't be here, but answer
            # honestly: no victims needed
            return PreemptionDecision(slice_id=sid, victims=[])
        for u in usable:
            chosen.append(u)
            freed |= u.coords_by_slice[sid]
            if fits():
                break
        else:
            continue  # this slice can't be freed enough
        # minimize: drop most-valuable-first any unit not actually needed
        for u in sorted(chosen, key=lambda u: (-u.priority, -u.total_chips)):
            trial_freed = freed - u.coords_by_slice[sid]
            trial = dataclasses.replace(view, used=frozenset(view.used - trial_freed))
            if fit_gang(trial, incoming).success:
                chosen.remove(u)
                freed = trial_freed
        decision = PreemptionDecision(slice_id=sid, victims=chosen)
        cost = (max((u.priority for u in chosen), default=-1), sum(u.total_chips for u in chosen))
        if best is None or cost < (
            max((u.priority for u in best.victims), default=-1),
            sum(u.total_chips for u in best.victims),
        ):
            best = decision
    return best


def find_victims_joint(
    views: Dict[str, SliceView],
    units: Sequence[VictimUnit],
    incoming_priority: int,
    fits,
    allowed_slices: Optional[Set[str]] = None,
) -> Optional[PreemptionDecision]:
    """Joint CROSS-SLICE victim search for layout-shaped requests — the
    per-slice :func:`find_victims` cannot model a gang that needs chips
    freed on several slices at once (a fresh multislice gang, or an
    anchored multislice gang refilling per-slice deficits).

    ``fits(trial_views) -> bool`` judges a hypothetical eviction (e.g.
    ``fit_gang_into_layout(...).success``); victims accumulate least-
    valuable-first across ALL allowed slices until it holds, then the set
    is minimized most-valuable-first.  A victim unit may itself span
    slices (multislice gangs evict whole)."""
    def trial(freed_by_slice: Dict[str, Set[Tuple[int, ...]]]):
        return {
            sid: (
                dataclasses.replace(
                    v, used=frozenset(v.used - freed_by_slice[sid])
                )
                if sid in freed_by_slice
                else v
            )
            for sid, v in views.items()
        }

    def freeable(u: VictimUnit) -> Dict[str, Set[Tuple[int, ...]]]:
        return {
            sid: set(cs)
            for sid, cs in u.coords_by_slice.items()
            if allowed_slices is None or sid in allowed_slices
        }

    candidates = sorted(
        (
            u
            for u in units
            if u.priority < incoming_priority and freeable(u)
        ),
        key=lambda u: (u.priority, u.total_chips, u.unit_id),
    )
    if fits(trial({})):
        return PreemptionDecision(slice_id="", victims=[])
    freed: Dict[str, Set[Tuple[int, ...]]] = {}
    chosen: List[VictimUnit] = []
    for u in candidates:
        chosen.append(u)
        for sid, cs in freeable(u).items():
            freed.setdefault(sid, set()).update(cs)
        if fits(trial(freed)):
            break
    else:
        return None
    # minimize: drop most-valuable-first any unit not actually needed
    for u in sorted(chosen, key=lambda u: (-u.priority, -u.total_chips)):
        trial_freed = {sid: set(cs) for sid, cs in freed.items()}
        for sid, cs in freeable(u).items():
            trial_freed[sid] -= cs
        if fits(trial(trial_freed)):
            chosen.remove(u)
            freed = trial_freed
    return PreemptionDecision(slice_id="", victims=chosen)
