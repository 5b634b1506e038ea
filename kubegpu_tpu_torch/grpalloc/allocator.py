"""The port's copy of the JAX package's ``grpalloc/allocator.py``.

The allocation core: fit, score, take/return — pure logic, no I/O.

Capability parity with the reference's grpalloc (SURVEY.md §2 #2):
``pod_fits_group_constraints`` (feasibility + best concrete placement + score
per node), ``take_pod_resources``/``return_pod_resources`` (bookkeeping), plus
what the reference lacked and the north star requires: ``fit_gang``
(all-or-nothing multi-pod placement on one ICI-contiguous rectangle,
SURVEY.md §7 stage 6).

Hot loop shape (SURVEY.md §3.1): tree walk per (pod × node) is replaced by a
subset scan over a host's ≤8 free chips (C(8,4)=70 candidates worst case) and
a rectangle scan over the slice mesh (≤256 chips) — small, deterministic,
exhaustive.  The JAX package's optional C++ twin of the rectangle scan
(``native_core``) is not ported: the port runs the defining Python loop.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from kubegpu_tpu_torch.grpalloc.scoring import placement_score
from kubegpu_tpu_torch.grpalloc.view import SliceView
from kubegpu_tpu_torch.types.info import Assignment, ChipRef, NodeInfo, PodInfo, TpuRequest
from kubegpu_tpu_torch.types.resource import ResourcePath, ResourceTree
from kubegpu_tpu_torch.types.topology import (
    Coord,
    Submesh,
    factor_shapes,
    is_contiguous_submesh,
)


@dataclass
class FitResult:
    fits: bool
    reason: str = ""
    score: float = 0.0
    assignment: Optional[Assignment] = None
    # True when the failure is capacity-shaped (not enough free/contiguous
    # chips) — i.e. something preemption could fix.  Structured so callers
    # never probe reason strings.
    capacity_failure: bool = False


@dataclass
class GangResult:
    success: bool
    reason: str = ""
    score: float = 0.0
    per_pod: Dict[str, Assignment] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Single-pod fit (one pod's chips always live on ONE node: a container can
# only see its own host's chips — same constraint the reference had).
# ---------------------------------------------------------------------------

def clear_fit_caches() -> None:
    """Drop the subset-search memo.  The cache keys are pure values so
    entries can never go STALE — but each one pins whole-slice coord sets,
    so a long-lived scheduler calls this on every cache refresh to bound
    retention to one resync period (the memo's win is de-duplicating the
    repeated evaluations WITHIN a gang-packing burst, not across days)."""
    _best_subset_cached.cache_clear()


@functools.lru_cache(maxsize=2048)
def _best_subset_cached(
    avail: FrozenSet[Coord],
    n: int,
    require_contiguous: bool,
    free: FrozenSet[Coord],
    mesh_shape: Coord,
    wrap: Tuple[bool, ...],
) -> Tuple[Optional[FrozenSet[Coord]], float]:
    """Best-scoring n-chip subset of `avail` (scored against the slice-wide
    `free` context), deterministic (ties toward the smallest sorted coord
    tuple).

    Contiguous requests enumerate RECTANGLES of volume n directly instead
    of scanning all C(|avail|, n) subsets and filtering — the same
    candidate space (contiguous == rectangular submesh), polynomially many
    candidates instead of combinatorially many.  Relaxed requests still
    need the exhaustive scan; the LRU cache de-duplicates the repeated
    (host avail × rectangle-candidate) evaluations gang packing performs —
    every argument is a hashable value, so stale entries are impossible."""
    if require_contiguous:
        cands = _scored_rectangles(
            n, mesh_shape, wrap, avail,
            scoring_free=None if avail == free else free,
        )
        if not cands:
            return None, -1.0
        s, _, coords = cands[0]
        return coords, s
    best: Optional[Tuple[Coord, ...]] = None
    best_score = -1.0
    for combo in itertools.combinations(sorted(avail), n):
        cset = frozenset(combo)
        s = placement_score(cset, free, mesh_shape, wrap)
        # combinations over sorted input arrive in lexicographic order, so
        # keeping the first strictly-better combo already breaks ties toward
        # the smallest coord tuple → deterministic
        if s > best_score:
            best, best_score = combo, s
    if best is None:
        return None, -1.0
    return frozenset(best), best_score


def _best_subset(
    free_on_node: FrozenSet[Coord],
    n: int,
    view: SliceView,
    require_contiguous: bool,
) -> Tuple[Optional[FrozenSet[Coord]], float]:
    return _best_subset_cached(
        frozenset(free_on_node), n, require_contiguous, view.free,
        tuple(view.mesh_shape),
        tuple(view.wrap or tuple(False for _ in view.mesh_shape)),
    )


def _split_containers(
    chips: Sequence[ChipRef], request: TpuRequest
) -> Dict[str, List[ChipRef]]:
    """Deal the pod's chips out to its containers in spec order."""
    ordered = sorted(chips, key=lambda r: (r.host, r.device_index))
    out: Dict[str, List[ChipRef]] = {}
    i = 0
    for cname, cnt in request.per_container.items():
        out[cname] = list(ordered[i : i + cnt])
        i += cnt
    return out


def pod_fits_group_constraints(
    node: NodeInfo,
    request: TpuRequest,
    view: Optional[SliceView] = None,
) -> FitResult:
    """Can this pod's device request be satisfied on this node, and if so,
    which concrete chips and how good is that placement?

    Mirrors the reference's PodFitsGroupConstraints semantics (SURVEY.md §2
    #2) with the ICI scorer replacing tree-nesting affinity."""
    if request.total_chips == 0:
        # 0-device passthrough (BASELINE config 1): never blocks a pod.
        return FitResult(fits=True, reason="no device request", score=0.0)
    if not node.is_tpu_node:
        return FitResult(fits=False, reason=f"node {node.name} advertises no TPU chips")
    if view is None:
        view = _single_node_view(node)
    free = view.free_on_host(node.name)
    if request.total_chips > len(free):
        return FitResult(
            fits=False,
            reason=(
                f"insufficient free chips on {node.name}: "
                f"want {request.total_chips}, free {len(free)}"
            ),
            capacity_failure=True,
        )
    subset, score = _best_subset(free, request.total_chips, view, request.contiguous)
    if subset is None:
        return FitResult(
            fits=False,
            reason=(
                f"no ICI-contiguous {request.total_chips}-chip placement free on "
                f"{node.name} (set annotation kubegpu-tpu/contiguous=false to relax)"
            ),
            capacity_failure=True,
        )
    refs = [view.chips[c] for c in sorted(subset)]
    assignment = Assignment(
        node=node.name,
        slice_id=view.slice_id,
        per_container=_split_containers(refs, request),
        score=score,
    )
    return FitResult(fits=True, score=score, assignment=assignment)


def _single_node_view(node: NodeInfo) -> SliceView:
    from kubegpu_tpu_torch.grpalloc.view import build_slice_views

    views = build_slice_views([node])
    if node.slice_id in views:
        return views[node.slice_id]
    # non-TPU or malformed: empty view
    return SliceView(slice_id=node.slice_id or "none", mesh_shape=(1,), wrap=(False,))


# ---------------------------------------------------------------------------
# Take / return bookkeeping (the reference's TakePodGroupResource twins,
# SURVEY.md §2 #2): mutate the node's used-tree; SliceViews are derived.
# ---------------------------------------------------------------------------

def take_pod_resources(node: NodeInfo, assignment: Assignment,
                       skip_missing: bool = False) -> None:
    """Commit an assignment against the node's used-tree.

    Validates-then-mutates: raises ValueError (with NO state change) if any
    chip is already taken — a second take of the same chips is a bind race
    or a retry bug, and surfacing it here keeps the cache consistent
    (SURVEY.md §7 hard part (c): serialize/detect bind races).

    ``skip_missing=True`` (cache replay/re-apply paths): chips absent from
    the node's current advertisement are skipped instead of raising — the
    record stays trackable so the absent-chip strike detector can evict its
    pod, and return_pod_resources symmetrically skips missing indices, so
    the charge/return pair stays balanced."""
    by_idx = {ch.device_index: ch for ch in node.chips}
    mine = [r for r in assignment.all_chips() if r.host == node.name]
    chips = []
    for ref in mine:
        ch = by_idx.get(ref.device_index)
        if ch is None:
            if skip_missing:
                continue
            raise KeyError(f"node {node.name} has no chip index {ref.device_index}")
        if node.used.get(node.chip_path(ch)) > 0:
            raise ValueError(
                f"chip {ref.device_index} on {node.name} already allocated "
                f"(double-take / bind race)"
            )
        chips.append(ch)
    # generic plugin bindings (SURVEY.md §2 #5): validate before mutating,
    # same all-or-nothing contract as the chip path
    grouped = (
        [(ResourcePath.parse(p), q) for p, q in assignment.grouped_totals().items()]
        if assignment.node == node.name
        else []
    )
    for path, qty in grouped:
        avail = node.capacity.get(path) - node.used.get(path)
        if qty > avail:
            raise ValueError(
                f"grouped resource {path} on {node.name}: want {qty}, "
                f"available {avail} (double-take / bind race)"
            )
    for ch in chips:
        node.used.add(node.chip_path(ch), 1)
    for path, qty in grouped:
        node.used.add(path, qty)


def return_pod_resources(node: NodeInfo, assignment: Assignment) -> None:
    """Release an assignment.  Idempotent: chips already returned (or no
    longer advertised) are skipped — return is cleanup and must be safe to
    replay after a failed bind or a restart (SURVEY.md §3.1 failure
    containment, §3.5 replay)."""
    by_idx = {ch.device_index: ch for ch in node.chips}
    for ref in assignment.all_chips():
        if ref.host != node.name:
            continue
        ch = by_idx.get(ref.device_index)
        if ch is None:
            continue  # chip disappeared from advertisement; nothing to return
        path = node.chip_path(ch)
        if node.used.get(path) > 0:
            single = ResourceTree()
            single.add(path, 1)
            node.used.add_tree(single, sign=-1)
    if assignment.node == node.name:
        for p, qty in assignment.grouped_totals().items():
            path = ResourcePath.parse(p)
            back = min(qty, node.used.get(path))  # clamp: return is cleanup
            if back > 0:
                single = ResourceTree()
                single.add(path, back)
                node.used.add_tree(single, sign=-1)


# ---------------------------------------------------------------------------
# Gang fit: place N pods all-or-nothing on one contiguous rectangle.
# ---------------------------------------------------------------------------

def fit_gang(view: SliceView, pods: Sequence[PodInfo]) -> GangResult:
    """All-or-nothing placement of a pod group onto ONE rectangular submesh.

    Strategy (SURVEY.md §7 stage 2: exhaustive rectangle scan is fine at
    these sizes): enumerate every free rectangle of the gang's total size,
    highest placement score first; for each, bin-pack pods onto the hosts
    owning the rectangle (first-fit decreasing); every pod's own chips must
    be host-local and, if required, contiguous.  First rectangle that packs
    wins.  Falls back to best-effort scatter only if every pod in the gang
    relaxed contiguity."""
    requests = {p.key: TpuRequest.from_pod(p) for p in pods}
    total = sum(r.total_chips for r in requests.values())
    if total == 0:
        return GangResult(success=True, reason="no device request", score=0.0)
    free = view.free
    if total > len(free):
        return GangResult(
            success=False, reason=f"slice {view.slice_id}: want {total} chips, free {len(free)}"
        )
    max_host = max((len(view.free_on_host(h)) for h in view.hosts()), default=0)
    for p in pods:
        if requests[p.key].total_chips > max_host:
            return GangResult(
                success=False,
                reason=(
                    f"pod {p.key} wants {requests[p.key].total_chips} chips but no host "
                    f"has more than {max_host} free (a pod cannot span hosts)"
                ),
            )

    candidates = _candidate_rectangles(total, view, free)

    for s, _, coords in candidates:
        packed = _pack_rectangle(view, pods, requests, coords)
        if packed is not None:
            return GangResult(success=True, score=s, per_pod=packed)

    if all(not requests[p.key].contiguous for p in pods if requests[p.key].total_chips):
        packed = _pack_scatter(view, pods, requests)
        if packed is not None:
            score = placement_score(
                frozenset(
                    r.coords for a in packed.values() for r in a.all_chips()
                ),
                free,
                view.mesh_shape,
                view.wrap,
            )
            return GangResult(success=True, score=score, per_pod=packed)

    return GangResult(
        success=False,
        reason=(
            f"no ICI-contiguous {total}-chip rectangle packs gang of "
            f"{len(pods)} pods on slice {view.slice_id}"
        ),
    )


def _candidate_rectangles(
    total: int,
    view: SliceView,
    free: FrozenSet[Coord],
    shape: Optional[Coord] = None,
):
    """Scored free rectangles of `total` chips, score desc then lexicographic
    coords.  ``shape`` restricts the scan to rectangles of exactly that
    shape (multislice equal-shape placement); the restricted scan
    enumerates only that shape's origins."""
    return _scored_rectangles(
        total, tuple(view.mesh_shape),
        tuple(view.wrap or tuple(False for _ in view.mesh_shape)),
        free, shape=shape,
    )


def _scored_rectangles(
    total: int,
    mesh_shape: Coord,
    wrap: Tuple[bool, ...],
    membership: FrozenSet[Coord],
    scoring_free: Optional[FrozenSet[Coord]] = None,
    shape: Optional[Coord] = None,
):
    """The ONE rectangle scan: rectangles of `total` chips fully inside
    `membership`, scored against `scoring_free` (defaults to membership),
    sorted score desc then lexicographic coords."""
    score_ctx = membership if scoring_free is None else scoring_free
    candidates = []
    # A qualifying rect's origin is always one of its coords, so only
    # membership-anchored origins can ever qualify: iterate THOSE directly
    # instead of every whole-mesh origin (identical candidate set to the
    # enumerate_rectangles scan with the origin pre-filter, but the gang
    # hot path — small per-host membership against a 16x16 mesh — does
    # |membership| x |shapes| work instead of |mesh| x |shapes|, measured
    # ~4x on the churn row's binds/sec).  Origin validity matches
    # enumerate_rectangles exactly: a dim wraps only when the torus wraps
    # AND the shape doesn't span it (full-extent dims pin origin 0).
    ndims = len(mesh_shape)
    shapes = [shape] if shape else factor_shapes(total, ndims)
    origins = sorted(membership)
    for shp in shapes:
        if any(shp[d] > mesh_shape[d] for d in range(ndims)):
            continue
        for origin in origins:
            if any(
                origin[d] + shp[d] > mesh_shape[d]
                and not (wrap[d] and shp[d] < mesh_shape[d])
                for d in range(ndims)
            ):
                continue
            rect = Submesh(origin=origin, shape=shp)
            coords = rect.coords(mesh_shape, wrap)
            if not coords <= membership:
                continue
            s = placement_score(coords, score_ctx, mesh_shape, wrap)
            candidates.append((s, sorted(coords), coords))
    # deterministic: score desc, then lexicographic coords
    candidates.sort(key=lambda t: (-t[0], t[1]))
    return candidates


def _pack_rectangle(
    view: SliceView,
    pods: Sequence[PodInfo],
    requests: Dict[str, TpuRequest],
    rect_coords: FrozenSet[Coord],
) -> Optional[Dict[str, Assignment]]:
    """Bin-pack the gang's pods onto the hosts that own rect_coords."""
    host_avail: Dict[str, set] = {}
    for c in rect_coords:
        host_avail.setdefault(view.chips[c].host, set()).add(c)
    # first-fit decreasing over pod size; deterministic order
    order = sorted(pods, key=lambda p: (-requests[p.key].total_chips, p.key))
    out: Dict[str, Assignment] = {}
    for pod in order:
        req = requests[pod.key]
        if req.total_chips == 0:
            out[pod.key] = Assignment(node="", slice_id=view.slice_id)
            continue
        placed = False
        for host in sorted(host_avail, key=lambda h: (len(host_avail[h]), h)):
            avail = host_avail[host]
            if len(avail) < req.total_chips:
                continue
            subset = _pick_pod_subset(avail, req, view)
            if subset is None:
                continue
            refs = [view.chips[c] for c in sorted(subset)]
            out[pod.key] = Assignment(
                node=host,
                slice_id=view.slice_id,
                per_container=_split_containers(refs, req),
                score=placement_score(subset, view.free, view.mesh_shape, view.wrap),
            )
            avail -= subset
            placed = True
            break
        if not placed:
            return None
    return out


def _pick_pod_subset(
    avail: set, req: TpuRequest, view: SliceView
) -> Optional[FrozenSet[Coord]]:
    return _best_subset(frozenset(avail), req.total_chips, view, req.contiguous)[0]


def _pack_scatter(
    view: SliceView, pods: Sequence[PodInfo], requests: Dict[str, TpuRequest]
) -> Optional[Dict[str, Assignment]]:
    """Relaxed fallback: greedy per-pod best placement, no global rectangle."""
    remaining = set(view.free)
    out: Dict[str, Assignment] = {}
    order = sorted(pods, key=lambda p: (-requests[p.key].total_chips, p.key))
    for pod in order:
        req = requests[pod.key]
        if req.total_chips == 0:
            out[pod.key] = Assignment(node="", slice_id=view.slice_id)
            continue
        best = None
        best_score = -1.0
        best_host = None
        for host in view.hosts():
            avail = view.by_host[host] & frozenset(remaining)
            if len(avail) < req.total_chips:
                continue
            subset = _pick_pod_subset(set(avail), req, view)
            if subset is None:
                continue
            s = placement_score(subset, frozenset(remaining), view.mesh_shape, view.wrap)
            if s > best_score:
                best, best_score, best_host = subset, s, host
        if best is None:
            return None
        refs = [view.chips[c] for c in sorted(best)]
        out[pod.key] = Assignment(
            node=best_host,
            slice_id=view.slice_id,
            per_container=_split_containers(refs, req),
            score=best_score,
        )
        remaining -= best
    return out
