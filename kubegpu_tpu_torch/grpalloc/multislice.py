"""The port's copy of the JAX package's ``grpalloc/multislice.py``.

Multislice gang placement: one gang spanning DCN-connected slices.

The reference's allocator never crossed an NVLink island — one pod's GPUs
lived on one node, one job's pods on one machine's topology tree.  TPU pods
break that assumption at the top end: a job larger than any single ICI slice
runs *multislice* — k identical sub-jobs, one per slice, with XLA's
DCN collectives (megascale) bridging slices while ICI collectives run inside
each.  The placement contract that makes this work:

1. every slice hosts the SAME rectangle shape (XLA requires identical
   per-slice topology: the DCN mesh axis is outermost, so each slice's
   logical device grid must be congruent);
2. each per-slice sub-gang is ICI-contiguous as usual;
3. fewer slices always beats more (every extra slice adds DCN hops, which
   are an order of magnitude slower than ICI).

``fit_gang_multislice`` therefore tries single-slice placement first (the
existing ``fit_gang`` semantics over every slice), and only when that fails
— and the pod opted in via the ``kubegpu-tpu/multislice`` annotation —
searches k = 2, 3, ... slices, minimal k first, for equal-shape sub-gang
placements.  Pure logic, no I/O, same testability as the rest of grpalloc.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kubegpu_tpu_torch.grpalloc.allocator import (
    GangResult,
    _candidate_rectangles,
    _pack_rectangle,
    fit_gang,
)
from kubegpu_tpu_torch.grpalloc.view import SliceView
from kubegpu_tpu_torch.types.info import Assignment, PodInfo, TpuRequest
from kubegpu_tpu_torch.types.topology import Coord

# Subtracted from the mean per-slice score for every slice beyond the first:
# ranks multislice layouts among themselves (k is already minimized by
# searching ascending).  Scores are 0-100 (scoring.py).
DCN_PENALTY = 10.0


@dataclass
class MultisliceResult:
    success: bool
    reason: str = ""
    score: float = 0.0
    per_pod: Dict[str, Assignment] = field(default_factory=dict)
    slice_ids: List[str] = field(default_factory=list)
    # the common per-slice rectangle shape when the gang spans slices
    slice_shape: Optional[Coord] = None

    @property
    def num_slices(self) -> int:
        return len(self.slice_ids)


def fit_gang_multislice(
    views: Dict[str, SliceView],
    pods: Sequence[PodInfo],
    allow_multislice: bool = False,
    max_slices: Optional[int] = None,
) -> MultisliceResult:
    """Best placement for a gang over the cluster's slices.

    Single-slice first (best score across slices — the pre-multislice
    behavior, always preferred); then, if allowed, minimal-k multislice."""
    best: Optional[Tuple[str, GangResult]] = None
    reasons: List[str] = []
    for sid in sorted(views):
        g = fit_gang(views[sid], pods)
        if g.success and (best is None or g.score > best[1].score):
            best = (sid, g)
        elif not g.success:
            reasons.append(f"{sid}: {g.reason}")
    if best is not None:
        sid, g = best
        return MultisliceResult(
            success=True, score=g.score, per_pod=dict(g.per_pod), slice_ids=[sid]
        )
    detail = "; ".join(reasons) if reasons else "no TPU slices advertised"

    if not allow_multislice:
        hint = ""
        if len(views) > 1:
            from kubegpu_tpu_torch.types.annotations import POD_MULTISLICE

            hint = (
                f" (cluster has {len(views)} slices; annotate the gang "
                f"{POD_MULTISLICE}=true to allow DCN multislice placement)"
            )
        return MultisliceResult(success=False, reason=detail + hint)

    ms = _fit_multislice(views, pods, max_slices)
    if ms is not None:
        return ms
    return MultisliceResult(
        success=False, reason=f"{detail}; no multislice split fits either"
    )


def _refit_chunk_exact_hole(
    view: SliceView,
    chunk: Sequence[PodInfo],
    requests: Dict[str, TpuRequest],
    occupied: frozenset,
) -> Optional[Tuple[float, Dict[str, Assignment]]]:
    """Exact-hole refit: place the replacement chunk so the gang's union on
    this slice is a rectangle again.

    The gang's surviving members hold ``occupied``; enumerate rectangles of
    volume |occupied| + chunk chips that CONTAIN every occupied coord and
    whose remainder is free, then bin-pack the replacements into that
    remainder (the hole).  Best-scored such rectangle wins — usually the
    gang's original one, if the dead member's coords are still free.
    Returns None when no union-restoring rectangle exists (hole stolen,
    geometry changed); the caller falls back to the best-score refit."""
    need = sum(requests[p.key].total_chips for p in chunk)
    if not occupied or need == 0:
        return None
    avail = view.free | occupied
    for s, _, coords in _candidate_rectangles(len(occupied) + need, view, avail):
        if not occupied <= coords:
            continue
        hole = frozenset(coords - occupied)
        packed = _pack_rectangle(view, chunk, requests, hole)
        if packed is not None:
            return s, packed
    return None


def fit_gang_into_layout(
    views: Dict[str, SliceView],
    pods: Sequence[PodInfo],
    scheduled_by_slice: Dict[str, int],
    occupied_by_slice: Optional[Dict[str, frozenset]] = None,
) -> MultisliceResult:
    """Place replacement members of a PARTIALLY-BOUND gang back into the
    gang's existing slice layout.

    A gang's running members have their rendezvous (and, multislice, their
    megascale slice table) baked into their containers; a replacement that
    lands on any other slice would disagree with every sibling and wedge the
    job at rendezvous.  So: single-slice gangs refit strictly on their
    slice; multislice gangs refill exactly each slice's member deficit
    (equal per-slice population of CHIP members — the invariant planning
    established; ``scheduled_by_slice`` only ever counts chip-holding
    members, so the math here counts chip members too and zero-chip
    members ride along unconstrained).

    When ``occupied_by_slice`` supplies the surviving members' chip coords,
    the refit first tries the EXACT-HOLE path (_refit_chunk_exact_hole):
    the replacement goes into the dead member's freed coords — or any
    placement restoring a rectangular union — so the gang keeps the ICI
    property it was sold.  Best-score refit via fit_gang remains the
    fallback (hole stolen by another tenant, slice reshaped)."""
    slices = sorted(scheduled_by_slice)
    missing = [s for s in slices if s not in views]
    if missing:
        return MultisliceResult(
            success=False,
            reason=f"gang's existing slice(s) {missing} no longer advertised",
        )
    requests = {p.key: TpuRequest.from_pod(p) for p in pods}
    chip_pods = sorted(
        (p for p in pods if requests[p.key].total_chips > 0),
        key=lambda p: p.key,
    )
    zero_pods = [p for p in pods if requests[p.key].total_chips == 0]
    occupied_by_slice = occupied_by_slice or {}

    def _with_zeros(res: MultisliceResult) -> MultisliceResult:
        if res.success:
            for p in zero_pods:  # 0-chip members ride slice 0, no chips
                res.per_pod[p.key] = Assignment(node="", slice_id=slices[0])
        return res

    def _refit(sid: str, chunk: Sequence[PodInfo]):
        """(score, per_pod) on slice `sid`, exact-hole first; or GangResult
        -like failure reason."""
        hole = _refit_chunk_exact_hole(
            views[sid], chunk, requests,
            frozenset(occupied_by_slice.get(sid) or ()),
        )
        if hole is not None:
            return hole
        g = fit_gang(views[sid], chunk)
        if not g.success:
            return g.reason
        return g.score, dict(g.per_pod)

    if len(slices) == 1:
        r = _refit(slices[0], chip_pods)
        if isinstance(r, str):
            return MultisliceResult(
                success=False,
                reason=f"cannot rejoin gang's slice {slices[0]}: {r}",
            )
        score, per_pod = r
        return _with_zeros(
            MultisliceResult(
                success=True, score=score, per_pod=per_pod, slice_ids=slices
            )
        )
    total_chip_members = sum(scheduled_by_slice.values()) + len(chip_pods)
    expected, rem = divmod(total_chip_members, len(slices))
    if rem:
        return MultisliceResult(
            success=False,
            reason=(
                f"{total_chip_members} chip members cannot split equally "
                f"over the gang's {len(slices)} existing slices"
            ),
        )
    merged: Dict[str, Assignment] = {}
    total = 0.0
    i = 0
    for sid in slices:
        deficit = expected - scheduled_by_slice[sid]
        if deficit < 0:
            return MultisliceResult(
                success=False,
                reason=f"slice {sid} already has more members than {expected}",
            )
        chunk = chip_pods[i : i + deficit]
        i += deficit
        if not chunk:
            continue
        r = _refit(sid, chunk)
        if isinstance(r, str):
            return MultisliceResult(
                success=False,
                reason=f"cannot rejoin gang's slice {sid}: {r}",
            )
        score, per_pod = r
        merged.update(per_pod)
        total += score
    if i != len(chip_pods):
        return MultisliceResult(
            success=False,
            reason=(
                f"{len(chip_pods)} pending chip members but the layout is "
                f"only missing {i}"
            ),
        )
    return _with_zeros(
        MultisliceResult(
            success=True,
            score=total / len(slices),
            per_pod=merged,
            slice_ids=slices,
        )
    )


def _fit_multislice(
    views: Dict[str, SliceView],
    pods: Sequence[PodInfo],
    max_slices: Optional[int],
) -> Optional[MultisliceResult]:
    requests = {p.key: TpuRequest.from_pod(p) for p in pods}
    chip_pods = sorted(
        (p for p in pods if requests[p.key].total_chips > 0), key=lambda p: p.key
    )
    zero_pods = [p for p in pods if requests[p.key].total_chips == 0]
    if not chip_pods:
        return None
    sizes = {requests[p.key].total_chips for p in chip_pods}
    if len(sizes) > 1:
        return MultisliceResult(
            success=False,
            reason=(
                "multislice placement requires homogeneous per-pod chip "
                f"counts, gang mixes {sorted(sizes)}"
            ),
        )
    per_pod_chips = sizes.pop()
    n = len(chip_pods)

    # slices must be geometrically comparable for equal-shape sub-gangs;
    # group by mesh rank and search within the largest-rank group
    by_rank: Dict[int, List[str]] = {}
    for sid, v in views.items():
        by_rank.setdefault(len(v.mesh_shape), []).append(sid)

    k_cap = min(len(views), n, max_slices if max_slices else n)
    for k in range(2, k_cap + 1):
        if n % k:
            continue
        chunk = n // k
        chunk_chips = chunk * per_pod_chips
        chunks = [chip_pods[i * chunk : (i + 1) * chunk] for i in range(k)]
        for rank, sids in sorted(by_rank.items()):
            # prune before the combinatorial walk: a slice without enough
            # free chips can never host a chunk, and this whole search runs
            # under the scheduler's cache lock on every filter retry
            usable = [s for s in sids if len(views[s].free) >= chunk_chips]
            if len(usable) < k:
                continue
            shapes = _candidate_shapes(chunk_chips, rank, [views[s] for s in usable])
            # first success wins: shapes are ordered squarest-first (the
            # score's own aspect preference) and combos lexicographically,
            # so the result is deterministic without exhausting the
            # (combinations x shapes x rectangles) product under the lock
            for shape in shapes:
                for combo in itertools.combinations(sorted(usable), k):
                    placed = _place_combo(views, combo, chunks, requests, shape)
                    if placed is None:
                        continue
                    score, per_pod = placed
                    best = MultisliceResult(
                        success=True,
                        score=score - DCN_PENALTY * (k - 1),
                        per_pod=per_pod,
                        slice_ids=list(combo),
                        slice_shape=shape,
                    )
                    for p in zero_pods:  # 0-chip members ride slice 0
                        best.per_pod[p.key] = Assignment(
                            node="", slice_id=best.slice_ids[0]
                        )
                    return best
    return None


def _candidate_shapes(
    chunk_chips: int, rank: int, slice_views: Sequence[SliceView]
) -> List[Coord]:
    """Rectangle shapes of chunk_chips chips that fit in at least one of the
    candidate slices, squarest first (aspect ≈ ring bandwidth, scoring.py)."""
    from kubegpu_tpu_torch.types.topology import factor_shapes

    out = []
    for shape in factor_shapes(chunk_chips, rank):
        if any(
            all(shape[d] <= v.mesh_shape[d] for d in range(rank))
            for v in slice_views
        ):
            out.append(shape)
    out.sort(key=lambda s: (max(s) / min(s), s))
    return out


def _place_combo(
    views: Dict[str, SliceView],
    combo: Sequence[str],
    chunks: Sequence[Sequence[PodInfo]],
    requests: Dict[str, TpuRequest],
    shape: Coord,
) -> Optional[Tuple[float, Dict[str, Assignment]]]:
    """Place chunk i on slice combo[i], every slice using rectangle `shape`.
    Chunks are interchangeable (homogeneous pods), so identity mapping loses
    nothing.  Returns (mean slice score, merged per-pod assignments)."""
    merged: Dict[str, Assignment] = {}
    total_score = 0.0
    for sid, chunk in zip(combo, chunks):
        placed = _fit_subgang_shape(views[sid], chunk, requests, shape)
        if placed is None:
            return None
        score, per_pod = placed
        total_score += score
        merged.update(per_pod)
    return total_score / len(combo), merged


def _fit_subgang_shape(
    view: SliceView,
    pods: Sequence[PodInfo],
    requests: Dict[str, TpuRequest],
    shape: Coord,
) -> Optional[Tuple[float, Dict[str, Assignment]]]:
    """Best free rectangle of exactly `shape` on this slice that bin-packs
    the sub-gang — the allocator's own candidate scan (shared code, shared
    determinism) restricted to the one shape every slice must share."""
    if len(shape) != len(view.mesh_shape):
        return None
    for s, _, coords in _candidate_rectangles(
        _volume(shape), view, view.free, shape=shape
    ):
        packed = _pack_rectangle(view, pods, requests, coords)
        if packed is not None:
            return s, packed
    return None


def _volume(shape: Coord) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
