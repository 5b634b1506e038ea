"""Placement scoring: the port's copy of the JAX package's
``grpalloc/scoring.py`` — what "good" means on a mesh of devices.

1. **Contiguity** — a device set that is exactly a rectangular submesh
   gets the full contiguity term; otherwise it is scored by packing
   density (n / bounding-box volume).
2. **Aspect** — among rectangles of equal size, prefer squarer ones.
3. **Anti-fragmentation** — prefer placements that leave fewer free
   cells touching the allocation, so the free space stays rectangular
   for the next job.

On a GPU host's 1-D line of cards this picks a contiguous run of cards
at an end of the free space.  Scores are 0–100 floats; pure functions of
(coords, mesh).
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, Optional, Tuple

from kubegpu_tpu_torch.types.topology import (
    Coord,
    coords_bounding_box,
    is_contiguous_submesh,
)

W_CONTIG = 60.0
W_ASPECT = 15.0
W_FRAG = 25.0


def neighbors(c: Coord, mesh_shape: Coord, wrap: Tuple[bool, ...]):
    for d in range(len(c)):
        for step in (-1, 1):
            v = c[d] + step
            if 0 <= v < mesh_shape[d]:
                yield c[:d] + (v,) + c[d + 1 :]
            elif wrap[d] and mesh_shape[d] > 2:
                yield c[:d] + (v % mesh_shape[d],) + c[d + 1 :]


def packing_density(coords: FrozenSet[Coord]) -> float:
    """n / bounding-box volume ∈ (0, 1]; 1.0 iff exactly a rectangle."""
    if not coords:
        return 0.0
    _, shape = coords_bounding_box(coords)
    vol = 1
    for s in shape:
        vol *= s
    return len(coords) / vol


def aspect_score(coords: FrozenSet[Coord]) -> float:
    """1.0 for a perfect hypercube bounding box, → 0 as it elongates."""
    if not coords:
        return 0.0
    _, shape = coords_bounding_box(coords)
    return min(shape) / max(shape)


def frag_score(
    coords: FrozenSet[Coord],
    free: FrozenSet[Coord],
    mesh_shape: Coord,
    wrap: Tuple[bool, ...],
) -> float:
    """1 - (exposed free perimeter / max possible): placements that leave
    fewer free cells touching the allocation fragment the mesh less."""
    if not coords:
        return 0.0
    remaining_free = free - coords
    exposed = 0
    for c in coords:
        for nb in neighbors(c, mesh_shape, wrap):
            if nb in remaining_free:
                exposed += 1
    max_exposed = 2 * len(mesh_shape) * len(coords)
    return 1.0 - exposed / max_exposed


def placement_score(
    coords: Iterable[Coord],
    free: FrozenSet[Coord],
    mesh_shape: Coord,
    wrap: Optional[Tuple[bool, ...]] = None,
) -> float:
    """Total 0–100 score for allocating `coords` out of `free`."""
    cset = frozenset(coords)
    if not cset:
        return 0.0
    if wrap is None:
        wrap = tuple(False for _ in mesh_shape)
    contig = 1.0 if is_contiguous_submesh(cset, mesh_shape, wrap) else packing_density(cset)
    score = (
        W_CONTIG * contig
        + W_ASPECT * aspect_score(cset)
        + W_FRAG * frag_score(cset, free, mesh_shape, wrap)
    )
    return score
