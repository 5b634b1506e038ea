"""Chips with explicit mesh coordinates: the port's copy of the JAX
package's ``types/topology.py`` (``Chip``, ``Coord``, ``Submesh`` and the
geometry helpers the placement scorer needs).

A GPU host advertises its cards as a 1-D line in NVML's index order
(``plugins/discovery.py``): card i sits at ``(i,)``.  "Good placement"
is contiguity in those coordinates, as it is on a TPU slice's mesh."""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import FrozenSet, Iterable, Iterator, List, Optional, Tuple

Coord = Tuple[int, ...]


@dataclass(frozen=True)
class Chip:
    """One device of a host: its mesh coordinates, its id within the
    slice, the node that owns it, its host-local index and its health."""

    coords: Coord
    chip_id: int
    host_id: str
    device_index: int
    healthy: bool = True

    def to_dict(self) -> dict:
        return {
            "coords": list(self.coords),
            "chip_id": self.chip_id,
            "host_id": self.host_id,
            "device_index": self.device_index,
            "healthy": self.healthy,
        }

    @staticmethod
    def from_dict(d: dict) -> "Chip":
        return Chip(
            coords=tuple(int(c) for c in d["coords"]),
            chip_id=int(d["chip_id"]),
            host_id=str(d["host_id"]),
            device_index=int(d["device_index"]),
            healthy=bool(d.get("healthy", True)),
        )


@dataclass(frozen=True)
class Submesh:
    """A rectangular region of a mesh: origin + shape, with optional
    per-dimension wraparound."""

    origin: Coord
    shape: Coord

    def coords(self, mesh_shape: Coord, wrap: Tuple[bool, ...]) -> FrozenSet[Coord]:
        out: List[Coord] = []
        for offs in itertools.product(*(range(s) for s in self.shape)):
            c = []
            for d, (o, off) in enumerate(zip(self.origin, offs)):
                v = o + off
                if v >= mesh_shape[d]:
                    if not wrap[d]:
                        raise ValueError(f"submesh {self} exceeds mesh {mesh_shape} in dim {d}")
                    v %= mesh_shape[d]
                c.append(v)
            out.append(tuple(c))
        return frozenset(out)


def factor_shapes(n: int, ndims: int) -> List[Coord]:
    """All ndims-tuples of positive ints whose product is n, deduplicated,
    sorted for determinism (e.g. n=4, ndims=2 → [(1,4),(2,2),(4,1)])."""
    if ndims == 1:
        return [(n,)]
    out: List[Coord] = []
    for first in range(1, n + 1):
        if n % first == 0:
            for rest in factor_shapes(n // first, ndims - 1):
                out.append((first,) + rest)
    return sorted(set(out))


def enumerate_rectangles(
    n: int,
    mesh_shape: Coord,
    wrap: Optional[Tuple[bool, ...]] = None,
) -> Iterator[Submesh]:
    """Every axis-aligned rectangular submesh of exactly n devices that
    fits in the mesh (with wraparound where the mesh allows)."""
    ndims = len(mesh_shape)
    if wrap is None:
        wrap = tuple(False for _ in mesh_shape)
    for shape in factor_shapes(n, ndims):
        if any(shape[d] > mesh_shape[d] for d in range(ndims)):
            continue
        origin_ranges = []
        for d in range(ndims):
            if wrap[d] and shape[d] < mesh_shape[d]:
                origin_ranges.append(range(mesh_shape[d]))
            else:
                origin_ranges.append(range(mesh_shape[d] - shape[d] + 1))
        for origin in itertools.product(*origin_ranges):
            yield Submesh(origin=tuple(origin), shape=shape)


def coords_bounding_box(coords: Iterable[Coord]) -> Tuple[Coord, Coord]:
    """(origin, shape) of the axis-aligned bounding box (no wraparound)."""
    pts = list(coords)
    if not pts:
        raise ValueError("empty coordinate set")
    ndims = len(pts[0])
    lo = tuple(min(p[d] for p in pts) for d in range(ndims))
    hi = tuple(max(p[d] for p in pts) for d in range(ndims))
    return lo, tuple(hi[d] - lo[d] + 1 for d in range(ndims))


def is_contiguous_submesh(
    coords: Iterable[Coord], mesh_shape: Coord, wrap: Optional[Tuple[bool, ...]] = None
) -> bool:
    """True iff the coordinate set is exactly some rectangular submesh
    (considering wraparound)."""
    cset = frozenset(coords)
    if not cset:
        return False
    if wrap is None:
        wrap = tuple(False for _ in mesh_shape)
    n = len(cset)
    if not any(wrap):
        _, shape = coords_bounding_box(cset)
        vol = 1
        for s in shape:
            vol *= s
        return vol == n
    for sub in enumerate_rectangles(n, mesh_shape, wrap):
        if sub.origin in cset and sub.coords(mesh_shape, wrap) == cset:
            return True
    return False
