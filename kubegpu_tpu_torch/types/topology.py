"""Devices with explicit mesh coordinates: the port's copy of the JAX
package's ``types/topology.py`` (``TpuGeneration``, ``Chip``,
``Submesh``, ``SliceTopology`` and the geometry helpers the allocator
and the placement scorer use).

A GPU host advertises its cards as a 1-D line in NVML's index order
(``plugins/discovery.py``): card i sits at ``(i,)``.  A TPU slice's
chips sit on a 2-D or 3-D mesh spanning several hosts.  "Good
placement" is rectangular contiguity in those coordinates on either.
All coordinates are global within a slice; everything here is pure data
and pure functions, serializable to annotations."""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, FrozenSet, Iterable, Iterator, List, Optional, Tuple

Coord = Tuple[int, ...]


class TpuGeneration(str, Enum):
    V4 = "v4"        # 3D torus, 4 chips/host
    V5E = "v5e"      # 2D mesh, up to 16x16; 1/4/8 chips per host
    V5P = "v5p"      # 3D torus
    V6E = "v6e"      # 2D mesh

    @property
    def ndims(self) -> int:
        return 3 if self in (TpuGeneration.V4, TpuGeneration.V5P) else 2

    @property
    def hbm_gib_per_chip(self) -> int:
        return {
            TpuGeneration.V4: 32,
            TpuGeneration.V5E: 16,
            TpuGeneration.V5P: 95,
            TpuGeneration.V6E: 32,
        }[self]


@dataclass(frozen=True)
class Chip:
    """One TPU chip of a slice."""

    coords: Coord                 # global mesh coordinates within the slice
    chip_id: int                  # global id within the slice (row-major)
    host_id: str                  # Kubernetes node name that owns this chip
    device_index: int             # local index on the host (TPU_VISIBLE_CHIPS value)
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
    """A rectangular region of a slice mesh: origin + shape, with optional
    per-dimension wraparound (torus links)."""

    origin: Coord
    shape: Coord

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

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


@dataclass
class SliceTopology:
    """The full ICI topology of one TPU slice, spanning one or more hosts."""

    slice_id: str
    generation: TpuGeneration
    mesh_shape: Coord
    wrap: Tuple[bool, ...]
    chips: Dict[Coord, Chip] = field(default_factory=dict)

    # -- construction -----------------------------------------------------
    @staticmethod
    def build(
        slice_id: str,
        generation: TpuGeneration,
        mesh_shape: Coord,
        host_block: Coord,
        wrap: Optional[Tuple[bool, ...]] = None,
        host_name: Optional[callable] = None,
        unhealthy: Iterable[Coord] = (),
    ) -> "SliceTopology":
        """Build a slice whose hosts each own a ``host_block`` rectangle.

        E.g. v5e-16: ``mesh_shape=(4,4), host_block=(2,2)`` → 4 hosts × 4
        chips, matching a GKE ct5lp-hightpu-4t node pool.
        """
        ndims = len(mesh_shape)
        if len(host_block) != ndims:
            raise ValueError("host_block rank must match mesh rank")
        for d in range(ndims):
            if mesh_shape[d] % host_block[d] != 0:
                raise ValueError(f"mesh {mesh_shape} not divisible by host block {host_block}")
        if wrap is None:
            wrap = tuple(False for _ in mesh_shape)
        host_name = host_name or (lambda i: f"{slice_id}-host-{i}")
        unhealthy_set = set(unhealthy)

        topo = SliceTopology(slice_id, generation, tuple(mesh_shape), tuple(wrap))
        host_grid = tuple(mesh_shape[d] // host_block[d] for d in range(ndims))
        host_index: Dict[Coord, int] = {}
        per_host_count: Dict[int, int] = {}
        for hc in itertools.product(*(range(g) for g in host_grid)):
            host_index[hc] = len(host_index)
        chip_id = 0
        for coords in itertools.product(*(range(s) for s in mesh_shape)):
            hc = tuple(coords[d] // host_block[d] for d in range(ndims))
            hi = host_index[hc]
            local = per_host_count.get(hi, 0)
            per_host_count[hi] = local + 1
            topo.chips[coords] = Chip(
                coords=coords,
                chip_id=chip_id,
                host_id=host_name(hi),
                device_index=local,
                healthy=coords not in unhealthy_set,
            )
            chip_id += 1
        return topo

    # -- views ------------------------------------------------------------
    @property
    def num_chips(self) -> int:
        return len(self.chips)

    def healthy_coords(self) -> FrozenSet[Coord]:
        return frozenset(c for c, ch in self.chips.items() if ch.healthy)

    def host_chips(self, host_id: str) -> List[Chip]:
        return sorted(
            (ch for ch in self.chips.values() if ch.host_id == host_id),
            key=lambda ch: ch.device_index,
        )

    def hosts(self) -> List[str]:
        return sorted({ch.host_id for ch in self.chips.values()})

    # -- (de)serialization (annotation wire format) -----------------------
    def to_dict(self) -> dict:
        return {
            "slice_id": self.slice_id,
            "generation": self.generation.value,
            "mesh_shape": list(self.mesh_shape),
            "wrap": list(self.wrap),
            "chips": [ch.to_dict() for _, ch in sorted(self.chips.items())],
        }

    @staticmethod
    def from_dict(d: dict) -> "SliceTopology":
        topo = SliceTopology(
            slice_id=str(d["slice_id"]),
            generation=TpuGeneration(d["generation"]),
            mesh_shape=tuple(int(x) for x in d["mesh_shape"]),
            wrap=tuple(bool(x) for x in d["wrap"]),
        )
        for cd in d["chips"]:
            ch = Chip.from_dict(cd)
            topo.chips[ch.coords] = ch
        return topo


# ---------------------------------------------------------------------------
# Pure geometry helpers used by the allocator's contiguity scorer.
# ---------------------------------------------------------------------------

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
    shapes: Optional[List[Coord]] = None,
) -> Iterator[Submesh]:
    """Every axis-aligned rectangular submesh of exactly n chips that fits in
    the mesh (with wraparound where the torus allows).  Meshes are small
    (≤256 chips — SURVEY.md §7 stage 2), so exhaustive scan is fine.
    ``shapes`` restricts the scan to the given rectangle shapes (they must
    each have volume n) — multislice placement uses this to enumerate only
    the one shape every slice must share."""
    ndims = len(mesh_shape)
    if wrap is None:
        wrap = tuple(False for _ in mesh_shape)
    for shape in shapes if shapes is not None else factor_shapes(n, ndims):
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
    (considering torus wraparound)."""
    cset = frozenset(coords)
    if not cset:
        return False
    if wrap is None:
        wrap = tuple(False for _ in mesh_shape)
    n = len(cset)
    if not any(wrap):
        origin, shape = coords_bounding_box(cset)
        vol = 1
        for s in shape:
            vol *= s
        return vol == n
    for sub in enumerate_rectangles(n, mesh_shape, wrap):
        if sub.origin in cset and sub.coords(mesh_shape, wrap) == cset:
            return True
    return False
