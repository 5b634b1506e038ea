"""Node/pod/container records: the port's copy of the JAX package's
``types/info.py`` (``NodeInfo``, ``ContainerInfo``, ``PodInfo``,
``ChipRef``, ``Assignment``), the fields the annotation codec reads and
writes, unchanged, so the port decodes what the JAX extender binds."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubegpu_tpu_torch.types.resource import LEAF_TPU, ResourcePath, ResourceTree
from kubegpu_tpu_torch.types.topology import Chip, Coord


@dataclass
class NodeInfo:
    """One Kubernetes node: the devices it owns, with their mesh
    coordinates, and the capacity tree of its healthy ones.
    ``generation`` is the TPU generation's name in the JAX package; a
    GPU host has none."""

    name: str
    slice_id: Optional[str] = None
    generation: Optional[str] = None
    mesh_shape: Optional[Coord] = None
    wrap: Optional[Tuple[bool, ...]] = None
    chips: List[Chip] = field(default_factory=list)
    capacity: ResourceTree = field(default_factory=ResourceTree)

    def chip_path(self, chip: Chip) -> ResourcePath:
        """``tpu-slice/<slice>/host/<node>/chip/<local-index>/tpu``."""
        return ResourcePath(
            groups=(
                ("tpu-slice", self.slice_id or "none"),
                ("host", self.name),
                ("chip", str(chip.device_index)),
            ),
            leaf=LEAF_TPU,
        )

    def rebuild_capacity(self) -> None:
        """Capacity tree from the chip list: healthy chips only."""
        self.capacity = ResourceTree()
        for ch in self.chips:
            if ch.healthy:
                path = self.chip_path(ch)
                self.capacity.add(path, 1)
                node = self.capacity
                for kind, idx in path.groups:
                    node = node.child(kind, idx)
                node.meta["coords"] = ch.coords
                node.meta["chip_id"] = ch.chip_id


@dataclass
class ContainerInfo:
    name: str
    tpu_chips: int = 0                      # scalar google.com/tpu request
    grouped: Optional[ResourceTree] = None  # explicit grouped request (rare)
    extended: Dict[str, int] = field(default_factory=dict)


@dataclass
class PodInfo:
    name: str
    namespace: str = "default"
    uid: str = ""
    containers: List[ContainerInfo] = field(default_factory=list)
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    priority: int = 0
    node_name: Optional[str] = None
    subdomain: Optional[str] = None  # spec.subdomain (headless-service DNS)
    pod_group: Optional[str] = None
    pod_group_size: int = 1
    pod_group_uid: str = ""
    require_contiguous: bool = True
    allow_multislice: bool = False
    slice_selector: Optional[frozenset] = None
    phase: str = ""
    deletion_timestamp: Optional[str] = None

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def total_tpu_chips(self) -> int:
        return sum(c.tpu_chips for c in self.containers)


@dataclass(frozen=True)
class ChipRef:
    """A concrete allocated device: its host, host-local index, id and
    coordinates."""

    host: str
    device_index: int
    chip_id: int
    coords: Coord

    def to_dict(self) -> dict:
        return {
            "host": self.host,
            "device_index": self.device_index,
            "chip_id": self.chip_id,
            "coords": list(self.coords),
        }

    @staticmethod
    def from_dict(d: dict) -> "ChipRef":
        return ChipRef(
            host=str(d["host"]),
            device_index=int(d["device_index"]),
            chip_id=int(d["chip_id"]),
            coords=tuple(int(x) for x in d["coords"]),
        )


@dataclass
class Assignment:
    """The bind-time decision for one pod, written into its annotations
    by the extender and read by the CRI shim."""

    node: str
    slice_id: Optional[str]
    per_container: Dict[str, List[ChipRef]] = field(default_factory=dict)
    score: float = 0.0
    grouped: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)
    bound_at: float = 0.0

    def all_chips(self) -> List[ChipRef]:
        out: List[ChipRef] = []
        for refs in self.per_container.values():
            out.extend(refs)
        return out

    def to_dict(self) -> dict:
        d = {
            "node": self.node,
            "slice_id": self.slice_id,
            "score": self.score,
            "per_container": {
                c: [r.to_dict() for r in refs] for c, refs in self.per_container.items()
            },
        }
        if self.grouped:
            d["grouped"] = {
                c: [[p, q] for p, q in pairs] for c, pairs in self.grouped.items()
            }
        if self.bound_at:
            d["bound_at"] = self.bound_at
        return d

    @staticmethod
    def from_dict(d: dict) -> "Assignment":
        return Assignment(
            node=str(d["node"]),
            slice_id=d.get("slice_id"),
            score=float(d.get("score", 0.0)),
            per_container={
                c: [ChipRef.from_dict(r) for r in refs]
                for c, refs in d.get("per_container", {}).items()
            },
            grouped={
                c: [(str(p), int(q)) for p, q in pairs]
                for c, pairs in d.get("grouped", {}).items()
            },
            bound_at=float(d.get("bound_at", 0.0) or 0.0),
        )
