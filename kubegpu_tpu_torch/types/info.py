"""Node/pod/container records: the port's copy of the JAX package's
``types/info.py`` (``NodeInfo``, ``ContainerInfo``, ``PodInfo``,
``ChipRef``, ``Assignment``, ``TpuRequest``), with the fields the
annotation codec reads and writes unchanged, so the port decodes what
either extender binds.  A node carries capacity and used grouped-resource
trees and the devices it owns; a pod carries its containers' requests
and its gang metadata."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubegpu_tpu_torch.types.resource import LEAF_TPU, ResourcePath, ResourceTree
from kubegpu_tpu_torch.types.topology import Chip, Coord, TpuGeneration


@dataclass
class NodeInfo:
    """One Kubernetes node as the scheduler sees it.  A GPU host has no
    TPU ``generation`` (None)."""

    name: str
    # TPU slice fragment owned by this host (empty for non-TPU nodes).
    slice_id: Optional[str] = None
    generation: Optional[TpuGeneration] = None
    mesh_shape: Optional[Coord] = None
    wrap: Optional[Tuple[bool, ...]] = None
    chips: List[Chip] = field(default_factory=list)
    # Grouped-resource bookkeeping (device resources only; cpu/mem stay with
    # the default scheduler, as in the reference).
    capacity: ResourceTree = field(default_factory=ResourceTree)
    used: ResourceTree = field(default_factory=ResourceTree)

    @property
    def is_tpu_node(self) -> bool:
        return bool(self.chips)

    def allocatable(self) -> ResourceTree:
        t = self.capacity.clone()
        t.add_tree(self.used, sign=-1)
        return t

    def chip_path(self, chip: Chip) -> ResourcePath:
        """Canonical grouped path for one chip's allocatable unit:
        ``tpu-slice/<slice>/host/<node>/chip/<local-index>/tpu`` — the
        slice→host→chip ownership encoding (resource.py docstring).  The host
        level keeps paths cluster-globally unique so slice-wide aggregation
        across NodeInfos cannot conflate chips; the leaf is the slash-free
        LEAF_TPU (the k8s name RES_TPU contains '/', which is illegal in a
        path segment)."""
        return ResourcePath(
            groups=(
                ("tpu-slice", self.slice_id or "none"),
                ("host", self.name),
                ("chip", str(chip.device_index)),
            ),
            leaf=LEAF_TPU,
        )

    def rebuild_capacity(self) -> None:
        """Capacity tree from the chip list: healthy chips only — dead chips
        fall out of the allocatable set (SURVEY.md §5.3)."""
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

    def coords_by_device_index(self) -> Dict[int, Coord]:
        return {ch.device_index: ch.coords for ch in self.chips}


@dataclass
class ContainerInfo:
    name: str
    tpu_chips: int = 0                      # scalar google.com/tpu request
    grouped: Optional[ResourceTree] = None  # explicit grouped request (rare)
    # Other extended resources (domain/name-style limits, e.g. a custom
    # device type served by a non-TPU DeviceSchedulerPlugin — SURVEY.md §2 #5)
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
    # Gang metadata (parsed from annotations by scheduler.podgroup).
    pod_group: Optional[str] = None
    pod_group_size: int = 1
    # gang incarnation id (POD_GROUP_UID annotation, e.g. the owning Job's
    # UID); "" when unset — scopes completed-member memory per incarnation
    pod_group_uid: str = ""
    require_contiguous: bool = True
    # opt-in: the gang may span DCN-connected slices when no single slice
    # fits it (grpalloc.multislice)
    allow_multislice: bool = False
    # tenant pinning: slice ids placement may use (None = any slice)
    slice_selector: Optional[frozenset] = None
    # Lifecycle (status.phase / metadata.deletionTimestamp): the stranded-
    # gang sweep must not count Terminating victims or garbage-collected
    # Succeeded members as "bound" capacity holders.
    phase: str = ""
    deletion_timestamp: Optional[str] = None

    @property
    def terminal(self) -> bool:
        """Succeeded/Failed: the pod's chips are released; it will never
        run again (its containers are done)."""
        return self.phase in ("Succeeded", "Failed")

    @property
    def terminating(self) -> bool:
        """Graceful deletion in progress (deletionTimestamp set)."""
        return self.deletion_timestamp is not None

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def total_tpu_chips(self) -> int:
        return sum(c.tpu_chips for c in self.containers)


@dataclass(frozen=True)
class ChipRef:
    """A concrete allocated chip: enough for both the CRI shim (host-local
    device index) and observability (global coords)."""

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
    (SURVEY.md §1 data-flow contract: state lives in the API server)."""

    node: str
    slice_id: Optional[str]
    per_container: Dict[str, List[ChipRef]] = field(default_factory=dict)
    score: float = 0.0
    # Non-chip device bindings from a generic DeviceSchedulerPlugin
    # (SURVEY.md §2 #5): container -> [(concrete resource path, qty)].
    grouped: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)
    # epoch seconds of the durable bind commit; rides the annotation so
    # the preemption min-runtime shield (anti-starvation) survives
    # scheduler restarts.  0.0 = unknown (legacy annotation): unshielded.
    bound_at: float = 0.0

    def all_chips(self) -> List[ChipRef]:
        out: List[ChipRef] = []
        for refs in self.per_container.values():
            out.extend(refs)
        return out

    def grouped_totals(self) -> Dict[str, int]:
        """Aggregate grouped bindings across containers: path -> qty."""
        out: Dict[str, int] = {}
        for pairs in self.grouped.values():
            for path, qty in pairs:
                out[path] = out.get(path, 0) + qty
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


@dataclass
class TpuRequest:
    """A pod's device request, normalized for the allocator."""

    total_chips: int
    contiguous: bool = True
    per_container: Dict[str, int] = field(default_factory=dict)

    @staticmethod
    def from_pod(pod: PodInfo) -> "TpuRequest":
        per = {c.name: c.tpu_chips for c in pod.containers if c.tpu_chips > 0}
        return TpuRequest(
            total_chips=sum(per.values()),
            contiguous=pod.require_contiguous,
            per_container=per,
        )
