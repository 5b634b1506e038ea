"""Grouped-resource paths and trees: the port's copy of the JAX
package's ``types/resource.py``, trimmed to what a node's capacity tree
needs.

The resource name and the annotation prefix are the system's own,
unchanged: the JAX package's extender counts ``google.com/tpu`` on a
node and in a pod's limits, so a GPU node that the port advertises
offers its cards under that name until the control plane is ported.
The names of the visibility env live here too, below the device layer
that injects them and the training layer that reads them.

Wire format of a path: ``group/index/group/index/.../leafresource``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

RES_TPU = "google.com/tpu"
LEAF_TPU = "tpu"

# The env that grants a container its cards, both the cards' NVML UUIDs:
# CUDA's (which the worker counts) and the NVIDIA container runtime's
ENV_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
ENV_NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"

WILDCARD = "*"


@dataclass(frozen=True, order=True)
class ResourcePath:
    """An alternating (group-kind, index) path ending in a leaf resource
    name, e.g. ``tpu-slice/s0/host/h0/chip/5/tpu``."""

    groups: Tuple[Tuple[str, str], ...]
    leaf: str

    def __str__(self) -> str:
        segs: List[str] = []
        for kind, idx in self.groups:
            segs.extend((kind, idx))
        segs.append(self.leaf)
        return "/".join(segs)


class ResourceTree:
    """A nested multiset of resources: group nodes keyed ``kind/index``,
    leaves are ``{resource_name: int quantity}``; deterministic (sorted)
    iteration."""

    __slots__ = ("children", "leaves", "meta")

    def __init__(self) -> None:
        self.children: Dict[Tuple[str, str], "ResourceTree"] = {}
        self.leaves: Dict[str, int] = {}
        # Arbitrary metadata (e.g. mesh coords on chip nodes).
        self.meta: Dict[str, object] = {}

    def child(self, kind: str, index: str, create: bool = False) -> Optional["ResourceTree"]:
        key = (kind, index)
        node = self.children.get(key)
        if node is None and create:
            node = ResourceTree()
            self.children[key] = node
        return node

    def add(self, path: ResourcePath, qty: int = 1) -> None:
        node = self
        for kind, idx in path.groups:
            if idx == WILDCARD:
                raise ValueError(f"cannot add wildcard path to concrete tree: {path}")
            node = node.child(kind, idx, create=True)  # type: ignore[assignment]
        node.leaves[path.leaf] = node.leaves.get(path.leaf, 0) + qty

    def walk(self, prefix: Tuple[Tuple[str, str], ...] = ()) -> Iterator[Tuple[ResourcePath, int]]:
        """Yield every (concrete leaf path, qty), deterministically sorted."""
        for name in sorted(self.leaves):
            yield ResourcePath(groups=prefix, leaf=name), self.leaves[name]
        for key in sorted(self.children):
            yield from self.children[key].walk(prefix + (key,))

    def to_flat(self) -> Dict[str, int]:
        """Flatten to {path string: qty} — the annotation wire format."""
        return {str(p): q for p, q in self.walk()}

    def total(self, leaf: str) -> int:
        return sum(q for p, q in self.walk() if p.leaf == leaf)

    def __repr__(self) -> str:
        return f"ResourceTree({self.to_flat()})"
