"""Grouped-resource paths and trees: the port's copy of the JAX package's
``types/resource.py``.

The resource name and the annotation prefix are the system's own,
unchanged: the extender (the JAX package's and the port's alike) counts
``google.com/tpu`` on a node and in a pod's limits, so a GPU node that
the port advertises offers its cards under that name.  The names of the
visibility env live here too, below the device layer that injects them
and the training layer that reads them.

Paths encode ownership (slice -> host -> chip); topology lives in the
chips' mesh coordinates.  ``ResourceTree`` holds any nested grouped
resources, and ``grpalloc/treefit.py`` fits wildcard request trees
against it.  Wire format of a path: ``group/index/group/index/.../leaf``,
where any ``index`` in a *request* may be the wildcard ``*``."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

# Canonical extended-resource names (the TPU analog of nvidia.com/gpu) —
# used in k8s container specs / node capacity, NOT inside ResourcePaths
# (they contain '/'; tree paths use the slash-free LEAF_TPU).
RES_TPU = "google.com/tpu"
RES_TPU_MEM_GIB = "kubegpu-tpu/hbm-gib"
LEAF_TPU = "tpu"

# Prefix marking grouped-resource keys in container specs / annotations,
# mirroring the reference's alpha/grpresource-style prefix (SURVEY.md §2 #1).
DEVICE_GROUP_PREFIX = "kubegpu-tpu/grpresource"

# The env that grants a container its cards, both the cards' NVML UUIDs:
# CUDA's (which the worker counts) and the NVIDIA container runtime's
ENV_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
ENV_NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"

WILDCARD = "*"

_SEGMENT_RE = re.compile(r"^[A-Za-z0-9_.\-*]+$")


@dataclass(frozen=True, order=True)
class ResourcePath:
    """An alternating (group-kind, index) path ending in a leaf resource name.

    ``ResourcePath.parse("tpu-slice/s0/host/2/chip/5/tpu")`` has
    ``groups == (("tpu-slice","s0"), ("host","2"), ("chip","5"))`` and
    ``leaf == "tpu"``.
    """

    groups: Tuple[Tuple[str, str], ...]
    leaf: str

    @staticmethod
    def parse(s: str) -> "ResourcePath":
        parts = s.split("/")
        if len(parts) % 2 != 1 or not parts:
            raise ValueError(f"malformed resource path (need odd segment count): {s!r}")
        for p in parts:
            if not p or not _SEGMENT_RE.match(p):
                raise ValueError(f"malformed path segment {p!r} in {s!r}")
        groups = tuple((parts[i], parts[i + 1]) for i in range(0, len(parts) - 1, 2))
        return ResourcePath(groups=groups, leaf=parts[-1])

    def __str__(self) -> str:
        segs: List[str] = []
        for kind, idx in self.groups:
            segs.extend((kind, idx))
        segs.append(self.leaf)
        return "/".join(segs)

    @property
    def has_wildcard(self) -> bool:
        return any(idx == WILDCARD for _, idx in self.groups)

    def matches(self, concrete: "ResourcePath") -> bool:
        """True if *concrete* (no wildcards) satisfies this (possibly
        wildcarded) path: same shape, same group kinds, same leaf, and every
        non-wildcard index equal."""
        if self.leaf != concrete.leaf or len(self.groups) != len(concrete.groups):
            return False
        for (k1, i1), (k2, i2) in zip(self.groups, concrete.groups):
            if k1 != k2:
                return False
            if i1 != WILDCARD and i1 != i2:
                return False
        return True


class ResourceTree:
    """A nested multiset of resources: group nodes keyed ``kind/index``,
    leaves are ``{resource_name: int quantity}``.

    This is the in-memory form of both a node's capacity/allocatable/used and
    a pod's grouped request.  Deterministic iteration (sorted keys) mirrors the
    reference's sorted-tree walks (SURVEY.md §2 #10) so allocation is
    reproducible.
    """

    __slots__ = ("children", "leaves", "meta")

    def __init__(self) -> None:
        self.children: Dict[Tuple[str, str], "ResourceTree"] = {}
        self.leaves: Dict[str, int] = {}
        # Arbitrary metadata (e.g. mesh coords on chip nodes, health).
        self.meta: Dict[str, object] = {}

    # -- construction -----------------------------------------------------
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

    def get(self, path: ResourcePath) -> int:
        node: Optional[ResourceTree] = self
        for kind, idx in path.groups:
            node = node.child(kind, idx) if node is not None else None
            if node is None:
                return 0
        return node.leaves.get(path.leaf, 0)

    # -- iteration --------------------------------------------------------
    def walk(self, prefix: Tuple[Tuple[str, str], ...] = ()) -> Iterator[Tuple[ResourcePath, int]]:
        """Yield every (concrete leaf path, qty), deterministically sorted."""
        for name in sorted(self.leaves):
            yield ResourcePath(groups=prefix, leaf=name), self.leaves[name]
        for key in sorted(self.children):
            yield from self.children[key].walk(prefix + (key,))

    def subtrees(self, kind: str) -> Iterator[Tuple[str, "ResourceTree"]]:
        """Yield (index, child) for children of the given group kind, sorted."""
        for (k, idx) in sorted(self.children):
            if k == kind:
                yield idx, self.children[(k, idx)]

    # -- arithmetic (take/return bookkeeping) -----------------------------
    def add_tree(self, other: "ResourceTree", sign: int = 1) -> None:
        for path, qty in other.walk():
            cur = self.get(path)
            new = cur + sign * qty
            if new < 0:
                raise ValueError(f"resource underflow at {path}: {cur} - {qty}")
            node = self
            for kind, idx in path.groups:
                node = node.child(kind, idx, create=True)  # type: ignore[assignment]
            if new == 0:
                node.leaves.pop(path.leaf, None)
            else:
                node.leaves[path.leaf] = new

    def clone(self) -> "ResourceTree":
        t = ResourceTree()
        for path, qty in self.walk():
            t.add(path, qty)
        # shallow-copy metadata along the structure
        _copy_meta(self, t)
        return t

    # -- (de)serialization ------------------------------------------------
    def to_flat(self) -> Dict[str, int]:
        """Flatten to {path string: qty} — the annotation wire format."""
        return {str(p): q for p, q in self.walk()}

    @staticmethod
    def from_flat(flat: Dict[str, int]) -> "ResourceTree":
        t = ResourceTree()
        for s, q in flat.items():
            t.add(ResourcePath.parse(s), int(q))
        return t

    def total(self, leaf: str) -> int:
        return sum(q for p, q in self.walk() if p.leaf == leaf)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ResourceTree):
            return NotImplemented
        return self.to_flat() == other.to_flat()

    def __repr__(self) -> str:
        return f"ResourceTree({self.to_flat()})"


def _copy_meta(src: ResourceTree, dst: ResourceTree) -> None:
    dst.meta = dict(src.meta)
    for key, child in src.children.items():
        if key in dst.children:
            _copy_meta(child, dst.children[key])
