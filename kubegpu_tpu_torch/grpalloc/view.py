"""The port's copy of the JAX package's ``grpalloc/view.py``.

SliceView: the allocator's aggregated, slice-wide picture of free chips.

The reference's grpalloc walked a single node's nested resource tree
(SURVEY.md §3.1) because NVLink topology never crossed a node.  A TPU slice's
ICI mesh *does* cross nodes (a v5e-16 is 4 hosts of 4 chips on one 4×4 mesh),
so the allocator views the whole slice at once: every chip's global mesh
coordinate, which host owns it, and whether it is free, used, or unhealthy.
Built on demand from NodeInfos (cheap: slices are ≤256 chips); holds no state
of its own — the NodeInfo used-trees remain the single source of truth.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Tuple

from kubegpu_tpu_torch.types.info import ChipRef, NodeInfo
from kubegpu_tpu_torch.types.resource import LEAF_TPU
from kubegpu_tpu_torch.types.topology import Coord


@dataclass
class SliceView:
    slice_id: str
    mesh_shape: Coord
    wrap: Tuple[bool, ...]
    # coord -> ChipRef for every healthy chip advertised by some node
    chips: Dict[Coord, ChipRef] = field(default_factory=dict)
    # coords currently taken by bound/assumed pods
    used: FrozenSet[Coord] = frozenset()
    # node name -> its healthy coords
    by_host: Dict[str, FrozenSet[Coord]] = field(default_factory=dict)

    @property
    def free(self) -> FrozenSet[Coord]:
        return frozenset(self.chips) - self.used

    def free_on_host(self, host: str) -> FrozenSet[Coord]:
        return self.by_host.get(host, frozenset()) & self.free

    def hosts(self) -> List[str]:
        return sorted(self.by_host)


def used_coords_of_node(node: NodeInfo) -> FrozenSet[Coord]:
    """Decode which of a node's chips are in use from its used-tree (the
    bookkeeping written by take/return)."""
    by_idx = node.coords_by_device_index()
    out = set()
    for path, qty in node.used.walk():
        if path.leaf != LEAF_TPU or qty <= 0:
            continue
        # path: tpu-slice/<s>/host/<h>/chip/<idx>/tpu
        idx = None
        for kind, val in path.groups:
            if kind == "chip":
                idx = int(val)
        if idx is not None and idx in by_idx:
            out.add(by_idx[idx])
    return frozenset(out)


def build_slice_views(nodes: Iterable[NodeInfo]) -> Dict[str, SliceView]:
    """Aggregate per-node slice fragments into slice-wide views.

    Nodes of one slice must agree on geometry (mesh shape AND torus wrap —
    wrong wrap would let the allocator place gangs across torus links that do
    not exist).  Disagreements are resolved by majority: the geometry
    advertised by the most nodes wins (ties broken deterministically), and
    dissenting nodes are excluded — a single misconfigured advertiser cannot
    poison the slice regardless of iteration order."""
    tpu_nodes = [
        n
        for n in nodes
        if n.is_tpu_node and n.slice_id is not None and n.mesh_shape is not None
    ]
    # elect each slice's geometry by majority of advertising nodes
    geom_votes: Dict[str, Dict[Tuple[Coord, Tuple[bool, ...]], int]] = {}
    for node in tpu_nodes:
        geom = (
            tuple(node.mesh_shape),
            tuple(node.wrap or tuple(False for _ in node.mesh_shape)),
        )
        geom_votes.setdefault(node.slice_id, {})
        geom_votes[node.slice_id][geom] = geom_votes[node.slice_id].get(geom, 0) + 1
    elected = {
        sid: max(votes.items(), key=lambda kv: (kv[1], kv[0]))[0]
        for sid, votes in geom_votes.items()
    }

    views: Dict[str, SliceView] = {}
    for node in sorted(tpu_nodes, key=lambda n: n.name):
        mesh_shape, wrap = elected[node.slice_id]
        node_geom = (
            tuple(node.mesh_shape),
            tuple(node.wrap or tuple(False for _ in node.mesh_shape)),
        )
        if node_geom != (mesh_shape, wrap):
            continue
        view = views.get(node.slice_id)
        if view is None:
            view = SliceView(slice_id=node.slice_id, mesh_shape=mesh_shape, wrap=wrap)
            views[node.slice_id] = view
        host_coords = set()
        for ch in node.chips:
            if not ch.healthy:
                continue
            ref = ChipRef(
                host=node.name,
                device_index=ch.device_index,
                chip_id=ch.chip_id,
                coords=ch.coords,
            )
            view.chips[ch.coords] = ref
            host_coords.add(ch.coords)
        view.by_host[node.name] = frozenset(host_coords)
        view.used = view.used | used_coords_of_node(node)
    return views
