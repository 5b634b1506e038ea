"""GpuProvider: the device-backend interface of the port's device layer,
the counterpart of the JAX package's ``plugins/provider.py``
(``HostFragment``, ``AllocateResponse``, ``TpuProvider``,
``visible_chips_env``).

A provider enumerates the host's cards as a fragment, reports their
health and answers a container's ``allocate`` with the env and device
nodes that grant it exactly those cards.  Implementations:

- ``discovery.NvmlGpuProvider`` — the real host, through NVML;
- ``fake.FakeGpuProvider`` — a fabricated host for the tests.

The visibility env holds the cards' NVML UUIDs, not indices: CUDA
enumerates ``FASTEST_FIRST`` by default while NVML counts in PCI bus
order, and a container given only ``/dev/nvidia3`` has no card 3 inside.
A UUID names the same card in both."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from kubegpu_tpu_torch.types.info import ChipRef, NodeInfo
from kubegpu_tpu_torch.types.resource import (  # noqa: F401 - re-exported
    ENV_NVIDIA_VISIBLE_DEVICES,
    ENV_VISIBLE_DEVICES,
)
from kubegpu_tpu_torch.types.topology import Chip, Coord

# the driver's control nodes a CUDA process opens beside its cards'
CONTROL_DEVICES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")


@dataclass
class HostFragment:
    """What one host contributes: its devices with their mesh coordinates.
    A GPU host is a slice of its own (``slice_id`` the node's name), a
    1-D line of ``mesh_shape (n,)`` in NVML's index order, with no TPU
    generation."""

    node_name: str
    slice_id: str
    generation: Optional[str]
    mesh_shape: Coord
    wrap: Tuple[bool, ...]
    chips: List[Chip] = field(default_factory=list)

    def to_node_info(self) -> NodeInfo:
        node = NodeInfo(
            name=self.node_name,
            slice_id=self.slice_id,
            generation=self.generation,
            mesh_shape=self.mesh_shape,
            wrap=self.wrap,
            chips=list(self.chips),
        )
        node.rebuild_capacity()
        return node


@dataclass
class AllocateResponse:
    """Injection set for one container: env vars, device nodes, and
    mounts the CRI shim must add to the container config."""

    env: Dict[str, str] = field(default_factory=dict)
    devices: List[str] = field(default_factory=list)   # host /dev paths
    mounts: List[Tuple[str, str]] = field(default_factory=list)  # (host, ctr)


class GpuProvider:
    """Device backend interface.  Every method may be called repeatedly
    (the advertiser and the device plugin poll enumerate/health)."""

    def enumerate(self) -> Optional[HostFragment]:
        """This host's cards; None when the host has none (a CPU node)."""
        raise NotImplementedError

    def allocate(self, chips: Sequence[ChipRef]) -> AllocateResponse:
        """Injection set granting a container exactly these host-local
        cards; raises for a card the host lacks or cannot open."""
        raise NotImplementedError

    def healthy_device_indices(self) -> Optional[List[int]]:
        """Fresh health probe; None = provider cannot probe (assume
        enumerate()'s view)."""
        return None


def visible_devices_env(chips: Sequence[ChipRef],
                        uuids: Mapping[int, str]) -> str:
    """Canonical ``CUDA_VISIBLE_DEVICES`` value: the UUIDs of the cards'
    host-local indices (``uuids``: index -> UUID), comma-joined in
    ascending index order, each once."""
    return ",".join(uuids[i] for i in sorted({c.device_index for c in chips}))


def allocate_env(chips: Sequence[ChipRef],
                 uuids: Mapping[int, str]) -> Dict[str, str]:
    """The visibility env of a container granted ``chips``: both
    variables, the same UUID list."""
    visible = visible_devices_env(chips, uuids)
    return {ENV_VISIBLE_DEVICES: visible, ENV_NVIDIA_VISIBLE_DEVICES: visible}
