"""FakeGpuHost / FakeGpuProvider: an in-memory GPU host for the tests,
the counterparts of the JAX package's ``FakeSlice`` and
``FakeTpuProvider`` (``kubegpu_tpu/plugins/fake.py``).

A host of n cards with fixed fake UUIDs (a function of the node's name
and the card's index), advertised as ``NvmlGpuProvider`` advertises a
real host, with failure injection (``kill_card``/``revive_card``)."""

from __future__ import annotations

import uuid
from typing import List, Optional, Sequence, Set

from kubegpu_tpu_torch.plugins.discovery import host_fragment
from kubegpu_tpu_torch.plugins.provider import (
    CONTROL_DEVICES,
    AllocateResponse,
    GpuProvider,
    HostFragment,
    allocate_env,
)
from kubegpu_tpu_torch.types.info import ChipRef

_UUID_NAMESPACE = uuid.UUID("6ba7b812-9dad-11d1-80b4-00c04fd430c8")


def fake_uuid(node_name: str, index: int) -> str:
    """The fixed UUID of a fake host's card, in NVML's ``GPU-...`` form."""
    return f"GPU-{uuid.uuid5(_UUID_NAMESPACE, f'{node_name}/{index}')}"


class FakeGpuHost:
    """A fabricated GPU host: ``cards`` cards, all healthy until killed."""

    def __init__(self, node_name: str = "gpu-node-0", cards: int = 8) -> None:
        self.node_name = node_name
        self.uuids: List[str] = [fake_uuid(node_name, i) for i in range(cards)]
        self.dead: Set[int] = set()

    def kill_card(self, index: int) -> None:
        if not 0 <= index < len(self.uuids):
            raise KeyError(f"no card {index} on {self.node_name}")
        self.dead.add(index)

    def revive_card(self, index: int) -> None:
        self.dead.discard(index)

    def provider(self) -> "FakeGpuProvider":
        return FakeGpuProvider(self)


class FakeGpuProvider(GpuProvider):
    def __init__(self, host: FakeGpuHost) -> None:
        self._host = host

    def enumerate(self) -> Optional[HostFragment]:
        n = len(self._host.uuids)
        if not n:
            return None
        return host_fragment(self._host.node_name,
                             [i not in self._host.dead for i in range(n)])

    def allocate(self, chips: Sequence[ChipRef]) -> AllocateResponse:
        wanted = sorted({c.device_index for c in chips})
        healthy = self.healthy_device_indices()
        bad = [i for i in wanted if i not in healthy]
        if bad:
            raise ValueError(
                f"allocated card indices {bad} are not on this host or "
                f"cannot be opened (healthy: {healthy})")
        return AllocateResponse(
            env=allocate_env(chips, dict(enumerate(self._host.uuids))),
            devices=[f"/dev/nvidia{i}" for i in wanted]
            + [f"/dev/{n}" for n in CONTROL_DEVICES],
            mounts=[],
        )

    def healthy_device_indices(self) -> Optional[List[int]]:
        return [i for i in range(len(self._host.uuids))
                if i not in self._host.dead]
