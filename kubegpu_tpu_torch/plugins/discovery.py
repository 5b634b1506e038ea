"""NvmlGpuProvider: discover this host's cards from the real machine, the
counterpart of the JAX package's ``GkeTpuProvider``
(``kubegpu_tpu/plugins/discovery.py``).

Where a TPU VM answers through its platform env and ``/dev/accel*``, a
GPU host answers through NVML (``plugins/nvml.py``) and
``/dev/nvidia<minor>``.  The host is one slice: its cards form a 1-D
line in NVML's index order (PCI bus order), card i at coordinates
``(i,)`` with chip id and device index i; the slice is named after the
node, and it has no TPU generation.  A k-card pod is therefore placed on
a contiguous run of cards, and a gang that spans hosts is a multislice
gang over the network, as it is across TPU slices.

A card is healthy when NVML's handle and memory queries succeed for it
and its ``/dev/nvidia<minor>`` opens for reading and writing (the native
probe's accessibility bit in the JAX package).  Allocating a card that
the host lacks or cannot open raises, so the CRI shim fails that
container's ``CreateContainer``.  The library, the devfs root and the
node name are injectable, so discovery is testable without a card."""

from __future__ import annotations

import os
import socket
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from kubegpu_tpu_torch.plugins import nvml
from kubegpu_tpu_torch.plugins.provider import (
    CONTROL_DEVICES,
    AllocateResponse,
    GpuProvider,
    HostFragment,
    allocate_env,
)
from kubegpu_tpu_torch.types.info import ChipRef
from kubegpu_tpu_torch.types.topology import Chip


def host_fragment(node_name: str, healthy: Sequence[bool]) -> HostFragment:
    """The fragment of a host with ``len(healthy)`` cards, card i's health
    ``healthy[i]``: one slice named after the node, a line of cards."""
    n = len(healthy)
    return HostFragment(
        node_name=node_name,
        slice_id=node_name,
        generation=None,
        mesh_shape=(n,),
        wrap=(False,),
        chips=[
            Chip(coords=(i,), chip_id=i, host_id=node_name, device_index=i,
                 healthy=bool(ok))
            for i, ok in enumerate(healthy)
        ],
    )


def device_opens(path: str) -> bool:
    """True when the device node opens for reading and writing."""
    try:
        fd = os.open(path, os.O_RDWR)
    except OSError:
        return False
    os.close(fd)
    return True


class NvmlGpuProvider(GpuProvider):
    def __init__(
        self,
        node_name: Optional[str] = None,
        env: Optional[Mapping[str, str]] = None,
        nvml_lib=None,
        devfs_root: str = "/dev",
    ) -> None:
        self._env = dict(os.environ if env is None else env)
        self._node_name = node_name or self._env.get("NODE_NAME") or socket.gethostname()
        self._lib = nvml_lib
        self._devfs = devfs_root
        self._probe_cache: Tuple[float, Optional[nvml.NvmlProbe]] = (0.0, None)
        self._probe_ttl_s = 1.0

    def probe(self) -> Optional[nvml.NvmlProbe]:
        """NVML's view of the host (None: no library, a CPU node).  Briefly
        memoized: one advertise cycle (enumerate + health) and one
        CreateContainer (allocate) each cost a single probe."""
        now = time.monotonic()
        ts, cached = self._probe_cache
        if cached is not None and now - ts < self._probe_ttl_s:
            return cached
        if self._lib is None:
            self._lib = nvml.load(self._env)
        out = None if self._lib is None else nvml.probe(self._lib)
        if out is not None:
            self._probe_cache = (now, out)
        return out

    def device_node(self, minor: int) -> str:
        return os.path.join(self._devfs, f"nvidia{minor}")

    def card_healthy(self, card: nvml.NvmlCard) -> bool:
        return card.error is None and device_opens(self.device_node(card.minor))

    # -- enumeration ------------------------------------------------------
    def enumerate(self) -> Optional[HostFragment]:
        probe = self.probe()
        if probe is None or not probe.cards:
            return None
        return host_fragment(self._node_name,
                             [self.card_healthy(c) for c in probe.cards])

    # -- allocate ---------------------------------------------------------
    def allocate(self, chips: Sequence[ChipRef]) -> AllocateResponse:
        probe = self.probe()
        cards: Dict[int, nvml.NvmlCard] = {
            c.index: c for c in (probe.cards if probe is not None else [])
        }
        wanted = sorted({c.device_index for c in chips})
        bad = [i for i in wanted
               if i not in cards or not self.card_healthy(cards[i])]
        if bad:
            # a container that believes it owns a card it cannot open
            # fails obscurely inside CUDA: fail at injection time instead
            raise ValueError(
                f"allocated card indices {bad} are not on this host or "
                f"cannot be opened (healthy: "
                f"{[i for i, c in sorted(cards.items()) if self.card_healthy(c)]})"
            )
        devices = [self.device_node(cards[i].minor) for i in wanted]
        devices += [p for p in (os.path.join(self._devfs, n)
                                for n in CONTROL_DEVICES) if os.path.exists(p)]
        return AllocateResponse(
            env=allocate_env(chips, {i: cards[i].uuid for i in wanted}),
            devices=devices,
            mounts=[],
        )

    def healthy_device_indices(self) -> Optional[List[int]]:
        probe = self.probe()
        if probe is None:
            return None
        return [c.index for c in probe.cards if self.card_healthy(c)]
