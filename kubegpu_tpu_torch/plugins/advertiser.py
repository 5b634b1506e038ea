"""Node advertiser daemon: publish this host's cards to the cluster, the
port's copy of the JAX package's ``plugins/advertiser.py`` over a
``GpuProvider``.

Periodically (re-)enumerate the cards, fold in a fresh health probe, and
patch the node object: the topology annotation (the system's own JSON,
which the JAX package's extender decodes) and the extended-resource
capacity.  A card that dies here falls out of the allocatable set
cluster-wide on the next cycle."""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional

from kubegpu_tpu_torch.plugins.provider import GpuProvider
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.resource import RES_TPU
from kubegpu_tpu_torch.utils.apiserver import ApiServer

log = logging.getLogger(__name__)


class Advertiser:
    def __init__(self, provider: GpuProvider, api: ApiServer, interval_s: float = 30.0) -> None:
        self.provider = provider
        self.api = api
        self.interval_s = interval_s
        self._stop = threading.Event()

    def advertise_once(self) -> Optional[str]:
        """One advertisement cycle; returns the node name patched, or None
        for a host without cards (a clean no-op)."""
        frag = self.provider.enumerate()
        if frag is None:
            return None
        healthy = self.provider.healthy_device_indices()
        if healthy is not None:
            alive = set(healthy)
            frag.chips = [
                dataclasses.replace(ch, healthy=ch.healthy and ch.device_index in alive)
                for ch in frag.chips
            ]
        node = frag.to_node_info()
        n_healthy = sum(1 for ch in node.chips if ch.healthy)
        self.api.patch_node_annotations(
            node.name,
            {
                annotations.NODE_TOPOLOGY: annotations.encode_node_topology(node),
                # distinct value per cycle: the scheduler's failure
                # detector counts strikes per advertisement, not per read
                annotations.NODE_ADVERT_SEQ: str(time.time_ns()),
            },
        )
        self.api.patch_node_capacity(node.name, {RES_TPU: str(n_healthy)})
        log.info(
            "advertised %s: slice=%s cards=%d healthy=%d",
            node.name,
            node.slice_id,
            len(node.chips),
            n_healthy,
        )
        return node.name

    def run(self) -> None:
        """Blocking advertise loop (the DaemonSet entrypoint)."""
        while not self._stop.is_set():
            try:
                self.advertise_once()
            except Exception:  # noqa: BLE001 - daemon must survive API blips
                log.exception("advertise cycle failed; will retry")
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()


def main(argv=None) -> None:
    """DaemonSet entrypoint: discover this host's cards through NVML and
    advertise them to the real API server on a loop (``--once`` for a
    single cycle)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--interval", type=float, default=30.0)
    ap.add_argument("--once", action="store_true", help="one cycle, then exit")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    from kubegpu_tpu_torch.plugins.discovery import NvmlGpuProvider
    from kubegpu_tpu_torch.utils.apiserver import KubeApiServer

    adv = Advertiser(NvmlGpuProvider(), KubeApiServer(), interval_s=args.interval)
    if args.once:
        name = adv.advertise_once()
        log.info("advertised once: %s", name or "<no cards on this host>")
    else:
        adv.run()


if __name__ == "__main__":
    main()
