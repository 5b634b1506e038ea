"""CRI shim daemon: wires the proxy to the API server and the node's
``GpuProvider``, the port's copy of the JAX package's
``crishim/daemon.py``.  One per GPU node; kubelet's
``--container-runtime-endpoint`` points at it.

    python -m kubegpu_tpu_torch.crishim.daemon \
        --upstream unix:///run/containerd/containerd.sock \
        --listen unix:///run/kubegpu-tpu/crishim.sock
"""

from __future__ import annotations

import argparse
import logging
import threading
from typing import Optional, Sequence

from kubegpu_tpu_torch.crishim.inject import Injection, InjectionError, compute_injection
from kubegpu_tpu_torch.crishim.proxy import CriProxy
from kubegpu_tpu_torch.plugins.provider import GpuProvider
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.info import PodInfo
from kubegpu_tpu_torch.utils.apiserver import ApiServer

log = logging.getLogger(__name__)


class ShimDaemon:
    def __init__(self, api: ApiServer, provider: GpuProvider) -> None:
        self.api = api
        self.provider = provider

    def decide(
        self,
        namespace: str,
        pod_name: str,
        container_name: str,
        sandbox_annotations: dict,
        hostname: str,
    ) -> Optional[Injection]:
        pod = self._pod(namespace, pod_name, sandbox_annotations)
        if annotations.assignment_from_pod(pod.annotations) is None:
            return None  # not a device pod: pure passthrough
        members: Optional[Sequence[str]] = None
        member_slices: Optional[dict] = None
        if pod.pod_group:
            # only reached for pods that DO need injection — an API outage
            # here raises InjectionError (fail CreateContainer, retry)
            # rather than degrading innocent passthrough containers
            members = self._gang_member_names(pod)
            if pod.allow_multislice:
                # the gang MAY span slices: the megascale env needs every
                # member's bind-time slice, exactly or not at all
                member_slices = self._gang_member_slices(pod, members)
        return compute_injection(
            pod, container_name, self.provider, member_names=members,
            subdomain=pod.subdomain, member_slices=member_slices,
        )

    def _pod(self, namespace: str, pod_name: str, sandbox_annotations: dict) -> PodInfo:
        """Fresh pod from the API server (its assignment annotation is
        written at bind); the sandbox's annotation copy is the offline
        fallback — same data, captured at sandbox creation."""
        try:
            # lenient: injection only needs identity/gang/assignment fields;
            # a malformed quantity must not push a bound pod onto the
            # sandbox-annotation fallback path
            return annotations.pod_from_k8s(
                self.api.get_pod(namespace, pod_name), strict=False
            )
        except Exception:  # noqa: BLE001 - degrade to the sandbox's copy,
            # but say so: repeated fallbacks signal an API/parse problem
            log.warning(
                "could not fetch pod %s/%s from API server; using sandbox "
                "annotations", namespace, pod_name, exc_info=True,
            )
            pod = PodInfo(
                name=pod_name,
                namespace=namespace,
                annotations=dict(sandbox_annotations),
            )
            pod.pod_group = sandbox_annotations.get(annotations.POD_GROUP)
            try:
                pod.pod_group_size = int(
                    sandbox_annotations.get(annotations.POD_GROUP_SIZE, "1")
                )
            except ValueError:
                pod.pod_group_size = 1
            pod.allow_multislice = (
                sandbox_annotations.get(annotations.POD_MULTISLICE, "false").lower()
                == "true"
            )
            return pod

    def _gang_member_names(self, pod: PodInfo) -> Sequence[str]:
        """All member names of the pod's gang — required exactly, or the
        rendezvous env would be wrong for every worker.  Raises
        InjectionError when the list cannot be established (API down,
        members missing): CreateContainer must fail-and-retry rather than
        start a worker that initializes as a standalone job while its
        siblings block at rendezvous."""
        try:
            names = []
            for obj in self.api.list_pods(namespace=pod.namespace):
                try:
                    p = annotations.pod_from_k8s(obj, strict=False)
                except Exception:  # noqa: BLE001 - unrelated malformed pods
                    continue
                if p.pod_group == pod.pod_group:
                    names.append(p.name)
        except Exception as e:  # noqa: BLE001
            raise InjectionError(
                f"cannot list gang members of {pod.key}: {e}"
            ) from e
        if pod.name not in names:
            names.append(pod.name)
        if len(names) < pod.pod_group_size:
            raise InjectionError(
                f"gang {pod.pod_group}: only {len(names)}/{pod.pod_group_size} "
                f"members visible; refusing to inject a partial worker table"
            )
        return sorted(names)[: pod.pod_group_size]

    def _gang_member_slices(self, pod: PodInfo, members: Sequence[str]) -> dict:
        """name -> bind-time slice_id for every CHIP-requesting gang member.
        Zero-chip members (coordinators/sidecars) never receive an
        assignment annotation — they bind plain — and don't participate in
        the device mesh, so they are excluded rather than treated as
        missing.
        Raises InjectionError when a chip member's assignment is not yet
        visible: a partial slice table would compute a wrong
        MEGASCALE_NUM_SLICES / slice index for every worker, so fail
        CreateContainer and let kubelet retry after the siblings bind."""
        slices: dict = {}
        missing = []
        for name in members:
            try:
                obj = self.api.get_pod(pod.namespace, name)
            except Exception as e:  # noqa: BLE001
                raise InjectionError(
                    f"gang {pod.pod_group}: cannot fetch member {name}: {e}"
                ) from e
            try:
                info = annotations.pod_from_k8s(obj, strict=False)
                if info.total_tpu_chips() == 0:
                    continue
            except Exception:  # noqa: BLE001 - fall through to the
                pass  # assignment check: chips unknown => require assignment
            a = annotations.assignment_from_pod(obj)
            if a is None or not a.slice_id:
                missing.append(name)
            else:
                slices[name] = a.slice_id
        if missing:
            raise InjectionError(
                f"gang {pod.pod_group}: members {missing} have no bind-time "
                f"slice assignment yet; refusing a partial multislice table"
            )
        return slices

    def serve(self, upstream: str, listen: str) -> CriProxy:
        proxy = CriProxy(upstream_target=upstream, decide=self.decide, listen_target=listen)
        proxy.start()
        log.info("crishim proxying %s -> %s", listen, upstream)
        return proxy


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--upstream", default="unix:///run/containerd/containerd.sock")
    ap.add_argument("--listen", default="unix:///run/kubegpu-tpu/crishim.sock")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    from kubegpu_tpu_torch.plugins.discovery import NvmlGpuProvider
    from kubegpu_tpu_torch.utils.apiserver import KubeApiServer

    daemon = ShimDaemon(KubeApiServer(), NvmlGpuProvider())
    daemon.serve(args.upstream, args.listen)
    threading.Event().wait()


if __name__ == "__main__":
    main()
