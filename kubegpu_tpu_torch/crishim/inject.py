"""Device + multi-host env injection: the logic layer of the CRI shim,
the port's copy of the JAX package's ``crishim/inject.py`` over a
``GpuProvider``, pure and testable off-cluster.

Given the pod's bind-time assignment annotation (written by the
extender) and its gang metadata, compute what the container must
receive:

- ``CUDA_VISIBLE_DEVICES``/``NVIDIA_VISIBLE_DEVICES`` (the cards' UUIDs)
  and the ``/dev/nvidia*`` nodes, from the node's ``GpuProvider``;
- the multi-host rendezvous contract, unchanged, because the port's
  worker reads it (``parallel/mesh.py::distributed_init_from_env``):
    TPU_WORKER_ID            index of this pod among its gang (sorted keys;
                             slice-local index for multislice gangs)
    TPU_WORKER_HOSTNAMES     comma list of workers' stable hostnames (the
                             pod's own slice only, for multislice gangs)
    JAX_COORDINATOR_ADDRESS  worker 0's hostname:port
    JAX_NUM_PROCESSES / JAX_PROCESS_ID
  and, for a gang that spans slices (hosts), the ``MEGASCALE_*`` set.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

from kubegpu_tpu_torch.plugins.provider import AllocateResponse, GpuProvider
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.info import PodInfo

log = logging.getLogger(__name__)

DEFAULT_COORDINATOR_PORT = 8476
# DCN transport rendezvous for multislice jobs (XLA megascale); distinct
# from the jax.distributed coordinator port above
DEFAULT_MEGASCALE_PORT = 8081


class InjectionError(Exception):
    """The shim POSITIVELY knows this container needs injection but cannot
    compute it correctly (e.g. gang rendezvous with the API server down).
    CreateContainer must fail — kubelet retries — rather than start a worker
    with wrong env that silently corrupts the whole gang."""


@dataclass
class Injection:
    env: Dict[str, str] = field(default_factory=dict)
    devices: List[str] = field(default_factory=list)
    mounts: List[tuple] = field(default_factory=list)  # (host_path, container_path)

    @property
    def empty(self) -> bool:
        return not (self.env or self.devices or self.mounts)


def pod_hostname(pod_name: str, subdomain: Optional[str], namespace: str) -> str:
    """Stable DNS name for a worker: headless-service form when the pod spec
    sets a subdomain (the supported pattern for gang jobs), else the bare
    pod name (same-node resolution only)."""
    if subdomain:
        return f"{pod_name}.{subdomain}.{namespace}.svc"
    return pod_name


def worker_env(
    pod: PodInfo,
    member_names: Sequence[str],
    subdomain: Optional[str] = None,
    coordinator_port: int = DEFAULT_COORDINATOR_PORT,
    member_slices: Optional[Mapping[str, str]] = None,
) -> Dict[str, str]:
    """The multi-host rendezvous env for one gang member.  member_names are
    the gang's pod names; ordering is canonicalized here (sorted) so every
    member derives the same worker table independently.

    The JAX_* process table is always gang-global: it is the one the
    port's worker joins (``parallel/mesh.py::distributed_init_from_env``).
    The worker table (TPU_WORKER_ID / TPU_WORKER_HOSTNAMES) is PER SLICE,
    as the JAX package computes it: each worker's id is its index within
    its own slice and the hostname list covers only that slice's members;
    cross-slice rendezvous rides MEGASCALE_* (multislice_env).
    ``member_slices`` (pod name -> slice id) triggers the slice-local table
    when the gang actually spans more than one slice."""
    names = sorted(member_names)
    if pod.name not in names:
        names = sorted(names + [pod.name])
    worker_id = names.index(pod.name)
    hostnames = [pod_hostname(n, subdomain, pod.namespace) for n in names]
    coordinator = f"{hostnames[0]}:{coordinator_port}"

    local_names = names
    if member_slices and len(set(member_slices.values())) > 1:
        my_slice = member_slices.get(pod.name)
        if my_slice is None:
            raise InjectionError(
                f"pod {pod.key}: multislice gang but no slice recorded for "
                f"it ({sorted(member_slices)})"
            )
        # names is already canonically sorted; filtering preserves it, so
        # the slice-local table inherits the global ordering
        local_names = [n for n in names if member_slices.get(n) == my_slice]
    return {
        "TPU_WORKER_ID": str(local_names.index(pod.name)),
        "TPU_WORKER_HOSTNAMES": ",".join(
            pod_hostname(n, subdomain, pod.namespace) for n in local_names
        ),
        "JAX_COORDINATOR_ADDRESS": coordinator,
        "JAX_NUM_PROCESSES": str(len(names)),
        "JAX_PROCESS_ID": str(worker_id),
    }


def multislice_env(
    pod: PodInfo,
    member_slices: Mapping[str, str],
    subdomain: Optional[str] = None,
    megascale_port: int = DEFAULT_MEGASCALE_PORT,
) -> Dict[str, str]:
    """The multislice (DCN) env contract for one gang member, when its gang
    spans more than one slice (grpalloc.multislice placement).

    ``member_slices`` maps every gang member's pod name to the slice_id its
    bind-time assignment landed on.  The variables are the megascale
    rendezvous set: slice count, this worker's slice index, and
    the DCN coordinator — the first member ON THE FIRST SLICE (megascale
    expects the coordinator on slice 0, so picking the globally-first name
    would break whenever name order and slice order diverge, e.g. after a
    member was re-planned into an existing gang's hole).  Empty when the
    gang sits on one slice — single-slice jobs must not see megascale
    vars."""
    slices = sorted(set(member_slices.values()))
    if len(slices) <= 1:
        return {}
    my_slice = member_slices.get(pod.name)
    if my_slice is None:
        raise InjectionError(
            f"pod {pod.key}: no slice recorded for it in its own gang "
            f"({sorted(member_slices)})"
        )
    coordinator = pod_hostname(
        min(n for n, s in member_slices.items() if s == slices[0]),
        subdomain,
        pod.namespace,
    )
    return {
        "MEGASCALE_COORDINATOR_ADDRESS": f"{coordinator}:{megascale_port}",
        "MEGASCALE_NUM_SLICES": str(len(slices)),
        "MEGASCALE_SLICE_ID": str(slices.index(my_slice)),
        "MEGASCALE_PORT": str(megascale_port),
    }


def compute_injection(
    pod: PodInfo,
    container_name: str,
    provider: GpuProvider,
    member_names: Optional[Sequence[str]] = None,
    subdomain: Optional[str] = None,
    member_slices: Optional[Mapping[str, str]] = None,
    coordinator_port: int = DEFAULT_COORDINATOR_PORT,
) -> Injection:
    """Everything to add to one container's config at CreateContainer time:
    the provider's injection for the container's cards, then the gang's
    rendezvous env, its coordinator at ``coordinator_port`` (the shim's
    fixed port by default; a caller that runs the gang's pods on one host
    passes a free one).

    Pods without an assignment annotation get an empty injection — the
    shim is a transparent passthrough for them."""
    a = annotations.assignment_from_pod(pod.annotations)
    if a is None:
        return Injection()
    chips = a.per_container.get(container_name, [])
    if not chips:
        return Injection()
    try:
        alloc: AllocateResponse = provider.allocate(chips)
    except Exception as e:  # noqa: BLE001 - every refusal fails the container
        # a card the host lacks or cannot open, or NVML failing to probe
        # the host: fail CreateContainer rather than start the container
        # without its visibility env (under the NVIDIA runtime a CUDA
        # image would then see every card of the node)
        raise InjectionError(f"pod {pod.key}: {e}") from e
    inj = Injection(env=dict(alloc.env), devices=list(alloc.devices), mounts=list(alloc.mounts))
    if pod.pod_group:
        members = list(member_names) if member_names is not None else [pod.name]
        inj.env.update(
            worker_env(
                pod, members, subdomain=subdomain,
                coordinator_port=coordinator_port,
                member_slices=member_slices,
            )
        )
        if member_slices:
            inj.env.update(
                multislice_env(pod, member_slices, subdomain=subdomain)
            )
    else:
        inj.env.setdefault("TPU_WORKER_ID", "0")
        inj.env.setdefault("JAX_NUM_PROCESSES", "1")
        inj.env.setdefault("JAX_PROCESS_ID", "0")
    return inj
