"""The port's copy of the JAX package's ``testing/fake_serving.py``.

Shared fake serving-cluster bring-up (gateway tests, the gateway
server's ``--replica-endpoint`` mode).

One builder for the scenario every gateway harness needs: a fabricated
cluster whose decode replicas are REALLY scheduled — created as pods,
passed through the extender's filter, bound so the assignment annotation
the registry discovers actually exists.  Where the JAX package
fabricates TPU slices (``slice_ids``, ``mesh``), the port fabricates GPU
hosts (``hosts``, ``cards``): each ``FakeGpuHost`` advertised through the
port's ``Advertiser`` is a slice of its own named after its node, its
cards a line.  Replica keys are the JAX package's (``default/dec-0``,
``default/dec-1``, ...), so ``--replica-endpoint`` binds keys to
endpoints in the same sorted order.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Sequence

from kubegpu_tpu_torch.plugins.advertiser import Advertiser
from kubegpu_tpu_torch.plugins.fake import FakeGpuHost
from kubegpu_tpu_torch.scheduler import Scheduler
from kubegpu_tpu_torch.types import RES_TPU, annotations
from kubegpu_tpu_torch.utils.apiserver import InMemoryApiServer


def schedule_decode_replicas(
    api,
    sched: Scheduler,
    n_replicas: int,
    group: str = "decode",
    pin_slices: Optional[Sequence[str]] = None,
    name_prefix: str = "dec",
    priority: Optional[int] = None,
    roles: Optional[Sequence[str]] = None,
) -> list:
    """Create + filter + bind ``n_replicas`` single-card serving pods
    through the real control plane; returns the pod names.

    ``priority`` stamps POD_PRIORITY (the preemption contract: a
    scale-up placement evicts strictly-lower-priority units, and an
    unstamped replica at the default 0 would read as a victim).
    ``roles`` stamps POD_ROLE per replica (prefill|decode|flex) for
    disaggregated harnesses — omitted entries default to the registry's
    'flex'.  ``pin_slices`` names each replica's host (a GPU host is a
    slice of its own)."""
    nodes = sorted(node["metadata"]["name"] for node in api.list_nodes())
    names = []
    for i in range(n_replicas):
        name = f"{name_prefix}-{i}"
        ann = {annotations.POD_SERVING_GROUP: group}
        if priority is not None:
            ann[annotations.POD_PRIORITY] = str(priority)
        if roles is not None and i < len(roles) and roles[i]:
            ann[annotations.POD_ROLE] = roles[i]
        if pin_slices:
            ann[annotations.POD_SLICE_SELECTOR] = pin_slices[i]
        api.create_pod({
            "metadata": {"name": name, "namespace": "default",
                         "annotations": ann},
            "spec": {"containers": [
                {"name": "s", "resources": {"limits": {RES_TPU: "1"}}}]},
        })
        result = sched.filter(api.get_pod("default", name), nodes)
        assert result.nodes, f"{name}: no feasible node ({result.failed})"
        err = sched.bind("default", name, result.nodes[0])
        assert err is None, f"{name}: bind failed: {err}"
        names.append(name)
    return names


def build_fake_serving_stack(
    n_replicas: int = 3,
    group: str = "decode",
    hosts: Sequence[str] = ("sa", "sb"),
    cards: int = 8,
    pin_slices: Optional[Sequence[str]] = None,
    metrics=None,
    priority: Optional[int] = None,
    roles: Optional[Sequence[str]] = None,
) -> SimpleNamespace:
    """Fabricated cluster of GPU hosts (``hosts`` nodes of ``cards``
    cards each) with scheduled decode replicas and a ReplicaRegistry
    over them.  Returns (api, hosts, advs, sched, registry) — the
    data-plane client and Gateway stay the caller's choice (SimBatcher
    vs a real batcher, policy knobs).  ``priority`` stamps the replicas'
    POD_PRIORITY (see ``schedule_decode_replicas``)."""
    from kubegpu_tpu_torch.gateway.registry import ReplicaRegistry

    api = InMemoryApiServer()
    fake_hosts = {node: FakeGpuHost(node, cards=cards) for node in hosts}
    advs = {}
    for node, host in fake_hosts.items():
        advs[node] = Advertiser(host.provider(), api)
        advs[node].advertise_once()
    sched = Scheduler(api, metrics=metrics) if metrics is not None \
        else Scheduler(api)
    sched.cache.refresh()
    schedule_decode_replicas(api, sched, n_replicas, group, pin_slices,
                             priority=priority, roles=roles)
    registry = ReplicaRegistry(api, group=group)
    return SimpleNamespace(
        api=api, hosts=fake_hosts, advs=advs, sched=sched, registry=registry
    )
