"""The port's scheduler extender (``kubegpu_tpu_torch/scheduler/``) held
against the JAX package's on the CPU: the same pod stream into both
``Scheduler``s, each over its own in-memory API server holding the same
nodes (tests/torch_sched_twin.py), must give equal ``filter``,
``prioritize``, ``bind`` and ``preemption_victims`` answers and, after
every step, equal pod and node annotations, equal event reasons and
equal caches.

Covered: single pods and contiguous placement; gangs all-or-nothing (an
incomplete gang binds nothing); priority preemption, active and through
the advisory verb, and which of two needless victims of different
priorities it spares (per slice and across slices); chip death through
``on_node_updated`` with eviction; a multislice gang; the
grouped-resource plugin; ``resync`` after a restart reproducing the
cache; and a seeded differential soak
of creates, deletes, card deaths and revivals, re-advertisements,
resyncs and restarts, on TPU slices and on GPU hosts."""

import pytest

from kubegpu_tpu.scheduler.plugins import (
    GroupedResourceScheduler as JaxGroupedResourceScheduler,
)
from kubegpu_tpu.scheduler.plugins import default_registry as jax_registry
from kubegpu_tpu_torch.grpalloc.allocator import clear_fit_caches
from kubegpu_tpu_torch.scheduler.plugins import (
    GroupedResourceScheduler,
    default_registry,
)
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.resource import ResourcePath, ResourceTree

from torch_sched_twin import Fleet, Twin, api_state, plain, pod_obj, soak

KINDS = {
    "tpu": lambda: Fleet("tpu"),                      # one v5e-16: 4 hosts of 4
    "gpu": lambda: Fleet("gpu", n=2, cards=8),        # two 8-card hosts
}


@pytest.fixture(params=sorted(KINDS))
def twin(request):
    clear_fit_caches()
    return Twin(KINDS[request.param]())


def test_single_pods_filter_prioritize_bind_equal(twin):
    for i, chips in enumerate([1, 2, 4, 1, 1]):
        obj = pod_obj(f"p{i}", chips)
        twin.create(obj)
        fj, fp = twin.filter(obj)
        assert plain(fp) == plain(fj) and fj.nodes
        pj, pp = twin.prioritize(obj, fj.nodes)
        assert pp == pj
        node = twin.schedule(obj)
        assert node is not None
        twin.assert_same()
    state = api_state(twin.port_api)
    assert all(node for node, _ in state["pods"].values())
    assert (twin.port.metrics.get("kubegpu_placements_total")
            == twin.jax.metrics.get("kubegpu_placements_total") == 5)
    assert (twin.port.metrics.get("kubegpu_placements_contiguous_total")
            == twin.jax.metrics.get("kubegpu_placements_contiguous_total"))


def test_passthrough_and_refusals_equal(twin):
    """A pod without a device request passes everywhere; an oversize one,
    a malformed quantity and a bind to an unknown pod are refused with
    the same words."""
    web = pod_obj("web", 0)
    twin.create(web)
    fj, fp = twin.filter(web)
    assert plain(fp) == plain(fj) and fj.nodes == twin.nodes()
    big = pod_obj("big", 64)
    twin.create(big)
    fj, fp = twin.filter(big)
    assert plain(fp) == plain(fj) and not fj.nodes and fj.failed
    bad = pod_obj("bad", 1)
    bad["spec"]["containers"][0]["resources"]["limits"]["google.com/tpu"] = "x"
    twin.create(bad)
    fj, fp = twin.filter(bad)
    assert plain(fp) == plain(fj) and fj.error
    bj, bp = twin.bind("default", "ghost", twin.nodes()[0])
    assert bp == bj and bj
    twin.assert_same()


def test_gang_is_all_or_nothing(twin):
    """An incomplete gang (3 of 4 members created) binds nothing and
    both extenders say so with the same words; the fourth member's
    arrival admits the whole gang on both, on the same devices."""
    members = [pod_obj(f"g-{k}", 1, group="g", size=4) for k in range(4)]
    for m in members[:3]:
        twin.create(m)
    for m in members[:3]:
        fj, fp = twin.filter(m)
        assert plain(fp) == plain(fj)
        assert not fj.nodes
    twin.assert_same()
    assert not any(n for n, _ in api_state(twin.port_api)["pods"].values())
    twin.create(members[3])
    for m in members:
        assert twin.schedule(m) is not None
    state = twin.assert_same()
    assigned = [annotations.assignment_from_pod(ann)
                for _, ann in state["pods"].values()]
    assert all(a is not None and len(a.all_chips()) == 1 for a in assigned)
    reasons = {e[2] for e in state["events"]}
    assert "GangPlanned" in reasons


def test_priority_preemption_active_and_advisory():
    """Active: a VIP evicts lower-priority pods inside filter on both.
    Advisory (``active_preemption=False``): filter refuses and
    ``preemption_victims`` nominates the same victims on both."""
    for active in (True, False):
        clear_fit_caches()
        twin = Twin(Fleet("tpu"), active_preemption=active)
        for i in range(4):
            obj = pod_obj(f"low{i}", 4, priority=1)
            twin.create(obj)
            assert twin.schedule(obj) is not None
        vip = pod_obj("vip", 4, priority=9)
        twin.create(vip)
        if active:
            assert twin.schedule(vip) is not None
            state = twin.assert_same()
            assert "Preempted" in {e[2] for e in state["events"]}
            assert len([k for k in state["pods"] if "low" in k]) == 3
        else:
            fj, fp = twin.filter(vip)
            assert plain(fp) == plain(fj) and not fj.nodes
            vj, vp = twin.preemption_victims(vip)
            assert vp == vj and sum(len(v) for v in vj.values()) == 1
            vj, vp = twin.preemption_victims(vip, sorted(twin.nodes())[:1])
            assert vp == vj
            twin.assert_same()


@pytest.mark.parametrize("hosts", [1, 2], ids=["one-slice", "multislice"])
def test_preemption_spares_the_more_valuable_of_two_needless_victims(hosts):
    """On each 4-card host a (1 card, priority 1) at card 0, c (2 cards,
    priority 3) at 1-2 and b (1 card, priority 2) at 3; a VIP of 3
    contiguous cards (one pod, or on two hosts a multislice gang of two)
    frees a, b and c before it fits, and then either a or b is not
    needed: the minimize pass drops the more valuable, b, on both
    extenders (per slice, and in the joint cross-slice search), actively
    and through the advisory verb."""
    for active in (True, False):
        clear_fit_caches()
        twin = Twin(Fleet("gpu", n=hosts, cards=4), active_preemption=active)
        for h in range(hosts):
            for name, chips, prio in (("a", 1, 1), ("c", 2, 3), ("b", 1, 2)):
                obj = pod_obj(f"{name}{h}", chips, priority=prio)
                twin.create(obj)
                assert twin.schedule(obj) == f"gpu-{h}"
        vips = ([pod_obj("vip", 3, priority=9)] if hosts == 1 else
                [pod_obj(f"vip-{k}", 3, group="vip", size=2, priority=9,
                         multislice=True) for k in range(2)])
        for v in vips:
            twin.create(v)
        want = {f"gpu-{h}": [f"default/a{h}", f"default/c{h}"]
                for h in range(hosts)}
        if active:
            for v in vips:
                assert twin.schedule(v) is not None
            state = twin.assert_same()
            assert sorted(state["pods"]) == sorted(
                [f"default/b{h}" for h in range(hosts)]
                + [f"default/{v['metadata']['name']}" for v in vips])
            preempted = {e[1] for e in state["events"]
                         if e[2] == "Preempted"}
            assert preempted == {k.split("/")[1] for ks in want.values()
                                 for k in ks}
        else:
            vj, vp = twin.preemption_victims(vips[0])
            assert plain(vp) == plain(vj) == want
            twin.assert_same()


def test_chip_death_evicts_through_the_node_watch(twin):
    """A bound pod's device dies; the advertiser's patch reaches both
    extenders through ``on_node_updated``: both evict the pod, free its
    devices and record ChipFailure; a revived device is placeable again."""
    objs = [pod_obj(f"p{i}", 2) for i in range(3)]
    for o in objs:
        twin.create(o)
        twin.schedule(o)
    a = annotations.assignment_from_pod(
        twin.port_api.get_pod("default", "p1"))
    dev = a.all_chips()[0]
    twin.fleet.kill(dev.host, dev.device_index)
    twin.readvertise(dev.host)
    state = twin.assert_same()
    assert "default/p1" not in state["pods"]
    assert "ChipFailure" in {e[2] for e in state["events"]}
    assert (twin.port.metrics.get("kubegpu_health_evictions_total")
            == twin.jax.metrics.get("kubegpu_health_evictions_total") == 1)
    twin.fleet.revive(dev.host, dev.device_index)
    twin.readvertise(dev.host)
    again = pod_obj("again", 2)
    twin.create(again)
    assert twin.schedule(again) is not None
    twin.assert_same()


def test_multislice_gang_spans_two_slices():
    """A gang larger than any one slice, opted in to multislice, lands on
    both slices of a two-slice cluster alike on both extenders."""
    clear_fit_caches()
    twin = Twin(Fleet("tpu", n=2, mesh=(2, 4), block=(2, 2)))
    members = [pod_obj(f"ms-{k}", 4, group="ms", size=4, multislice=True)
               for k in range(4)]
    for m in members:
        twin.create(m)
    for m in members:
        assert twin.schedule(m) is not None
    state = twin.assert_same()
    slices = {annotations.assignment_from_pod(ann).slice_id
              for _, ann in state["pods"].values()}
    assert slices == {"s0", "s1"}


def _npu_twin():
    """A GPU host beside a node whose npu devices only the grouped
    plugin (registered on both extenders) places."""
    clear_fit_caches()
    reg_j, reg_p = jax_registry(), default_registry()
    reg_j.register(JaxGroupedResourceScheduler("npu", "example.com/npu",
                                               "npugrp/*/npu/*/dev"))
    reg_p.register(GroupedResourceScheduler("npu", "example.com/npu",
                                            "npugrp/*/npu/*/dev"))
    cap = ResourceTree()
    for g in range(2):
        for d in range(2):
            cap.add(ResourcePath.parse(f"npugrp/{g}/npu/{d}/dev"), 1)
    npu = {"metadata": {"name": "npu-node", "annotations": {
        annotations.NODE_GROUPED_CAPACITY:
            annotations.encode_grouped_capacity(cap)}}}
    return Twin(Fleet("gpu", n=1, cards=4), extra_nodes=[npu],
                registries=(reg_j, reg_p))


def test_grouped_resource_plugin():
    """The generic grouped-resource plugin: npu pods fit the node's
    grouped-capacity tree alike on both, bind with grouped bindings in
    the assignment, are refused when it is full, and release on
    delete."""
    twin = _npu_twin()
    nodes = ["gpu-0", "npu-node"]
    for i, want in enumerate([2, 1, 2]):
        obj = pod_obj(f"n{i}", 0, extended={"example.com/npu": str(want)})
        twin.create(obj)
        fj, fp = twin.filter(obj, nodes)
        assert plain(fp) == plain(fj)
        if i < 2:
            assert fj.nodes == ["npu-node"]
            pj, pp = twin.prioritize(obj, fj.nodes)
            assert pp == pj
            bj, bp = twin.bind("default", f"n{i}", "npu-node")
            assert bp == bj is None
        else:
            assert not fj.nodes
    mixed = pod_obj("mixed", 1, extended={"example.com/npu": "1"})
    twin.create(mixed)
    fj, fp = twin.filter(mixed, nodes)
    assert plain(fp) == plain(fj) and not fj.nodes
    assert all("multiple device types" in r for r in fj.failed.values())
    state = twin.assert_same()
    a = annotations.assignment_from_pod(state["pods"]["default/n0"][1])
    assert sum(a.grouped_totals().values()) == 2
    twin.delete("default", "n0")
    fj, fp = twin.filter(pod_obj("n2", 0, extended={"example.com/npu": "2"}),
                         nodes)
    assert plain(fp) == plain(fj) and fj.nodes == ["npu-node"]
    twin.assert_same()


def test_resync_after_restart_reproduces_the_cache(twin):
    """Bound pods, a gang and a pending pod; new scheduler processes
    rebuild from the annotations alone the cache the old ones held, and
    both packages rebuild the same one."""
    for i, chips in enumerate([1, 2, 1]):
        o = pod_obj(f"p{i}", chips)
        twin.create(o)
        twin.schedule(o)
    members = [pod_obj(f"g-{k}", 1, group="g", size=2) for k in range(2)]
    for m in members:
        twin.create(m)
    for m in members:
        twin.schedule(m)
    twin.create(pod_obj("pending", 64))
    before = plain(twin.port.cache.assignments_snapshot())
    twin.restart()
    twin.resync()
    assert plain(twin.port.cache.assignments_snapshot()) == before
    twin.assert_same()
    views_j = {sid: sorted(v.free) for sid, v in twin.jax.cache.views().items()}
    views_p = {sid: sorted(v.free) for sid, v in twin.port.cache.views().items()}
    assert views_p == views_j


@pytest.mark.parametrize("kind, seed", [("tpu", 0), ("tpu", 1), ("gpu", 2),
                                        ("gpu", 3), ("tpu-2", 4)])
def test_differential_soak(kind, seed):
    """About 200 seeded operations on both extenders (create a pod or a
    gang and schedule it, delete, kill or revive a device, re-advertise
    a node, resync, restart), the API-visible state equal after each."""
    clear_fit_caches()
    if kind == "tpu-2":
        fleet, kw = Fleet("tpu", n=2, mesh=(2, 4)), {"multislice": True}
    elif kind == "tpu":
        fleet, kw = Fleet("tpu"), {}
    else:
        fleet, kw = Fleet("gpu", n=2, cards=8), {}
    twin = Twin(fleet)
    done = soak(twin, seed, 200, **kw)
    assert done["create"] > 50 and done.get("kill", 0) > 5
    assert done.get("restart", 0) > 3 and done.get("delete", 0) > 10
    reasons = {e[2] for e in api_state(twin.port_api)["events"]}
    assert {"DeviceAssigned", "ChipFailure"} <= reasons


def test_the_port_extender_reads_what_either_advertiser_wrote():
    """The two packages' API servers hold the same node bytes after the
    twin's set-up, and the port's cache decodes a GPU host as the JAX
    package's does: one slice a host, its cards a line."""
    twin = Twin(Fleet("gpu", n=2, cards=4))
    assert (api_state(twin.port_api)["nodes"]
            == api_state(twin.jax_api)["nodes"])
    for name in twin.nodes():
        pj = twin.jax.cache.node(name)
        pp = twin.port.cache.node(name)
        assert plain(pp) == plain(pj)
        assert pp.mesh_shape == (4,) and pp.slice_id == name
