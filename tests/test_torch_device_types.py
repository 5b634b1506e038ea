"""The port's copy of the system's wire types (``kubegpu_tpu_torch/types``)
held against the JAX package's on the CPU:

- a GPU host's node annotation (``encode_node_topology``) is the JAX
  package's string for the same chips, byte for byte, for hosts of 1, 2,
  4 and 8 cards (some of them dead), and the JAX package's
  ``decode_node_topology`` reads it back: the same chips, a 1-D line,
  no generation, a capacity of the healthy cards;
- ``pod_from_k8s``, ``decode_assignment``/``assignment_from_pod`` and
  ``encode_assignment`` agree with the JAX package's on every pod of
  ``samples/*.yaml``, each bound by the JAX extender (the multislice
  sample over two slices), strict and lenient.
"""

import dataclasses

import pytest

from kubegpu_tpu.plugins import Advertiser as JaxAdvertiser
from kubegpu_tpu.plugins import FakeSlice
from kubegpu_tpu.scheduler import Scheduler
from kubegpu_tpu.types import annotations as jax_ann
from kubegpu_tpu.types.info import NodeInfo as JaxNodeInfo
from kubegpu_tpu.types.topology import Chip as JaxChip
from kubegpu_tpu.utils import InMemoryApiServer
from kubegpu_tpu_torch.plugins.fake import FakeGpuHost
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.resource import RES_TPU

from test_samples import MESH, load_pods, make_cluster, sample_files, schedule_all


def jax_node(frag) -> JaxNodeInfo:
    """The JAX package's NodeInfo of the same chips as the port's
    fragment."""
    node = JaxNodeInfo(
        name=frag.node_name, slice_id=frag.slice_id, generation=None,
        mesh_shape=frag.mesh_shape, wrap=frag.wrap,
        chips=[JaxChip(**c.to_dict() | {"coords": c.coords})
               for c in frag.chips])
    node.rebuild_capacity()
    return node


@pytest.mark.parametrize("cards,dead", [(1, ()), (2, ()), (2, (1,)), (4, ()),
                                        (4, (0, 3)), (8, ()), (8, (5,))])
def test_node_annotation_is_the_jax_packages_byte_for_byte(cards, dead):
    host = FakeGpuHost(f"gpu-node-{cards}", cards=cards)
    for i in dead:
        host.kill_card(i)
    frag = host.provider().enumerate()
    got = annotations.encode_node_topology(frag.to_node_info())
    assert got == jax_ann.encode_node_topology(jax_node(frag))
    back = jax_ann.decode_node_topology(frag.node_name, got)
    assert back.slice_id == frag.node_name and back.generation is None
    assert back.mesh_shape == (cards,) and back.wrap == (False,)
    assert [(c.coords, c.chip_id, c.device_index, c.healthy)
            for c in back.chips] == [((i,), i, i, i not in dead)
                                     for i in range(cards)]
    assert back.capacity.total("tpu") == cards - len(dead)
    assert (back.capacity.to_flat()
            == frag.to_node_info().capacity.to_flat())


def test_the_port_advertises_what_the_jax_extender_places_contiguously():
    """The port's advertiser on the JAX package's API server: the JAX
    extender decodes the GPU node and places a 3-card pod on a
    contiguous run of its healthy cards, keeping clear of a dead one."""
    from kubegpu_tpu_torch.plugins.advertiser import Advertiser

    api = InMemoryApiServer()
    host = FakeGpuHost("gpu-node", cards=8)
    host.kill_card(2)
    Advertiser(host.provider(), api).advertise_once()
    assert api.get_node("gpu-node")["status"]["capacity"][RES_TPU] == "7"
    sched = Scheduler(api)
    sched.cache.refresh()
    obj = {"metadata": {"name": "p", "namespace": "default", "uid": "u"},
           "spec": {"containers": [{"name": "main", "resources": {
               "limits": {RES_TPU: "3"}}}]}}
    api.create_pod(obj)
    r = sched.filter(obj, ["gpu-node"])
    assert r.nodes == ["gpu-node"], r.failed
    assert sched.bind("default", "p", "gpu-node") is None
    a = annotations.assignment_from_pod(api.get_pod("default", "p"))
    idx = sorted(c.device_index for c in a.all_chips())
    assert len(idx) == 3 and idx == list(range(idx[0], idx[0] + 3))
    assert 2 not in idx and a.slice_id == "gpu-node"


def bound_sample(name):
    """The sample's pods, created and bound by the JAX extender on a
    fabricated v5e-16 (two for the multislice sample): pod objects as the
    API server holds them."""
    pods = load_pods(name)
    if name == "jax-multislice.yaml":
        api = InMemoryApiServer()
        for sid in ("v5e-16-a", "v5e-16-b"):
            fs = FakeSlice(slice_id=sid, mesh_shape=MESH, host_block=(2, 2))
            for prov in fs.providers().values():
                JaxAdvertiser(prov, api).advertise_once()
        sched = Scheduler(api)
        sched.cache.refresh()
    else:
        api, sched, _ = make_cluster()
    schedule_all(api, sched, pods)
    return [api.get_pod("default", p["metadata"]["name"]) for p in pods]


@pytest.mark.parametrize("name", sample_files())
def test_pods_and_assignments_decode_as_the_jax_packages(name):
    for obj in bound_sample(name):
        for strict in (True, False):
            got = annotations.pod_from_k8s(obj, strict=strict)
            want = jax_ann.pod_from_k8s(obj, strict=strict)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        ann = obj["metadata"].get("annotations") or {}
        for src in (obj, ann):
            got = annotations.assignment_from_pod(src)
            want = jax_ann.assignment_from_pod(src)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.to_dict() == want.to_dict()
                assert (annotations.encode_assignment(got)
                        == jax_ann.encode_assignment(want)
                        == ann[annotations.POD_ASSIGNMENT])
        if jax_ann.POD_ASSIGNMENT in ann:
            payload = ann[jax_ann.POD_ASSIGNMENT]
            assert (annotations.decode_assignment(payload).to_dict()
                    == jax_ann.decode_assignment(payload).to_dict())


def test_malformed_quantities_fail_strict_and_count_zero_lenient():
    obj = {"metadata": {"name": "bad", "annotations": {
        annotations.POD_GROUP: "g", annotations.POD_GROUP_SIZE: "x",
        annotations.POD_PRIORITY: "high"}},
           "spec": {"containers": [
               {"name": "a", "resources": {"limits": {RES_TPU: "two"}}},
               {"name": "b", "resources": {"limits": {"vendor/dev": "1.5"}}}]}}
    for mod in (annotations, jax_ann):
        with pytest.raises(ValueError):
            mod.pod_from_k8s(obj)
    got = annotations.pod_from_k8s(obj, strict=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_ann.pod_from_k8s(obj, strict=False))
    assert got.containers[0].tpu_chips == 0 and got.pod_group_size == 1
    assert [k for k in vars(annotations) if k.isupper()] and all(
        getattr(annotations, k) == getattr(jax_ann, k)
        for k in vars(annotations) if k.isupper())
