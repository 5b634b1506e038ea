"""The port's allocation core (``kubegpu_tpu_torch/grpalloc/``) held
against the JAX package's on the CPU.  On seeded clusters of two kinds,
TPU slices advertised by the JAX package's ``FakeSlice`` and GPU hosts
advertised by the port's ``FakeGpuHost``, with part of the devices
taken and some dead, each package decodes the same node objects with
its own codec and the two must agree field for field (node, device
coordinates, score; refusal reasons) on:

- ``build_slice_views``;
- ``pod_fits_group_constraints`` for 1- to 8-device requests,
  contiguous and not;
- ``fit_gang`` for gangs of 1-, 2- and 4-device pods, contiguous and
  not;
- ``fit_gang_multislice`` and ``fit_gang_into_layout``;
- ``fit_request_tree`` over ``expand_scalar_request``'s wildcard trees;
- take/return round trips, and the refusal of a second take.

The JAX package's rectangle scan may take its optional C++ twin where it
is built; the two are held equal in its own tests, and the port runs the
defining Python loop."""

import random

import pytest

from kubegpu_tpu.grpalloc import allocator as jax_alloc
from kubegpu_tpu.grpalloc import multislice as jax_ms
from kubegpu_tpu.grpalloc import treefit as jax_treefit
from kubegpu_tpu.grpalloc import view as jax_view
from kubegpu_tpu.types import annotations as jax_ann
from kubegpu_tpu.types import info as jax_info
from kubegpu_tpu.types import resource as jax_resource
from kubegpu_tpu_torch.grpalloc import allocator
from kubegpu_tpu_torch.grpalloc import multislice
from kubegpu_tpu_torch.grpalloc import treefit
from kubegpu_tpu_torch.grpalloc import view
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types import info
from kubegpu_tpu_torch.types import resource

from torch_sched_twin import Fleet, plain, pod_obj

JAX = dict(alloc=jax_alloc, ms=jax_ms, treefit=jax_treefit, view=jax_view,
           ann=jax_ann, info=jax_info, resource=jax_resource)
PORT = dict(alloc=allocator, ms=multislice, treefit=treefit, view=view,
            ann=annotations, info=info, resource=resource)

CLUSTERS = {
    "v5e-16": lambda: Fleet("tpu"),
    "2x-v5e-8": lambda: Fleet("tpu", n=2, mesh=(2, 4)),
    "torus-4x4": lambda: Fleet("tpu", mesh=(4, 4), block=(2, 2),
                               wrap=(True, True)),
    "h100-8": lambda: Fleet("gpu", n=1, cards=8),
    "2x-h100-8": lambda: Fleet("gpu", n=2, cards=8),
}


def seeded_cluster(name, seed):
    """The cluster's node objects after some devices died, and a seeded
    set of devices (a few per node) to take; seed None: whole and
    free."""
    rng = random.Random(seed)
    fleet = CLUSTERS[name]()
    devices = fleet.devices()
    if seed is None:
        return fleet.node_objects(), {n: [] for n in fleet.nodes()}
    for dev in rng.sample(devices, max(1, len(devices) // 10)):
        fleet.kill(*dev)
    taken = {}
    for node in fleet.nodes():
        idx = sorted(i for n, i in devices if n == node)
        taken[node] = sorted(rng.sample(idx, rng.randint(0, len(idx) // 2)))
    return fleet.node_objects(), taken


def decoded(pkg, objs, taken):
    """Each node decoded by ``pkg``'s codec, its ``taken`` devices (the
    healthy ones) charged through ``take_pod_resources``."""
    nodes = [pkg["ann"].node_from_k8s(o) for o in objs]
    for node in nodes:
        by_idx = {c.device_index: c for c in node.chips if c.healthy}
        refs = [pkg["info"].ChipRef(host=node.name, device_index=i,
                                    chip_id=by_idx[i].chip_id,
                                    coords=by_idx[i].coords)
                for i in taken[node.name] if i in by_idx]
        if refs:
            a = pkg["info"].Assignment(node=node.name, slice_id=node.slice_id,
                                       per_container={"main": refs})
            pkg["alloc"].take_pod_resources(node, a)
    return nodes


def both(name, seed):
    objs, taken = seeded_cluster(name, seed)
    return decoded(JAX, objs, taken), decoded(PORT, objs, taken)


def pods(pkg, sizes, contiguous=True, group="g"):
    return [pkg["ann"].pod_from_k8s(pod_obj(
        f"{group}-{k}", chips, group=group, size=len(sizes),
        contiguous=contiguous)) for k, chips in enumerate(sizes)]


SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_views_and_single_pod_fits_equal(name, seed):
    nj, np_ = both(name, seed)
    vj = jax_view.build_slice_views(nj)
    vp = view.build_slice_views(np_)
    assert plain(vp) == plain(vj)
    assert {s: sorted(v.free) for s, v in vp.items()} == {
        s: sorted(v.free) for s, v in vj.items()}
    fits = 0
    for a, b in zip(nj, np_):
        for n in (1, 2, 3, 4, 8):
            for contiguous in (True, False):
                rj = jax_alloc.pod_fits_group_constraints(
                    a, jax_info.TpuRequest(n, contiguous, {"main": n}),
                    vj.get(a.slice_id))
                rp = allocator.pod_fits_group_constraints(
                    b, info.TpuRequest(n, contiguous, {"main": n}),
                    vp.get(b.slice_id))
                assert plain(rp) == plain(rj), (a.name, n, contiguous)
                fits += rj.fits
        # the single-node view the scheduler falls back on
        r1 = jax_alloc.pod_fits_group_constraints(
            a, jax_info.TpuRequest(2, True, {"main": 2}))
        r2 = allocator.pod_fits_group_constraints(
            b, info.TpuRequest(2, True, {"main": 2}))
        assert plain(r2) == plain(r1)
    assert fits > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_fit_gang_equal(name, seed):
    nj, np_ = both(name, seed)
    vj = jax_view.build_slice_views(nj)
    vp = view.build_slice_views(np_)
    placed = 0
    for sizes in ([1, 1], [1, 1, 1, 1], [2, 2], [2, 2, 2, 2], [4, 4],
                  [4], [1, 2, 1]):
        for contiguous in (True, False):
            pj = pods(JAX, sizes, contiguous)
            pp = pods(PORT, sizes, contiguous)
            for sid in sorted(vj):
                gj = jax_alloc.fit_gang(vj[sid], pj)
                gp = allocator.fit_gang(vp[sid], pp)
                assert plain(gp) == plain(gj), (sid, sizes, contiguous)
                placed += gj.success
    assert placed > 0


@pytest.mark.parametrize("seed", [None] + SEEDS)
@pytest.mark.parametrize("name", ["2x-v5e-8", "2x-h100-8"])
def test_multislice_and_layout_refit_equal(name, seed):
    nj, np_ = both(name, seed)
    vj = jax_view.build_slice_views(nj)
    vp = view.build_slice_views(np_)
    sids = sorted(vj)
    spans = 0
    for sizes in ([2, 2], [4, 4], [2, 2, 2, 2], [1] * 6, [4, 4, 4],
                  [4, 4, 4, 4]):
        for allow in (False, True):
            mj = jax_ms.fit_gang_multislice(vj, pods(JAX, sizes), allow)
            mp = multislice.fit_gang_multislice(vp, pods(PORT, sizes), allow)
            assert plain(mp) == plain(mj), (sizes, allow)
            assert mp.num_slices == mj.num_slices
            spans += mj.num_slices > 1
        # a partially-bound gang's replacements back into its layout,
        # with and without the survivors' coordinates
        for layout in ({sids[0]: 1}, {sids[0]: 1, sids[1]: 1}):
            occupied = {s: frozenset(sorted(vj[s].used)[:1]) for s in layout}
            for occ in (None, occupied):
                lj = jax_ms.fit_gang_into_layout(
                    vj, pods(JAX, sizes[:len(layout)]), layout, occ)
                lp = multislice.fit_gang_into_layout(
                    vp, pods(PORT, sizes[:len(layout)]), layout, occ)
                assert plain(lp) == plain(lj), (sizes, layout, occ)
    assert spans > 0 or seed is not None


TEMPLATES = ["tpu-slice/*/host/*/chip/*/tpu", "npugrp/*/npu/*/dev",
             "npugrp/0/npu/*/dev", "npugrp/1/npu/0/dev"]


@pytest.mark.parametrize("seed", SEEDS)
def test_fit_request_tree_equal(seed):
    rng = random.Random(seed)
    for pkg in (JAX, PORT):
        pkg["cap"] = pkg["resource"].ResourceTree()
    for g in range(3):
        for d in range(rng.randint(1, 3)):
            q = rng.randint(1, 2)
            for pkg in (JAX, PORT):
                pkg["cap"].add(pkg["resource"].ResourcePath.parse(
                    f"npugrp/{g}/npu/{d}/dev"), q)
    objs, taken = seeded_cluster("v5e-16", seed)
    nj = decoded(JAX, objs, taken)[0]
    npt = decoded(PORT, objs, taken)[0]
    cases = [(t, c) for t in TEMPLATES for c in (1, 2, 3, 5, 9)]
    fits = 0
    for template, count in cases:
        rj = jax_treefit.expand_scalar_request("x", count, template)
        rp = treefit.expand_scalar_request("x", count, template)
        assert plain(rp) == plain(rj)
        for alloc_j, alloc_p in ((JAX["cap"], PORT["cap"]),
                                 (nj.allocatable(), npt.allocatable())):
            fj = jax_treefit.fit_request_tree(rj, alloc_j)
            fp = treefit.fit_request_tree(rp, alloc_p)
            assert plain(fp) == plain(fj), (template, count)
            fits += fj.fits
    assert 0 < fits < 2 * len(cases)


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_take_return_round_trip(name):
    """Placing a pod, taking its devices, refusing a second take and
    returning them restores each package's node exactly, and the two
    packages' used-trees stay equal throughout."""
    objs, taken = seeded_cluster(name, 7)
    nj, np_ = decoded(JAX, objs, taken), decoded(PORT, objs, taken)
    for a, b in zip(nj, np_):
        before_j, before_p = a.used.to_flat(), b.used.to_flat()
        assert before_p == before_j
        rj = jax_alloc.pod_fits_group_constraints(
            a, jax_info.TpuRequest(1, True, {"main": 1}))
        rp = allocator.pod_fits_group_constraints(
            b, info.TpuRequest(1, True, {"main": 1}))
        assert plain(rp) == plain(rj)
        if not rj.fits:
            continue
        jax_alloc.take_pod_resources(a, rj.assignment)
        allocator.take_pod_resources(b, rp.assignment)
        assert b.used.to_flat() == a.used.to_flat() != before_j
        assert b.allocatable().to_flat() == a.allocatable().to_flat()
        with pytest.raises(ValueError) as ej:
            jax_alloc.take_pod_resources(a, rj.assignment)
        with pytest.raises(ValueError) as ep:
            allocator.take_pod_resources(b, rp.assignment)
        assert str(ep.value) == str(ej.value)
        jax_alloc.return_pod_resources(a, rj.assignment)
        allocator.return_pod_resources(b, rp.assignment)
        allocator.return_pod_resources(b, rp.assignment)   # idempotent
        assert b.used.to_flat() == before_p
        assert a.used.to_flat() == before_j
