"""The port's mesh helpers (``kubegpu_tpu_torch/parallel/mesh.py``:
``local_chip_count``, ``mesh_from_assignment``, ``hybrid_device_mesh``,
``launch.gang_slice_ids``) held against the JAX package's on the CPU
devices and assignments of tests/test_models.py:60 and
tests/test_multislice.py:806: the same device order, laid out over the
same axes, and each refusal where JAX refuses.  The port's entries are
the JAX devices' ids; JAX's are its devices, or hashable stand-ins that
carry a ``slice_index`` where the grouping needs one."""

import itertools

import jax
import pytest
import torch
import torch.distributed as dist

from kubegpu_tpu.parallel import hybrid_device_mesh as jax_hybrid
from kubegpu_tpu.parallel import local_chip_count as jax_local_chip_count
from kubegpu_tpu.parallel import mesh_from_assignment as jax_from_assignment
from kubegpu_tpu.types.info import Assignment as JaxAssignment
from kubegpu_tpu.types.info import ChipRef as JaxChipRef
from kubegpu_tpu_torch.parallel import launch
from kubegpu_tpu_torch.parallel import mesh
from kubegpu_tpu_torch.types.info import Assignment, ChipRef


class Dev:
    """A stand-in device for JAX's grouping: an id and a slice index."""

    def __init__(self, i, slice_index=None):
        self.id = i
        self.slice_index = slice_index

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return self.id == other.id


def ids(jax_mesh):
    return [d.id for d in jax_mesh.devices.flat]


@pytest.mark.parametrize("visible", ["0", "0,1", "3,1,2", "0,1,2,3,4,5,6,7",
                                     "1, ,2"])
def test_local_chip_count_counts_the_visible_list_as_jax(visible):
    uuids = ",".join(f"GPU-{c.strip()}" if c.strip() else c
                     for c in visible.split(","))
    assert mesh.local_chip_count({"CUDA_VISIBLE_DEVICES": uuids}) == (
        jax_local_chip_count({"TPU_VISIBLE_CHIPS": visible}))


def test_local_chip_count_without_the_env_counts_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.local_chip_count({}) == 3
    assert mesh.local_chip_count({"CUDA_VISIBLE_DEVICES": ""}) == 3
    assert jax_local_chip_count({}) == jax.local_device_count()


# tests/test_models.py:60's assignment: device_index order != coord order
CHIPS = [(0, (1, 1)), (1, (0, 0)), (2, (1, 0)), (3, (0, 1))]


def assignments(chips):
    return (Assignment("n0", "s0", {"m": [ChipRef("n0", i, i, c)
                                          for i, c in chips]}),
            JaxAssignment("n0", "s0", {"m": [JaxChipRef("n0", i, i, c)
                                             for i, c in chips]}))


@pytest.mark.parametrize("axes", [{"data": 4}, {"data": 2, "model": 2},
                                  {"data": -1, "model": 2}])
@pytest.mark.parametrize("order", list(itertools.permutations(range(4)))[::5])
def test_mesh_from_assignment_orders_as_jax(axes, order):
    chips = [CHIPS[i] for i in order]
    port, jax_a = assignments(chips)
    devs = jax.devices()[:4]
    want = jax_from_assignment(jax_a, axes, devices=devs)
    got_axes, order = mesh.mesh_from_assignment(port, axes,
                                                devices=[d.id for d in devs])
    assert order == ids(want)
    assert got_axes == dict(want.shape)
    assert tuple(got_axes) == tuple(want.axis_names)


def test_mesh_from_assignment_defaults_to_the_pods_local_ranks(monkeypatch):
    """Without devices the layout is of the pod's cards, one for each
    entry of ``CUDA_VISIBLE_DEVICES``, in the assignment's order."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "GPU-a,GPU-b,GPU-c,GPU-d")
    port, jax_a = assignments(CHIPS)
    want = jax_from_assignment(jax_a, {"data": 2, "model": 2},
                               devices=jax.devices()[:4])
    assert mesh.mesh_from_assignment(port, {"data": 2, "model": 2}) == (
        {"data": 2, "model": 2}, [f"cuda:{i}" for i in ids(want)])


def test_mesh_from_assignment_of_a_gpu_line_and_its_refusals():
    # a GPU host's line: cards 5, 6, 7 assigned, coordinates (i,)
    port, jax_a = assignments([(7, (7,)), (5, (5,)), (6, (6,))])
    devs = jax.devices()[:3]
    _, got = mesh.mesh_from_assignment(port, {"data": 3},
                                       devices=[d.id for d in devs])
    assert got == ids(jax_from_assignment(jax_a, {"data": 3}, devices=devs))
    # as many devices as chips or the order is left as it is (JAX's rule)
    devs = jax.devices()[:6]
    _, got = mesh.mesh_from_assignment(port, {"data": 2, "model": 3},
                                       devices=[d.id for d in devs])
    assert got == ids(jax_from_assignment(jax_a, {"data": 2, "model": 3},
                                          devices=devs))
    for axes in ({"data": 4}, {"data": -1, "model": -1}, {"data": 5}):
        with pytest.raises(ValueError) as want:
            jax_from_assignment(jax_a, axes, devices=jax.devices()[:3])
        with pytest.raises(ValueError) as got:
            mesh.mesh_from_assignment(port, axes, devices=[0, 1, 2])
        assert str(got.value) == str(want.value)


def test_hybrid_mesh_groups_contiguously_as_jax():
    # tests/test_multislice.py:806
    want = jax_hybrid({"dcn": 2, "data": 4}, num_slices=2)
    axes, order = mesh.hybrid_device_mesh(
        {"dcn": 2, "data": 4}, num_slices=2,
        devices=[d.id for d in jax.devices()])
    assert order == ids(want) and axes == dict(want.shape)
    assert tuple(axes) == ("dcn", "data")
    want = jax_hybrid({"dcn": 4, "data": 1, "model": 2})
    axes, order = mesh.hybrid_device_mesh({"dcn": 4, "data": 1, "model": 2},
                                          devices=list(range(8)))
    assert order == ids(want) and axes == dict(want.shape)


SLICES = [
    [1, 0, 1, 0, 1, 0, 1, 0],
    [0, 0, 0, 0, 1, 1, 1, 1],
    [2, 2, 0, 0, 1, 1, 3, 3],
]


@pytest.mark.parametrize("slices", SLICES)
@pytest.mark.parametrize("dcn", [-1, "count"])
def test_hybrid_mesh_groups_ranks_by_slice_id_as_jax_by_slice_index(slices,
                                                                    dcn):
    k = len(set(slices))
    axes = {"dcn": k if dcn == "count" else -1, "data": -1}
    want = jax_hybrid(axes, devices=[Dev(i, s) for i, s in enumerate(slices)])
    got_axes, order = mesh.hybrid_device_mesh(axes, devices=list(range(8)),
                                              slice_ids=slices)
    assert order == ids(want) and got_axes == dict(want.shape)


REFUSALS = [
    # (axes, num_slices, slice ids): the dcn axis not first
    ({"data": 4, "dcn": 2}, 2, None),
    # 8 devices into 3 slices
    ({"dcn": 3, "data": 2}, 3, None),
    # a -1 dcn axis without slice ids
    ({"dcn": -1, "data": 4}, None, None),
    # unequal slices
    ({"dcn": 2, "data": -1}, None, [0, 0, 0, 1, 1, 1, 1, 1]),
    # a dcn size that is not the slice count
    ({"dcn": 4, "data": -1}, None, [0, 0, 0, 0, 1, 1, 1, 1]),
    # the layout after grouping wants other sizes
    ({"dcn": 2, "data": 3}, 2, None),
]


@pytest.mark.parametrize("axes,num_slices,slices", REFUSALS)
def test_hybrid_mesh_refuses_what_jax_refuses(axes, num_slices, slices):
    devs = (jax.devices() if slices is None
            else [Dev(i, s) for i, s in enumerate(slices)])
    with pytest.raises(ValueError) as want:
        jax_hybrid(axes, num_slices=num_slices, devices=devs)
    with pytest.raises(ValueError) as got:
        mesh.hybrid_device_mesh(axes, num_slices=num_slices,
                                devices=list(range(8)), slice_ids=slices)
    msg = str(want.value).replace("without device slice_index metadata",
                                  "without slice ids")
    assert str(got.value) == msg


def test_hybrid_mesh_defaults_to_every_rank_of_the_world(monkeypatch):
    monkeypatch.setattr(mesh.dist, "get_world_size", lambda: 8)
    axes, order = mesh.hybrid_device_mesh({"dcn": 2, "data": -1})
    want = jax_hybrid({"dcn": 2, "data": -1}, devices=jax.devices())
    assert axes == dict(want.shape) and order == ids(want)
    with pytest.raises(ValueError, match="2 slice ids for 8 devices"):
        mesh.hybrid_device_mesh({"dcn": 2, "data": 4}, slice_ids=[0, 1])


def test_gang_slice_ids_read_every_pods_megascale_slice():
    """Each pod publishes its MEGASCALE_SLICE_ID on the gang's store; a
    rank of pod p sits on p's slice.  Here the other pods' keys are
    already on the store."""
    store = dist.HashStore()
    table = mesh.GangTable(host="127.0.0.1", port=0, num_processes=4,
                           process_id=1, timeout_s=2.0)
    for p, sid in ((0, "1"), (2, "0"), (3, "1")):
        store.set(f"{launch.GANG_PREFIX}slice/{p}", sid)
    got = launch.gang_slice_ids(store, table, 2, {"MEGASCALE_SLICE_ID": "0"})
    assert got == [1, 1, 0, 0, 0, 0, 1, 1]
    axes, order = mesh.hybrid_device_mesh({"dcn": -1, "data": -1},
                                          devices=list(range(8)),
                                          slice_ids=got)
    assert axes == {"dcn": 2, "data": 4}
    assert order == [2, 3, 4, 5, 0, 1, 6, 7]
    want = jax_hybrid({"dcn": -1, "data": -1},
                      devices=[Dev(i, s) for i, s in enumerate(got)])
    assert order == ids(want)
    lone = mesh.GangTable(host="127.0.0.1", port=0, num_processes=2,
                          process_id=0, timeout_s=0.2)
    with pytest.raises(RuntimeError, match="slice id"):
        launch.gang_slice_ids(dist.HashStore(), lone, 1, {})
