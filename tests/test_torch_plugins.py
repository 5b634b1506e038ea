"""The port's GPU device layer (``kubegpu_tpu_torch/plugins``) on the CPU,
mirroring tests/test_plugins.py:

- the fake host's enumerate and allocate, kill and revive, and the UUID
  order of ``CUDA_VISIBLE_DEVICES``;
- ``NvmlGpuProvider`` driven through the ctypes binding by a Python fake
  of NVML's functions (same signatures, the same ctypes arguments): one
  card, eight cards (minor numbers out of index order), a lost card
  (``NVML_ERROR_GPU_IS_LOST`` from any of its queries),
  ``nvmlInit_v2`` failing (raises, never zero cards), the library absent
  (None, a CPU node), a device node missing from an injected devfs;
- the advertiser over ``InMemoryApiServer``, its annotation decoded by
  the JAX package.
"""

import ctypes
import os

import pytest

from kubegpu_tpu.grpalloc import build_slice_views
from kubegpu_tpu.types import annotations as jax_ann
from kubegpu_tpu_torch.plugins import nvml
from kubegpu_tpu_torch.plugins.advertiser import Advertiser
from kubegpu_tpu_torch.plugins.discovery import NvmlGpuProvider
from kubegpu_tpu_torch.plugins.fake import FakeGpuHost, fake_uuid
from kubegpu_tpu_torch.plugins.provider import (
    CONTROL_DEVICES,
    ENV_NVIDIA_VISIBLE_DEVICES,
    ENV_VISIBLE_DEVICES,
    visible_devices_env,
)
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.info import ChipRef
from kubegpu_tpu_torch.types.resource import RES_TPU
from kubegpu_tpu_torch.utils.apiserver import InMemoryApiServer

H100 = "NVIDIA H100 80GB HBM3"
H100_BYTES = 85_520_809_984
H100_RESERVED = 503_316_480
_HANDLE0 = 0x1000
_MESSAGES = {
    nvml.NVML_ERROR_UNINITIALIZED: b"Uninitialized",
    nvml.NVML_ERROR_DRIVER_NOT_LOADED: b"Driver Not Loaded",
    nvml.NVML_ERROR_GPU_IS_LOST: b"GPU is lost",
}


class FakeNvml:
    """NVML's functions as the binding calls them, over ``cards`` fake
    cards: the out-arguments are ctypes pointers and string buffers,
    handles ``c_void_p``.  ``lost`` maps a card index to the query that
    reports it lost (``handle``, ``memory``, ``minor``, ``uuid``,
    ``name``, ``memory_v2`` or ``pci``); ``init_rc`` is ``nvmlInit_v2``'s
    return code."""

    def __init__(self, cards=1, minors=None, lost=None, init_rc=0,
                 pci_rc=0):
        self.uuids = [fake_uuid("nvml-host", i) for i in range(cards)]
        self.minors = list(minors if minors is not None else range(cards))
        self.lost = dict(lost or {})
        self.init_rc = init_rc
        self.pci_rc = pci_rc
        self.inits = self.shutdowns = 0

    def nvmlInit_v2(self):
        self.inits += 1
        return self.init_rc

    def nvmlShutdown(self):
        self.shutdowns += 1
        return 0

    def nvmlErrorString(self, code):
        return _MESSAGES.get(code, b"Unknown Error")

    def nvmlSystemGetDriverVersion(self, buf, size):
        buf.value = b"550.54.15"
        return 0

    def nvmlDeviceGetCount_v2(self, count):
        count.contents.value = len(self.uuids)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        if self.lost.get(index.value) == "handle":
            return nvml.NVML_ERROR_GPU_IS_LOST
        handle.contents.value = _HANDLE0 + index.value
        return 0

    def _index(self, handle):
        return handle.value - _HANDLE0

    def _is_lost(self, handle, call):
        return self.lost.get(self._index(handle)) == call

    def nvmlDeviceGetMemoryInfo(self, handle, mem):
        if self._is_lost(handle, "memory"):
            return nvml.NVML_ERROR_GPU_IS_LOST
        mem.contents.total = H100_BYTES
        mem.contents.free = H100_BYTES - 2**20
        mem.contents.used = 2**20
        return 0

    def nvmlDeviceGetMemoryInfo_v2(self, handle, mem):
        assert mem.contents.version == nvml.MEMORY_V2
        if self._is_lost(handle, "memory_v2"):
            return nvml.NVML_ERROR_GPU_IS_LOST
        mem.contents.total = H100_BYTES
        mem.contents.reserved = H100_RESERVED
        return 0

    def nvmlDeviceGetUUID(self, handle, buf, size):
        if self._is_lost(handle, "uuid"):
            return nvml.NVML_ERROR_GPU_IS_LOST
        buf.value = self.uuids[self._index(handle)].encode()
        return 0

    def nvmlDeviceGetName(self, handle, buf, size):
        if self._is_lost(handle, "name"):
            return nvml.NVML_ERROR_GPU_IS_LOST
        buf.value = H100.encode()
        return 0

    def nvmlDeviceGetMinorNumber(self, handle, minor):
        if self._is_lost(handle, "minor"):
            return nvml.NVML_ERROR_GPU_IS_LOST
        minor.contents.value = self.minors[self._index(handle)]
        return 0

    def nvmlDeviceGetPciInfo_v3(self, handle, pci):
        if self._is_lost(handle, "pci"):
            return nvml.NVML_ERROR_GPU_IS_LOST
        if self.pci_rc:
            return self.pci_rc
        pci.contents.busId = f"00000000:{0x18 + self._index(handle):02X}:00.0".encode()
        return 0


def devfs(tmp_path, minors, controls=True):
    """A device directory holding ``/dev/nvidia<minor>`` for ``minors``
    (and the control nodes): plain files, which open for reading and
    writing."""
    root = tmp_path / "dev"
    root.mkdir()
    names = [f"nvidia{m}" for m in minors]
    names += list(CONTROL_DEVICES) if controls else []
    for n in names:
        (root / n).write_bytes(b"")
    return str(root)


def refs(node, indices):
    return [ChipRef(node, i, i, (i,)) for i in indices]


# -- the fake host --------------------------------------------------------

def test_fake_host_enumerate_and_allocate():
    host = FakeGpuHost("gpu-node-0", cards=4)
    frag = host.provider().enumerate()
    assert (frag.node_name, frag.slice_id, frag.generation) == (
        "gpu-node-0", "gpu-node-0", None)
    assert frag.mesh_shape == (4,) and frag.wrap == (False,)
    assert [(c.coords, c.chip_id, c.device_index, c.healthy)
            for c in frag.chips] == [((i,), i, i, True) for i in range(4)]
    assert frag.to_node_info().capacity.total("tpu") == 4
    resp = host.provider().allocate(refs("gpu-node-0", [1, 2]))
    want = ",".join(host.uuids[1:3])
    assert resp.env == {ENV_VISIBLE_DEVICES: want,
                        ENV_NVIDIA_VISIBLE_DEVICES: want}
    assert resp.devices == ["/dev/nvidia1", "/dev/nvidia2"] + [
        f"/dev/{n}" for n in CONTROL_DEVICES]
    assert resp.mounts == []


def test_fake_kill_and_revive_card():
    host = FakeGpuHost(cards=4)
    prov = host.provider()
    host.kill_card(0)
    assert [c.healthy for c in prov.enumerate().chips] == [False, True, True,
                                                           True]
    assert prov.healthy_device_indices() == [1, 2, 3]
    with pytest.raises(ValueError, match="cannot be opened"):
        prov.allocate(refs(host.node_name, [0]))
    host.revive_card(0)
    assert all(c.healthy for c in prov.enumerate().chips)
    assert prov.allocate(refs(host.node_name, [0])).devices[0] == "/dev/nvidia0"
    with pytest.raises(KeyError):
        host.kill_card(4)
    with pytest.raises(ValueError, match="not on this host"):
        prov.allocate(refs(host.node_name, [4]))


def test_visible_devices_are_uuids_in_index_order_each_once():
    host = FakeGpuHost(cards=8)
    chips = refs(host.node_name, [5, 1, 3, 1])
    want = ",".join(host.uuids[i] for i in (1, 3, 5))
    assert visible_devices_env(chips, dict(enumerate(host.uuids))) == want
    env = host.provider().allocate(chips).env
    assert env[ENV_VISIBLE_DEVICES] == env[ENV_NVIDIA_VISIBLE_DEVICES] == want
    assert all(u.startswith("GPU-") for u in host.uuids)
    assert len(set(host.uuids)) == 8
    assert FakeGpuHost(cards=8).uuids == host.uuids          # fixed
    assert FakeGpuHost("other", cards=1).uuids[0] != host.uuids[0]


# -- NVML through the binding ----------------------------------------------

def test_nvml_one_card(tmp_path):
    lib = FakeNvml(cards=1)
    probe = nvml.probe(lib)
    assert probe.driver_version == "550.54.15"
    assert probe.cards == [nvml.NvmlCard(
        index=0, uuid=lib.uuids[0], name=H100, minor=0,
        memory_total=H100_BYTES, memory_reserved=H100_RESERVED,
        pci_bus_id="00000000:18:00.0")]
    # what a CUDA process is offered: the total less the reserve
    assert probe.cards[0].memory_usable == 85_017_493_504
    assert (lib.inits, lib.shutdowns) == (1, 1)
    prov = NvmlGpuProvider("gpu-node", nvml_lib=lib,
                           devfs_root=devfs(tmp_path, [0]))
    frag = prov.enumerate()
    assert (frag.slice_id, frag.mesh_shape, frag.generation) == (
        "gpu-node", (1,), None)
    assert [c.healthy for c in frag.chips] == [True]
    resp = prov.allocate(refs("gpu-node", [0]))
    assert resp.env == {ENV_VISIBLE_DEVICES: lib.uuids[0],
                        ENV_NVIDIA_VISIBLE_DEVICES: lib.uuids[0]}
    root = devfs_root(prov)
    assert resp.devices == [os.path.join(root, n) for n in
                            ["nvidia0", *CONTROL_DEVICES]]


def devfs_root(prov):
    return os.path.dirname(prov.device_node(0))


def test_nvml_eight_cards_map_index_to_minor(tmp_path):
    minors = [7, 6, 5, 4, 3, 2, 1, 0]
    lib = FakeNvml(cards=8, minors=minors)
    prov = NvmlGpuProvider("gpu-node", nvml_lib=lib,
                           devfs_root=devfs(tmp_path, minors, controls=False))
    frag = prov.enumerate()
    assert frag.mesh_shape == (8,) and all(c.healthy for c in frag.chips)
    assert prov.healthy_device_indices() == list(range(8))
    resp = prov.allocate(refs("gpu-node", [6, 2, 3]))
    root = devfs_root(prov)
    # devices in index order, each at its card's minor; no control node
    # that the devfs lacks
    assert resp.devices == [os.path.join(root, f"nvidia{minors[i]}")
                            for i in (2, 3, 6)]
    assert resp.env[ENV_VISIBLE_DEVICES] == ",".join(
        lib.uuids[i] for i in (2, 3, 6))
    # the probe is memoized for a second: one NVML session for the cycle
    assert lib.inits == lib.shutdowns == 1


@pytest.mark.parametrize("where", ["handle", "memory", "minor", "uuid", "name",
                                   "memory_v2", "pci"])
def test_nvml_lost_card_is_unhealthy_and_refused(tmp_path, where):
    """A card lost at any of its queries is unhealthy and refused; the
    others stay advertised and allocatable."""
    lib = FakeNvml(cards=4, lost={2: where})
    probe = nvml.probe(lib)
    assert probe.cards[2].uuid is None
    assert "GPU is lost" in probe.cards[2].error
    assert str(nvml.NVML_ERROR_GPU_IS_LOST) in probe.cards[2].error
    assert all(c.error is None for i, c in enumerate(probe.cards) if i != 2)
    prov = NvmlGpuProvider("gpu-node", nvml_lib=lib,
                           devfs_root=devfs(tmp_path, range(4)))
    assert [c.healthy for c in prov.enumerate().chips] == [True, True, False,
                                                           True]
    assert prov.healthy_device_indices() == [0, 1, 3]
    with pytest.raises(ValueError, match=r"\[2\]"):
        prov.allocate(refs("gpu-node", [1, 2]))
    assert prov.allocate(refs("gpu-node", [3])).env[ENV_VISIBLE_DEVICES] == (
        lib.uuids[3])


def test_nvml_init_failure_raises_never_zero_cards(tmp_path):
    lib = FakeNvml(cards=2, init_rc=nvml.NVML_ERROR_DRIVER_NOT_LOADED)
    with pytest.raises(nvml.NvmlError, match="nvmlInit_v2.*Driver Not Loaded"):
        nvml.probe(lib)
    prov = NvmlGpuProvider("gpu-node", nvml_lib=lib,
                           devfs_root=devfs(tmp_path, [0, 1]))
    for call in (prov.enumerate, prov.healthy_device_indices,
                 lambda: prov.allocate(refs("gpu-node", [0]))):
        with pytest.raises(nvml.NvmlError) as e:
            call()
        assert e.value.code == nvml.NVML_ERROR_DRIVER_NOT_LOADED
    api = InMemoryApiServer()
    with pytest.raises(nvml.NvmlError):
        Advertiser(prov, api).advertise_once()
    assert api.list_nodes() == []


def test_nvml_failure_after_init_shuts_down_and_raises():
    lib = FakeNvml(cards=2)
    lib.nvmlDeviceGetCount_v2 = lambda count: nvml.NVML_ERROR_UNINITIALIZED
    with pytest.raises(nvml.NvmlError, match="Uninitialized"):
        nvml.probe(lib)
    assert lib.inits == lib.shutdowns == 1


def test_nvml_absent_library_is_a_cpu_node(monkeypatch, tmp_path):
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    env = {nvml.ENV_LIBRARY: str(tmp_path / "libnvidia-ml.so.1")}
    assert nvml.candidates(env) == [env[nvml.ENV_LIBRARY],
                                    "libnvidia-ml-absent.so.1"]
    assert nvml.load(env) is None
    # a library without NVML's functions is passed over, as absent
    foreign = {nvml.ENV_LIBRARY: "libc.so.6"}
    assert nvml.load(foreign) is None
    prov = NvmlGpuProvider("cpu-node", env=env)
    assert prov.probe() is None and prov.enumerate() is None
    assert prov.healthy_device_indices() is None
    with pytest.raises(ValueError, match="not on this host"):
        prov.allocate(refs("cpu-node", [0]))
    api = InMemoryApiServer()
    assert Advertiser(prov, api).advertise_once() is None
    assert api.list_nodes() == []


def test_nvml_declares_every_function_it_calls():
    """The real library's functions get their restype and argtypes; the
    fake has every function the binding calls."""
    class Lib:
        pass

    lib = Lib()
    for name in nvml._SIGNATURES:
        setattr(lib, name, type("Fn", (), {})())
    nvml._declare(lib)
    assert lib.nvmlErrorString.restype is ctypes.c_char_p
    assert all(hasattr(FakeNvml, name) for name in nvml._SIGNATURES)
    assert all(hasattr(FakeNvml, name)
               for name in nvml._OPTIONAL_SIGNATURES)


def test_nvml_informational_queries_may_be_unsupported():
    """A virtualised card may answer the PCI query NOT_SUPPORTED and an
    old driver lack the second memory query: the card is whole, those
    fields unknown; any other error of theirs marks the card."""
    lib = FakeNvml(cards=2, pci_rc=nvml.NVML_ERROR_NOT_SUPPORTED)
    lib.nvmlDeviceGetMemoryInfo_v2 = None   # absent from the library
    cards = nvml.probe(lib).cards
    assert [c.pci_bus_id for c in cards] == [None, None]
    assert [c.memory_reserved for c in cards] == [None, None]
    assert cards[1].memory_usable is None and cards[1].error is None
    assert cards[1].uuid == lib.uuids[1] and cards[1].memory_total == H100_BYTES
    lib = FakeNvml(cards=1, pci_rc=nvml.NVML_ERROR_GPU_IS_LOST)
    (card,) = nvml.probe(lib).cards
    assert card.uuid is None
    assert "nvmlDeviceGetPciInfo_v3" in card.error
    assert "GPU is lost" in card.error
    assert lib.inits == lib.shutdowns == 1


def test_missing_device_node_marks_the_card_unhealthy(tmp_path):
    lib = FakeNvml(cards=4)
    root = devfs(tmp_path, [0, 1, 3])
    prov = NvmlGpuProvider("gpu-node", nvml_lib=lib, devfs_root=root)
    # card 2's node is missing: card 2 (not card 3) is the dead one
    assert [c.healthy for c in prov.enumerate().chips] == [True, True, False,
                                                           True]
    assert prov.allocate(refs("gpu-node", [3])).devices[0] == os.path.join(
        root, "nvidia3")
    with pytest.raises(ValueError, match=r"cannot be opened.*healthy: \[0, 1, 3\]"):
        prov.allocate(refs("gpu-node", [2]))
    os.mkdir(os.path.join(root, "nvidia2"))   # a directory does not open RW
    assert prov.healthy_device_indices() == [0, 1, 3]


# -- the advertiser -------------------------------------------------------

def test_advertiser_publishes_topology_and_capacity():
    api = InMemoryApiServer()
    hosts = [FakeGpuHost(f"gpu-node-{i}", cards=8) for i in range(2)]
    for h in hosts:
        assert Advertiser(h.provider(), api).advertise_once() == h.node_name
    nodes = api.list_nodes()
    assert len(nodes) == 2
    for n in nodes:
        assert n["status"]["capacity"][RES_TPU] == "8"
        ann = n["metadata"]["annotations"]
        assert int(ann[annotations.NODE_ADVERT_SEQ]) > 0
    infos = [jax_ann.node_from_k8s(n) for n in nodes]
    views = build_slice_views(infos)
    # each GPU host is a slice of its own
    assert sorted(views) == ["gpu-node-0", "gpu-node-1"]
    assert all(len(v.free) == 8 for v in views.values())


def test_advertiser_health_propagates_to_the_cluster_view(tmp_path):
    api = InMemoryApiServer()
    lib = FakeNvml(cards=4)
    prov = NvmlGpuProvider("gpu-node", nvml_lib=lib,
                           devfs_root=devfs(tmp_path, range(4)))
    adv = Advertiser(prov, api)
    adv.advertise_once()
    assert api.get_node("gpu-node")["status"]["capacity"][RES_TPU] == "4"
    lib.lost[1] = "memory"
    prov._probe_ttl_s = 0.0   # the next cycle probes afresh
    adv.advertise_once()
    node = api.get_node("gpu-node")
    assert node["status"]["capacity"][RES_TPU] == "3"
    info = jax_ann.node_from_k8s(node)
    assert [c.healthy for c in info.chips] == [True, False, True, True]
    view = build_slice_views([info])["gpu-node"]
    assert len(view.free) == 3
