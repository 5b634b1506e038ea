"""The port's CRI shim (``kubegpu_tpu_torch/crishim``) held against the
JAX package's on the CPU:

- for every pod of the samples ``single-chip``, ``four-chip``,
  ``jax-resnet``, ``jax-lm-tp``, ``jax-lm-cp``, ``jax-multislice`` and
  ``multi-tenant``, bound by the JAX extender, the port's daemon decides
  (``ShimDaemon.decide`` -> ``compute_injection``) what the JAX daemon
  decides on the same assignment annotation, the JAX side over its
  ``FakeTpuProvider``, the port's over a ``FakeGpuProvider`` of the same
  node: every rendezvous variable equal, ``CUDA_VISIBLE_DEVICES`` and
  ``NVIDIA_VISIBLE_DEVICES`` the UUIDs of exactly the indices in JAX's
  ``TPU_VISIBLE_CHIPS``, in order, and their ``/dev/nvidia<i>``;
- the protowire codec and the CreateContainer surgery are the JAX
  package's, byte for byte;
- the proxy test of tests/test_crishim.py passes on the port's proxy
  (passthrough, injection, a gang's env, an API outage failing the
  call), and a container assigned a card the host lacks or cannot open,
  or on a host whose NVML fails, fails at CreateContainer.
"""

from concurrent import futures

import grpc
import pytest

from kubegpu_tpu.crishim import ShimDaemon as JaxShimDaemon
from kubegpu_tpu.crishim import compute_injection as jax_compute_injection
from kubegpu_tpu.crishim import mutate_create_request as jax_mutate
from kubegpu_tpu.crishim.inject import Injection as JaxInjection
from kubegpu_tpu.plugins import FakeSlice
from kubegpu_tpu.types import annotations as jax_ann
from kubegpu_tpu.utils import InMemoryApiServer as JaxInMemoryApiServer
from kubegpu_tpu.utils import protowire as jax_pw
from kubegpu_tpu_torch.crishim.daemon import ShimDaemon
from kubegpu_tpu_torch.crishim.inject import (
    Injection,
    InjectionError,
    compute_injection,
)
from kubegpu_tpu_torch.crishim.proxy import (
    CREATE_CONTAINER,
    CriProxy,
    mutate_create_request,
    parse_create_request,
)
from kubegpu_tpu_torch.plugins import nvml
from kubegpu_tpu_torch.plugins.discovery import NvmlGpuProvider
from kubegpu_tpu_torch.plugins.fake import FakeGpuHost
from kubegpu_tpu_torch.plugins.provider import CONTROL_DEVICES
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.utils import protowire as pw
from kubegpu_tpu_torch.utils.apiserver import InMemoryApiServer

from test_crishim import FakeCriBackend, make_create_request
from test_scheduler import fake_cluster, make_sched, nodes_of, pod_obj
from test_torch_device_types import bound_sample
from test_torch_plugins import FakeNvml, devfs

JAX_DEVICE_ENV = ("TPU_VISIBLE_CHIPS", "TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY")
PORT_DEVICE_ENV = ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES")
SAMPLES = ["single-chip.yaml", "four-chip.yaml", "jax-resnet.yaml",
           "jax-lm-tp.yaml", "jax-lm-cp.yaml", "jax-multislice.yaml",
           "multi-tenant.yaml"]


def jax_api_of(objs):
    api = JaxInMemoryApiServer()
    for o in objs:
        api.create_pod(o)
    return api


def fake_tpu_providers(objs):
    """The JAX side's provider of each node the pods landed on."""
    out = {}
    for sid in sorted({annotations.assignment_from_pod(o).slice_id
                       for o in objs}):
        fs = FakeSlice(slice_id=sid, mesh_shape=(4, 4), host_block=(2, 2))
        out.update(fs.providers())
    return out


@pytest.mark.parametrize("name", SAMPLES)
def test_injection_is_the_jax_shims_with_uuids_for_indices(name):
    objs = bound_sample(name)
    jax_api = jax_api_of(objs)
    port_api = InMemoryApiServer()
    for o in objs:
        port_api.create_pod(o)
    tpu = fake_tpu_providers(objs)
    checked = 0
    for obj in objs:
        meta = obj["metadata"]
        a = annotations.assignment_from_pod(obj)
        ann = meta.get("annotations") or {}
        host = FakeGpuHost(a.node, cards=4)
        for c in obj["spec"]["containers"]:
            args = ("default", meta["name"], c["name"], ann, a.node)
            want = JaxShimDaemon(jax_api, tpu[a.node]).decide(*args)
            got = ShimDaemon(port_api, host.provider()).decide(*args)
            assert (got is None) == (want is None)
            if want is None or want.empty:
                assert got is None or got.empty
                continue
            rendezvous = {k: v for k, v in want.env.items()
                          if k not in JAX_DEVICE_ENV}
            assert {k: v for k, v in got.env.items()
                    if k not in PORT_DEVICE_ENV} == rendezvous
            indices = [int(i) for i in
                       want.env["TPU_VISIBLE_CHIPS"].split(",")]
            uuids = ",".join(host.uuids[i] for i in indices)
            assert got.env["CUDA_VISIBLE_DEVICES"] == uuids
            assert got.env["NVIDIA_VISIBLE_DEVICES"] == uuids
            assert got.devices == [f"/dev/nvidia{i}" for i in indices] + [
                f"/dev/{n}" for n in CONTROL_DEVICES]
            assert got.mounts == want.mounts == []
            checked += 1
    assert checked == sum(len(annotations.assignment_from_pod(o).all_chips())
                          > 0 for o in objs)
    if name == "jax-multislice.yaml":
        assert got.env["MEGASCALE_NUM_SLICES"] == "2"


def test_compute_injection_passthrough_and_sidecar():
    api, fs, _ = fake_cluster()
    sched = make_sched(api)
    host = FakeGpuHost("x", cards=4)
    plain = annotations.pod_from_k8s(pod_obj("web", 0))
    assert compute_injection(plain, "main", host.provider()).empty
    obj = pod_obj("p0", 2)
    api.create_pod(obj)
    r = sched.filter(obj, nodes_of(api))
    assert sched.bind("default", "p0", r.nodes[0]) is None
    bound = api.get_pod("default", "p0")
    pod = annotations.pod_from_k8s(bound)
    assert compute_injection(pod, "sidecar", host.provider()).empty
    inj = compute_injection(pod, "main", host.provider())
    want = jax_compute_injection(jax_ann.pod_from_k8s(bound), "main",
                                 fs.provider_for(r.nodes[0]))
    assert {k: v for k, v in inj.env.items() if k not in PORT_DEVICE_ENV} == {
        k: v for k, v in want.env.items() if k not in JAX_DEVICE_ENV}
    assert inj.env["CUDA_VISIBLE_DEVICES"].count(",") == 1


def test_a_card_the_host_lacks_fails_the_injection():
    api, fs, _ = fake_cluster()
    sched = make_sched(api)
    obj = pod_obj("p0", 4)
    api.create_pod(obj)
    r = sched.filter(obj, nodes_of(api))
    assert sched.bind("default", "p0", r.nodes[0]) is None
    pod = annotations.pod_from_k8s(api.get_pod("default", "p0"))
    host = FakeGpuHost(r.nodes[0], cards=2)   # the host has 2 of the 4
    with pytest.raises(InjectionError, match="not on this host"):
        compute_injection(pod, "main", host.provider())
    host = FakeGpuHost(r.nodes[0], cards=4)
    host.kill_card(3)
    with pytest.raises(InjectionError, match="cannot be opened"):
        compute_injection(pod, "main", host.provider())


@pytest.mark.parametrize("lib", [
    FakeNvml(cards=4, init_rc=nvml.NVML_ERROR_DRIVER_NOT_LOADED),
    FakeNvml(cards=4, lost={2: "uuid"}),
], ids=["init-fails", "card-lost"])
def test_an_nvml_refusal_fails_the_injection(tmp_path, lib):
    """NVML failing to probe the host, or a card lost at any query, fails
    the injection: never an empty one that would leave the container
    every card of the node."""
    api, fs, _ = fake_cluster()
    sched = make_sched(api)
    obj = pod_obj("p0", 4)
    api.create_pod(obj)
    r = sched.filter(obj, nodes_of(api))
    assert sched.bind("default", "p0", r.nodes[0]) is None
    pod = annotations.pod_from_k8s(api.get_pod("default", "p0"))
    prov = NvmlGpuProvider(r.nodes[0], nvml_lib=lib,
                           devfs_root=devfs(tmp_path, range(4)))
    with pytest.raises(InjectionError,
                       match=r"Driver Not Loaded|\[2\] are not on this host"):
        compute_injection(pod, "main", prov)


# -- the wire codec and the CreateContainer surgery -------------------------

def test_protowire_is_the_jax_packages():
    for n in (0, 1, 127, 128, 300, 2**32, 2**60):
        assert pw.encode_varint(n) == jax_pw.encode_varint(n)
        assert pw.decode_varint(pw.encode_varint(n), 0) == (
            n, len(pw.encode_varint(n)))
    msg = (pw.encode_string_field(1, "hello")
           + pw.encode_varint((2 << 3) | 0) + pw.encode_varint(42)
           + pw.encode_len_field(7, pw.encode_key_value("k1", "v1"))
           + pw.encode_len_field(7, pw.encode_key_value("k2", "v2"))
           + pw.encode_string_field(99, "unknown"))
    assert pw.get_field(msg, 1) == b"hello" and pw.get_field(msg, 2) == 42
    assert pw.decode_string_map(pw.get_all(msg, 7)) == {"k1": "v1",
                                                         "k2": "v2"}
    appended = pw.append_to_message_field(msg, 6, [pw.encode_key_value("A", "B")])
    assert appended == jax_pw.append_to_message_field(
        msg, 6, [jax_pw.encode_key_value("A", "B")])
    assert pw.replace_field(appended, 1, b"x") == jax_pw.replace_field(
        appended, 1, b"x")
    assert pw.get_field(pw.replace_field(appended, 1, b"x"), 99) == b"unknown"


def test_create_request_surgery_is_the_jax_packages():
    req = make_create_request("ml", "w0", "train", ann={"a": "b"},
                              hostname="w0")
    assert parse_create_request(req) == ("ml", "w0", "train", {"a": "b"}, "w0")
    env = {"CUDA_VISIBLE_DEVICES": "GPU-a,GPU-b", "JAX_PROCESS_ID": "0"}
    devices = ["/dev/nvidia0", "/dev/nvidia1", "/dev/nvidiactl"]
    mounts = [("/usr/lib/x", "/usr/lib/y")]
    got = mutate_create_request(req, Injection(env=env, devices=devices,
                                               mounts=mounts))
    assert got == jax_mutate(req, JaxInjection(env=env, devices=devices,
                                               mounts=mounts))
    config = bytes(pw.get_field(got, 2))
    assert pw.decode_string_map(pw.get_all(config, 6)) == {"EXISTING": "1",
                                                           **env}
    assert [pw.get_field(bytes(d), 2) for d in pw.get_all(config, 8)] == [
        d.encode() for d in devices]
    assert mutate_create_request(req, Injection()) == req


# -- the full gRPC proxy path (tests/test_crishim.py's) ---------------------

@pytest.fixture()
def cri_stack(request):
    """The fake CRI runtime behind the port's proxy and shim daemon, over
    a fake host of 4 cards, or the provider ``request.param`` makes of
    the node's name (an indirect parametrisation)."""
    backend = FakeCriBackend()
    upstream = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    upstream.add_generic_rpc_handlers((backend,))
    up_port = upstream.add_insecure_port("127.0.0.1:0")
    upstream.start()
    api, fs, _ = fake_cluster()
    sched = make_sched(api)
    host = FakeGpuHost(fs.hosts()[0], cards=4)
    make_provider = getattr(request, "param", None)
    provider = (host.provider() if make_provider is None
                else make_provider(fs.hosts()[0]))
    # the JAX package's API server: the shim reads pods through the same
    # four verbs
    daemon = ShimDaemon(api, provider)
    proxy = CriProxy(upstream_target=f"127.0.0.1:{up_port}",
                     decide=daemon.decide, listen_target="127.0.0.1:0")
    proxy.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{proxy.port}")
    yield api, sched, fs, host, backend, channel
    channel.close()
    proxy.stop(0)
    upstream.stop(0)


def _call(channel, method, payload):
    return channel.unary_unary(method, request_serializer=lambda b: b,
                               response_deserializer=lambda b: b)(
        payload, timeout=5)


def bind_on(api, sched, node, obj):
    api.create_pod(obj)
    assert sched.filter(obj, [node]).nodes == [node]
    assert sched.bind("default", obj["metadata"]["name"], node) is None
    return api.get_pod("default", obj["metadata"]["name"])


def test_proxy_passthrough_unrelated_method(cri_stack):
    api, sched, fs, host, backend, channel = cri_stack
    payload = pw.encode_string_field(1, "v1")
    resp = _call(channel, "/runtime.v1.RuntimeService/Version", payload)
    assert backend.requests["/runtime.v1.RuntimeService/Version"] == [payload]
    assert pw.get_field(resp, 1) == b"ctr-1"


def test_proxy_injects_for_scheduled_pod(cri_stack):
    api, sched, fs, host, backend, channel = cri_stack
    stored = bind_on(api, sched, fs.hosts()[0], pod_obj("w0", 2))
    req = make_create_request("default", "w0", "main",
                              ann=stored["metadata"]["annotations"])
    _call(channel, CREATE_CONTAINER, req)
    config = bytes(pw.get_field(backend.requests[CREATE_CONTAINER][0], 2))
    envs = pw.decode_string_map(pw.get_all(config, 6))
    a = annotations.assignment_from_pod(stored)
    idx = sorted(c.device_index for c in a.all_chips())
    uuids = ",".join(host.uuids[i] for i in idx)
    assert envs["EXISTING"] == "1"
    assert envs["CUDA_VISIBLE_DEVICES"] == envs["NVIDIA_VISIBLE_DEVICES"] == uuids
    assert envs["JAX_NUM_PROCESSES"] == "1"
    assert "TPU_VISIBLE_CHIPS" not in envs
    assert [bytes(pw.get_field(bytes(d), 2)).decode()
            for d in pw.get_all(config, 8)] == [
        f"/dev/nvidia{i}" for i in idx] + [f"/dev/{n}" for n in CONTROL_DEVICES]


def test_proxy_passthrough_for_non_device_pod(cri_stack):
    api, sched, fs, host, backend, channel = cri_stack
    api.create_pod(pod_obj("web", 0))
    req = make_create_request("default", "web", "main")
    _call(channel, CREATE_CONTAINER, req)
    assert backend.requests[CREATE_CONTAINER][0] == req


def test_proxy_gang_api_outage_fails_create_not_corrupts(cri_stack):
    api, sched, fs, host, backend, channel = cri_stack
    objs = [pod_obj(f"w{i}", 1, group="job", group_size=4) for i in range(4)]
    for o in objs:
        api.create_pod(o)
    for o in objs:
        r = sched.filter(o, nodes_of(api))
        assert sched.bind("default", o["metadata"]["name"], r.nodes[0]) is None
    stored = api.get_pod("default", "w1")

    def broken_list(namespace=None):
        raise OSError("api server unreachable")

    api.list_pods = broken_list
    req = make_create_request("default", "w1", "main",
                              ann=stored["metadata"]["annotations"])
    with pytest.raises(grpc.RpcError) as ei:
        _call(channel, CREATE_CONTAINER, req)
    assert ei.value.code() == grpc.StatusCode.INTERNAL
    assert "gang members" in ei.value.details()
    assert CREATE_CONTAINER not in backend.requests


def test_proxy_gang_worker_env(cri_stack):
    api, sched, fs, host, backend, channel = cri_stack
    objs = [pod_obj(f"w{i}", 1, group="job", group_size=4) for i in range(4)]
    for o in objs:
        o["spec"]["subdomain"] = "job-svc"
        api.create_pod(o)
    for o in objs:
        r = sched.filter(o, nodes_of(api))
        assert sched.bind("default", o["metadata"]["name"], r.nodes[0]) is None
    stored = api.get_pod("default", "w2")
    req = make_create_request("default", "w2", "main",
                              ann=stored["metadata"]["annotations"])
    _call(channel, CREATE_CONTAINER, req)
    got = backend.requests[CREATE_CONTAINER][-1]
    envs = pw.decode_string_map(pw.get_all(bytes(pw.get_field(got, 2)), 6))
    assert envs["TPU_WORKER_ID"] == "2"
    assert envs["JAX_NUM_PROCESSES"] == "4"
    assert envs["JAX_COORDINATOR_ADDRESS"].startswith("w0.job-svc.default.svc:")
    assert envs["TPU_WORKER_HOSTNAMES"].split(",")[2].startswith("w2.")
    idx = annotations.assignment_from_pod(stored).all_chips()[0].device_index
    assert envs["CUDA_VISIBLE_DEVICES"] == host.uuids[idx]


def test_proxy_fails_create_for_a_card_the_host_cannot_open(cri_stack):
    api, sched, fs, host, backend, channel = cri_stack
    stored = bind_on(api, sched, fs.hosts()[0], pod_obj("w0", 1))
    idx = annotations.assignment_from_pod(stored).all_chips()[0].device_index
    host.kill_card(idx)
    req = make_create_request("default", "w0", "main",
                              ann=stored["metadata"]["annotations"])
    with pytest.raises(grpc.RpcError) as ei:
        _call(channel, CREATE_CONTAINER, req)
    assert ei.value.code() == grpc.StatusCode.INTERNAL
    assert "cannot be opened" in ei.value.details()
    assert CREATE_CONTAINER not in backend.requests


def _nvml_without_a_driver(node):
    """A node whose ``libnvidia-ml.so.1`` loads but whose ``nvmlInit_v2``
    fails (the driver is not loaded)."""
    lib = FakeNvml(cards=4, init_rc=nvml.NVML_ERROR_DRIVER_NOT_LOADED)
    return NvmlGpuProvider(node, nvml_lib=lib, devfs_root="/nonexistent")


@pytest.mark.parametrize("cri_stack", [_nvml_without_a_driver],
                         indirect=True)
def test_proxy_fails_create_when_nvml_cannot_probe_the_host(cri_stack):
    """The request is never passed through without the visibility env: a
    CUDA image's default ``NVIDIA_VISIBLE_DEVICES=all`` would then give
    the pod every card of the node."""
    api, sched, fs, host, backend, channel = cri_stack
    stored = bind_on(api, sched, fs.hosts()[0], pod_obj("w0", 1))
    req = make_create_request("default", "w0", "main",
                              ann=stored["metadata"]["annotations"])
    with pytest.raises(grpc.RpcError) as ei:
        _call(channel, CREATE_CONTAINER, req)
    assert ei.value.code() == grpc.StatusCode.INTERNAL
    assert "nvmlInit_v2" in ei.value.details()
    assert "Driver Not Loaded" in ei.value.details()
    assert CREATE_CONTAINER not in backend.requests
