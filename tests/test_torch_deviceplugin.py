"""The port's kubelet device plugin (``kubegpu_tpu_torch/plugins/
deviceplugin.py``) on the CPU, mirroring tests/test_deviceplugin.py: real
gRPC over unix sockets in ``tmp_path``, a fake kubelet on the other end,
the port's server over a fake GPU host beside the JAX package's server
over a 1-D fake slice of as many chips, each asked the same:

- Register's request and the options are the JAX server's bytes;
- ListAndWatch streams the same inventory and the same health
  transitions;
- Allocate grants exactly the asked cards (their UUIDs in
  ``CUDA_VISIBLE_DEVICES`` and ``NVIDIA_VISIBLE_DEVICES``, their
  ``/dev/nvidia<i>`` and the driver's control nodes) where the JAX server
  grants the same indices in ``TPU_VISIBLE_CHIPS``; an unknown id fails
  the RPC on both;
- GetPreferredAllocation picks the ids the JAX server picks on the same
  1-D free set, over gRPC and on request bytes alone;
- the serve loop re-registers through kubelet restart churn.
"""

import os
import threading
import time
from concurrent import futures

import grpc
import pytest

from kubegpu_tpu.plugins import DevicePluginServer as JaxDevicePluginServer
from kubegpu_tpu.plugins import FakeSlice
from kubegpu_tpu.utils import protowire as jax_pw
from kubegpu_tpu_torch.plugins.deviceplugin import (
    HEALTHY,
    SVC_ALLOCATE,
    SVC_LIST_AND_WATCH,
    SVC_OPTIONS,
    SVC_PREFERRED,
    SVC_PRESTART,
    SVC_REGISTRATION,
    UNHEALTHY,
    DevicePluginServer,
    decode_devices,
)
from kubegpu_tpu_torch.plugins.fake import FakeGpuHost
from kubegpu_tpu_torch.plugins.provider import CONTROL_DEVICES
from kubegpu_tpu_torch.types.resource import RES_TPU
from kubegpu_tpu_torch.utils import protowire as pw

IDENT = lambda b: b  # noqa: E731
CARDS = 8


class FakeKubelet:
    """Registration service that records RegisterRequests."""

    def __init__(self, socket_path):
        self.requests = []
        self._event = threading.Event()
        kubelet = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, hcd):
                if hcd.method == SVC_REGISTRATION:
                    def register(req, ctx):
                        kubelet.requests.append(bytes(req))
                        kubelet._event.set()
                        return b""

                    return grpc.unary_unary_rpc_method_handler(
                        register, request_deserializer=IDENT,
                        response_serializer=IDENT)
                return None

        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        self.server.add_generic_rpc_handlers((Handler(),))
        self.server.add_insecure_port(f"unix://{socket_path}")
        self.server.start()

    def wait(self, timeout=5.0) -> bool:
        return self._event.wait(timeout)

    def stop(self):
        self.server.stop(0.1).wait()


class Pair:
    """The port's plugin over a fake GPU host and the JAX package's over a
    1-D slice of as many chips on one host, each with its own kubelet."""

    def __init__(self, tmp_path, cards=CARDS):
        self.host = FakeGpuHost("gpu-node", cards=cards)
        self.slice = FakeSlice(slice_id="s0", mesh_shape=(cards,),
                               host_block=(cards,))
        self.jax_host = self.slice.hosts()[0]
        self.servers = {}
        self.kubelets = {}
        for name, provider, cls in (
                ("port", self.host.provider(), DevicePluginServer),
                ("jax", self.slice.provider_for(self.jax_host),
                 JaxDevicePluginServer)):
            d = tmp_path / name
            d.mkdir()
            self.kubelets[name] = FakeKubelet(str(d / "kubelet.sock"))
            self.servers[name] = cls(provider, socket_dir=str(d),
                                     poll_interval_s=0.05)
            self.servers[name].start()

    def kill(self, i):
        self.host.kill_card(i)
        self.slice.kill_chip((i,))

    def unary(self, name, method, payload=b""):
        with grpc.insecure_channel(
                f"unix://{self.servers[name].socket_path}") as ch:
            return ch.unary_unary(method, request_serializer=IDENT,
                                  response_deserializer=IDENT)(
                payload, timeout=5.0)

    def close(self):
        for s in self.servers.values():
            s.stop()
        for k in self.kubelets.values():
            k.stop()


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def stream(p, name):
    ch = grpc.insecure_channel(f"unix://{p.servers[name].socket_path}")
    return ch, ch.unary_stream(SVC_LIST_AND_WATCH, request_serializer=IDENT,
                               response_deserializer=IDENT)(b"", timeout=10.0)


def allocate_request(*containers):
    return b"".join(pw.encode_len_field(
        1, b"".join(pw.encode_string_field(1, d) for d in ids))
        for ids in containers)


def preferred_request(available, must, size):
    creq = b"".join(pw.encode_string_field(1, d) for d in available)
    creq += b"".join(pw.encode_string_field(2, d) for d in must)
    creq += pw.encode_varint((3 << 3) | 0) + pw.encode_varint(size)
    return pw.encode_len_field(1, creq)


def test_registration_and_options_are_the_jax_servers(pair):
    for name in ("port", "jax"):
        pair.servers[name].register_with_kubelet()
        assert pair.kubelets[name].wait()
    req = pair.kubelets["port"].requests[0]
    assert req == pair.kubelets["jax"].requests[0]
    assert bytes(pw.get_field(req, 1)).decode() == "v1beta1"
    assert bytes(pw.get_field(req, 3)).decode() == RES_TPU
    opts = pair.unary("port", SVC_OPTIONS)
    assert opts == pair.unary("jax", SVC_OPTIONS)
    assert pw.get_field(opts, 2) == 1   # preferred allocation available
    assert pair.unary("port", SVC_PRESTART) == b""


def test_list_and_watch_streams_the_jax_servers_health_transitions(pair):
    chans, streams = zip(*(stream(pair, n) for n in ("port", "jax")))
    try:
        first = [decode_devices(next(s)) for s in streams]
        assert first[0] == first[1] == {str(i): HEALTHY for i in range(CARDS)}
        pair.kill(3)
        second = [decode_devices(next(s)) for s in streams]
        assert second[0] == second[1]
        assert second[0]["3"] == UNHEALTHY and second[0]["2"] == HEALTHY
        pair.host.revive_card(3)
        pair.slice.revive_chip((3,))
        third = [decode_devices(next(s)) for s in streams]
        assert third[0] == third[1] == first[0]
    finally:
        for s in streams:
            s.cancel()
        for c in chans:
            c.close()


@pytest.mark.parametrize("containers", [(["1", "2"],), (["7"],),
                                        (["0", "3"], ["5", "4", "6"])])
def test_allocate_grants_the_cards_the_jax_server_grants(pair, containers):
    req = allocate_request(*containers)
    got = pw.get_all(pair.unary("port", SVC_ALLOCATE, req), 1)
    want = jax_pw.get_all(pair.unary("jax", SVC_ALLOCATE, req), 1)
    assert len(got) == len(want) == len(containers)
    for ids, g, w in zip(containers, got, want):
        envs = pw.decode_string_map(pw.get_all(bytes(g), 1))
        jax_envs = jax_pw.decode_string_map(jax_pw.get_all(bytes(w), 1))
        indices = [int(i) for i in jax_envs["TPU_VISIBLE_CHIPS"].split(",")]
        assert indices == sorted(int(i) for i in ids)
        uuids = ",".join(pair.host.uuids[i] for i in indices)
        assert envs == {"CUDA_VISIBLE_DEVICES": uuids,
                        "NVIDIA_VISIBLE_DEVICES": uuids}
        devices = [bytes(pw.get_field(bytes(d), 2)).decode()
                   for d in pw.get_all(bytes(g), 3)]
        assert devices == [f"/dev/nvidia{i}" for i in indices] + [
            f"/dev/{n}" for n in CONTROL_DEVICES]
        assert pw.get_all(bytes(g), 2) == []   # no mounts
    # the same answer on request bytes alone, without a channel
    assert pair.servers["port"].allocate(req, None) == pair.unary(
        "port", SVC_ALLOCATE, req)


def test_allocate_unknown_or_dead_card_fails_the_rpc(pair):
    for name in ("port", "jax"):
        with pytest.raises(grpc.RpcError):
            pair.unary(name, SVC_ALLOCATE, allocate_request(["99"]))
    pair.kill(4)
    with pytest.raises(grpc.RpcError):
        pair.unary("port", SVC_ALLOCATE, allocate_request(["4"]))


PREFERRED = [
    (list("01234567"), [], 2),
    (list("01234567"), [], 3),
    (list("01234567"), ["5"], 2),
    (list("0123567"), [], 4),
    (list("1357"), [], 2),
    (list("023456"), ["0"], 2),
    (list("01234567"), ["2", "6"], 3),
    (list("01234567"), [], 8),
    (list("0124"), [], 0),
    (list("012"), [], 5),
    (list("34567"), ["7"], 5),
    (list("0167"), [], 2),
]


@pytest.mark.parametrize("available,must,size", PREFERRED,
                         ids=[f"{''.join(a)}-{''.join(m)}-{s}"
                              for a, m, s in PREFERRED])
def test_preferred_allocation_picks_the_jax_servers_ids(pair, available,
                                                        must, size):
    req = preferred_request(available, must, size)
    got = pair.servers["port"].preferred_allocation(req, None)
    assert got == pair.servers["jax"].preferred_allocation(req, None)
    chosen = [bytes(i).decode()
              for i in pw.get_all(bytes(pw.get_all(got, 1)[0]), 1)]
    assert len(chosen) == min(max(size, 0), len(available))
    assert set(must) <= set(chosen) or size > len(available) or size <= 0


def test_preferred_allocation_over_grpc(pair):
    req = preferred_request(list("01234567"), [], 3) + preferred_request(
        list("1357"), ["3"], 2)
    got = pair.unary("port", SVC_PREFERRED, req)
    assert got == pair.unary("jax", SVC_PREFERRED, req)
    picks = [[bytes(i).decode() for i in pw.get_all(bytes(c), 1)]
             for c in pw.get_all(got, 1)]
    # a contiguous run of 3 at an end of the free line
    assert picks[0] in (["0", "1", "2"], ["5", "6", "7"])
    assert "3" in picks[1] and len(picks[1]) == 2


def test_reregistration_through_kubelet_restart_churn(tmp_path):
    """kubelet restarts wipe the plugin directory and recreate
    kubelet.sock: the serve loop re-serves and re-registers, also after
    a window with kubelet down, and on an inode change alone."""
    host = FakeGpuHost("gpu-node", cards=4)
    kubelet_sock = str(tmp_path / "kubelet.sock")
    kubelet1 = FakeKubelet(kubelet_sock)
    plugin = DevicePluginServer(host.provider(), socket_dir=str(tmp_path),
                                poll_interval_s=0.1)
    plugin.start()
    stop = threading.Event()
    t = threading.Thread(target=plugin.serve_forever, args=(stop,),
                         kwargs={"watch_interval_s": 0.1}, daemon=True)
    t.start()
    try:
        assert kubelet1.wait(5.0), "initial registration never arrived"
        kubelet1.stop()
        for path in (kubelet_sock, plugin.socket_path):
            if os.path.exists(path):
                os.unlink(path)
        time.sleep(0.4)   # several watch ticks with kubelet down
        kubelet2 = FakeKubelet(kubelet_sock)
        try:
            assert kubelet2.wait(5.0), "no re-registration after restart"
            deadline = time.monotonic() + 5.0
            devices = None
            while time.monotonic() < deadline:
                try:
                    with grpc.insecure_channel(
                            f"unix://{plugin.socket_path}") as ch:
                        devices = decode_devices(next(ch.unary_stream(
                            SVC_LIST_AND_WATCH, request_serializer=IDENT,
                            response_deserializer=IDENT)(b"", timeout=5.0)))
                    break
                except Exception:  # noqa: BLE001 - socket mid-rebuild
                    time.sleep(0.1)
            assert devices == {str(i): HEALTHY for i in range(4)}
        finally:
            kubelet2.stop()
        if os.path.exists(kubelet_sock):
            os.unlink(kubelet_sock)
        kubelet3 = FakeKubelet(kubelet_sock)
        try:
            assert kubelet3.wait(5.0), "no re-registration on an inode change"
        finally:
            kubelet3.stop()
    finally:
        stop.set()
        t.join(timeout=5.0)
        plugin.stop()
