"""Kubelet Device Plugin API (v1beta1) for the host's cards: the port's
copy of the JAX package's ``plugins/deviceplugin.py`` over a
``GpuProvider``.

The plugin serves on a unix socket under
``/var/lib/kubelet/device-plugins/``, registers itself with kubelet's
``kubelet.sock``, streams its device inventory (``ListAndWatch``) and
answers ``Allocate`` at container-admission time with the provider's
injection set (``CUDA_VISIBLE_DEVICES``/``NVIDIA_VISIBLE_DEVICES`` as
the cards' UUIDs, ``/dev/nvidia<minor>`` and the driver's control
nodes).  ``GetPreferredAllocation`` answers kubelet's choice of device
IDs with the most contiguous subset by the allocator's scorer.  A device
ID is the card's host-local index, as a chip's is in the JAX package.

``grpc`` is imported only where a server or a channel starts
(:meth:`DevicePluginServer.start`, :meth:`register_with_kubelet`,
:func:`plugin_handler`): the inventory, ``allocate`` and
``preferred_allocation`` turn request bytes into response bytes without
it.  Wire format: the schema-free protowire codec
(``utils/protowire.py``); field numbers follow the public
``k8s.io/kubelet/pkg/apis/deviceplugin/v1beta1/api.proto``.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Iterable, List, Optional, Sequence

from kubegpu_tpu_torch.grpalloc.scoring import placement_score
from kubegpu_tpu_torch.plugins.provider import GpuProvider, HostFragment
from kubegpu_tpu_torch.types.info import ChipRef
from kubegpu_tpu_torch.types.resource import RES_TPU
from kubegpu_tpu_torch.utils import protowire as pw

log = logging.getLogger(__name__)

API_VERSION = "v1beta1"
KUBELET_SOCKET = "kubelet.sock"
DEFAULT_SOCKET_DIR = "/var/lib/kubelet/device-plugins"
DEFAULT_ENDPOINT = "kubegpu-tpu.sock"

SVC_REGISTRATION = "/v1beta1.Registration/Register"
SVC_OPTIONS = "/v1beta1.DevicePlugin/GetDevicePluginOptions"
SVC_LIST_AND_WATCH = "/v1beta1.DevicePlugin/ListAndWatch"
SVC_PREFERRED = "/v1beta1.DevicePlugin/GetPreferredAllocation"
SVC_ALLOCATE = "/v1beta1.DevicePlugin/Allocate"
SVC_PRESTART = "/v1beta1.DevicePlugin/PreStartContainer"

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

_IDENT = lambda b: b  # noqa: E731 - bytes in, bytes out


# ---------------------------------------------------------------------------
# Message builders/parsers (field numbers from deviceplugin v1beta1 api.proto)
# ---------------------------------------------------------------------------

def encode_register_request(endpoint: str, resource_name: str) -> bytes:
    """RegisterRequest{version=1, endpoint=2, resource_name=3, options=4}."""
    return (
        pw.encode_string_field(1, API_VERSION)
        + pw.encode_string_field(2, endpoint)
        + pw.encode_string_field(3, resource_name)
        + pw.encode_len_field(4, encode_options())
    )


def encode_options() -> bytes:
    """DevicePluginOptions{pre_start_required=1,
    get_preferred_allocation_available=2}."""
    return (
        # pre_start_required=false is the proto default (omitted)
        pw.encode_varint((2 << 3) | 0) + pw.encode_varint(1)
    )


def encode_device(device_id: str, healthy: bool) -> bytes:
    """Device{ID=1, health=2}."""
    return pw.encode_string_field(1, device_id) + pw.encode_string_field(
        2, HEALTHY if healthy else UNHEALTHY
    )


def encode_list_and_watch_response(devices: List[bytes]) -> bytes:
    out = bytearray()
    for d in devices:
        out += pw.encode_len_field(1, d)
    return bytes(out)


def decode_devices(payload: bytes) -> Dict[str, str]:
    """ListAndWatchResponse → {device_id: health}."""
    out: Dict[str, str] = {}
    for d in pw.get_all(payload, 1):
        d = bytes(d)
        did = pw.get_field(d, 1)
        health = pw.get_field(d, 2)
        out[bytes(did).decode() if did else ""] = (
            bytes(health).decode() if health else ""
        )
    return out


def decode_id_list_requests(payload: bytes, ids_field: int = 1) -> List[List[str]]:
    """AllocateRequest/PreStartContainerRequest-style: repeated container
    requests (field 1), each with repeated string device IDs."""
    out: List[List[str]] = []
    for creq in pw.get_all(payload, 1):
        out.append([bytes(i).decode() for i in pw.get_all(bytes(creq), ids_field)])
    return out


def decode_preferred_requests(payload: bytes) -> List[dict]:
    """PreferredAllocationRequest{container_requests=1} with
    ContainerPreferredAllocationRequest{available_deviceIDs=1,
    must_include_deviceIDs=2, allocation_size=3}."""
    out = []
    for creq in pw.get_all(payload, 1):
        creq = bytes(creq)
        size = pw.get_field(creq, 3)
        out.append(
            {
                "available": [bytes(i).decode() for i in pw.get_all(creq, 1)],
                "must_include": [bytes(i).decode() for i in pw.get_all(creq, 2)],
                "size": int(size) if isinstance(size, int) else 0,
            }
        )
    return out


def encode_container_allocate_response(
    env: Dict[str, str],
    devices: Sequence[str],
    mounts: Sequence[tuple],
) -> bytes:
    """ContainerAllocateResponse{envs=1 map, mounts=2, devices=3}."""
    out = bytearray()
    for k, v in sorted(env.items()):
        out += pw.encode_len_field(1, pw.encode_key_value(k, v))
    for host, ctr in mounts:
        # Mount{container_path=1, host_path=2, read_only=3}
        m = pw.encode_string_field(1, ctr) + pw.encode_string_field(2, host)
        m += pw.encode_varint((3 << 3) | 0) + pw.encode_varint(1)
        out += pw.encode_len_field(2, m)
    for path in devices:
        # DeviceSpec{container_path=1, host_path=2, permissions=3}
        d = (
            pw.encode_string_field(1, path)
            + pw.encode_string_field(2, path)
            + pw.encode_string_field(3, "rwm")
        )
        out += pw.encode_len_field(3, d)
    return bytes(out)


# ---------------------------------------------------------------------------
# The plugin server
# ---------------------------------------------------------------------------

class DevicePluginServer:
    """Serves the DevicePlugin service for one host's GpuProvider and
    registers it with kubelet.  A ``device_id`` is the card's host-local
    index (NVML's index order, stable across restarts)."""

    def __init__(
        self,
        provider: GpuProvider,
        socket_dir: str = DEFAULT_SOCKET_DIR,
        endpoint: str = DEFAULT_ENDPOINT,
        resource_name: str = RES_TPU,
        poll_interval_s: float = 5.0,
    ) -> None:
        self.provider = provider
        self.socket_dir = socket_dir
        self.endpoint = endpoint
        self.resource_name = resource_name
        self.poll_interval_s = poll_interval_s
        self._server = None  # a grpc.Server once started
        self._stop = threading.Event()

    # -- lifecycle --------------------------------------------------------
    @property
    def socket_path(self) -> str:
        return os.path.join(self.socket_dir, self.endpoint)

    def start(self) -> None:
        from concurrent import futures

        import grpc

        if self._server is not None:
            # re-serve (kubelet restart churn): a started grpc.Server is
            # never garbage-collected until stopped — overwriting the
            # reference would leak its poller thread + executor per restart
            self._server.stop(0.2).wait()
            self._server = None
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)  # stale socket from a previous run
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((plugin_handler(self),))
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        log.info("device plugin serving %s on %s", self.resource_name, self.socket_path)

    def stop(self, grace: float = 1.0) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.stop(grace).wait()

    def register_with_kubelet(self, kubelet_socket: Optional[str] = None) -> None:
        """One unary Register call; kubelet then dials back our endpoint."""
        import grpc

        target = f"unix://{kubelet_socket or os.path.join(self.socket_dir, KUBELET_SOCKET)}"
        with grpc.insecure_channel(target) as channel:
            register = channel.unary_unary(
                SVC_REGISTRATION, request_serializer=_IDENT, response_deserializer=_IDENT
            )
            register(
                encode_register_request(self.endpoint, self.resource_name),
                timeout=5.0,
            )
        log.info("registered %s with kubelet at %s", self.resource_name, target)

    def serve_forever(
        self,
        stop: threading.Event,
        kubelet_socket: Optional[str] = None,
        watch_interval_s: float = 2.0,
    ) -> None:
        """The DaemonSet serve loop, re-registration churn included —
        kubelet owns the plugin contract's lifecycle and a plugin that
        only registers once silently falls out of the allocatable set on
        the first kubelet restart:

        - our own socket vanishing = kubelet restarted and wiped
          ``/var/lib/kubelet/device-plugins`` → re-serve + re-register
          (the fsnotify trigger the NVIDIA plugin watches);
        - the kubelet socket's INODE changing = kubelet restarted without
          wiping the dir (containerized kubelets recreate their socket) →
          our old registration died with the old process → re-register;
        - registration failures (kubelet briefly down mid-restart) are
          logged and retried next tick, never fatal.
        """
        kubelet_path = kubelet_socket or os.path.join(
            self.socket_dir, KUBELET_SOCKET
        )
        last_ident: Optional[tuple] = None
        registered = False
        while not stop.is_set():
            if not os.path.exists(self.socket_path):
                log.warning(
                    "plugin socket vanished (kubelet restart); re-serving"
                )
                try:
                    self.start()
                except Exception as e:  # noqa: BLE001 - bind can fail
                    # transiently while kubelet recreates the plugin dir;
                    # the same never-fatal rule as registration
                    log.warning("re-serve failed (%s); retrying", e)
                    stop.wait(watch_interval_s)
                    continue
                registered = False
            try:
                st = os.stat(kubelet_path)
                # inode + mtime: tmpfs recycles inode numbers, so a
                # recreated socket can reuse its predecessor's — the
                # creation timestamp disambiguates
                ident: Optional[tuple] = (st.st_ino, st.st_mtime_ns)
            except OSError:
                ident = None  # kubelet down/mid-restart: wait for it
                registered = False
            if ident is not None and (not registered or ident != last_ident):
                try:
                    self.register_with_kubelet(kubelet_path)
                    registered = True
                    last_ident = ident
                except Exception as e:  # noqa: BLE001 - retry next tick
                    log.warning("kubelet registration failed (%s); retrying", e)
                    registered = False
            stop.wait(watch_interval_s)

    # -- device inventory -------------------------------------------------
    def _fragment(self) -> Optional[HostFragment]:
        return self.provider.enumerate()

    def _inventory(self) -> Dict[str, bool]:
        """device_id -> healthy, folding in a fresh health probe."""
        frag = self._fragment()
        if frag is None:
            return {}
        fresh = self.provider.healthy_device_indices()
        out = {}
        for ch in frag.chips:
            healthy = ch.healthy if fresh is None else ch.device_index in fresh
            out[str(ch.device_index)] = healthy
        return out

    def list_and_watch(self, request: bytes, context) -> Iterable[bytes]:
        """Stream the inventory; re-send whenever it changes (kubelet keeps
        this stream open for the plugin's lifetime)."""
        last: Optional[Dict[str, bool]] = None
        while not self._stop.is_set() and context.is_active():
            inv = self._inventory()
            if inv != last:
                last = inv
                yield encode_list_and_watch_response(
                    [encode_device(did, ok) for did, ok in sorted(inv.items())]
                )
            # Event.wait returns early on stop — no sleep-latency on shutdown
            self._stop.wait(self.poll_interval_s)

    # -- allocation -------------------------------------------------------
    def _chips_for_ids(self, ids: Sequence[str]) -> List[ChipRef]:
        frag = self._fragment()
        if frag is None:
            raise ValueError("no GPU fragment on this host")
        by_idx = {str(ch.device_index): ch for ch in frag.chips}
        refs = []
        for did in ids:
            ch = by_idx.get(did)
            if ch is None:
                raise ValueError(f"unknown device id {did!r}")
            refs.append(
                ChipRef(
                    host=frag.node_name,
                    device_index=ch.device_index,
                    chip_id=ch.chip_id,
                    coords=ch.coords,
                )
            )
        return refs

    def allocate(self, request: bytes, context) -> bytes:
        out = bytearray()
        for ids in decode_id_list_requests(request):
            resp = self.provider.allocate(self._chips_for_ids(ids))
            out += pw.encode_len_field(
                1,
                encode_container_allocate_response(
                    resp.env, resp.devices, resp.mounts
                ),
            )
        return bytes(out)

    def preferred_allocation(self, request: bytes, context) -> bytes:
        """kubelet's "which device IDs should I pick" — answered with the
        most contiguous subset by the allocator's own scorer, so even
        extender-less clusters get topology-aware placement."""
        frag = self._fragment()
        out = bytearray()
        for creq in decode_preferred_requests(request):
            chosen = self._prefer(
                frag, creq["available"], creq["must_include"], creq["size"]
            )
            resp = bytearray()
            for did in chosen:
                resp += pw.encode_string_field(1, did)
            out += pw.encode_len_field(1, bytes(resp))
        return bytes(out)

    def _prefer(
        self,
        frag: Optional[HostFragment],
        available: List[str],
        must_include: List[str],
        size: int,
    ) -> List[str]:
        import itertools

        if size <= 0 or size > len(available):
            return sorted(available)[:max(size, 0)]
        if frag is None:
            return sorted(available)[:size]
        coords_of = {str(ch.device_index): ch.coords for ch in frag.chips}
        must = [d for d in must_include if d in coords_of]
        pool = sorted(d for d in available if d in coords_of and d not in must)
        want = size - len(must)
        if want < 0 or want > len(pool):
            return sorted(available)[:size]
        free = frozenset(coords_of[d] for d in pool + must)
        best, best_score = None, -1.0
        for combo in itertools.combinations(pool, want):
            cset = frozenset(coords_of[d] for d in combo) | frozenset(
                coords_of[d] for d in must
            )
            s = placement_score(cset, free, frag.mesh_shape, frag.wrap)
            if s > best_score:
                best, best_score = list(combo), s
        return sorted(must + (best or []))


def plugin_handler(plugin: DevicePluginServer):
    """The gRPC handler of the DevicePlugin service over ``plugin``."""
    import grpc

    class _PluginHandler(grpc.GenericRpcHandler):
        def service(self, handler_call_details):
            method = handler_call_details.method
            p = plugin
            if method == SVC_OPTIONS:
                return grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: encode_options(),
                    request_deserializer=_IDENT,
                    response_serializer=_IDENT,
                )
            if method == SVC_LIST_AND_WATCH:
                return grpc.unary_stream_rpc_method_handler(
                    p.list_and_watch,
                    request_deserializer=_IDENT,
                    response_serializer=_IDENT,
                )
            if method == SVC_ALLOCATE:
                return grpc.unary_unary_rpc_method_handler(
                    p.allocate, request_deserializer=_IDENT, response_serializer=_IDENT
                )
            if method == SVC_PREFERRED:
                return grpc.unary_unary_rpc_method_handler(
                    p.preferred_allocation,
                    request_deserializer=_IDENT,
                    response_serializer=_IDENT,
                )
            if method == SVC_PRESTART:
                return grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: b"",  # PreStartContainerResponse{}
                    request_deserializer=_IDENT,
                    response_serializer=_IDENT,
                )
            return None

    return _PluginHandler()


def main(argv=None) -> None:
    """DaemonSet entrypoint: serve + register + re-register on kubelet
    restart (kubelet deletes plugin sockets when it restarts; watching our
    own socket disappear is the standard re-registration trigger)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--socket-dir", default=DEFAULT_SOCKET_DIR)
    ap.add_argument("--endpoint", default=DEFAULT_ENDPOINT)
    ap.add_argument("--resource", default=RES_TPU)
    ap.add_argument("--poll-interval", type=float, default=5.0)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    from kubegpu_tpu_torch.plugins.discovery import NvmlGpuProvider

    plugin = DevicePluginServer(
        NvmlGpuProvider(),
        socket_dir=args.socket_dir,
        endpoint=args.endpoint,
        resource_name=args.resource,
        poll_interval_s=args.poll_interval,
    )
    plugin.start()
    stop = threading.Event()
    try:
        plugin.serve_forever(stop)
    except KeyboardInterrupt:
        stop.set()
        plugin.stop()


if __name__ == "__main__":
    main()
