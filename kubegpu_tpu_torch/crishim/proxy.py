"""CRI gRPC proxy with a CreateContainer mutation hook: the port's copy
of the JAX package's ``crishim/proxy.py``.

kubelet's CRI endpoint points at this proxy, which forwards every method
byte-for-byte to the real runtime — except CreateContainer, where the
device/env injection is spliced into the serialized request via the
wire-format editor (``utils/protowire.py``), so no CRI proto schema is
vendored and unknown/new fields pass through untouched.  ``grpc`` is
imported where the proxy starts (:class:`CriProxy`,
:func:`passthrough_handler`); the request surgery needs none.

Wiring:  kubelet ──CRI──▶ CriProxy ──CRI──▶ containerd
                             │
                             └─ decide(ns, pod, container) → Injection
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Optional, Tuple

from kubegpu_tpu_torch.crishim.inject import Injection, InjectionError
from kubegpu_tpu_torch.utils import protowire as pw

log = logging.getLogger(__name__)

CREATE_CONTAINER = "/runtime.v1.RuntimeService/CreateContainer"
# server-streaming CRI methods (everything else is unary)
STREAMING_METHODS = {
    "/runtime.v1.RuntimeService/GetContainerEvents",
}

# Decide callback: (namespace, pod_name, container_name,
#                   sandbox_annotations, hostname) -> Injection | None
DecideFn = Callable[[str, str, str, Dict[str, str], str], Optional[Injection]]


# ---------------------------------------------------------------------------
# CreateContainerRequest surgery (field numbers from the CRI v1 proto):
#   CreateContainerRequest: pod_sandbox_id=1, config=2, sandbox_config=3
#   PodSandboxConfig: metadata=1{name=1,uid=2,namespace=3}, hostname=2,
#                     labels=6, annotations=7
#   ContainerConfig: metadata=1{name=1}, envs=6 (KeyValue key=1,value=2),
#                    mounts=7, devices=8 (container_path=1, host_path=2,
#                    permissions=3)
# ---------------------------------------------------------------------------

def encode_device(host_path: str, container_path: Optional[str] = None,
                  permissions: str = "rwm") -> bytes:
    return (
        pw.encode_string_field(1, container_path or host_path)
        + pw.encode_string_field(2, host_path)
        + pw.encode_string_field(3, permissions)
    )


def parse_create_request(req: bytes) -> Tuple[str, str, str, Dict[str, str], str]:
    """(namespace, pod_name, container_name, sandbox_annotations, hostname)"""
    sandbox_cfg = pw.get_field(req, 3) or b""
    container_cfg = pw.get_field(req, 2) or b""
    meta = pw.get_field(bytes(sandbox_cfg), 1) or b""
    pod_name = pw.get_field(bytes(meta), 1)
    namespace = pw.get_field(bytes(meta), 3)
    hostname = pw.get_field(bytes(sandbox_cfg), 2)
    ann = pw.decode_string_map(pw.get_all(bytes(sandbox_cfg), 7))
    cmeta = pw.get_field(bytes(container_cfg), 1) or b""
    cname = pw.get_field(bytes(cmeta), 1)
    return (
        bytes(namespace).decode() if namespace else "default",
        bytes(pod_name).decode() if pod_name else "",
        bytes(cname).decode() if cname else "",
        ann,
        bytes(hostname).decode() if hostname else "",
    )


def encode_mount(host_path: str, container_path: str, readonly: bool = True) -> bytes:
    out = pw.encode_string_field(1, container_path) + pw.encode_string_field(2, host_path)
    if readonly:
        out += pw.encode_varint((3 << 3) | 0) + pw.encode_varint(1)
    return out


def mutate_create_request(req: bytes, injection: Injection) -> bytes:
    """Splice env (field 6), mounts (field 7) and devices (field 8) into the
    serialized request's ContainerConfig."""
    if injection.empty:
        return req
    config = bytes(pw.get_field(req, 2) or b"")
    env_entries = [pw.encode_key_value(k, v) for k, v in sorted(injection.env.items())]
    config = pw.append_to_message_field(config, 6, env_entries)
    mnt_entries = [encode_mount(h, c) for h, c in injection.mounts]
    config = pw.append_to_message_field(config, 7, mnt_entries)
    dev_entries = [encode_device(d) for d in injection.devices]
    config = pw.append_to_message_field(config, 8, dev_entries)
    return pw.replace_field(req, 2, config)


# ---------------------------------------------------------------------------
# The proxy server
# ---------------------------------------------------------------------------

_IDENT = lambda b: b  # noqa: E731 - bytes in, bytes out


def passthrough_handler(channel, decide: DecideFn):
    """The gRPC handler that forwards every CRI call to ``channel``,
    CreateContainer after splicing in ``decide``'s injection."""
    import grpc

    class _PassthroughHandler(grpc.GenericRpcHandler):
        def __init__(self, channel: grpc.Channel, decide: DecideFn):
            self._channel = channel
            self._decide = decide
            self._unary: Dict[str, object] = {}
            self._stream: Dict[str, object] = {}

        def _unary_callable(self, method: str):
            mc = self._unary.get(method)
            if mc is None:
                mc = self._channel.unary_unary(
                    method, request_serializer=_IDENT, response_deserializer=_IDENT
                )
                self._unary[method] = mc
            return mc

        def _stream_callable(self, method: str):
            mc = self._stream.get(method)
            if mc is None:
                mc = self._channel.unary_stream(
                    method, request_serializer=_IDENT, response_deserializer=_IDENT
                )
                self._stream[method] = mc
            return mc

        def service(self, handler_call_details):
            method = handler_call_details.method

            if method in STREAMING_METHODS:
                def stream_forward(request: bytes, context) -> Iterable[bytes]:
                    upstream = self._stream_callable(method)
                    yield from upstream(request, metadata=context.invocation_metadata())

                return grpc.unary_stream_rpc_method_handler(
                    stream_forward, request_deserializer=_IDENT, response_serializer=_IDENT
                )

            def forward(request: bytes, context) -> bytes:
                if method == CREATE_CONTAINER:
                    request = self._maybe_inject(request, context)
                try:
                    return self._unary_callable(method)(
                        request, metadata=context.invocation_metadata()
                    )
                except grpc.RpcError as e:
                    context.abort(e.code(), e.details())

            return grpc.unary_unary_rpc_method_handler(
                forward, request_deserializer=_IDENT, response_serializer=_IDENT
            )

        def _maybe_inject(self, request: bytes, context) -> bytes:
            try:
                ns, pod, cname, ann, hostname = parse_create_request(request)
                injection = self._decide(ns, pod, cname, ann, hostname)
            except InjectionError as e:
                # the decide layer POSITIVELY knows injection is required but
                # cannot compute it correctly: fail CreateContainer (kubelet
                # retries) instead of starting a silently-corrupt worker
                context.abort(grpc.StatusCode.INTERNAL, f"device injection failed: {e}")
            except Exception:  # noqa: BLE001 - a decide bug must not take down
                # every container on the node; pods without devices dominate
                # this path
                log.exception("injection decision failed; passing request through")
                return request
            if injection is None or injection.empty:
                return request
            try:
                mutated = mutate_create_request(request, injection)
                log.info(
                    "injected %d env vars + %d devices + %d mounts into %s/%s:%s",
                    len(injection.env), len(injection.devices), len(injection.mounts),
                    ns, pod, cname,
                )
                return mutated
            except ValueError as e:
                # refuse to forward a request we failed to mutate coherently: a
                # device pod silently started without its devices fails much
                # more obscurely later (see plugins/discovery allocate)
                context.abort(grpc.StatusCode.INTERNAL, f"device injection failed: {e}")

    return _PassthroughHandler(channel, decide)


class CriProxy:
    def __init__(
        self,
        upstream_target: str,
        decide: DecideFn,
        listen_target: str = "unix:///run/kubegpu-tpu/crishim.sock",
        max_workers: int = 16,
    ) -> None:
        from concurrent import futures

        import grpc

        self.channel = grpc.insecure_channel(upstream_target)
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
        self.server.add_generic_rpc_handlers(
            (passthrough_handler(self.channel, decide),)
        )
        self.port = self.server.add_insecure_port(listen_target)

    def start(self) -> None:
        self.server.start()

    def stop(self, grace: float = 2.0) -> None:
        self.server.stop(grace)
        self.channel.close()
