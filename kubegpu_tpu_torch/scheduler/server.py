"""The port's copy of the JAX package's ``scheduler/server.py``.

Scheduler-extender HTTP service (SURVEY.md §2 #4, §3.1).

Implements the Kubernetes scheduler-extender wire API — POST /filter,
/prioritize, /bind with the upstream JSON shapes — plus /healthz, /metrics
(Prometheus text) and /state (debug dump), mirroring the observability the
rebuild adds over the reference (SURVEY.md §5.1/§5.5).

Run in-cluster against the real API server:
    python -m kubegpu_tpu_torch.scheduler.server --listen 0.0.0.0:12345

or self-hosted on a fabricated cluster for demos/tests (no k8s needed):
    python -m kubegpu_tpu_torch.scheduler.server --fake-cluster 2x-h100-8

Register with kube-scheduler via deploy/extender-policy.json.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from kubegpu_tpu_torch.scheduler.core import Scheduler
from kubegpu_tpu_torch.utils.apiserver import ApiServer, InMemoryApiServer

log = logging.getLogger(__name__)


def make_handler(sched: Scheduler, is_leader=None, auth_token=None):
    """is_leader: optional callable gating the scheduling verbs (leader
    election).  A standby replica answers them 503 "not leader" — a
    NON-FATAL refusal kube-scheduler treats as an extender error and
    retries, by which time the real leader (or this replica, newly
    promoted) answers.  Health/metrics/state stay served on standbys:
    probes and operators still need them.

    auth_token: optional bearer token required on the PRIVILEGED verbs —
    /bind commits placements and /preemption nominates deletions; with
    the default in-cluster network they would otherwise be callable by
    any pod that can reach the Service.  Filter/prioritize stay open
    (read-only advice; kube-scheduler is the only caller that matters and
    gating them would take scheduling down on token skew)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # -- plumbing ----------------------------------------------------
        def setup(self):
            # TLS: the listening socket is wrapped with
            # do_handshake_on_connect=False, so the handshake happens
            # HERE, on this connection's own thread, under a deadline —
            # a stalled or silent client costs one worker thread for 10 s,
            # never the accept loop (which would take down every verb and
            # the health probes with it)
            if hasattr(self.request, "do_handshake"):
                prev = self.request.gettimeout()
                self.request.settimeout(10.0)
                try:
                    self.request.do_handshake()
                finally:
                    self.request.settimeout(prev)
            super().setup()
        def _read_json(self) -> Optional[dict]:
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                return json.loads(raw) if raw else {}
            except (ValueError, json.JSONDecodeError):
                return None

        def _send(self, code: int, payload, content_type="application/json") -> None:
            body = (
                json.dumps(payload).encode()
                if content_type == "application/json"
                else payload.encode()
            )
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # route through logging, not stderr
            log.debug("http: " + fmt, *args)

        # -- verbs -------------------------------------------------------
        def do_DELETE(self):
            parts = self.path.strip("/").split("/")
            if (
                len(parts) == 3
                and parts[0] == "pods"
                and isinstance(sched.api, InMemoryApiServer)
            ):
                ns, name = parts[1], parts[2]
                try:
                    obj = sched.api.get_pod(ns, name)
                    sched.api.delete_pod(ns, name)
                    sched.on_pod_deleted(obj)
                    self._send(200, {"deleted": f"{ns}/{name}"})
                except Exception as e:  # noqa: BLE001
                    self._send(404, {"error": str(e)})
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_GET(self):
            if self.path == "/healthz":
                # liveness: the process serves — true on standbys too
                self._send(200, "ok", content_type="text/plain")
            elif self.path == "/readyz":
                # readiness: ONLY the leader belongs in the Service's
                # Endpoints — a Ready standby would eat ~1/replicas of all
                # extender calls with 503s in steady state, failing those
                # scheduling cycles permanently, not just during failover
                if is_leader is None or is_leader():
                    self._send(200, "ok", content_type="text/plain")
                else:
                    self._send(503, "standby", content_type="text/plain")
            elif self.path == "/metrics":
                self._send(200, sched.metrics.render(), content_type="text/plain")
            elif self.path == "/state":
                state = _debug_state(sched)
                state["is_leader"] = is_leader() if is_leader else True
                self._send(200, state)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            body = self._read_json()
            if body is None:
                self._send(400, {"Error": "malformed JSON body"})
                return
            if (
                is_leader is not None
                and not is_leader()
                and self.path in ("/filter", "/prioritize", "/bind", "/preemption")
            ):
                # the in-memory cache is only authoritative on the leader;
                # a standby answering verbs would assume chips the leader
                # knows nothing about (double-allocation)
                self._send(503, {"Error": "not leader (standby replica)"})
                return
            if auth_token and self.path in ("/bind", "/preemption"):
                import hmac

                sent = self.headers.get("Authorization", "")
                # constant-time compare: the token gates exactly the
                # callers a timing oracle would serve
                if not hmac.compare_digest(sent, f"Bearer {auth_token}"):
                    self._send(401, {"Error": "unauthorized (bearer token required)"})
                    return
            try:
                if self.path == "/filter":
                    self._send(200, self._filter(body))
                elif self.path == "/prioritize":
                    self._send(200, self._prioritize(body))
                elif self.path == "/bind":
                    self._send(200, self._bind(body))
                elif self.path == "/preemption":
                    self._send(200, self._preemption(body))
                elif self.path == "/pods" and isinstance(sched.api, InMemoryApiServer):
                    # fake-cluster demo mode only: lets curl drive the full
                    # filter→prioritize→bind flow without a real API server
                    self._send(200, sched.api.create_pod(body))
                else:
                    self._send(404, {"error": f"no route {self.path}"})
            except Exception as e:  # noqa: BLE001 - extender must never hang kube-scheduler
                log.exception("handler error on %s", self.path)
                self._send(200, {"Error": f"internal error: {e}"})

        def _candidates(self, body: dict) -> Tuple[list, bool]:
            """Extender args carry either NodeNames (preferred) or full
            Nodes.Items; return (names, used_full_objects)."""
            if body.get("NodeNames"):
                return list(body["NodeNames"]), False
            items = (body.get("Nodes") or {}).get("Items") or []
            return [n.get("metadata", {}).get("name", "") for n in items], True

        def _filter(self, body: dict) -> dict:
            names, full = self._candidates(body)
            result = sched.filter(body.get("Pod") or {}, names)
            out = {
                "NodeNames": result.nodes,
                "FailedNodes": result.failed,
                "Error": result.error,
            }
            if full:
                items = (body.get("Nodes") or {}).get("Items") or []
                keep = set(result.nodes)
                out["Nodes"] = {
                    "Items": [
                        n for n in items if n.get("metadata", {}).get("name") in keep
                    ]
                }
            return out

        def _prioritize(self, body: dict) -> list:
            names, _ = self._candidates(body)
            scores = sched.prioritize(body.get("Pod") or {}, names)
            return [{"Host": h, "Score": s} for h, s in scores]

        def _bind(self, body: dict) -> dict:
            err = sched.bind(
                body.get("PodNamespace", "default"),
                body.get("PodName", ""),
                body.get("Node", ""),
            )
            return {"Error": err or ""}

        def _preemption(self, body: dict) -> dict:
            """ExtenderPreemptionArgs -> NodeNameToMetaVictims (advisory:
            kube-scheduler performs the eviction for this verb).  The
            nominated-node map scopes which slices victims may come from."""
            nominated = (
                body.get("NodeNameToVictims") or body.get("NodeNameToMetaVictims") or {}
            )
            candidates = sorted(nominated) if nominated else None
            by_node = sched.preemption_victims(body.get("Pod") or {}, candidates)
            meta = {}
            for node, keys in by_node.items():
                pods = []
                for key in keys:
                    ns, name = key.split("/", 1)
                    try:
                        uid = sched.api.get_pod(ns, name).get("metadata", {}).get("uid", key)
                    except Exception:  # noqa: BLE001
                        uid = key
                    pods.append({"UID": uid})
                meta[node] = {"Pods": pods, "NumPDBViolations": 0}
            return {"NodeNameToMetaVictims": meta}

    return Handler


def _debug_state(sched: Scheduler) -> dict:
    views = sched.cache.views()
    return {
        "nodes": sched.cache.node_names(),
        "slices": {
            sid: {
                "mesh": list(v.mesh_shape),
                "free": sorted(list(c) for c in v.free),
                "used": sorted(list(c) for c in v.used),
                "hosts": v.hosts(),
            }
            for sid, v in views.items()
        },
        # in-flight gang admissions (plans reserve every member up front);
        # locked snapshot accessors — handler threads race the verbs
        "gang_plans": sched.groups.plans_snapshot(),
        "assumed": sched.cache.assumed_keys(),
    }


class _ExtenderHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):
        # routine connection noise (failed TLS handshakes from probes and
        # scanners, clients dropping mid-request) — log, don't spray
        # tracebacks to stderr
        log.debug("connection error from %s", client_address, exc_info=True)


class ExtenderServer:
    """Owns the HTTP server + node/pod watches + a cache resync loop.

    The node watch is the fast path of failure detection: the advertiser's
    node patch lands as an event and chip-death eviction fires immediately
    instead of waiting for the next resync tick.  The pod watch is the fast
    path of gang lifecycle: a deleted member invalidates its gang plan and
    frees its chips the moment the DELETED event lands, instead of waiting
    out the plan TTL or the next resync LIST (SURVEY.md §3.5 — the
    reference ran BOTH informers).  The periodic resync stays as the
    consistency backstop (watch-stream drops, missed events, the
    orphaned-node sweep)."""

    def __init__(
        self,
        sched: Scheduler,
        listen: Tuple[str, int] = ("127.0.0.1", 12345),
        resync_interval_s: float = 30.0,
        watch: bool = True,
        elector=None,
        tls_cert: Optional[str] = None,
        tls_key: Optional[str] = None,
        auth_token: Optional[str] = None,
    ) -> None:
        self.sched = sched
        self.elector = elector  # utils.leaderelection.LeaderElector or None
        if elector is not None:
            # fencing re-check before the durable annotation write: a bind
            # that entered the verb gate just before the lease window
            # closed must not commit after a promoted standby may have
            # re-allocated the chips.  (A Lease is not a true fencing
            # token — an already-issued PATCH can still land late; the
            # conflict sweep's durable double-annotation eviction is the
            # final backstop for that residue.)
            sched.serving_gate = self._is_leader
        self.httpd = _ExtenderHTTPServer(
            listen,
            make_handler(
                sched,
                self._is_leader if elector else None,
                auth_token=auth_token,
            ),
        )
        self.tls = bool(tls_cert and tls_key)
        if self.tls:
            # serve the extender verbs over HTTPS (VERDICT r3 missing #2):
            # /bind and /preemption are privileged writes, and the client
            # side (KubeApiServer) already does TLS+bearer — the server
            # side must match.  Plain HTTP stays available for dev
            # (--fake-cluster demos) by simply not passing cert/key.
            #
            # do_handshake_on_connect=False is load-bearing: with the
            # default, the TLS handshake runs inside accept() on the ONE
            # serve_forever thread — a client that connects and never
            # speaks would stall every verb AND the health probes.  The
            # handshake instead runs in the per-connection handler thread
            # (Handler.setup) under a deadline.
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self.httpd.socket = ctx.wrap_socket(
                self.httpd.socket,
                server_side=True,
                do_handshake_on_connect=False,
            )
        self.resync_interval_s = resync_interval_s
        self.watch = watch
        self._stop = threading.Event()
        self._threads = []

    def _is_leader(self) -> bool:
        return self.elector is None or self.elector.is_leader()

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> None:
        self.sched.cache.refresh()
        if self.elector is not None:
            e = threading.Thread(
                target=self.elector.run, args=(self._stop,), daemon=True
            )
            e.start()
            self._threads.append(e)
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)
        r = threading.Thread(target=self._resync_loop, daemon=True)
        r.start()
        self._threads.append(r)
        if self.watch:
            w = threading.Thread(target=self._watch_loop, daemon=True)
            w.start()
            self._threads.append(w)
            p = threading.Thread(target=self._pod_watch_loop, daemon=True)
            p.start()
            self._threads.append(p)

    def _resync_loop(self) -> None:
        while not self._stop.wait(self.resync_interval_s):
            try:
                if self._is_leader():
                    # refresh + dead-chip eviction sweep (failure detector)
                    self.sched.resync()
                else:
                    # warm standby (SURVEY §1: durable state lives in the
                    # API server): keep the cache replaying annotations so
                    # promotion is instant, but sweep/evict NOTHING — only
                    # the leader acts on the cluster
                    self.sched.cache.refresh()
            except Exception:  # noqa: BLE001
                log.exception("cache resync failed; keeping stale cache")

    def _watch_loop(self) -> None:
        def handler(event: str, obj: dict) -> None:
            try:
                if event == "node-updated":
                    if self._is_leader():
                        self.sched.on_node_updated(obj)
                    else:
                        # standby: track topology for cache warmth, never
                        # evict (cache has its own lock; the strike maps
                        # the lifecycle lock guards are leader-only state)
                        self.sched.cache.update_node(obj)
                # node-deleted: left to resync's orphan sweep, which owns
                # the absence-grace bookkeeping (one LIST blip ≠ node loss)
            except Exception:  # noqa: BLE001
                log.exception("node watch handler failed for %s", event)

        try:
            self.sched.api.watch_nodes(handler, self._stop)
        except NotImplementedError:
            log.info("api server has no node watch; relying on periodic resync")
        except Exception:  # noqa: BLE001
            log.exception("node watch died; relying on periodic resync")

    def _pod_watch_loop(self) -> None:
        def handler(event: str, obj: dict) -> None:
            try:
                if event == "pod-deleted" and self._is_leader():
                    # standbys skip: they hold no plans/reservations to
                    # free, and the GET-confirm round-trip is the leader's
                    # to spend; their cache converges via refresh()
                    self.sched.on_pod_deleted(obj)
                # pod-created needs no action here: planning happens in
                # filter, which kube-scheduler re-drives for pending pods —
                # and the deletion path above has already freed whatever a
                # fresh plan needs.  pod-updated is reconciled by resync.
            except Exception:  # noqa: BLE001
                log.exception("pod watch handler failed for %s", event)

        try:
            self.sched.api.watch_pods(handler, self._stop)
        except NotImplementedError:
            log.info("api server has no pod watch; relying on plan TTL + resync")
        except Exception:  # noqa: BLE001
            log.exception("pod watch died; relying on plan TTL + resync")

    def stop(self) -> None:
        self._stop.set()
        if self.elector is not None:
            # release the lease NOW, synchronously — the elector thread is
            # a daemon and may be killed at interpreter exit before its
            # own run()-exit release runs; without this a rolling update
            # leaves the dead pod's holderIdentity on the lease and the
            # standby waits out the whole observation window (a leaderless
            # stretch where every verb 503s)
            self.elector.release()
        close = getattr(self.sched.api, "close_watches", None)
        if close is not None:
            close()  # unblock watch threads from quiet-window socket reads
        self.httpd.shutdown()
        self.httpd.server_close()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

# name -> cards per fabricated GPU host
FAKE_PRESETS = {
    "h100-1": 1,
    "h100-2": 2,
    "h100-4": 4,
    "h100-8": 8,
}

# the JAX package's TPU slice presets, which the port does not fabricate
TPU_PRESETS = ("v5e-4", "v5e-8", "v5e-16", "v5e-32", "v5e-64", "v5e-256")


def build_fake_cluster(preset: str) -> ApiServer:
    """Fabricated in-memory cluster of GPU hosts: ``h100-8`` is one host
    of 8 cards, advertised as the node advertiser advertises a real one
    (``FakeGpuHost`` through the port's ``Advertiser``: each host a
    slice of its own, its cards a line in index order).  An ``Nx-``
    prefix (e.g. ``2x-h100-8``) fabricates N such hosts, ``fake-h100-8-a``
    onwards.  The JAX package's TPU presets are refused: the port
    fabricates GPU hosts."""
    from kubegpu_tpu_torch.plugins.advertiser import Advertiser
    from kubegpu_tpu_torch.plugins.fake import FakeGpuHost

    count, base = 1, preset
    if "x-" in preset:
        head, _, rest = preset.partition("x-")
        if head.isdigit() and int(head) > 0:
            count, base = int(head), rest
    if base in TPU_PRESETS:
        raise SystemExit(
            f"preset {preset} is a TPU slice; the port fabricates GPU hosts: "
            f"choose from {sorted(FAKE_PRESETS)} (with an optional Nx- prefix)")
    if base not in FAKE_PRESETS:
        raise SystemExit(f"unknown preset {preset}; choose from {sorted(FAKE_PRESETS)}")
    api = InMemoryApiServer()
    for i in range(count):
        suffix = f"-{chr(ord('a') + i)}" if count > 1 else ""
        host = FakeGpuHost(f"fake-{base}{suffix}", cards=FAKE_PRESETS[base])
        Advertiser(host.provider(), api).advertise_once()
    return api


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--listen", default="127.0.0.1:12345")
    ap.add_argument(
        "--fake-cluster",
        metavar="PRESET",
        help="serve a fabricated in-memory cluster of GPU hosts (e.g. "
        "h100-8, 2x-h100-8) instead of "
        "connecting to a real API server",
    )
    ap.add_argument("--resync-interval", type=float, default=30.0)
    ap.add_argument(
        "--plugin",
        action="append",
        default=[],
        metavar="MODULE[:FACTORY]",
        help="load an extra DeviceSchedulerPlugin (SURVEY.md §3.5 plugin "
        "loading); FACTORY defaults to create_device_scheduler_plugin",
    )
    ap.add_argument(
        "--tls-cert",
        help="serve the extender over HTTPS with this PEM certificate "
        "(pair with --tls-key; omit both for plain-HTTP dev mode)",
    )
    ap.add_argument("--tls-key", help="PEM private key for --tls-cert")
    ap.add_argument(
        "--auth-token-file",
        help="require 'Authorization: Bearer <token>' (file contents) on "
        "the privileged verbs /bind and /preemption",
    )
    ap.add_argument(
        "--leader-elect",
        action="store_true",
        help="run with coordination.k8s.io Lease leader election: only the "
        "lease holder serves verbs and acts on the cluster; standbys keep "
        "a warm cache and answer 503 so kube-scheduler retries.  Makes "
        "replicas>1 safe (HA)",
    )
    ap.add_argument("--lease-namespace", default="kube-system")
    ap.add_argument("--lease-name", default="kubegpu-tpu-scheduler")
    ap.add_argument(
        "--identity",
        default=None,
        help="lease holder identity (default hostname_pid)",
    )
    ap.add_argument(
        "--preemption-min-runtime",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="anti-starvation shield: a freshly-admitted unit (pod or "
        "whole gang) is non-preemptible for this long after its last "
        "member binds, so alternating higher-priority tenants cannot "
        "starve it forever (0 disables)",
    )
    ap.add_argument(
        "--no-active-preemption",
        action="store_true",
        help="do not evict victims inside filter; only nominate them via "
        "the advisory /preemption verb (kube-scheduler performs the "
        "evictions — the classic extender division of labor)",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    if args.fake_cluster:
        api = build_fake_cluster(args.fake_cluster)
    else:
        from kubegpu_tpu_torch.utils.apiserver import KubeApiServer

        api = KubeApiServer()
    from kubegpu_tpu_torch.scheduler.plugins import default_registry

    registry = default_registry()
    for spec in args.plugin:
        registry.load(spec)
    host, _, port = args.listen.rpartition(":")
    sched = Scheduler(
        api,
        plugins=registry,
        active_preemption=not args.no_active_preemption,
        preemption_min_runtime_s=args.preemption_min_runtime,
    )
    elector = None
    if args.leader_elect:
        import os
        import socket as _socket

        from kubegpu_tpu_torch.utils.leaderelection import LeaderElector

        elector = LeaderElector(
            api,
            identity=args.identity or f"{_socket.gethostname()}_{os.getpid()}",
            namespace=args.lease_namespace,
            name=args.lease_name,
            # a freshly-promoted leader replays annotations before its
            # first verb, so the cache it binds against is current
            on_started_leading=sched.cache.refresh,
        )
    auth_token = None
    if args.auth_token_file:
        with open(args.auth_token_file) as f:
            auth_token = f.read().strip()
    if bool(args.tls_cert) != bool(args.tls_key):
        raise SystemExit("--tls-cert and --tls-key must be given together")
    server = ExtenderServer(
        sched,
        listen=(host or "127.0.0.1", int(port)),
        resync_interval_s=args.resync_interval,
        elector=elector,
        tls_cert=args.tls_cert,
        tls_key=args.tls_key,
        auth_token=auth_token,
    )
    server.start()
    log.info(
        "extender listening on %s://%s:%d",
        "https" if server.tls else "http",
        *server.address,
    )
    # SIGTERM is the deployed shutdown path (kubelet, rolling updates):
    # without a handler Python dies without unwinding, the lease release
    # never runs, and the standby waits out the full lease window
    import signal

    shutdown = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: shutdown.set())
    try:
        shutdown.wait()
    except KeyboardInterrupt:
        pass
    server.stop()


if __name__ == "__main__":
    main()
