"""The port's scheduler-extender service (``kubegpu_tpu_torch/scheduler/
server.py``, ``status.py``, ``utils/leaderelection.py``) held against the
JAX package's on the CPU, over loopback HTTP:

- the same kube-scheduler request bodies into the port's
  ``ExtenderServer`` and the JAX package's, each over its own API server
  holding the same nodes: equal status codes and JSON, equal ``/state``,
  the same ``/metrics`` series names;
- both driven by the JAX package's ``FakeKubeScheduler`` through the
  real ``deploy/scheduler-config.yaml`` over HTTPS (NodeNames-only args,
  weighted priorities, delegated bind, the preemption verb): equal
  calls, binds and API state;
- the bearer token on ``/bind`` and ``/preemption``, a standby's 503,
  and TLS through the JAX package's ``testing/tlsutil.py`` certificates;
- the port's ``LeaderElector`` against the JAX package's over one API
  server: the lease passes over on expiry and on release;
- the whole chain: ``samples/jax-resnet.yaml``'s 4-pod gang through the
  port's extender on a fabricated 8-card GPU host, turned into envs by the
  port's shim, equal to what the JAX extender's bind gives the same shim;
- the entry points: ``python -m kubegpu_tpu_torch.scheduler.server
  --fake-cluster 2x-h100-8`` answers ``/filter`` and ``/state``, its
  status screen renders, and a TPU preset is refused."""

import json
import os
import re
import select
import signal
import ssl
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from kubegpu_tpu.scheduler import ExtenderServer as JaxExtenderServer
from kubegpu_tpu.testing import (
    ExtenderConfig,
    FakeKubeScheduler,
    load_scheduler_config,
)
from kubegpu_tpu.utils.apiserver import Conflict as JaxConflict
from kubegpu_tpu.utils.apiserver import NotFound as JaxNotFound
from kubegpu_tpu.utils.leaderelection import LeaderElector as JaxLeaderElector
from kubegpu_tpu_torch.crishim.daemon import ShimDaemon
from kubegpu_tpu_torch.scheduler import ExtenderServer
from kubegpu_tpu_torch.scheduler.server import build_fake_cluster
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.resource import RES_TPU
from kubegpu_tpu_torch.utils.apiserver import Conflict as PortConflict
from kubegpu_tpu_torch.utils.apiserver import InMemoryApiServer
from kubegpu_tpu_torch.utils.apiserver import NotFound as PortNotFound
from kubegpu_tpu_torch.utils.leaderelection import LeaderElector

from test_samples import load_pods
from torch_sched_twin import Fleet, Twin, api_state, pod_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "deploy", "scheduler-config.yaml")


def call(base, method, path, body=None, raw=None, headers=None, ctx=None):
    """One HTTP call: (status, content type, body bytes)."""
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10, context=ctx) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def decoded(resp):
    code, ctype, raw = resp
    return code, ctype, json.loads(raw) if ctype == "application/json" else raw


class Pair:
    """The JAX package's ``ExtenderServer`` and the port's over a
    :class:`Twin`'s two schedulers, on loopback."""

    def __init__(self, twin, tls=None, auth_token=None, watch=False,
                 electors=(None, None)):
        self.twin = twin
        kw = dict(listen=("127.0.0.1", 0), resync_interval_s=3600.0,
                  watch=watch, auth_token=auth_token,
                  tls_cert=tls and tls[0], tls_key=tls and tls[1])
        self.jax = JaxExtenderServer(twin.jax, elector=electors[0], **kw)
        self.port = ExtenderServer(twin.port, elector=electors[1], **kw)
        scheme = "https" if tls else "http"
        self.bases = [f"{scheme}://{s.address[0]}:{s.address[1]}"
                      for s in (self.jax, self.port)]
        self.ctx = ssl.create_default_context(cafile=tls[0]) if tls else None

    def __enter__(self):
        self.jax.start()
        self.port.start()
        return self

    def __exit__(self, *exc):
        # each stop waits out its serve loop's half-second poll: both at once
        jax_stop = threading.Thread(target=self.jax.stop)
        jax_stop.start()
        self.port.stop()
        jax_stop.join()

    def both(self, method, path, body=None, **kw):
        """The same call on both; asserts equal answers, returns the
        port's (status, content type, decoded body)."""
        rj, rp = (decoded(call(b, method, path, body, ctx=self.ctx, **kw))
                  for b in self.bases)
        assert rp == rj, (method, path)
        return rp


def metric_names(text):
    return sorted({re.split(r"[{ ]", line, 1)[0]
                   for line in text.decode().splitlines()
                   if line and not line.startswith("#")})


@pytest.mark.parametrize("kind", ["tpu", "gpu"])
def test_wire_answers_equal(kind):
    """A kube-scheduler session, request for request: pod creation (the
    fake cluster's demo verb), filter with NodeNames and with full
    Nodes.Items, prioritize, bind, a refused bind, the advisory
    preemption verb, deletion, malformed bodies, unknown routes and the
    probes; then /state and the /metrics series names."""
    fleet = Fleet("tpu") if kind == "tpu" else Fleet("gpu", n=2, cards=8)
    twin = Twin(fleet, active_preemption=False)
    with Pair(twin) as pair:
        nodes = fleet.nodes()
        full = {"Items": twin.port_api.list_nodes()}
        for i, chips in enumerate([1, 2, 4, 4, 4, 1]):
            obj = pod_obj(f"p{i}", chips, priority=1)
            pair.both("POST", "/pods", obj)
            code, _, f = pair.both("POST", "/filter",
                                   {"Pod": obj, "NodeNames": nodes})
            assert code == 200
            pair.both("POST", "/filter", {"Pod": obj, "Nodes": full})
            if not f["NodeNames"]:
                continue
            _, _, prio = pair.both("POST", "/prioritize",
                                   {"Pod": obj, "NodeNames": f["NodeNames"]})
            best = max(prio, key=lambda e: e["Score"])["Host"]
            _, _, b = pair.both("POST", "/bind", {
                "PodNamespace": "default", "PodName": f"p{i}", "Node": best})
            assert b == {"Error": ""}
        pair.both("POST", "/bind", {"PodNamespace": "default",
                                    "PodName": "p0", "Node": nodes[0]})
        members = [pod_obj(f"g-{k}", 1, group="g", size=3) for k in range(3)]
        for m in members[:2]:
            pair.both("POST", "/pods", m)
            pair.both("POST", "/filter", {"Pod": m, "NodeNames": nodes})
        vip = pod_obj("vip", 8 if kind == "gpu" else 4, priority=9)
        pair.both("POST", "/pods", vip)
        _, _, f = pair.both("POST", "/filter", {"Pod": vip, "NodeNames": nodes})
        _, _, victims = pair.both("POST", "/preemption", {
            "Pod": vip, "NodeNameToMetaVictims": {n: {"Pods": []}
                                                  for n in nodes}})
        assert victims["NodeNameToMetaVictims"] or f["NodeNames"]
        assert pair.both("DELETE", "/pods/default/p1")[0] == 200
        assert pair.both("DELETE", "/pods/default/p1")[0] == 404
        assert pair.both("POST", "/filter", raw=b"{nope")[0] == 400
        assert pair.both("POST", "/nope", {})[0] == 404
        assert pair.both("GET", "/nope")[0] == 404
        assert pair.both("GET", "/healthz")[2] == b"ok"
        assert pair.both("GET", "/readyz")[2] == b"ok"
        _, _, state = pair.both("GET", "/state")
        assert state["is_leader"] is True and sorted(state) == sorted(
            ["nodes", "slices", "gang_plans", "assumed", "is_leader"])
        mj, mp = (call(b, "GET", "/metrics") for b in pair.bases)
        assert mp[0] == mj[0] == 200
        assert metric_names(mp[2]) == metric_names(mj[2])
        assert "kubegpu_bind_total" in metric_names(mp[2])
    twin.assert_same()


@pytest.fixture
def tls(tmp_path):
    pytest.importorskip("cryptography")
    from kubegpu_tpu.testing.tlsutil import make_self_signed

    return make_self_signed(str(tmp_path))


def kube_schedulers(pair, tls):
    """A FakeKubeScheduler over each API server, from the deployed
    config with only its host and CA retargeted at each live server."""
    out = []
    for api, base in zip((pair.twin.jax_api, pair.twin.port_api),
                         pair.bases):
        exts = load_scheduler_config(CONFIG)
        for e in exts:
            assert e.enable_https and e.node_cache_capable
            e.url_prefix = base
            e.tls_ca_file = tls[0]
        out.append(FakeKubeScheduler(api, exts))
    return out


@pytest.mark.parametrize("kind", ["tpu", "gpu"])
def test_conformance_through_the_deployed_config(kind, tls):
    """Passthrough, single pods, a gang and a VIP whose victims the
    extender evicts inside filter: the two FakeKubeSchedulers make the
    same calls, bind the same pods to the same nodes, and leave equal API
    state."""
    fleet = Fleet("tpu") if kind == "tpu" else Fleet("gpu", n=2, cards=8)
    twin = Twin(fleet)
    with Pair(twin, tls=tls) as pair:
        kj, kp = kube_schedulers(pair, tls)
        objs = ([pod_obj("web", 0), pod_obj("one", 1), pod_obj("quad", 4)]
                + [pod_obj(f"dp-{k}", 1, group="dp", size=4)
                   for k in range(4)])
        for o in objs:
            twin.create(o)
        bj, bp = kj.run_until_settled(), kp.run_until_settled()
        assert bp == bj and len(bj) == len(objs)
        assert kp.extender_calls == kj.extender_calls
        assert ("filter", "web") not in kj.extender_calls
        twin.assert_same()
        n = 4 if kind == "tpu" else 8
        for i in range(4 if kind == "tpu" else 2):
            twin.create(pod_obj(f"low{i}", n, priority=1))
        kj.run_until_settled(), kp.run_until_settled()
        twin.create(pod_obj("vip", n, priority=9))
        bj, bp = kj.run_until_settled(), kp.run_until_settled()
        assert bp == bj and "default/vip" in bj
        assert kp.extender_calls == kj.extender_calls
        state = twin.assert_same()
        assert "Preempted" in {e[2] for e in state["events"]}


def test_advisory_preemption_verb_through_the_deployed_config(tls):
    """``active_preemption=False``: filter refuses the VIP, the
    scheduler calls the preemption verb, performs the evictions it
    nominates, and admits the VIP next pass, alike on both (the
    evictions reach each extender through its pod watch)."""
    twin = Twin(Fleet("tpu"), active_preemption=False)
    with Pair(twin, tls=tls, watch=True) as pair:
        kj, kp = kube_schedulers(pair, tls)
        for i in range(4):
            twin.create(pod_obj(f"low{i}", 4, priority=1))
        assert len(kj.run_until_settled()) == len(kp.run_until_settled()) == 4
        twin.create(pod_obj("vip", 4, priority=9))
        bj = kj.run_until_settled(settle_s=0.3)
        bp = kp.run_until_settled(settle_s=0.3)
        assert "default/vip" in bj and bp == bj
        assert ("preemption", "vip") in kp.extender_calls
        assert kp.extender_calls == kj.extender_calls
        sj, sp = api_state(twin.jax_api), api_state(twin.port_api)
        assert sp["pods"] == sj["pods"]


def test_bearer_token_gates_bind_and_preemption(tls, tmp_path):
    """With a token, /bind and /preemption answer 401 without it or with
    a wrong one, as the JAX extender does; /filter stays open; the
    conformance client that sends it binds."""
    twin = Twin(Fleet("gpu", n=1, cards=8))
    token = tmp_path / "token"
    token.write_text("sekret\n")
    with Pair(twin, tls=tls, auth_token="sekret") as pair:
        pod = pod_obj("p0", 1)
        pair.both("POST", "/pods", pod)
        code, _, f = pair.both("POST", "/filter",
                               {"Pod": pod, "NodeNames": ["gpu-0"]})
        assert code == 200 and f["NodeNames"] == ["gpu-0"]
        bind = {"PodNamespace": "default", "PodName": "p0", "Node": "gpu-0"}
        for headers in ({}, {"Authorization": "Bearer wrong"}):
            assert pair.both("POST", "/bind", bind, headers=headers)[:2] == (
                401, "application/json")
            assert pair.both("POST", "/preemption", {"Pod": pod},
                             headers=headers)[0] == 401
        for base in pair.bases:
            ext = ExtenderConfig(
                url_prefix=base, filter_verb="filter",
                prioritize_verb="prioritize", bind_verb="bind",
                preempt_verb="preemption", weight=1, node_cache_capable=True,
                managed_resources=[RES_TPU], tls_ca_file=tls[0],
                auth_token_file=str(token))
            api = twin.jax_api if base == pair.bases[0] else twin.port_api
            assert FakeKubeScheduler(api, [ext]).run_until_settled() == {
                "default/p0": "gpu-0"}
    twin.assert_same()


def test_standby_answers_503(tls):
    """An extender whose elector does not hold the lease refuses every
    scheduling verb 503 and is not ready, as the JAX extender's standby
    does; liveness and /state stay served."""
    twin = Twin(Fleet("gpu", n=1, cards=4))
    for elector in (JaxLeaderElector(twin.jax_api, "holder"),
                    LeaderElector(twin.port_api, "holder")):
        assert elector.try_acquire_or_renew() == "ok"
    electors = (JaxLeaderElector(twin.jax_api, "b"),
                LeaderElector(twin.port_api, "b"))
    with Pair(twin, tls=tls, electors=electors) as pair:
        pod = pod_obj("p0", 1)
        for path in ("/filter", "/prioritize", "/bind", "/preemption"):
            code, _, body = pair.both("POST", path, {"Pod": pod})
            assert code == 503 and "not leader" in body["Error"]
        assert pair.both("GET", "/readyz")[:3] == (503, "text/plain",
                                                   b"standby")
        assert pair.both("GET", "/healthz")[0] == 200
        assert pair.both("GET", "/state")[2]["is_leader"] is False


class SharedLeaseServer(InMemoryApiServer):
    """One API server for both packages' electors: its lease verbs raise
    errors that are each package's NotFound and Conflict, as each
    package's REST client would report the real API server's 404 and
    409."""

    def _lease(self, verb, *args):
        try:
            return getattr(super(), verb)(*args)
        except PortNotFound as e:
            raise _NotFound(str(e)) from None
        except PortConflict as e:
            raise _Conflict(str(e)) from None

    def get_lease(self, namespace, name):
        return self._lease("get_lease", namespace, name)

    def create_lease(self, obj):
        return self._lease("create_lease", obj)

    def update_lease(self, namespace, name, obj):
        return self._lease("update_lease", namespace, name, obj)


class _NotFound(PortNotFound, JaxNotFound):
    pass


class _Conflict(PortConflict, JaxConflict):
    pass


def test_leader_election_hands_over_between_the_packages():
    """The port's elector and the JAX package's over one API server: one
    holds, the other defers while the record changes, takes over once it
    sat unchanged for the lease's duration, and takes over at once after
    a release; the lease objects either writes have the same shape."""
    api = SharedLeaseServer()
    kw = dict(name="test-lease", lease_duration_s=0.4, renew_period_s=0.1,
              retry_period_s=0.1)
    j, p = JaxLeaderElector(api, "jax", **kw), LeaderElector(api, "port", **kw)
    assert j.try_acquire_or_renew() == "ok"
    shape = sorted(api.get_lease("kube-system", "test-lease")["spec"])
    assert p.try_acquire_or_renew() == "lost"
    assert j.try_acquire_or_renew() == "ok"         # renews: record changes
    assert p.try_acquire_or_renew() == "lost"
    time.sleep(0.5)                                  # the holder went quiet
    assert p.try_acquire_or_renew() == "ok"
    lease = api.get_lease("kube-system", "test-lease")
    assert lease["spec"]["holderIdentity"] == "port"
    assert lease["spec"]["leaseTransitions"] == 1
    assert sorted(lease["spec"]) == shape
    assert j.try_acquire_or_renew() == "lost"
    p._set_held(True)
    assert p.is_leader()
    p.release()
    assert not p.is_leader()
    assert api.get_lease("kube-system", "test-lease")["spec"][
        "holderIdentity"] == ""
    assert j.try_acquire_or_renew() == "ok"
    assert api.get_lease("kube-system", "test-lease")["spec"][
        "leaseTransitions"] == 2


def test_the_resnet_gang_through_the_port_extender_and_shim():
    """``samples/jax-resnet.yaml``'s 4 pods of one card on a fabricated
    8-card GPU host: the port's extender binds the gang on a contiguous
    run of cards; the port's shim turns each pod into its container env;
    the envs equal those the same shim gives for the JAX extender's bind
    of the same cluster."""
    twin = Twin(Fleet("gpu", n=1, cards=8))
    objs = load_pods("jax-resnet.yaml")
    for o in objs:
        twin.create(o)
    for o in objs:
        assert twin.schedule(o) == "gpu-0"
    twin.assert_same()
    host = twin.fleet.hosts["gpu-0"]
    envs = {}
    for api in (twin.jax_api, twin.port_api):
        shim = ShimDaemon(api, host.provider())
        for o in objs:
            name = o["metadata"]["name"]
            stored = api.get_pod("default", name)
            inj = shim.decide("default", name, "worker",
                              stored["metadata"]["annotations"], "gpu-0")
            envs.setdefault(name, []).append((inj.env, inj.devices))
    cards = []
    for name, (want, got) in envs.items():
        assert got == want
        env = got[0]
        assert env["JAX_NUM_PROCESSES"] == "4"
        assert env["CUDA_VISIBLE_DEVICES"] == env["NVIDIA_VISIBLE_DEVICES"]
        cards.append(host.uuids.index(env["CUDA_VISIBLE_DEVICES"]))
    assert sorted(cards) == list(range(min(cards), min(cards) + 4))
    assert sorted(envs[n][0][0]["JAX_PROCESS_ID"] for n in envs) == [
        "0", "1", "2", "3"]


def test_fake_cluster_presets():
    api = build_fake_cluster("2x-h100-8")
    names = sorted(n["metadata"]["name"] for n in api.list_nodes())
    assert names == ["fake-h100-8-a", "fake-h100-8-b"]
    node = annotations.node_from_k8s(api.get_node("fake-h100-8-a"))
    assert node.mesh_shape == (8,) and node.slice_id == "fake-h100-8-a"
    assert api.get_node("fake-h100-8-b")["status"]["capacity"][RES_TPU] == "8"
    with pytest.raises(SystemExit, match="GPU hosts"):
        build_fake_cluster("2x-v5e-16")
    with pytest.raises(SystemExit, match="unknown preset"):
        build_fake_cluster("h100-3")


def _listening_port(proc, deadline_s=60.0):
    """The port the server logs it listens on (``--listen host:0``)."""
    deadline = time.monotonic() + deadline_s
    seen = []
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stderr], [], [], 0.5)
        if not ready:
            if proc.poll() is not None:
                break
            continue
        line = proc.stderr.readline()
        if not line:
            break
        seen.append(line)
        m = re.search(r"extender listening on http://127\.0\.0\.1:(\d+)", line)
        if m:
            return int(m.group(1))
    raise AssertionError("server did not report its port: " + "".join(seen))


def test_entry_points_serve_and_render():
    env = dict(os.environ, PYTHONPATH=REPO)
    refused = subprocess.run(
        [sys.executable, "-m", "kubegpu_tpu_torch.scheduler.server",
         "--fake-cluster", "v5e-16"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=60)
    assert refused.returncode != 0 and "GPU hosts" in refused.stderr
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.scheduler.server",
         "--fake-cluster", "2x-h100-8", "--listen", "127.0.0.1:0"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        base = f"http://127.0.0.1:{_listening_port(proc)}"
        _, _, state = decoded(call(base, "GET", "/state"))
        assert state["nodes"] == ["fake-h100-8-a", "fake-h100-8-b"]
        pod = pod_obj("demo", 3)
        assert call(base, "POST", "/pods", pod)[0] == 200
        _, _, f = decoded(call(base, "POST", "/filter",
                               {"Pod": pod, "NodeNames": state["nodes"]}))
        assert f["NodeNames"] == state["nodes"] and not f["Error"]
        _, _, b = decoded(call(base, "POST", "/bind", {
            "PodNamespace": "default", "PodName": "demo",
            "Node": f["NodeNames"][0]}))
        assert b == {"Error": ""}
        status = subprocess.run(
            [sys.executable, "-m", "kubegpu_tpu_torch.scheduler.status",
             "--url", base], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=60)
        assert status.returncode == 0, status.stderr
        out = status.stdout
        assert f"extender {base}  nodes=2" in out
        assert "slice fake-h100-8-a  mesh 8  free 5  used 3  hosts 1" in out
        assert re.search(r"placements_total\s+1", out), out
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        proc.stderr.close()


def test_phase_70_matches_the_sample_and_rehearses_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 70 on a fabricated one-card host: its pod
    is the sample's ``decode-replica-0`` container (the port's worker,
    less the flags the phase drops, its steps cut); the gang is refused
    whole, the pod bound, its worker (here on the CPU, at a tiny width)
    runs under the shim's env, and after the delete it binds again."""
    import chip_smoke
    from kubegpu_tpu_torch.plugins.fake import FakeGpuHost

    (sample,) = [p for p in load_pods("jax-serve-gateway.yaml")
                 if p["metadata"]["name"] == "decode-replica-0"]
    command = sample["spec"]["containers"][0]["command"]
    assert command[:3] == ["python", "-m", "kubegpu_tpu.models.worker"]
    kept = [a for a in command[3:] if not a.startswith(
        ("--serve-http=", "--ckpt-dir=", "--steps="))]
    assert [a for a in chip_smoke.DECODE_REPLICA_ARGV
            if not a.startswith("--steps=")] == kept
    ann = sample["metadata"]["annotations"]
    assert chip_smoke.DECODE_REPLICA_GANG == (
        ann[annotations.POD_GROUP], int(ann[annotations.POD_GROUP_SIZE]))
    pod = chip_smoke.replica_pod("decode-replica-0", True)
    assert pod["metadata"]["annotations"] == ann
    assert (pod["spec"]["containers"][0]["resources"]
            == sample["spec"]["containers"][0]["resources"])

    host = FakeGpuHost("cpu-rehearsal", cards=1)
    tiny = ["--model=decode", "--serving=paged", "--batch-per-chip=2",
            "--prompt-len=16", "--steps=4", "--vocab=64", "--layers=2",
            "--heads=4", "--hidden=32", "--seq=64", "--device=cpu"]
    cp = chip_smoke.control_plane_bind(host.provider(), tiny)
    assert cp["env"]["CUDA_VISIBLE_DEVICES"] == host.uuids[0]
    gate = tmp_path / "built"
    chip_smoke._EARLY["pod"] = chip_smoke.worker_popen(cp["argv"], cp["env"],
                                                       str(gate))
    gate.touch()
    r = chip_smoke.phase_control_plane(cp)
    assert set(r["launches"].values()) == {0} and len(r["bind_ms"]) == 2
    assert "K1" in r["launches"] and "K2q" in r["launches"]
    assert "server" not in cp and "pod" not in chip_smoke._EARLY
