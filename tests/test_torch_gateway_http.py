"""The port's gateway over HTTP (``kubegpu_tpu_torch/gateway/server.py``
and the gateway half of ``dataplane.py``, ``HttpReplicaClient``) held
against the JAX package's on the CPU, over real loopback sockets:

- the port's ``GatewayServer`` in front of the port's ``ReplicaServer``
  (a tiny fp32 ``PagedContinuousBatcher`` on weights from
  ``params_from_numpy``) against the JAX ``GatewayServer`` in front of
  the JAX ``ReplicaServer`` on the same weights: the same JSON and SSE
  token streams, the same ``/readyz`` answers as the replica comes up
  and goes away, the same ``/metrics`` series and counts, and
  ``/debug/trace`` trees that pass ``validate_trace`` with the same
  spans;
- TLS and the bearer token both ways: the port's gateway in front of a
  JAX replica, a JAX gateway in front of the port's replica;
- ``python -m kubegpu_tpu_torch.gateway.server --replica-endpoint``:
  the announce line, one stream with the replica's own tokens, exit 0
  on SIGTERM after its drain;
- given the same endpoint list (in any order), the port's gateway and
  the JAX gateway route every session to the same endpoint under
  ``--router consistent-hash``;
- ``--help`` lists the JAX gateway's flags; ``--fake-cluster 2x-h100-4``
  serves; ``--autoscale`` and a TPU preset are refused before any
  listener opens.

Every comparison is exact; every wait is a bounded poll."""

import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubegpu_tpu.gateway as jax_gw
import kubegpu_tpu_torch.gateway as port_gw
from kubegpu_tpu.gateway import server as jax_server
from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
)
from kubegpu_tpu.testing.fake_serving import (
    build_fake_serving_stack as jax_stack,
)
from kubegpu_tpu.testing.tlsutil import make_self_signed
from kubegpu_tpu.utils import tracing as jax_tracing
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu_torch.gateway import server as port_server
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import params_from_numpy
from kubegpu_tpu_torch.testing.fake_serving import (
    build_fake_serving_stack as port_stack,
)
from kubegpu_tpu_torch.utils import tracing as port_tracing
from kubegpu_tpu_torch.utils.metrics import Metrics as PortMetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=61, num_layers=1, num_heads=2, hidden=16, max_seq=48)
PAGED_KW = dict(slots=3, prompt_pad=12, page_size=4, pool_pages=32)
WAIT_S = 60.0


@pytest.fixture(scope="module")
def jax_params():
    return TransformerLM(dtype=jnp.float32, **TINY).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params))


def torch_cb(torch_params):
    return PagedContinuousBatcher(torch_params, dtype=torch.float32,
                                  device="cpu", **TINY, **PAGED_KW)


def jax_cb(jax_params):
    return JaxPagedContinuousBatcher(jax_params, dtype=jnp.float32, **TINY,
                                     **PAGED_KW)


def wait_for(predicate, timeout=WAIT_S, what="condition"):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def http_call(address, method, path, body=None, timeout=WAIT_S):
    """(status, content type, body text) of one request."""
    conn = http.client.HTTPConnection(*address, timeout=timeout)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read().decode()
    finally:
        conn.close()


def sse(text: str) -> list:
    events, ev = [], None
    for line in text.splitlines():
        if line.startswith("event:"):
            ev = line[6:].strip()
        elif line.startswith("data:") and ev:
            events.append((ev, json.loads(line[5:].strip())))
            ev = None
    return events


def generate(address, body) -> tuple:
    """One ``/v1/generate``: (status, answer without its random id)."""
    status, ctype, text = http_call(address, "POST", "/v1/generate", body)
    if ctype == "text/event-stream":
        events = sse(text)
        for _, payload in events:
            payload.pop("request_id", None)
        return status, events
    payload = json.loads(text)
    payload.pop("request_id", None)
    return status, payload


def series(text: str) -> dict:
    """The ``gateway_*`` samples of an exposition but wall-time ones."""
    out = {}
    for line in text.splitlines():
        if not line.startswith("gateway_"):
            continue
        name, _, value = line.rpartition(" ")
        if "_sum" in name.split("{")[0] or "quantile=" in name:
            continue
        out[name] = float(value)
    return out


def prompts():
    rs = np.random.RandomState(11)
    return [rs.randint(0, 61, size=int(rs.randint(3, 12))).tolist()
            for _ in range(5)], [6, 9, 4, 8, 11]


def flatten(tree) -> list:
    out, stack = [], [tree]
    while stack:
        node = stack.pop()
        stack.extend(node.get("children", []))
        if node.get("name") not in (None, "__orphans__", "__no_root__"):
            out.append({k: v for k, v in node.items() if k != "children"})
    return out


def gateway_run(name, params) -> dict:
    """A package's GatewayServer in front of its ReplicaServer, through
    a replica's life: the answers of its routes."""
    if name == "port":
        gw_mod, stack_fn, srv_mod, metrics = (
            port_gw, port_stack, port_server, PortMetrics())
        replica = port_gw.ReplicaServer(torch_cb(params["torch"]),
                                        step_delay_s=0.005)
    else:
        gw_mod, stack_fn, srv_mod, metrics = (
            jax_gw, jax_stack, jax_server, JaxMetrics())
        replica = jax_gw.ReplicaServer(jax_cb(params["jax"]),
                                       step_delay_s=0.005)
    stack = stack_fn(1)
    registry = stack.registry
    client = gw_mod.HttpReplicaClient()
    registry.probe = client.probe
    registry.subscribe(client.sync_live)
    gateway = gw_mod.Gateway(
        registry, client, metrics=metrics, dispatchers=2,
        queue=gw_mod.AdmissionQueue(16),
        policy=gw_mod.FailoverPolicy(deadline_s=20.0, hedge_after_s=3600.0))
    server = srv_mod.GatewayServer(gateway, listen=("127.0.0.1", 0),
                                   refresh_interval_s=3600.0)
    server.start()
    addr = server.address
    out = {"readyz": []}
    try:
        out["readyz"].append(http_call(addr, "GET", "/readyz")[::2])
        replica.start()
        (key,) = [r.key for r in registry.all()]
        client.set_endpoint(key, replica.endpoint)

        def ready():
            # the failed probe backs off before it probes again
            registry.refresh()
            return http_call(addr, "GET", "/readyz")[0] == 200

        wait_for(ready, what="the replica's probe")
        out["readyz"].append(http_call(addr, "GET", "/readyz")[::2])
        ps, budgets = prompts()
        out["json"] = [generate(addr, {"prompt": p, "max_new_tokens": m})
                       for p, m in zip(ps[:3], budgets[:3])]
        out["sse"] = [generate(addr, {"prompt": p, "max_new_tokens": m,
                                      "stream": True})
                      for p, m in zip(ps[3:], budgets[3:])]
        out["bad"] = [generate(addr, {"prompt": []}),
                      http_call(addr, "POST", "/v1/other", {})[0]]
        assert gateway.tracer.wait_quiescent(30.0)
        trace = json.loads(http_call(addr, "GET", "/debug/trace?n=10")[2])
        out["traces"] = [flatten(t) for t in trace["traces"]]
        out["trace_meta"] = (trace["tracing"], trace["open_traces"],
                             len(trace["traces"]))
        state = json.loads(http_call(addr, "GET", "/state")[2])
        out["state"] = {k: state[k] for k in (
            "queue_depth", "in_flight", "outcomes", "completed_by_replica",
            "draining_replicas")}
        replica.stop()
        registry.refresh()
        out["readyz"].append(http_call(addr, "GET", "/readyz")[::2])
        out["metrics"] = series(http_call(addr, "GET", "/metrics")[2])
        out["healthz"] = http_call(addr, "GET", "/healthz")[::2]
    finally:
        server.stop()
        client.stop()
        replica.stop()
    return out


def test_port_gateway_over_port_replica_equals_jax_over_jax(jax_params,
                                                            torch_params):
    params = {"jax": jax_params, "torch": torch_params}
    want = gateway_run("jax", params)
    got = gateway_run("port", params)
    ps, budgets = prompts()
    oracle = torch_cb(torch_params).run(
        [np.asarray(p, np.int32) for p in ps], budgets)
    for i, (status, payload) in enumerate(got["json"]):
        assert status == 200 and payload["tokens"] == oracle[i], payload
    for i, (status, events) in enumerate(got["sse"]):
        assert status == 200 and events[-1][0] == "done"
        streamed = sum((p["tokens"] for e, p in events[:-1]), [])
        assert streamed == events[-1][1]["tokens"] == oracle[3 + i]
    for key in ("json", "readyz", "bad", "trace_meta", "state", "metrics",
                "healthz"):
        assert got[key] == want[key], key
    # the SSE framing may batch tokens differently: the stream and the
    # final answer are what must agree
    for (gs, ge), (ws, we) in zip(got["sse"], want["sse"]):
        assert gs == ws and ge[-1] == we[-1]
        assert (sum((p["tokens"] for _, p in ge[:-1]), [])
                == sum((p["tokens"] for _, p in we[:-1]), []))
    assert [s for s, _ in got["readyz"]] == [503, 200, 503]
    assert got["metrics"]['gateway_requests_total{outcome="ok"}'] == 5
    for spans_port, spans_jax in zip(got["traces"], want["traces"]):
        for spans in (spans_port, spans_jax):
            assert not port_tracing.validate_trace(spans)
            assert not jax_tracing.validate_trace(spans)
            assert not jax_tracing.serve_retire_violations(spans)
        assert (sorted(s["name"] for s in spans_port)
                == sorted(s["name"] for s in spans_jax))
    names = {s["name"] for s in got["traces"][0]}
    assert {"gateway_request", "dispatch", "replica_request", "serve",
            "decode", "retire"} <= names


@pytest.mark.parametrize("gateway_pkg", ["port", "jax"])
def test_tls_and_bearer_token_both_ways(jax_params, torch_params, tmp_path,
                                        gateway_pkg):
    """The port's gateway in front of a JAX replica, and a JAX gateway in
    front of the port's, over HTTPS with the bearer token."""
    cert, key = make_self_signed(str(tmp_path))
    prompt = [3, 1, 4, 1, 5]
    want = torch_cb(torch_params).run([np.asarray(prompt, np.int32)],
                                      [7])[0]
    if gateway_pkg == "port":
        gw_mod, stack_fn, metrics = port_gw, port_stack, PortMetrics()
        replica = jax_gw.ReplicaServer(jax_cb(jax_params), tls_cert=cert,
                                       tls_key=key, auth_token="tok")
    else:
        gw_mod, stack_fn, metrics = jax_gw, jax_stack, JaxMetrics()
        replica = port_gw.ReplicaServer(torch_cb(torch_params),
                                        tls_cert=cert, tls_key=key,
                                        auth_token="tok")
    replica.start()
    stack = stack_fn(1)
    stack.registry.refresh()
    (rep,) = stack.registry.all()
    results = {}
    try:
        for token in ("tok", "wrong"):
            client = gw_mod.HttpReplicaClient(tls_ca=cert, auth_token=token)
            client.set_endpoint(rep.key, replica.endpoint)
            ok, why = client.probe(types.SimpleNamespace(key=rep.key,
                                                         addr=None))
            assert ok, why               # /healthz stays open
            gateway = gw_mod.Gateway(
                stack.registry, client, metrics=metrics, dispatchers=1,
                policy=gw_mod.FailoverPolicy(deadline_s=30.0,
                                             hedge_after_s=3600.0,
                                             max_attempts=1))
            gateway.start()
            deltas = []
            request = gw_mod.GatewayRequest(prompt=prompt, max_new_tokens=7,
                                            request_id=f"tls-{token}")
            request.on_tokens = lambda attempt, d: deltas.append(list(d))
            pending = gateway.submit(request)
            try:
                assert pending.wait(WAIT_S)
                results[token] = (pending.result(), sum(deltas, []))
            finally:
                gateway.stop()
                client.stop()
    finally:
        replica.stop()
    good, streamed = results["tok"]
    assert good.status == "ok" and good.tokens == streamed == want
    bad, _ = results["wrong"]
    assert bad.status == "error" and "401" in bad.error, bad


def start_gateway(pkg: str, args: list) -> tuple:
    """``python -m <pkg>.gateway.server ARGS`` in a subprocess, once it
    announces its port: (process, (host, port))."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.gateway.server",
         "--listen", "127.0.0.1:0", *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                           JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line.startswith("GATEWAY_HTTP_SERVING port="):
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(line + out + err[-3000:])
    return proc, ("127.0.0.1", int(line.split("=")[1]))


def stop_gateway(proc) -> tuple:
    proc.send_signal(signal.SIGTERM)
    try:
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, err


def test_replica_endpoint_gateway_subprocess(torch_params):
    replica = port_gw.ReplicaServer(torch_cb(torch_params)).start()
    prompt, budget = [5, 9, 2, 6, 5, 3], 9
    want = torch_cb(torch_params).run([np.asarray(prompt, np.int32)],
                                      [budget])[0]
    proc = None
    try:
        proc, addr = start_gateway("kubegpu_tpu_torch", [
            "--replica-endpoint", replica.endpoint, "--drain-grace", "10"])
        wait_for(lambda: http_call(addr, "GET", "/readyz")[0] == 200,
                 what="the gateway's /readyz")
        status, events = generate(addr, {"prompt": prompt,
                                         "max_new_tokens": budget,
                                         "stream": True})
        assert status == 200 and events[-1][0] == "done", events
        assert sum((p["tokens"] for _, p in events[:-1]), []) == want
        assert events[-1][1]["tokens"] == want
        assert events[-1][1]["replica"] == "default/dec-0"
        rc, err = stop_gateway(proc)
        assert rc == 0, err[-3000:]
        assert "drain complete" in err
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
        replica.stop()


def test_same_endpoints_route_sessions_alike():
    """Three SimBatcher replicas behind the port's gateway and the JAX
    gateway, each given the endpoints in another order, consistent-hash
    routing: every session reaches the same endpoint through both."""
    replicas = [port_gw.ReplicaServer(port_gw.SimBatcher(slots=4)).start()
                for _ in range(3)]
    endpoints = [r.endpoint for r in replicas]
    procs = []
    try:
        answers = {}
        for pkg, order in (("kubegpu_tpu_torch", endpoints),
                           ("kubegpu_tpu", endpoints[::-1])):
            args = ["--router", "consistent-hash"]
            for e in order:
                args += ["--replica-endpoint", e]
            proc, addr = start_gateway(pkg, args)
            procs.append(proc)
            wait_for(lambda: http_call(addr, "GET", "/readyz")[0] == 200,
                     what=f"{pkg}'s /readyz")
            answers[pkg] = [generate(addr, {
                "prompt": [s, 7, 1], "max_new_tokens": 4,
                "session": f"sess-{s}"}) for s in range(12)]
            rc, err = stop_gateway(proc)
            assert rc == 0, err[-3000:]
        assert answers["kubegpu_tpu_torch"] == answers["kubegpu_tpu"]
        used = {a[1]["replica"] for a in answers["kubegpu_tpu"]}
        assert len(used) >= 2, used
        # each endpoint served exactly the sessions its key was routed:
        # keys go to the endpoints in sorted order
        admits = [json.loads(http_call(r.address, "GET", "/v1/state")[2])
                  ["stats"]["admits"]
                  for r in sorted(replicas, key=lambda r: r.endpoint)]
        keys = [f"default/dec-{i}" for i in range(3)]
        want = [2 * sum(a[1]["replica"] == k
                        for a in answers["kubegpu_tpu"]) for k in keys]
        assert admits == want
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        for r in replicas:
            r.stop()


def flags_of(main) -> set:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    return set(re.findall(r"(?<![\w-])(--[a-z][a-z0-9-]*[a-z0-9])",
                          buf.getvalue()))


def test_help_lists_the_jax_gateways_flags():
    flags = flags_of(port_server.main)
    assert flags == flags_of(jax_server.main)
    assert {"--autoscale", "--replica-endpoint", "--session-store",
            "--prefix-tier", "--router", "--replica-tls-ca"} <= flags
    # --autoscale and its eleven --autoscale-* knobs
    assert len([f for f in flags if f.startswith("--autoscale")]) == 12


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("argv,match", [
    (["--fake-cluster", "h100-8", "--autoscale"], "fleet controller"),
    (["--autoscale", "--autoscale-min", "2"], "fleet controller"),
    (["--fake-cluster", "v5e-16"], "TPU slice"),
])
def test_refusals_before_any_listener(argv, match):
    port = free_port()
    with pytest.raises(SystemExit, match=match):
        port_server.main(["--listen", f"127.0.0.1:{port}", *argv])
    with socket.socket() as s:       # nothing was left listening there
        s.bind(("127.0.0.1", port))


def test_fake_cluster_gateway_serves():
    proc, addr = start_gateway("kubegpu_tpu_torch",
                               ["--fake-cluster", "2x-h100-4",
                                "--replicas", "3"])
    try:
        wait_for(lambda: http_call(addr, "GET", "/readyz")[0] == 200,
                 what="the gateway's /readyz")
        status, payload = generate(addr, {"prompt": [1, 2, 3],
                                          "max_new_tokens": 5})
        assert status == 200 and len(payload["tokens"]) == 5, payload
        state = json.loads(http_call(addr, "GET", "/state")[2])
        assert [r["key"] for r in state["replicas"]] == [
            "default/decode-0", "default/decode-1", "default/decode-2"]
        assert {r["node"] for r in state["replicas"]} <= {
            "fake-h100-4-a", "fake-h100-4-b"}
        assert all(len(r["chips"][0]) == 1 for r in state["replicas"])
        rc, err = stop_gateway(proc)
        assert rc == 0, err[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
