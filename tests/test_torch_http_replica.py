"""The port's replica HTTP endpoint (kubegpu_tpu_torch/gateway/
dataplane.py, the worker's ``--serve-http``) over real loopback sockets,
fronted by the JAX package's unmodified gateway side: SSE framing, bearer
auth, TLS, a JAX gateway over one JAX and one torch replica serving the
in-memory JAX data plane's streams, wire cancel and disconnect freeing
pages, shed-before-work, trace trees across the wire, ``/v1/state``
parity with a JAX replica, sampled and seed-pinned requests streaming a
JAX replica's tokens, the migration routes answering (export, import,
role; tests/test_torch_migration_http.py holds them against the JAX
package), a batcher failure ending the streams, and the worker
subprocess; and the same gateway over the dense ``ContinuousBatcher``
replicas of both packages (streams, wire cancel, ``/v1/state`` and the
migration routes answering as the JAX dense replica answers, the
worker's ``--serving continuous --serve-http``).  Tiny fp32 replicas on the CPU, as in
tests/test_http_data_plane.py; every wait is a bounded poll."""

import http.client
import json
import os
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

from kubegpu_tpu.gateway import (
    FailoverPolicy,
    Gateway,
    GatewayRequest,
    HttpReplicaClient,
    InMemoryReplicaClient,
    ReplicaServer as JaxReplicaServer,
)
from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
)
from kubegpu_tpu.models.serving import (
    ContinuousBatcher as JaxContinuousBatcher,
)
from kubegpu_tpu.testing.fake_serving import build_fake_serving_stack
from kubegpu_tpu.testing.tlsutil import make_self_signed
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu.utils.tracing import serve_retire_violations, validate_trace
from kubegpu_tpu_torch.gateway.dataplane import ReplicaServer
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import params_from_numpy
from kubegpu_tpu_torch.models.serving import ContinuousBatcher
from kubegpu_tpu_torch.utils.metrics import Metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=61, num_layers=1, num_heads=2, hidden=16, max_seq=48)
PAGED_KW = dict(slots=3, prompt_pad=12, page_size=4, pool_pages=32)
TIMING = ("t", "host_ms", "device_ms")


@pytest.fixture(scope="module")
def jax_params():
    return TransformerLM(dtype=jnp.float32, **TINY).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params))


def _torch_cb(torch_params, **over):
    return PagedContinuousBatcher(torch_params, dtype=torch.float32,
                                  device="cpu", **TINY,
                                  **dict(PAGED_KW, **over))


def _jax_cb(jax_params, **over):
    return JaxPagedContinuousBatcher(jax_params, dtype=jnp.float32, **TINY,
                                     **dict(PAGED_KW, **over))


def _req(rid, prompt, max_new, **kw):
    return types.SimpleNamespace(
        request_id=rid, prompt=[int(t) for t in prompt],
        max_new_tokens=max_new, temperature=kw.pop("temperature", 0.0),
        session=None, **kw,
    )


def _wait(cond, timeout=45.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def _prompts():
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 61, size=rs.randint(3, 12)).astype(np.int32)
               for _ in range(6)]
    return prompts, [6, 10, 4, 8, 5, 12]


def _post(srv, path, body, headers=None, timeout=30.0):
    """One raw POST; returns (status, parsed SSE events or JSON)."""
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body),
                     dict({"Content-Type": "application/json"},
                          **(headers or {})))
        r = conn.getresponse()
        raw = r.read().decode()
        if r.getheader("Content-Type") == "text/event-stream":
            return r.status, _sse(raw)
        return r.status, json.loads(raw)
    finally:
        conn.close()


def _get(srv, path, headers=None):
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=30.0)
    try:
        conn.request("GET", path, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def _sse(text):
    events, ev = [], None
    for line in text.splitlines():
        if line.startswith("event:"):
            ev = line[6:].strip()
        elif line.startswith("data:") and ev:
            events.append((ev, json.loads(line[5:].strip())))
            ev = None
    return events


# ---------------------------------------------------------------------------
# the wire: framing, auth, TLS
# ---------------------------------------------------------------------------

def test_sse_streams_incremental_batches_then_done(torch_params):
    prompt, budget = np.array([4, 9, 16, 25, 36], np.int32), 12
    want = _torch_cb(torch_params).run([prompt], [budget])[0]
    cb = _torch_cb(torch_params)
    srv = ReplicaServer(cb, step_delay_s=0.005).start()
    client = HttpReplicaClient(endpoints={"r0": srv.endpoint})
    try:
        deltas = []
        a = client.submit("r0", _req(
            "rq", prompt, budget, on_tokens=lambda at, d: deltas.append(d)))
        assert a.wait(45) and a.result().ok, a.result()
        assert a.result().tokens == want
        assert sum(deltas, []) == want
        assert len(deltas) > 1, deltas
        # the raw frames: tokens events, then exactly one done at the end
        status, events = _post(srv, "/v1/submit", {
            "request_id": "raw", "prompt": prompt.tolist(),
            "max_new_tokens": budget})
        assert status == 200
        kinds = [k for k, _ in events]
        assert kinds[-1] == "done" and set(kinds[:-1]) == {"tokens"}
        done = events[-1][1]
        assert sum((e["tokens"] for k, e in events[:-1]), []) == want
        assert done["tokens"] == want
        assert set(done) == {"tokens", "spans", "t_recv"}
    finally:
        client.stop()
        srv.stop()


def test_bearer_auth_gates_v1_verbs(torch_params):
    srv = ReplicaServer(_torch_cb(torch_params), auth_token="tok").start()
    good = HttpReplicaClient(endpoints={"r": srv.endpoint}, auth_token="tok")
    bad = HttpReplicaClient(endpoints={"r": srv.endpoint})
    try:
        a = bad.submit("r", _req("x", [1, 2], 4))
        assert a.wait(30), "401 attempt hung"
        assert not a.result().ok and "401" in a.result().error
        assert bad._get_state("r") is None
        ok, why = bad.probe(types.SimpleNamespace(key="r", addr=None))
        assert ok, why
        a = good.submit("r", _req("y", [1, 2], 4))
        assert a.wait(30) and a.result().ok, a.result()
        assert good._get_state("r")["slots"] == 3
        assert _get(srv, "/metrics")[0] == 200
        assert _get(srv, "/v1/state")[0] == 401
        assert _get(srv, "/v1/state",
                    {"Authorization": "Bearer tok"})[0] == 200
    finally:
        good.stop()
        bad.stop()
        srv.stop()


def test_tls_and_auth_stream_token_identical(torch_params, tmp_path):
    cert, key = make_self_signed(str(tmp_path))
    with pytest.raises(ValueError, match="together"):
        ReplicaServer(_torch_cb(torch_params), tls_cert=cert)
    prompt = [3, 1, 4, 1, 5]
    want = _torch_cb(torch_params).run([np.array(prompt, np.int32)], [7])[0]
    srv = ReplicaServer(_torch_cb(torch_params), tls_cert=cert, tls_key=key,
                        auth_token="tok").start()
    client = HttpReplicaClient(endpoints={"r": srv.endpoint}, tls_ca=cert,
                               auth_token="tok")
    try:
        assert srv.tls
        deltas = []
        a = client.submit("r", _req("t", prompt, 7,
                                    on_tokens=lambda at, d: deltas.append(d)))
        assert a.wait(45) and a.result().ok, a.result()
        assert a.result().tokens == sum(deltas, []) == want
        assert client._get_state("r")["tp"] == 1
        ok, why = client.probe(types.SimpleNamespace(key="r", addr=None))
        assert ok, why
    finally:
        client.stop()
        srv.stop()


# ---------------------------------------------------------------------------
# the gate: a JAX gateway over a JAX and a torch replica
# ---------------------------------------------------------------------------

def _drive_gateway(make_client, prompts, budgets, n_replicas=2):
    stack = build_fake_serving_stack(n_replicas)
    registry = stack.registry
    registry.refresh()
    client, servers = make_client(registry)
    registry.subscribe(client.sync_live)
    registry.refresh()
    gw = Gateway(registry, client, metrics=JaxMetrics(), dispatchers=4,
                 policy=FailoverPolicy(deadline_s=60.0, hedge_after_s=30.0))
    gw.start()
    try:
        pendings = [gw.submit(GatewayRequest(
            prompt=[int(t) for t in p], max_new_tokens=m,
            request_id=f"r{i}")) for i, (p, m) in enumerate(zip(prompts,
                                                               budgets))]
        assert gw.drain(120.0)
        out = {}
        for i, p in enumerate(pendings):
            r = p.result()
            assert r.status == "ok", (i, r.status, r.error)
            out[i] = r.tokens
        return out
    finally:
        gw.stop()
        client.stop()
        for srv in servers:
            srv.stop()


def test_jax_gateway_fronts_a_jax_and_a_torch_replica(jax_params,
                                                      torch_params):
    prompts, budgets = _prompts()
    servers = {}

    def mixed(registry):
        client = HttpReplicaClient()
        made = []
        for rep, kind in zip(registry.live(), ("jax", "torch")):
            if kind == "jax":
                srv = JaxReplicaServer(_jax_cb(jax_params),
                                       step_delay_s=0.02).start()
            else:
                srv = ReplicaServer(_torch_cb(torch_params),
                                    step_delay_s=0.02).start()
            servers[kind] = srv
            made.append(srv)
            client.set_endpoint(rep.key, srv.endpoint)
        return client, made

    def inmemory(registry):
        client = InMemoryReplicaClient(
            batcher_factory=lambda key: _jax_cb(jax_params))
        for rep in registry.live():
            client.add_replica(rep.key)
        return client, []

    states = {}

    def mixed_with_states(registry):
        client, made = mixed(registry)
        orig_stop = client.stop

        def stop():
            for kind, srv in servers.items():
                states[kind] = json.loads(_get(srv, "/v1/state")[1])
            orig_stop()

        client.stop = stop
        return client, made

    over_wire = _drive_gateway(mixed_with_states, prompts, budgets)
    in_memory = _drive_gateway(inmemory, prompts, budgets)
    assert over_wire == in_memory
    for kind in ("jax", "torch"):
        assert states[kind]["stats"]["admits"] >= 1, (kind, states)
    assert (states["jax"]["stats"]["admits"]
            + states["torch"]["stats"]["admits"]) == len(prompts)


def test_both_replicas_stream_alike_and_report_equal_state(jax_params,
                                                          torch_params):
    """Each prompt submitted straight to a JAX and a torch replica
    through ``HttpReplicaClient.submit`` streams the same tokens; after
    the same traffic, one request at a time, plus a second turn that
    extends a first turn's stream, both replicas report the same
    ``/v1/state`` (ledger included), timing fields aside."""
    prompts, budgets = _prompts()
    over = dict(decode_page_cache="fp32")
    jsrv = JaxReplicaServer(_jax_cb(jax_params, **over)).start()
    tsrv = ReplicaServer(_torch_cb(torch_params, **over)).start()
    client = HttpReplicaClient(endpoints={"jax": jsrv.endpoint,
                                          "torch": tsrv.endpoint})

    def both(rid, prompt, budget):
        got = {}
        for key in ("jax", "torch"):
            deltas = []
            a = client.submit(key, _req(
                f"{key}-{rid}", prompt, budget,
                on_tokens=lambda at, d: deltas.append(d)))
            assert a.wait(45) and a.result().ok, (key, a.result())
            assert sum(deltas, []) == a.result().tokens
            got[key] = a.result().tokens
        assert got["torch"] == got["jax"] and len(got["jax"]) == budget
        return got["torch"]

    try:
        outs = [both(i, p, m) for i, (p, m) in enumerate(zip(prompts,
                                                             budgets))]
        longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
        turn2 = np.concatenate([prompts[longest], outs[longest]])[:12]
        both("turn2", turn2, 5)
        _wait(lambda: jsrv.loop.active_streams() == 0
              and tsrv.loop.active_streams() == 0)
        want = json.loads(_get(jsrv, "/v1/state?ledger=400")[1])
        got = json.loads(_get(tsrv, "/v1/state?ledger=400")[1])
    finally:
        client.stop()
        jsrv.stop()
        tsrv.stop()
    ledger_w, ledger_g = want.pop("ledger"), got.pop("ledger")
    assert got == want
    assert sum(got["prefix_cache"]["hit_tokens"].values()) > 0
    assert got["stats"]["decode_pages_sealed"] > 0
    assert len(ledger_g) == len(ledger_w) > 0
    for rw, rg in zip(ledger_w, ledger_g):
        assert ({k: v for k, v in rg.items() if k not in TIMING}
                == {k: v for k, v in rw.items() if k not in TIMING})


# ---------------------------------------------------------------------------
# cancel, disconnect, deadline
# ---------------------------------------------------------------------------

def test_midstream_wire_cancel_frees_pages(torch_params):
    cb = _torch_cb(torch_params)
    srv = ReplicaServer(cb, step_delay_s=0.03).start()
    client = HttpReplicaClient(endpoints={"r0": srv.endpoint})
    try:
        idle = json.loads(_get(srv, "/v1/state")[1])
        deltas = []
        a = client.submit("r0", _req(
            "long", [1, 2, 3], 40, on_tokens=lambda at, d: deltas.append(d)))
        _wait(lambda: deltas, msg="first streamed tokens")
        client.cancel(a)
        assert a.wait(30), "cancel did not resolve the attempt"
        assert not a.result().ok
        _wait(lambda: not cb.has_work(), msg="replica idle after cancel")
        assert sum(len(d) for d in deltas) < 40
        _wait(lambda: srv.metrics.get("replica_http_cancels_total") >= 1,
              msg="the wire cancel counted")
        state = json.loads(_get(srv, "/v1/state")[1])
        assert state["active_streams"] == 0
        assert "pages" not in idle or state["pages"]["live"] == 0
    finally:
        srv.stop()
        client.stop()
    cb.assert_page_accounting()


def test_vanished_client_cancels_its_sequence(torch_params):
    cb = _torch_cb(torch_params)
    srv = ReplicaServer(cb, step_delay_s=0.03).start()
    try:
        host, port = srv.address
        s = socket.create_connection((host, port), timeout=30)
        body = json.dumps({"request_id": "vanish", "prompt": [4, 5, 6],
                           "max_new_tokens": 40}).encode()
        s.sendall(b"POST /v1/submit HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(body) + body)
        s.recv(256)   # response headers arrived: the stream is live
        _wait(lambda: cb.stats["steps"] > 0, msg="decoding started")
        s.close()     # vanish: no /v1/cancel, no clean shutdown
        _wait(lambda: not cb.has_work(),
              msg="replica cancelled the abandoned stream")
        _wait(lambda: srv.metrics.get(
            "replica_http_disconnect_cancels_total") >= 1,
            msg="the disconnect cancel counted")
    finally:
        srv.stop()
    cb.assert_page_accounting()


def test_expired_deadline_is_refused_before_admission(torch_params):
    cb = _torch_cb(torch_params)
    srv = ReplicaServer(cb).start()
    try:
        status, events = _post(srv, "/v1/submit", {
            "request_id": "late", "prompt": [1, 2, 3], "max_new_tokens": 4,
            "deadline_s": 0.0})
        assert status == 200
        (kind, payload), = events
        assert kind == "error" and "deadline expired" in payload["error"]
        assert srv.metrics.get("replica_http_expired_refusals_total") == 1
        status, events = _post(srv, "/v1/submit", {
            "request_id": "ok", "prompt": [1, 2, 3], "max_new_tokens": 4,
            "deadline_s": 60.0})
        assert events[-1][0] == "done"
    finally:
        srv.stop()
    assert cb.stats["admits"] == 1


# ---------------------------------------------------------------------------
# traces across the wire
# ---------------------------------------------------------------------------

def test_trace_tree_spans_jax_gateway_and_torch_replica(torch_params):
    stack = build_fake_serving_stack(1)
    registry = stack.registry
    registry.refresh()
    srv = ReplicaServer(_torch_cb(torch_params)).start()
    client = HttpReplicaClient()
    client.set_endpoint(registry.live()[0].key, srv.endpoint)
    gw = Gateway(registry, client, metrics=JaxMetrics(), dispatchers=2)
    gw.start()
    try:
        p = gw.submit(GatewayRequest(prompt=[1, 2, 3, 4, 5, 6, 7],
                                     max_new_tokens=5, request_id="traced"))
        assert gw.drain(60.0) and p.result().status == "ok"
        assert gw.tracer.wait_quiescent(30.0)
        spans = next(
            s for s in gw.tracer.completed()
            if any(x["attrs"].get("request_id") == "traced" for x in s
                   if x["parent"] is None))
        problems = validate_trace(spans) + serve_retire_violations(spans)
        assert not problems, problems
        by_id = {s["span"]: s for s in spans}
        serve = next(s for s in spans if s["name"] == "serve")
        assert serve["attrs"].get("remote") is True
        hop = by_id[serve["parent"]]
        assert hop["name"] == "replica_request"
        dispatch = by_id[hop["parent"]]
        assert dispatch["name"] == "dispatch"
        assert not dispatch["attrs"].get("remote")
        names = {s["name"] for s in spans if s["attrs"].get("remote")}
        assert {"serve", "queue", "station_wait", "prefill", "chunk",
                "decode", "retire"} <= names
        decode = next(s for s in spans if s["name"] == "decode")
        assert "first_token_t" in decode["attrs"]
    finally:
        gw.stop()
        client.stop()
        srv.stop()


# ---------------------------------------------------------------------------
# sampled requests
# ---------------------------------------------------------------------------

def _gateway_one(srv, request):
    """Serve one ``GatewayRequest`` through a JAX gateway whose only
    replica is ``srv``; returns the result."""
    stack = build_fake_serving_stack(1)
    stack.registry.refresh()
    client = HttpReplicaClient()
    rep, = stack.registry.live()
    client.set_endpoint(rep.key, srv.endpoint)
    stack.registry.subscribe(client.sync_live)
    stack.registry.refresh()
    gw = Gateway(stack.registry, client, metrics=JaxMetrics(),
                 policy=FailoverPolicy(deadline_s=60.0, hedge_after_s=30.0))
    gw.start()
    try:
        pending = gw.submit(request)
        assert gw.drain(60.0)
        return pending.result()
    finally:
        gw.stop()
        client.stop()


SAMPLED_SPEC = dict(speculate_k=2, sampling=True, draft_num_layers=1,
                    draft_num_heads=2, draft_hidden=16)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
@pytest.mark.parametrize("extra", [dict(temperature=0.8),
                                   dict(temperature=1.1, seed=3)],
                         ids=["temperature", "seed"])
def test_sampled_request_streams_the_jax_replicas_tokens(
        jax_params, torch_params, extra, spec):
    """A sampled request — a temperature alone (keys from the replica's
    root key and seq id) or pinned to a seed — through a JAX gateway to a
    torch replica streams the tokens the same request streams from a JAX
    replica at fp32; afterwards both replicas report the same
    ``/v1/state``, and a speculative replica's verifies fill the
    ``serve_spec_accept_rate{mode="sampled"}`` series of both alike."""
    prompt, budget = [7, 1, 30, 2, 59, 11], 9
    jover = tover = {}
    if spec:
        jover = dict(SAMPLED_SPEC, draft_params=jax_params)
        tover = dict(SAMPLED_SPEC, draft_params=torch_params)
    jm, tm = JaxMetrics(), Metrics()
    servers = {"jax": JaxReplicaServer(_jax_cb(jax_params, metrics=jm,
                                               **jover)),
               "torch": ReplicaServer(_torch_cb(torch_params, metrics=tm,
                                                **tover))}
    results, states = {}, {}
    for kind, srv in servers.items():
        srv.start()
        try:
            results[kind] = _gateway_one(srv, GatewayRequest(
                prompt=prompt, max_new_tokens=budget, request_id=kind,
                **extra))
            states[kind] = json.loads(_get(srv, "/v1/state")[1])
        finally:
            srv.stop()
    for kind, r in results.items():
        assert r.status == "ok", (kind, r.status, r.error)
        assert len(r.tokens) == budget
    assert results["torch"].tokens == results["jax"].tokens
    for state in states.values():
        state.pop("ledger", None)
    assert states["torch"] == states["jax"]
    for mode in ("sampled", "greedy"):
        n = tm.histogram_count("serve_spec_accept_rate", mode=mode)
        assert n == jm.histogram_count("serve_spec_accept_rate", mode=mode)
        assert (n > 0) == (spec and mode == "sampled")
    servers["torch"].loop.batcher.assert_page_accounting()


# ---------------------------------------------------------------------------
# the migration routes, and failures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("verb", ["export", "import", "role"])
def test_migration_routes_answer(torch_params, verb):
    """The migration verbs serve: a live export detaches its stream
    (``migrated``) and returns the payload, a live import streams the
    continuation of that payload, the role flips; each refuses a
    malformed body with a 4xx and the connection keeps working."""
    src = ReplicaServer(_torch_cb(torch_params), step_delay_s=0.02).start()
    dst = ReplicaServer(_torch_cb(torch_params)).start()
    client = HttpReplicaClient(endpoints={"src": src.endpoint})
    prompt, budget = np.array([4, 9, 16, 25, 36], np.int32), 14
    want = _torch_cb(torch_params).run([prompt], [budget])[0]
    try:
        if verb == "role":
            status, body = _post(src, "/v1/role", {"role": "prefill"})
            assert (status, body) == (200, {"role": "prefill"})
            assert json.loads(_get(src, "/v1/state")[1])["role"] == "prefill"
            assert _post(src, "/v1/role", {"role": "x"})[0] == 400
            assert _post(src, "/v1/role", {"role": "flex"})[1] == {
                "role": "flex"}
        else:
            a = client.submit("src", _req("m", prompt, budget))
            _wait(lambda: len(src.loop.control(
                lambda: src.batcher.live_tokens()).get(0, [])) >= 2,
                msg="tokens before the export")
            status, body = _post(src, "/v1/export", {"request_id": "m"})
            assert status == 200 and body["payload"]["kind"] == "live"
            assert a.wait(30) and not a.result().ok
            assert "migrated" in a.result().error
            assert _post(src, "/v1/export", {"request_id": "m"})[0] == 404
            if verb == "import":
                status, events = _post(dst, "/v1/import", {
                    "request_id": "m", "payload": body["payload"]})
                assert status == 200 and events[-1][0] == "done"
                assert events[-1][1]["tokens"] == want
                assert _post(dst, "/v1/import", {"request_id": "m"})[0] \
                    == 400
        assert _get(src, "/healthz") == (200, "ok")
    finally:
        client.stop()
        src.stop()
        dst.stop()
    src.batcher.assert_page_accounting()
    dst.batcher.assert_page_accounting()


def test_a_batcher_error_ends_every_stream(torch_params):
    """No carrying on past a failed step: the live stream ends with an
    ``error`` naming the failure, later submits are refused, and
    ``/healthz`` turns 503."""
    cb = _torch_cb(torch_params)
    real = cb.serve_step

    def failing():
        if cb.stats["steps"] >= 2:
            raise RuntimeError("kernel launch failed (injected)")
        return real()

    cb.serve_step = failing
    srv = ReplicaServer(cb).start()
    try:
        status, events = _post(srv, "/v1/submit", {
            "request_id": "a", "prompt": [1, 2, 3], "max_new_tokens": 20})
        assert status == 200
        kind, payload = events[-1]
        assert kind == "error" and "injected" in payload["error"]
        _, events = _post(srv, "/v1/submit", {
            "request_id": "b", "prompt": [1, 2], "max_new_tokens": 2})
        (kind, payload), = events
        assert kind == "error" and "injected" in payload["error"]
        status, body = _get(srv, "/healthz")
        assert status == 503 and "injected" in body
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def test_worker_serve_http_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    token = tmp_path / "token"
    token.write_text("sekrit\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker",
         "--model", "decode", "--serving", "paged", "--device", "cpu",
         "--serve-http", "0", "--vocab", "61", "--layers", "1", "--heads",
         "2", "--hidden", "16", "--seq", "47", "--prompt-len", "12",
         "--page-size", "4", "--batch-per-chip", "3", "--steps", "8",
         "--serve-fp32",
         "--serve-http-auth-token-file", str(token)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if line.startswith("REPLICA_HTTP_SERVING") or not line:
                break
        assert line.startswith("REPLICA_HTTP_SERVING"), line
        fields = dict(f.split("=", 1) for f in line.split()[1:])
        assert fields["serving"] == "paged" and fields["role"] == "flex"
        assert fields["tls"] == "0"
        srv = types.SimpleNamespace(address=("127.0.0.1",
                                             int(fields["port"])))
        status, events = _post(srv, "/v1/submit", {
            "request_id": "w", "prompt": [1, 2, 3], "max_new_tokens": 6},
            headers={"Authorization": "Bearer sekrit"})
        assert status == 200 and events[-1][0] == "done"
        assert len(events[-1][1]["tokens"]) == 6
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "REPLICA_HTTP_STOPPED" in out and "error=False" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()



# ---------------------------------------------------------------------------
# a tensor-parallel replica: two gloo ranks behind one endpoint
# ---------------------------------------------------------------------------

# TINY with a vocab that splits over two ranks
TINY_TP = dict(TINY, vocab_size=62)


def test_jax_gateway_fronts_a_torch_tp2_replica(tmp_path):
    """A JAX gateway over one torch replica served by a two-rank gang
    (rank 0 runs the ``ReplicaServer``, rank 1 replays its batcher's
    calls) serves the in-memory JAX data plane's streams at fp32, and
    the replica's ``/v1/state`` says ``tp`` 2."""
    from concurrent.futures import ThreadPoolExecutor

    import torch_tp_cases as cases
    from kubegpu_tpu_torch.parallel.launch import Gang

    jp = TransformerLM(dtype=jnp.float32, **TINY_TP).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]
    prompts, budgets = _prompts()
    spec = dict(params=jax.tree.map(np.asarray, jp), cfg=TINY_TP,
                kw=PAGED_KW)
    ctrl = tmp_path / "ctrl"
    ctrl.mkdir()
    states = []
    with Gang(2, str(tmp_path), backend="gloo", devices=["cpu"] * 2,
              timeout_s=240.0) as gang, \
            ThreadPoolExecutor(1) as pool:
        served = pool.submit(gang.run, cases.serve_http, spec, str(ctrl))
        endpoint = ctrl / "endpoint"
        _wait(lambda: endpoint.exists() or served.done(), 120.0,
              "the TP replica's endpoint")
        assert endpoint.exists(), served.result()
        try:
            def over_wire(registry):
                client = HttpReplicaClient()
                client.set_endpoint(registry.live()[0].key,
                                    endpoint.read_text())
                orig_stop = client.stop

                def stop():
                    host, port = endpoint.read_text().rsplit(":", 1)
                    srv = types.SimpleNamespace(address=(host, int(port)))
                    states.append(json.loads(_get(srv, "/v1/state")[1]))
                    orig_stop()

                client.stop = stop
                return client, []

            got = _drive_gateway(over_wire, prompts, budgets, n_replicas=1)
        finally:
            (ctrl / "stop").write_text("")
        result = served.result(timeout=120)

    def inmemory(registry):
        client = InMemoryReplicaClient(
            batcher_factory=lambda key: JaxPagedContinuousBatcher(
                jp, dtype=jnp.float32, **TINY_TP, **PAGED_KW))
        for rep in registry.live():
            client.add_replica(rep.key)
        return client, []

    assert got == _drive_gateway(inmemory, prompts, budgets, n_replicas=1)
    assert states[0]["tp"] == 2
    assert states[0]["stats"]["admits"] == len(prompts)
    assert result["tp"] == 2 and result["error"] is None


def test_worker_serve_http_tp2_subprocess(tmp_path):
    """``--serve-http 0 --tp 2 --device cpu``: the worker prints
    ``SERVING_TP``, serves a JAX gateway's request to its budget,
    reports ``tp`` 2 at ``/v1/state``, and on SIGTERM stops both ranks
    and exits 0."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker",
         "--model", "decode", "--serving", "paged", "--device", "cpu",
         "--serve-http", "0", "--tp", "2", "--vocab", "62", "--layers", "1",
         "--heads", "2", "--hidden", "16", "--seq", "47", "--prompt-len",
         "12", "--page-size", "4", "--batch-per-chip", "3", "--steps", "8",
         "--serve-fp32"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            lines.append(proc.stdout.readline())
            if lines[-1].startswith("REPLICA_HTTP_SERVING") or not lines[-1]:
                break
        assert lines[-1].startswith("REPLICA_HTTP_SERVING"), lines
        assert any(ln.startswith("SERVING_TP tp=2 devices=cpu,cpu")
                   for ln in lines), lines
        fields = dict(f.split("=", 1) for f in lines[-1].split()[1:])
        endpoint = f"127.0.0.1:{fields['port']}"

        def over_wire(registry):
            client = HttpReplicaClient()
            client.set_endpoint(registry.live()[0].key, endpoint)
            return client, []

        got = _drive_gateway(over_wire, [np.arange(1, 6, dtype=np.int32)],
                             [6], n_replicas=1)
        assert len(got[0]) == 6
        srv = types.SimpleNamespace(address=("127.0.0.1",
                                             int(fields["port"])))
        state = json.loads(_get(srv, "/v1/state")[1])
        assert state["tp"] == 2 and state["stats"]["admits"] >= 1
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "REPLICA_HTTP_STOPPED" in out and "error=False" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ---------------------------------------------------------------------------
# the dense ContinuousBatcher behind the replica
# ---------------------------------------------------------------------------

DENSE_KW = dict(slots=3, prompt_pad=12, prefill_chunk=4)


def _torch_dense(torch_params):
    return ContinuousBatcher(torch_params, dtype=torch.float32, device="cpu",
                             **TINY, **DENSE_KW)


def _jax_dense(jax_params):
    return JaxContinuousBatcher(jax_params, dtype=jnp.float32, **TINY,
                                **DENSE_KW)


def test_jax_gateway_fronts_dense_jax_and_torch_replicas(jax_params,
                                                         torch_params):
    """A JAX gateway over one JAX and one torch ContinuousBatcher replica
    serves the streams of the in-memory JAX data plane over JAX dense
    batchers, both replicas taking traffic."""
    prompts, budgets = _prompts()
    states = {}

    def mixed(registry):
        client = HttpReplicaClient()
        made = []
        for rep, kind in zip(registry.live(), ("jax", "torch")):
            srv = (JaxReplicaServer(_jax_dense(jax_params), step_delay_s=0.02)
                   if kind == "jax" else
                   ReplicaServer(_torch_dense(torch_params),
                                 step_delay_s=0.02)).start()
            made.append((kind, srv))
            client.set_endpoint(rep.key, srv.endpoint)
        orig_stop = client.stop

        def stop():
            for kind, srv in made:
                states[kind] = json.loads(_get(srv, "/v1/state")[1])
            orig_stop()

        client.stop = stop
        return client, [srv for _, srv in made]

    def inmemory(registry):
        client = InMemoryReplicaClient(
            batcher_factory=lambda key: _jax_dense(jax_params))
        for rep in registry.live():
            client.add_replica(rep.key)
        return client, []

    assert (_drive_gateway(mixed, prompts, budgets)
            == _drive_gateway(inmemory, prompts, budgets))
    for kind in ("jax", "torch"):
        assert states[kind]["stats"]["admits"] >= 1, (kind, states)
    assert (states["jax"]["stats"]["admits"]
            + states["torch"]["stats"]["admits"]) == len(prompts)


def test_dense_replica_answers_like_the_jax_dense_replica(jax_params,
                                                          torch_params):
    """The same requests, one at a time, to a JAX and a torch dense
    replica: equal streams; then ``/v1/state`` and the migration routes
    (a live export, a sealed-chain capture, a sealed import, a role
    flip) answer alike — a dense batcher speaks no migration verb."""
    prompts, budgets = _prompts()
    srvs = {"jax": JaxReplicaServer(_jax_dense(jax_params),
                                    step_delay_s=0.02).start(),
            "torch": ReplicaServer(_torch_dense(torch_params),
                                   step_delay_s=0.02).start()}
    client = HttpReplicaClient(endpoints={k: s.endpoint
                                          for k, s in srvs.items()})
    answers = {}
    try:
        for key, srv in srvs.items():
            got = []
            for i, (p, m) in enumerate(zip(prompts, budgets)):
                a = client.submit(key, _req(f"{key}-{i}", p, m))
                assert a.wait(45) and a.result().ok, (key, a.result())
                got.append(a.result().tokens)
            long = client.submit(key, _req(f"{key}-live", [1, 2, 3], 30))
            _wait(lambda: srv.loop.control(
                lambda: srv.batcher.live_tokens()), msg="a live stream")
            answers[key] = dict(
                streams=got,
                export=_post(srv, "/v1/export",
                             {"request_id": f"{key}-live"}),
                missing=_post(srv, "/v1/export", {"request_id": "nope"}),
                sealed=_post(srv, "/v1/export", {"stream": [1, 2, 3]}),
                empty=_post(srv, "/v1/export", {}),
                role=_post(srv, "/v1/role", {"role": "decode"}),
            )
            client.cancel(long)
            assert long.wait(30)
            _wait(lambda: srv.loop.active_streams() == 0)
            state = json.loads(_get(srv, "/v1/state")[1])
            answers[key]["state"] = state
    finally:
        client.stop()
        for srv in srvs.values():
            srv.stop()
    jax_side, torch_side = answers["jax"], answers["torch"]
    assert torch_side == jax_side
    assert torch_side["export"][0] == 409
    assert "migration verbs" in torch_side["export"][1]["error"]
    assert torch_side["missing"][0] == 404
    assert torch_side["sealed"] == (200, {"payload": None, "pages": 0})
    assert torch_side["state"]["stats"]["admits"] == len(prompts) + 1


def test_dense_wire_cancel_frees_the_slot(torch_params):
    cb = _torch_dense(torch_params)
    srv = ReplicaServer(cb, step_delay_s=0.03).start()
    client = HttpReplicaClient(endpoints={"r0": srv.endpoint})
    try:
        deltas = []
        a = client.submit("r0", _req(
            "long", [1, 2, 3], 40, on_tokens=lambda at, d: deltas.append(d)))
        _wait(lambda: deltas, msg="first streamed tokens")
        client.cancel(a)
        assert a.wait(30) and not a.result().ok
        _wait(lambda: not cb.has_work(), msg="replica idle after cancel")
        assert sum(len(d) for d in deltas) < 40
        assert all(s.seq_id < 0 for s in cb._slots)
        _wait(lambda: srv.metrics.get("replica_http_cancels_total") >= 1,
              msg="the wire cancel counted")
        status, events = _post(srv, "/v1/submit", {
            "request_id": "next", "prompt": [4, 5], "max_new_tokens": 3})
        assert status == 200 and events[-1][0] == "done"
        assert events[-1][1]["tokens"] == _torch_dense(torch_params).run(
            [np.array([4, 5], np.int32)], [3])[0]
    finally:
        srv.stop()
        client.stop()


def test_worker_serves_continuous_over_http(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker",
         "--model", "decode", "--serving", "continuous", "--device", "cpu",
         "--serve-http", "0", "--vocab", "61", "--layers", "1", "--heads",
         "2", "--hidden", "16", "--seq", "47", "--prompt-len", "12",
         "--batch-per-chip", "3", "--steps", "8", "--serve-fp32"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if line.startswith("REPLICA_HTTP_SERVING") or not line:
                break
        assert line.startswith("REPLICA_HTTP_SERVING"), line
        fields = dict(f.split("=", 1) for f in line.split()[1:])
        assert fields["serving"] == "continuous"
        srv = types.SimpleNamespace(address=("127.0.0.1",
                                             int(fields["port"])))
        status, events = _post(srv, "/v1/submit", {
            "request_id": "w", "prompt": [1, 2, 3], "max_new_tokens": 6})
        assert status == 200 and events[-1][0] == "done"
        assert len(events[-1][1]["tokens"]) == 6
        state = json.loads(_get(srv, "/v1/state")[1])
        assert state["stats"]["admits"] == 1 and "pages" not in state
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "REPLICA_HTTP_STOPPED" in out and "error=False" in out
        assert "K1_LAUNCHES=0" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
