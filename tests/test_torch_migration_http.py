"""The port's migration verbs over the wire (kubegpu_tpu_torch/gateway/
dataplane.py, the worker's ``--role`` and ``--serve-http-fail-migration``),
fronted by the JAX package's unmodified gateway side, at float32 on the
CPU.

- The KV wire codec: the port's ``encode_kv_payload`` writes the JAX
  codec's bytes for float32, bfloat16 and int8 pages and float32 scales,
  and each side decodes the other's wire; a bfloat16 pool's pages cross
  between the packages over the wire bit for bit.
- A JAX ``Gateway`` with ``HttpReplicaClient`` drains a torch replica
  into a JAX one by transfer: the importer counts one import and its
  pages, never prefills, and the stream equals the un-migrated one.
- A disaggregated handoff over HTTP in each direction (torch prefill to
  JAX decode and the reverse) equals the co-located stream.
- The role surface, the sealed-chain and live import routes, the chaos
  knob refusing with nothing imported, and the worker subprocess
  advertising its role.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubegpu_tpu.gateway import (
    FailoverPolicy,
    Gateway,
    GatewayRequest,
    HttpReplicaClient,
    ReplicaServer as JaxReplicaServer,
)
from kubegpu_tpu.gateway import dataplane as jax_dataplane
from kubegpu_tpu.models import TransformerLM
from kubegpu_tpu.models.paging import (
    PagedContinuousBatcher as JaxPagedContinuousBatcher,
)
from kubegpu_tpu.testing.fake_serving import build_fake_serving_stack
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu_torch.gateway import dataplane
from kubegpu_tpu_torch.gateway.dataplane import ReplicaServer
from kubegpu_tpu_torch.models.paging import PagedContinuousBatcher
from kubegpu_tpu_torch.models.params import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_http_replica.py's tiny replica
TINY = dict(vocab_size=61, num_layers=1, num_heads=2, hidden=16, max_seq=48)
PAGED_KW = dict(slots=3, prompt_pad=12, page_size=4, pool_pages=32)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


@pytest.fixture(scope="module")
def jax_params():
    return TransformerLM(dtype=jnp.float32, **TINY).init(
        jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32))["params"]


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return params_from_numpy(jax.tree.map(np.asarray, jax_params))


def _torch_cb(torch_params, dtype=torch.float32, **over):
    return PagedContinuousBatcher(torch_params, dtype=dtype, device="cpu",
                                  **TINY, **dict(PAGED_KW, **over))


def _jax_cb(jax_params, dtype=jnp.float32, **over):
    return JaxPagedContinuousBatcher(jax_params, dtype=dtype, **TINY,
                                     **dict(PAGED_KW, **over))


def _ref(jax_params, prompt, budget):
    return _jax_cb(jax_params).run([np.asarray(prompt, np.int32)],
                                   [budget])[0]


def _wait(cond, timeout=45.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def _request(port, method, path, body=None, timeout=30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read().decode()
        if r.getheader("Content-Type") == "text/event-stream":
            events, ev = [], None
            for line in raw.splitlines():
                if line.startswith("event:"):
                    ev = line[6:].strip()
                elif line.startswith("data:") and ev:
                    events.append((ev, json.loads(line[5:].strip())))
                    ev = None
            return r.status, events
        return r.status, json.loads(raw) if raw else None
    finally:
        conn.close()


def _state(srv):
    return _request(srv.port, "GET", "/v1/state")[1]


def _drive(cb, seq, n, max_steps=200):
    for _ in range(max_steps):
        cb.serve_step()
        s = next((s for s in cb._seqs if s.seq_id == seq), None)
        if s is not None and s.active and len(s.tokens) >= n:
            return
    raise AssertionError("sequence never reached its token count")


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def _payload_pair(dtype_name, rng):
    """The same pool contents as a port payload and a JAX payload."""
    shape = (3, 2, 4, 8)
    geometry = {"page": 4, "layers": 2, "heads": 2, "head_dim": 8,
                "dtype": "float32" if dtype_name == "int8" else dtype_name,
                "kv_dtype": dtype_name, "schema": 2, "tp": 1}
    base = {"kind": "live", "geometry": geometry, "tokens": [1, 2],
            "page_keys": ["ab", None], "layer_base": 0}
    if dtype_name == "bfloat16":
        bits = rng.randint(0, 2 ** 16, size=(2, 2) + shape).astype(
            np.uint16)
        bits &= np.uint16(0xBFFF)            # finite values only
        port = [(b[0], b[1]) for b in bits]
        ref = [(b[0].view(ml_dtypes.bfloat16), b[1].view(ml_dtypes.bfloat16))
               for b in bits]
        return dict(base, layers=port), dict(base, layers=ref)
    if dtype_name == "int8":
        data = rng.randint(-127, 128, size=(2, 2) + shape).astype(np.int8)
        scales = rng.rand(2, 2, 3, 2).astype(np.float32)
        pairs = dict(base, layers=[(d[0], d[1]) for d in data],
                     scales=[(s[0], s[1]) for s in scales])
        return pairs, dict(pairs)
    data = rng.randn(2, 2, *shape).astype(np.float32)
    pairs = dict(base, layers=[(d[0], d[1]) for d in data])
    return pairs, dict(pairs)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8"])
def test_codec_writes_the_jax_codecs_bytes(dtype_name):
    port, ref = _payload_pair(dtype_name, np.random.RandomState(3))
    wire = dataplane.encode_kv_payload(port)
    assert json.dumps(wire) == json.dumps(
        jax_dataplane.encode_kv_payload(ref))
    back = dataplane.decode_kv_payload(json.loads(json.dumps(wire)))
    jback = jax_dataplane.decode_kv_payload(json.loads(json.dumps(wire)))
    for sect in ("layers", "scales"):
        for (pk, pv), (jk, jv), (ok, ov) in zip(back.get(sect, []),
                                               jback.get(sect, []),
                                               port.get(sect, [])):
            for p, j, o in ((pk, jk, ok), (pv, jv, ov)):
                assert p.tobytes() == j.tobytes() == o.tobytes()
                assert p.shape == o.shape
    if dtype_name == "bfloat16":
        assert back["layers"][0][0].dtype == np.uint16
    assert {k: v for k, v in back.items() if k not in ("layers", "scales")
            } == {k: v for k, v in port.items()
                  if k not in ("layers", "scales")}
    # a payload without arrays passes through
    assert dataplane.encode_kv_payload({"kind": "live"}) == {"kind": "live"}


def _wire(payload, encode, decode):
    return decode(json.loads(json.dumps(encode(payload))))


@pytest.mark.parametrize("src_side", ["torch", "jax"])
def test_bfloat16_pages_cross_the_wire_bit_for_bit(jax_params, torch_params,
                                                   src_side):
    """A bfloat16 pool's pages go over the wire between the packages
    and land in the importer's pool as the exporter's bits."""
    cbs = {"torch": _torch_cb(torch_params, dtype=torch.bfloat16),
           "jax": _jax_cb(jax_params, dtype=jnp.bfloat16)}
    dst_side = "jax" if src_side == "torch" else "torch"
    src, dst = cbs[src_side], cbs[dst_side]
    src.submit(1, np.asarray(PROMPT, np.int32), 10)
    _drive(src, 1, 4)
    payload = src.export_pages(1)
    assert payload["geometry"]["dtype"] == "bfloat16"
    if src_side == "torch":
        assert payload["layers"][0][0].dtype == np.uint16
        got = _wire(payload, dataplane.encode_kv_payload,
                    jax_dataplane.decode_kv_payload)
    else:
        got = _wire(payload, jax_dataplane.encode_kv_payload,
                    dataplane.decode_kv_payload)
    dst.import_pages(7, got)
    s = next(s for s in dst._seqs if s.seq_id == 7)
    n = len(payload["page_keys"])
    for li, (k_np, v_np) in enumerate(payload["layers"]):
        want = np.stack([np.asarray(k_np), np.asarray(v_np)])
        want = want.view(np.uint16)
        if dst_side == "jax":
            held = np.stack([np.asarray(a)[np.asarray(s.pages[:n])]
                             for a in dst.pools[li]]).view(np.uint16)
        else:
            held = np.stack([
                a[torch.tensor(s.pages[:n])].view(torch.int16).numpy()
                for a in dst.pools[li]]).view(np.uint16)
        np.testing.assert_array_equal(held, want)
    out = {}
    while dst.has_work():
        out.update(dst.serve_step())
    assert len(out[7]) == 10
    dst.assert_page_accounting()


def test_codec_carries_the_sampled_draft_ring(torch_params):
    """A seed-pinned sampled speculative sequence exported through the
    codec resumes with its draft-ring lane, token for token."""
    spec = dict(speculate_k=2, sampling=True, draft_params=torch_params,
                draft_num_layers=1, draft_num_heads=2, draft_hidden=16)
    prompt = np.asarray(PROMPT, np.int32)
    ref = _torch_cb(torch_params, **spec).run([prompt], [12],
                                             temperatures=[0.9],
                                             seeds=[5])[0]
    src = _torch_cb(torch_params, **spec)
    src.submit(1, prompt, 12, 0.9, seed=5)
    _drive(src, 1, 4)
    payload = src.export_pages(1)
    got = _wire(payload, dataplane.encode_kv_payload,
                dataplane.decode_kv_payload)
    for (pk, pv), (gk, gv) in zip(payload["draft"]["rows"],
                                  got["draft"]["rows"]):
        assert pk.tobytes() == gk.tobytes() and pv.tobytes() == gv.tobytes()
    dst = _torch_cb(torch_params, **spec)
    dst.import_pages(2, got)
    assert dst._d_pos[0] == payload["draft"]["d_pos"]
    out = {}
    while dst.has_work():
        out.update(dst.serve_step())
    assert out[2] == ref


def test_a_jax_replica_reads_the_ring_wire_without_its_ring(jax_params,
                                                           torch_params):
    """The JAX codec has no ring section, so a JAX importer decodes the
    port's wire without one and re-admits its draft from the prompt:
    the import lands, the stream completes its budget and the pool
    balances (sampled speculation stays lossless in distribution)."""
    spec = dict(speculate_k=2, sampling=True, draft_num_layers=1,
                draft_num_heads=2, draft_hidden=16)
    src = _torch_cb(torch_params, draft_params=torch_params, **spec)
    src.submit(1, np.asarray(PROMPT, np.int32), 12, 0.9, seed=5)
    _drive(src, 1, 4)
    payload = src.export_pages(1)
    wire = json.loads(json.dumps(dataplane.encode_kv_payload(payload)))
    assert "draft" not in wire and "draft_wire" in wire
    got = jax_dataplane.decode_kv_payload(wire)
    assert "draft" not in got
    dst = _jax_cb(jax_params, draft_params=jax_params, **spec)
    dst.import_pages(2, got)
    out = {}
    while dst.has_work():
        out.update(dst.serve_step())
    assert len(out[2]) == 12 and out[2][:4] == payload["tokens"][:4]
    dst.assert_page_accounting()


# ---------------------------------------------------------------------------
# a JAX gateway drains a torch replica into a JAX one
# ---------------------------------------------------------------------------

def test_jax_gateway_drains_a_torch_replica_by_transfer(jax_params,
                                                        torch_params):
    budget = 30
    ref = _ref(jax_params, PROMPT, budget)
    stack = build_fake_serving_stack(2)
    registry = stack.registry
    registry.refresh()
    keys = sorted(r.key for r in registry.live())
    tsrv = ReplicaServer(_torch_cb(torch_params),
                         step_delay_s=0.02).start()
    jsrv = JaxReplicaServer(_jax_cb(jax_params), step_delay_s=0.02).start()
    client = HttpReplicaClient()
    client.set_endpoint(keys[0], tsrv.endpoint)
    client.set_endpoint(keys[1], jsrv.endpoint)
    registry.subscribe(client.sync_live)
    registry.refresh()
    gw = Gateway(registry, client, metrics=JaxMetrics(), dispatchers=2,
                 policy=FailoverPolicy(deadline_s=60.0, hedge_after_s=30.0))
    gw.start()
    try:
        registry.set_draining(keys[1], True)   # land it on the torch side
        p = gw.submit(GatewayRequest(prompt=PROMPT, max_new_tokens=budget,
                                     request_id="slow"))
        _wait(lambda: len(tsrv.loop.control(
            lambda: tsrv.batcher.live_tokens()).get(0, [])) >= 3,
            msg="tokens on the torch replica")
        registry.set_draining(keys[1], False)
        miss0 = _state(jsrv)["stats"]["prefix_miss_tokens"]
        stats = gw.drain_replica(keys[0])
        assert stats["migrated"] == 1, stats
        assert p.wait(60)
        r = p.result()
        assert r.status == "ok", (r.status, r.error)
        assert list(r.tokens) == ref
        st = _state(jsrv)["stats"]
        assert st["imports"] == 1 and st["pages_imported"] > 0
        assert st["prefix_miss_tokens"] == miss0
        assert _state(tsrv)["stats"]["pages_exported"] > 0
    finally:
        gw.stop()
        client.stop()
        tsrv.stop()
        jsrv.stop()
    tsrv.batcher.assert_page_accounting()
    jsrv.batcher.assert_page_accounting()


# ---------------------------------------------------------------------------
# disaggregated handoffs over HTTP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefill_side", ["torch", "jax"])
def test_disaggregated_handoff_over_http(jax_params, torch_params,
                                         prefill_side):
    budget = 10
    ref = _ref(jax_params, PROMPT, budget)
    stack = build_fake_serving_stack(2, roles=("prefill", "flex"))
    registry = stack.registry
    registry.refresh()
    client = HttpReplicaClient()
    servers = {}
    for rep in registry.live():
        role = "prefill" if rep.role == "prefill" else "flex"
        side = prefill_side if role == "prefill" else (
            "jax" if prefill_side == "torch" else "torch")
        srv = (ReplicaServer(_torch_cb(torch_params), role=role)
               if side == "torch" else
               JaxReplicaServer(_jax_cb(jax_params), role=role)).start()
        servers[role] = srv
        client.set_endpoint(rep.key, srv.endpoint)
    registry.subscribe(client.sync_live)
    registry.refresh()
    gw = Gateway(registry, client, metrics=JaxMetrics(), dispatchers=2,
                 policy=FailoverPolicy(deadline_s=120.0, hedge_after_s=60.0,
                                       max_attempts=4))
    gw.start()
    try:
        p = gw.submit(GatewayRequest(prompt=PROMPT, max_new_tokens=budget,
                                     request_id="h0"))
        assert p.wait(120)
        r = p.result()
        assert r.status == "ok", (r.status, r.error)
        assert list(r.tokens) == ref
        assert gw.metrics.get("gateway_phase_handoff_total",
                              outcome="ok") == 1
        dec = _state(servers["flex"])["stats"]
        assert dec["imports"] == 1 and dec["pages_imported"] > 0
        assert _state(servers["prefill"])["role"] == "prefill"
        assert gw.drain(60)
    finally:
        gw.stop()
        client.stop()
        for srv in servers.values():
            srv.stop()
    for srv in servers.values():
        srv.batcher.assert_page_accounting()


# ---------------------------------------------------------------------------
# the routes and the role surface
# ---------------------------------------------------------------------------

def test_replica_server_role_surface(torch_params):
    srv = ReplicaServer(_torch_cb(torch_params), step_delay_s=0.001,
                        role="prefill").start()
    try:
        assert _state(srv)["role"] == "prefill"
        assert srv.batcher.prefill_only
        status, body = _request(srv.port, "POST", "/v1/role",
                                {"role": "decode"})
        assert (status, body) == (200, {"role": "decode"})
        assert _state(srv)["role"] == "decode"
        assert not srv.batcher.prefill_only
        status, body = _request(srv.port, "POST", "/v1/role",
                                {"role": "turbo"})
        assert status == 400
        assert _state(srv)["role"] == "decode"
    finally:
        srv.stop()


def test_prefill_role_streams_a_sealed_event_then_exports(torch_params,
                                                          jax_params):
    """A prefill replica's stream announces ``sealed`` and stays open;
    the live export ends it ``migrated``; the live import on another
    replica streams the continuation as SSE."""
    budget = 10
    ref = _ref(jax_params, PROMPT, budget)
    src = ReplicaServer(_torch_cb(torch_params), role="prefill").start()
    dst = ReplicaServer(_torch_cb(torch_params)).start()
    events = []
    try:
        import threading

        t = threading.Thread(target=lambda: events.extend(_request(
            src.port, "POST", "/v1/submit",
            {"request_id": "p0", "prompt": PROMPT,
             "max_new_tokens": budget})[1]))
        t.start()
        _wait(lambda: src.loop.control(
            lambda: any(s.parked for s in src.batcher._seqs)),
            msg="the sequence to park")
        status, body = _request(src.port, "POST", "/v1/export",
                                {"request_id": "p0"})
        assert status == 200 and body["pages"] >= 2
        t.join(30)
        kinds = [k for k, _ in events]
        assert kinds == ["sealed", "error"]
        assert events[-1][1]["error"] == "migrated"
        status, cont = _request(dst.port, "POST", "/v1/import",
                                {"request_id": "p0",
                                 "payload": body["payload"]})
        assert status == 200 and cont[-1][0] == "done"
        assert cont[-1][1]["tokens"] == ref
        assert sum((e["tokens"] for k, e in cont if k == "tokens"),
                   []) == ref
    finally:
        src.stop()
        dst.stop()
    assert src.metrics.get("replica_migrate_pages_total",
                           dir="export") == body["pages"]
    assert dst.metrics.get("replica_migrate_pages_total",
                           dir="import") == body["pages"]
    assert dst.metrics.get("replica_migrate_wire_bytes_total",
                           dir="import") > 0
    src.batcher.assert_page_accounting()
    dst.batcher.assert_page_accounting()


def test_sealed_chain_routes_and_the_chaos_knob(torch_params):
    src = ReplicaServer(_torch_cb(torch_params,
                                  decode_page_cache="fp32")).start()
    dst = ReplicaServer(_torch_cb(torch_params,
                                  decode_page_cache="fp32")).start()
    armed = ReplicaServer(_torch_cb(torch_params),
                          fail_migration=True).start()
    try:
        status, events = _request(src.port, "POST", "/v1/submit", {
            "request_id": "t1", "prompt": PROMPT, "max_new_tokens": 6})
        stream = PROMPT + events[-1][1]["tokens"]
        status, body = _request(src.port, "POST", "/v1/export",
                                {"stream": stream})
        assert status == 200 and body["pages"] == (len(stream) - 1) // 4
        status, got = _request(dst.port, "POST", "/v1/import",
                               {"payload": body["payload"]})
        assert (status, got) == (200, {"imported": body["pages"]})
        before = _state(armed)
        for extra in ({}, {"request_id": "x"}):
            status, got = _request(armed.port, "POST", "/v1/import",
                                   dict(extra, payload=body["payload"]))
            assert status == 503 and "chaos" in got["error"]
        after = _state(armed)
        assert after["stats"] == before["stats"]
        assert after["prefix_cache"] == before["prefix_cache"]
        assert armed.batcher.stats["imports"] == 0
        assert armed.batcher.free_pages == set(range(1, 32))
        # unknown streams and malformed bodies
        assert _request(src.port, "POST", "/v1/export",
                        {"request_id": "nope"})[0] == 404
        assert _request(src.port, "POST", "/v1/export", {})[0] == 400
        assert _request(dst.port, "POST", "/v1/import", {})[0] == 400
        status, got = _request(src.port, "POST", "/v1/export",
                               {"stream": [5, 5, 5, 5, 5, 5]})
        assert status == 200 and got["payload"] is None
    finally:
        for srv in (src, dst, armed):
            srv.stop()
    armed.batcher.assert_page_accounting()
    dst.batcher.assert_page_accounting()


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def test_worker_role_and_fail_migration_flags(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.models.worker",
         "--model", "decode", "--serving", "paged", "--device", "cpu",
         "--serve-http", "0", "--vocab", "61", "--layers", "1", "--heads",
         "2", "--hidden", "16", "--seq", "47", "--prompt-len", "12",
         "--page-size", "4", "--batch-per-chip", "3", "--steps", "8",
         "--serve-fp32",
         "--role", "prefill", "--serve-http-fail-migration"],
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
        assert fields["role"] == "prefill"
        srv = types.SimpleNamespace(port=int(fields["port"]))
        state = _state(srv)
        assert state["role"] == "prefill"
        payload = {"kind": "sealed", "geometry": {
            "page": 4, "layers": 1, "heads": 2, "head_dim": 8,
            "dtype": "float32", "kv_dtype": "float32", "schema": 2,
            "tp": 1}, "page_keys": ["00" * 32], "page_kinds": ["prompt"],
            "layers": [(np.zeros((1, 2, 4, 8), np.float32),) * 2]}
        status, got = _request(srv.port, "POST", "/v1/import", {
            "payload": dataplane.encode_kv_payload(payload)})
        assert status == 503 and "chaos" in got["error"]
        after = _state(srv)["stats"]
        assert after["imports"] == after["pages_imported"] == 0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "REPLICA_HTTP_STOPPED" in out and "error=False" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
