"""The port's session-KV store (``kubegpu_tpu_torch/gateway/
sessionstore.py``) held against the JAX package's on the CPU, over
loopback HTTP; every comparison is exact:

- one seeded sequence of session puts (plain and compare-and-swap),
  gets, deletes, lost-marks, lease expiries on a fixed clock and
  prefix-tier publishes and probes, run by each package's
  ``HttpStoreClient`` against each package's ``StoreServer`` (four
  pairs): the same ``StoreResult``s, payload bytes included, and the
  same ``session_store_*`` series on the server;
- a sealed bfloat16 KV payload written through one package's client
  reads back through the other's bit for bit (the port holds bf16 pages
  as their 16-bit patterns, the JAX package as ``ml_dtypes.bfloat16``);
- the circuit breaker: with the store down, both clients give the same
  results and the same retry, fast-fail and breaker counts, and the
  ``SessionKVStore`` above degrades a restore to cold;
- ``python -m kubegpu_tpu_torch.gateway.sessionstore`` announces
  ``SESSION_STORE_SERVING port=N``, serves a JAX client, and exits 0 on
  SIGTERM."""

import os
import random
import signal
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest

from kubegpu_tpu.gateway import sessionstore as jax_store
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu_torch.gateway import sessionstore as port_store
from kubegpu_tpu_torch.utils.metrics import Metrics as PortMetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODS = {"jax": (jax_store, JaxMetrics), "port": (port_store, PortMetrics)}


def plain(value):
    """A result with its numpy arrays as (dtype, shape, bytes)."""
    if isinstance(value, np.ndarray):
        return ("ndarray", value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    return value


def payload(rng, n_pages: int, keys: list) -> dict:
    """A float32 sealed-chain payload of 2 layers."""
    shape = (n_pages, 4, 2, 8)
    return {
        "geometry": {"dtype": "float32", "page": 4, "heads": 2, "hd": 8},
        "page_keys": list(keys),
        "tokens": rng.randint(0, 61, size=4 * n_pages).tolist(),
        "layers": [(rng.standard_normal(shape).astype(np.float32),
                    rng.standard_normal(shape).astype(np.float32))
                   for _ in range(2)],
    }


def op_sequence(client, clock, seed: int) -> list:
    rng = np.random.RandomState(seed)
    sessions = [f"s{i}" for i in range(6)]
    versions = {}
    out = []
    for i in range(80):
        op = rng.randint(10)
        s = sessions[rng.randint(len(sessions))]
        if op <= 2:
            entry = {"replica": f"default/dec-{rng.randint(3)}",
                     "stream": rng.randint(0, 61, size=5).tolist(),
                     "lost": False}
            if rng.rand() < 0.4:
                entry["payload"] = payload(
                    rng, 2, [f"k{i}a", f"k{i}b"])
            cas = None
            if rng.rand() < 0.5:
                cas = versions.get(s, 0) + int(rng.randint(-1, 2))
            r = client.put(s, entry, if_version=cas)
            versions[s] = r.version or versions.get(s, 0)
        elif op <= 4:
            r = client.get(s, meta=bool(rng.rand() < 0.5))
        elif op == 5:
            r = client.delete(s)
        elif op == 6:
            r = (client.sessions_on(f"default/dec-{rng.randint(3)}"),
                 client.mark_lost(f"default/dec-{rng.randint(3)}"),
                 client.sync_live({"default/dec-0", "default/dec-2"}))
        elif op == 7:
            chain = [f"c{rng.randint(4)}-{j}" for j in range(3)]
            r = client.put_prefix(chain[-1], {
                "payload": payload(rng, 3, chain), "page_keys": chain,
                "pages": 3})
        elif op == 8:
            r = (client.probe_prefix(
                     [f"c{rng.randint(4)}-{j}" for j in range(3)]),
                 client.get_prefix(f"c{rng.randint(4)}-2",
                                   meta=bool(rng.rand() < 0.5)))
        else:
            clock[0] += float(rng.choice([0.5, 3.0, 6.0]))
            r = ("tick", clock[0])
        out.append((op, plain(r)))
    # a lease that lapses under a session nobody wrote since
    r = client.put("last", {"replica": "default/dec-1", "stream": [3],
                            "lost": False})
    clock[0] += 6.0
    out.append(("lapsed", plain((r, client.get("last"),
                                 client.get("last")))))
    return out


def store_series(metrics) -> list:
    return [line for line in metrics.render().splitlines()
            if line.startswith("session_store_")
            and "quantile=" not in line and "_sum" not in line]


@pytest.mark.parametrize("seed", [0, 1])
def test_store_ops_agree_across_packages(seed):
    runs = {}
    for server_pkg in ("jax", "port"):
        for client_pkg in ("jax", "port"):
            smod, smet = MODS[server_pkg]
            cmod, cmet = MODS[client_pkg]
            clock = [100.0]
            metrics = smet()
            backend = smod.InProcessStoreBackend(
                lease_s=5.0, prefix_lease_s=6.0, clock=lambda: clock[0],
                metrics=metrics)
            server = smod.StoreServer(metrics=metrics,
                                      backend=backend).start()
            client = cmod.HttpStoreClient(server.url, timeout_s=10.0,
                                          retries=0, metrics=cmet())
            try:
                ops = op_sequence(client, clock, seed)
            finally:
                client.close()
                server.stop()
            runs[server_pkg, client_pkg] = (ops, store_series(metrics))
    want = runs["jax", "jax"]
    statuses = {r[1][0] for r in want[0] if isinstance(r[1], list)
                and r[1] and isinstance(r[1][0], str)}
    assert {"ok", "conflict", "absent"} <= statuses, statuses
    assert [r[0] for r in want[0][-1][1]] == ["ok", "expired", "absent"]
    for pair, got in runs.items():
        assert got[0] == want[0], pair
        assert got[1] == want[1], pair


def bf16_payload(bits: np.ndarray, as_jax: bool) -> dict:
    layer = bits.view(ml_dtypes.bfloat16) if as_jax else bits
    return {
        "geometry": {"dtype": "bfloat16", "page": 4, "heads": 2, "hd": 8},
        "page_keys": ["a", "b"],
        "tokens": list(range(8)),
        "layers": [(layer, layer[::-1].copy())],
    }


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_bf16_payload_crosses_packages_bit_for_bit(writer, reader):
    rng = np.random.RandomState(5)
    bits = rng.randint(0, 1 << 16, size=(2, 4, 2, 8)).astype(np.uint16)
    # neither NaN patterns (the bf16 view would not compare) nor -0
    bits &= np.uint16(0x7F7F)
    server = MODS[writer][0].StoreServer().start()
    try:
        w = MODS[writer][0].HttpStoreClient(server.url, timeout_s=10.0)
        r = MODS[reader][0].HttpStoreClient(server.url, timeout_s=10.0)
        put = w.put("sess", {"replica": "default/dec-0", "stream": [1, 2],
                             "lost": False,
                             "payload": bf16_payload(bits, writer == "jax")})
        assert put.status == "ok"
        got = r.get("sess")
        assert got.status == "ok"
        k, v = got.entry["payload"]["layers"][0]
        if reader == "jax":
            assert k.dtype == ml_dtypes.bfloat16
        else:
            assert k.dtype == np.uint16
        assert np.array_equal(k.view(np.uint16), bits)
        assert np.array_equal(v.view(np.uint16), bits[::-1])
        # and a payload published under the prefix tier's namespace
        w.put_prefix("b", {"payload": bf16_payload(bits, writer == "jax"),
                           "page_keys": ["a", "b"], "pages": 2})
        pk, _ = r.get_prefix("b").entry["payload"]["layers"][0]
        assert np.array_equal(pk.view(np.uint16), bits)
        w.close(), r.close()
    finally:
        server.stop()


def breaker_run(pkg: str) -> tuple:
    mod, met = MODS[pkg]
    probe = mod.StoreServer().start()
    url = probe.url
    probe.stop()                       # the store is down
    clock = [0.0]
    slept = []
    metrics = met()
    client = mod.HttpStoreClient(
        url, timeout_s=0.5, retries=2, breaker_threshold=3,
        breaker_cooldown_s=5.0, clock=lambda: clock[0],
        sleep=slept.append, rng=random.Random(0), metrics=metrics)
    results = []
    for i in range(8):
        results.append(plain(client.get(f"s{i}")))
        results.append(client.breaker.open)
        if i == 5:
            clock[0] += 6.0            # past the cooldown: one trial
    kv = mod.SessionKVStore(backend=client, metrics=metrics)
    restore = kv.restore_for(
        type("R", (), {"session": "s0", "request_id": "r"})(),
        "default/dec-0", object())
    counts = [line for line in metrics.render().splitlines()
              if line.startswith("gateway_session_store")]
    return results, slept, counts, restore, client.breaker.trips


def test_breaker_fast_fails_alike_with_the_store_down():
    want = breaker_run("jax")
    got = breaker_run("port")
    assert got == want
    results, slept, counts, restore, trips = got
    assert results[0][0] == "unreachable" and trips >= 1
    assert any("fastfail" in line for line in counts)
    assert len(slept) >= 2


def test_store_entry_point_serves_a_jax_client():
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubegpu_tpu_torch.gateway.sessionstore",
         "--listen", "127.0.0.1:0", "--lease", "30"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("SESSION_STORE_SERVING port="), (
            line + proc.stderr.read() if proc.poll() is not None else line)
        port = int(line.split()[1].split("=")[1])
        assert "lease=30" in line
        client = jax_store.HttpStoreClient(f"http://127.0.0.1:{port}",
                                           timeout_s=10.0)
        assert client.put("s", {"replica": "r", "stream": [1],
                                "lost": False}).status == "ok"
        assert client.get("s").entry["stream"] == [1]
        assert client.healthy()
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
