"""The port's ``Gateway`` (``kubegpu_tpu_torch/gateway/core.py`` over its
``failover.py``, ``router.py``, ``queue.py`` and ``client.py``) held
against the JAX package's on the CPU.  A gateway of each package fronts
its own ``InMemoryReplicaClient`` of ``SimBatcher`` replicas, over its
own fabricated cluster (the JAX package's TPU slices, the port's GPU
hosts; the replica keys are the same), and serves one seeded request
stream:

- a queue overflow: requests put before the dispatcher starts, past the
  queue's capacity and a tenant's cap, are refused (429's
  ``rejected``), and one queued request is cancelled by its caller;
- sessions of several turns over tenants, routed by the consistent-hash
  router, and sessionless requests by least-outstanding;
- a replica killed mid-stream (its process dies after its first token
  batch), so the request is retried on the ring's next replica;
- a deadline that expires while the request decodes;
- the gateway killed with requests still queued.

Each request's tokens, final status, error, replica key and attempt
count, and the count of every ``gateway_*`` series, are equal between
the packages.  One dispatcher and a hedge threshold far past the test's
length make the order of events a function of the stream alone."""

import threading
import types

import numpy as np
import pytest

import kubegpu_tpu.gateway as jax_gw
import kubegpu_tpu_torch.gateway as port_gw
from kubegpu_tpu.testing.fake_serving import (
    build_fake_serving_stack as jax_stack,
)
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu_torch.testing.fake_serving import (
    build_fake_serving_stack as port_stack,
)
from kubegpu_tpu_torch.utils.metrics import Metrics as PortMetrics

JAX = types.SimpleNamespace(gw=jax_gw, stack=jax_stack, Metrics=JaxMetrics)
PORT = types.SimpleNamespace(gw=port_gw, stack=port_stack,
                             Metrics=PortMetrics)
WAIT_S = 60.0


def series_counts(metrics) -> dict:
    """Every ``gateway_*`` sample of a registry's exposition but the
    wall-time ones (histogram sums and quantiles)."""
    out = {}
    for line in metrics.render().splitlines():
        if not line.startswith("gateway_"):
            continue
        name, _, value = line.rpartition(" ")
        if "_sum" in name.split("{")[0] or "quantile=" in name:
            continue
        out[name] = float(value)
    return out


def outcome(pending) -> tuple:
    assert pending.wait(WAIT_S), f"{pending.request_id} never resolved"
    r = pending.result()
    return (r.request_id, r.status, list(r.tokens), r.replica, r.error,
            r.attempts)


def make(pkg, queue_capacity=64, per_tenant_cap=None, step_delay_s=0.0):
    stack = pkg.stack(3)
    metrics = pkg.Metrics()
    client = pkg.gw.InMemoryReplicaClient(
        batcher_factory=lambda key: pkg.gw.SimBatcher(slots=4, vocab=97),
        step_delay_s=step_delay_s)
    stack.registry.subscribe(client.sync_live)
    gw = pkg.gw.Gateway(
        stack.registry, client,
        router=pkg.gw.ConsistentHashRouter(),
        queue=pkg.gw.AdmissionQueue(queue_capacity, per_tenant_cap),
        policy=pkg.gw.FailoverPolicy(deadline_s=30.0, hedge_after_s=3600.0,
                                     max_attempts=3),
        metrics=metrics, dispatchers=1)
    stack.registry.refresh()
    return stack, client, gw, metrics


def prompts(seed: int, n: int) -> list:
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, size=int(rng.randint(3, 12))).tolist()
            for _ in range(n)]


def run_stream(pkg, seed: int) -> tuple:
    """The whole seeded stream through one package: (per-request
    outcomes, the ``gateway_*`` series)."""
    rng = np.random.RandomState(seed)
    ps = prompts(seed, 40)
    stack, client, gw, metrics = make(pkg, queue_capacity=6,
                                      per_tenant_cap=4)
    Req = pkg.gw.GatewayRequest
    out = []
    try:
        # 1. overflow: ten requests of two tenants put before the
        #    dispatcher starts; one queued request cancelled
        held = []
        for i in range(10):
            r = Req(prompt=ps[i], max_new_tokens=int(rng.randint(2, 9)),
                    request_id=f"burst-{i}", tenant="ab"[i % 3 == 0],
                    session=f"s{i % 4}" if i % 2 else None)
            if i == 3:
                r.abort = threading.Event()
                r.abort.set()
            held.append(gw.submit(r))
        gw.start()
        out += [outcome(p) for p in held]
        # 2. sessions over tenants, one at a time
        for i in range(12):
            p = gw.submit(Req(
                prompt=ps[10 + i % 6], max_new_tokens=int(rng.randint(1, 12)),
                request_id=f"turn-{i}", tenant=f"t{rng.randint(3)}",
                session=f"user-{i % 6}" if i % 5 else None))
            out.append(outcome(p))
        # 3. the session's replica dies after its first token batch
        victim = next(r.replica for r in gw.results().values()
                      if r.request_id == "turn-1")
        client.set_step_delay(victim, 0.01)
        first = threading.Event()
        r = Req(prompt=ps[11], max_new_tokens=60, request_id="killed",
                session="user-1")
        r.on_tokens = lambda attempt, delta: first.set()
        p = gw.submit(r)
        assert first.wait(WAIT_S)
        client.fail_replica(victim)
        out.append(outcome(p))
        client.add_replica(victim)     # the pod restarts, cold
        # 4. a deadline that expires mid-decode
        home = next(r.replica for r in gw.results().values()
                    if r.request_id == "turn-2")
        client.set_step_delay(home, 0.01)
        p = gw.submit(Req(prompt=ps[12], max_new_tokens=500,
                          request_id="late", session="user-2",
                          deadline_s=0.2))
        out.append(outcome(p))
        # 5. the gateway killed with work queued behind a slow request
        started = threading.Event()
        r = Req(prompt=ps[13], max_new_tokens=100, request_id="slow",
                session="user-2")
        r.on_tokens = lambda attempt, delta: started.set()
        slow = gw.submit(r)
        assert started.wait(WAIT_S)
        queued = [gw.submit(Req(prompt=ps[20 + i], max_new_tokens=3,
                                request_id=f"queued-{i}"))
                  for i in range(3)]
        gw.kill()
        out += [outcome(q) for q in [slow] + queued]
    finally:
        gw.stop()
        client.stop()
    return out, series_counts(metrics)


@pytest.mark.parametrize("seed", [0, 1])
def test_gateway_serves_the_same_stream(seed):
    want, want_series = run_stream(JAX, seed)
    got, got_series = run_stream(PORT, seed)
    assert got == want
    assert got_series == want_series
    by_id = {o[0]: o for o in got}
    statuses = [o[1] for o in got]
    assert "rejected" in statuses and "timeout" in statuses
    assert by_id["killed"][1] == "ok" and by_id["killed"][5] == 2
    assert len(by_id["killed"][2]) == 60
    assert by_id["burst-3"][1] == "error"
    assert all(by_id[f"queued-{i}"][4] == "gateway died" for i in range(3))
    assert got_series["gateway_retries_total"] >= 1
    assert got_series['gateway_requests_total{outcome="rejected"}'] >= 3


def test_session_turns_stay_on_their_replica():
    """A session's turns land on one replica, the ring's owner, in both
    packages; sessionless requests go by load and name."""
    picks = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        stack, client, gw, _ = make(pkg)
        gw.start()
        try:
            got = []
            for i in range(18):
                p = gw.submit(pkg.gw.GatewayRequest(
                    prompt=[i % 7, 3, 5], max_new_tokens=2,
                    request_id=f"r{i}",
                    session=f"sess-{i % 6}" if i % 3 else None))
                got.append(outcome(p)[3])
            picks[name] = got
        finally:
            gw.stop()
            client.stop()
    assert picks["port"] == picks["jax"]
    for j in range(6):
        turns = {picks["port"][i] for i in range(18)
                 if i % 3 and i % 6 == j}
        assert len(turns) <= 1


def test_stream_relay_dedups_like_jax():
    """The SSE fan-in: two attempts' overlapping deltas reach the caller
    once each, in order, in both packages."""
    class Attempt:
        def __init__(self, stream_base=0):
            self.stream_base = stream_base

    a, b = Attempt(), Attempt(stream_base=3)
    feeds = [(a, [1, 2]), (b, [4, 5]), (a, [3, 4]), (a, [5, 6]),
             (b, [6, 7, 8]), (a, [7])]
    drained = []
    for mod, metrics in ((jax_gw, JaxMetrics()), (port_gw, PortMetrics())):
        relay = mod.StreamRelay(metrics=metrics)
        for attempt, delta in feeds:
            relay.on_tokens(attempt, delta)
        drained.append((relay.drain(), relay.emitted(),
                        metrics.get("gateway_stream_dedup_tokens_total")))
    assert drained[1] == drained[0]
    assert drained[0][0] == [1, 2, 4, 5, 6, 7, 8]
