"""The port's gateway tier (``kubegpu_tpu_torch/gateway/tier.py``: N
``Gateway`` instances over one registry, one data-plane client and one
session store) held against the JAX package's on the CPU.  A tier of 3
gateways of each package fronts its own ``InMemoryReplicaClient`` of
``SimBatcher`` replicas over its own fabricated cluster (the replica
keys are the same):

- every session takes the same route through any gateway: one replica,
  the ring's owner, whichever gateway admits it, and the same home
  gateway (``gateway_for``);
- a gateway killed mid-stream resolves its request with the retryable
  death error, and the caller's retry on a sibling (``GatewayTier.
  _clone``, carrying the stream relay's watermark N, its count when
  the sibling dispatches) continues the stream: the sibling's deltas
  are exactly ``full[N:]``, and the
  caller's stream is the full list once;
- ``submit_and_wait`` retries across a dead gateway by itself;
- the same events fed to the JAX tier give the same homes, routes,
  tokens and death/retry counts."""

import threading
import time
import types

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


def wait_for(predicate, timeout=WAIT_S, what="condition"):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.002)


def build_tier(pkg, step_delay_s=0.0):
    stack = pkg.stack(4)
    metrics = pkg.Metrics()
    client = pkg.gw.InMemoryReplicaClient(
        batcher_factory=lambda key: pkg.gw.SimBatcher(slots=8, vocab=101),
        step_delay_s=step_delay_s)
    stack.registry.subscribe(client.sync_live)
    tier = pkg.gw.GatewayTier(
        stack.registry, client, n_gateways=3, metrics=metrics,
        policy=pkg.gw.FailoverPolicy(deadline_s=30.0, hedge_after_s=3600.0,
                                     max_attempts=4),
        dispatchers=2)
    stack.registry.refresh()
    tier.start()
    return client, tier, metrics


def routes(pkg) -> dict:
    """Each session through each gateway: (home gateway, replicas,
    tokens)."""
    client, tier, _ = build_tier(pkg)
    out = {}
    try:
        for s in range(10):
            req = pkg.gw.GatewayRequest(prompt=[s, 2 * s + 1, 7],
                                        max_new_tokens=5,
                                        request_id=f"home-{s}",
                                        session=f"sess-{s}")
            home = tier.gateway_for(req)
            replicas, tokens = [], []
            for gid in sorted(tier.gateways):
                _, p = tier.submit(pkg.gw.GatewayRequest(
                    prompt=list(req.prompt), max_new_tokens=5,
                    request_id=f"r-{s}-{gid}", session=req.session),
                    via=gid)
                assert p.wait(WAIT_S)
                r = p.result()
                assert r.status == "ok", r
                replicas.append(r.replica)
                tokens.append(list(r.tokens))
            out[req.session] = (home, replicas, tokens)
    finally:
        tier.stop()
        client.stop()
    return out


def test_any_gateway_routes_a_session_alike():
    want = routes(JAX)
    got = routes(PORT)
    assert got == want
    for home, replicas, tokens in got.values():
        assert len(set(replicas)) == 1
        assert all(t == tokens[0] for t in tokens)
    assert len({v[0] for v in got.values()}) == 3     # every gateway homes
    assert len({v[1][0] for v in got.values()}) >= 3


def killed_mid_stream(pkg) -> dict:
    client, tier, metrics = build_tier(pkg, step_delay_s=0.004)
    try:
        relay = pkg.gw.StreamRelay(metrics, dedup=True)
        request = pkg.gw.GatewayRequest(prompt=[7, 8, 9], max_new_tokens=100,
                                        request_id="mig", session="sess-f")
        request.on_tokens = relay.on_tokens
        request.stream_watermark = relay.emitted
        gid, pending = tier.submit(request)
        wait_for(lambda: relay.emitted() >= 3, what="first tokens")
        tier.kill(gid)
        assert pending.wait(WAIT_S)
        first = pending.result()
        assert pkg.gw.is_gateway_death(first, tier.gateways[gid])
        n = relay.emitted()
        streamed = relay.drain()
        clone = pkg.gw.GatewayTier._clone(request)
        sibling_deltas, bases = [], set()

        def record(attempt, delta):
            # the watermark the sibling's attempt carried: the relay's
            # count when it was dispatched (a late delta of the dead
            # gateway's attempt may land after ``n`` was read)
            bases.add(int(getattr(attempt, "stream_base", 0) or 0))
            sibling_deltas.extend(delta)
            relay.on_tokens(attempt, delta)

        clone.on_tokens = record
        gid2, pending2 = tier.submit(clone)
        assert gid2 != gid
        assert pending2.wait(WAIT_S)
        result = pending2.result()
        assert result.status == "ok", result
        wait_for(lambda: relay.emitted() == len(result.tokens),
                 what="the stream's tail")
        streamed += relay.drain()
        # the tier client's own retry across another death
        request2 = pkg.gw.GatewayRequest(prompt=[3, 1, 4], max_new_tokens=100,
                                         request_id="saw", session="sess-w")
        box = {}
        home2 = tier.gateway_for(request2)
        t = threading.Thread(target=lambda: box.setdefault(
            "r", tier.submit_and_wait(request2, timeout=WAIT_S)))
        t.start()
        wait_for(lambda: tier.gateways[home2].in_flight() > 0 or "r" in box,
                 what="the request in flight")
        if home2 in tier.alive_ids():
            tier.kill(home2)
        t.join(WAIT_S)
        assert not t.is_alive()
        return dict(
            first=(first.status, first.error), n=n, bases=bases,
            sibling=sibling_deltas, streamed=streamed,
            result=(result.status, list(result.tokens), result.replica),
            gids=(gid, gid2), home2=home2,
            saw=(box["r"].status, list(box["r"].tokens), box["r"].replica),
            deaths=metrics.get("gateway_tier_deaths_total"),
            retries=metrics.get("gateway_tier_retries_total"))
    finally:
        tier.stop()
        client.stop()


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
def test_a_sibling_continues_a_killed_gateways_stream(pkg):
    got = killed_mid_stream(pkg)
    full = got["result"][1]
    assert len(full) == 100 and got["result"][0] == "ok"
    assert got["first"] == ("error", "gateway died")
    (base,) = got["bases"]
    assert 3 <= got["n"] <= base < 100
    assert got["sibling"] == full[base:]
    assert got["streamed"] == full
    assert got["saw"][0] == "ok" and len(got["saw"][1]) == 100


def test_the_same_events_give_the_same_tier_outcomes():
    want = killed_mid_stream(JAX)
    got = killed_mid_stream(PORT)
    for key in ("first", "result", "gids", "home2", "saw", "deaths",
                "retries"):
        assert got[key] == want[key], key
    assert got["deaths"] == 2 and got["retries"] >= 1
