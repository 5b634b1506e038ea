"""The port's gateway building blocks (``kubegpu_tpu_torch/gateway/``
``queue.py``, ``hashring.py``, ``registry.py``, ``router.py``,
``prefixtier.py``) held against the JAX package's on the CPU, each fed
the same inputs made from a numpy seed; every comparison is exact:

- ``AdmissionQueue``: one seeded put/get/close sequence over tenants
  and a ``per_tenant_cap`` gives the same order and the same
  ``QueueFull``/``QueueClosed`` outcomes;
- ``ConsistentHashRing``: the same owners, exclusion walks and
  preference lists for 1,000 keys over changing member sets;
- ``ReplicaRegistry``: the same ``ReplicaInfo`` fields over one set of
  node and pod objects (the JAX package's TPU slices, and the port's GPU
  hosts) with dead chips, draining, roles, terminal phases and pods
  being deleted;
- every router (least-outstanding, affinity, consistent-hash,
  prefix-locality, ``handoff_rank_key``): the same picks over one
  seeded sequence of requests, loads and exclusions;
- ``prompt_chain_keys`` bit for bit, and equal to the chain keys the
  port's paged batcher seals under;
- the gateway side imports no torch."""

import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from kubegpu_tpu.gateway import hashring as jax_hashring
from kubegpu_tpu.gateway import prefixtier as jax_prefixtier
from kubegpu_tpu.gateway import queue as jax_queue
from kubegpu_tpu.gateway import registry as jax_registry
from kubegpu_tpu.gateway import router as jax_router
from kubegpu_tpu.testing.fake_serving import (
    build_fake_serving_stack as jax_stack,
)
from kubegpu_tpu_torch.gateway import hashring as port_hashring
from kubegpu_tpu_torch.gateway import prefixtier as port_prefixtier
from kubegpu_tpu_torch.gateway import queue as port_queue
from kubegpu_tpu_torch.gateway import registry as port_registry
from kubegpu_tpu_torch.gateway import router as port_router
from kubegpu_tpu_torch.testing.fake_serving import (
    build_fake_serving_stack as port_stack,
)
from kubegpu_tpu_torch.types import annotations

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Req:
    """A request object as the queue and routers read it."""

    def __init__(self, request_id, tenant="", session=None, prompt=(),
                 preferred_slice=None, preferred_replica=None):
        self.request_id = request_id
        self.tenant = tenant
        self.session = session
        self.prompt = list(prompt)
        self.max_new_tokens = 4
        if preferred_slice is not None:
            self.preferred_slice = preferred_slice
        if preferred_replica is not None:
            self.preferred_replica = preferred_replica


# ---------------------------------------------------------------------------
# the admission queue
# ---------------------------------------------------------------------------

def queue_trace(mod, seed: int) -> list:
    rng = np.random.RandomState(seed)
    q = mod.AdmissionQueue(capacity=int(rng.randint(4, 12)),
                           per_tenant_cap=int(rng.randint(2, 5)))
    out = []
    for i in range(400):
        op = rng.rand()
        if i == 350:
            q.close()
            out.append("close")
        if op < 0.55:
            r = Req(f"r{i}", tenant=f"t{rng.randint(4)}")
            try:
                q.put(r)
                out.append(("put", r.request_id))
            except mod.QueueFull as e:
                out.append(("full", str(e)))
            except mod.QueueClosed as e:
                out.append(("closed", str(e)))
        else:
            got = q.get(0.0)
            out.append(("get", None if got is None else got.request_id))
        out.append(("depth", q.depth()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_queue_same_order_and_outcomes(seed):
    want = queue_trace(jax_queue, seed)
    got = queue_trace(port_queue, seed)
    assert got == want
    kinds = {e[0] for e in want if isinstance(e, tuple)}
    assert {"put", "get", "full", "closed"} <= kinds


def test_admission_queue_refuses_bad_capacity_alike():
    for mod in (jax_queue, port_queue):
        with pytest.raises(ValueError, match="capacity must be positive"):
            mod.AdmissionQueue(capacity=0)


# ---------------------------------------------------------------------------
# the hash ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vnodes", [1, 16, 64])
def test_hash_ring_same_owners(vnodes):
    rng = np.random.RandomState(vnodes)
    keys = [f"session-{rng.randint(1 << 30)}" for _ in range(1000)]
    pool = [f"default/dec-{i}" for i in range(9)]
    jr = jax_hashring.ConsistentHashRing(vnodes=vnodes)
    pr = port_hashring.ConsistentHashRing(vnodes=vnodes)
    for step in range(6):
        members = [m for m in pool if rng.rand() < 0.6] or pool[:1]
        jr.rebuild(members)
        pr.rebuild(members)
        assert pr.nodes() == jr.nodes()
        excl = frozenset(m for m in members if rng.rand() < 0.3)
        owners = [pr.lookup(k) for k in keys]
        assert owners == [jr.lookup(k) for k in keys]
        assert set(owners) <= set(members)
        assert ([pr.lookup(k, exclude=excl) for k in keys]
                == [jr.lookup(k, exclude=excl) for k in keys])
        assert ([pr.preference(k, 3) for k in keys[:100]]
                == [jr.preference(k, 3) for k in keys[:100]])
    assert (port_hashring.ConsistentHashRing().lookup("x")
            is jax_hashring.ConsistentHashRing().lookup("x") is None)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class ObjectsApi:
    """The two list verbs and the annotation patch of an API server over
    plain node and pod objects the test mutates."""

    def __init__(self, nodes, pods):
        self.nodes = nodes
        self.pods = pods

    def list_nodes(self):
        return copy.deepcopy(self.nodes)

    def list_pods(self, namespace=None):
        return copy.deepcopy(self.pods)

    def patch_pod_annotations(self, namespace, name, ann):
        for p in self.pods:
            meta = p["metadata"]
            if meta["name"] == name and meta.get("namespace") == namespace:
                cur = meta.setdefault("annotations", {})
                for k, v in ann.items():
                    if v == "":
                        cur.pop(k, None)
                    else:
                        cur[k] = v


def cluster_objects(kind: str):
    """Nodes and pods of 5 scheduled decode replicas: TPU slices built
    by the JAX package's stack, or GPU hosts built by the port's."""
    roles = ["prefill", "decode", "", "flex", "bogus"]
    if kind == "tpu":
        s = jax_stack(5, roles=roles)
        kill = lambda r: s.slices[r.slice_id].kill_chip(  # noqa: E731
            next(iter(r.coords)))
    else:
        s = port_stack(5, hosts=("ga", "gb"), cards=4, roles=roles,
                       pin_slices=["ga", "ga", "gb", "gb", "gb"])
        kill = lambda r: s.hosts[r.slice_id].kill_card(  # noqa: E731
            next(iter(r.coords))[0])
    return s, kill


def infos(reg) -> list:
    return [dataclasses.astuple(r) for r in reg.all()]


@pytest.mark.parametrize("kind", ["tpu", "gpu"])
def test_registry_same_replica_info(kind):
    s, kill = cluster_objects(kind)
    api = ObjectsApi(s.api.list_nodes(), s.api.list_pods())
    jr = jax_registry.ReplicaRegistry(api, group="decode")
    pr = port_registry.ReplicaRegistry(api, group="decode")
    seen_j, seen_p = [], []
    jr.subscribe(seen_j.append)
    pr.subscribe(seen_p.append)

    def check():
        jr.refresh()
        pr.refresh()
        assert infos(pr) == infos(jr)
        assert pr.live_keys() == jr.live_keys()
        assert [r.key for r in pr.routable()] == [
            r.key for r in jr.routable()]
        return {r.key: r for r in pr.all()}

    first = check()
    assert len(first) == 5 and all(r.healthy for r in first.values())
    assert [first[k].role for k in sorted(first)] == [
        "prefill", "decode", "flex", "flex", "flex"]
    if kind == "gpu":
        assert first["default/dec-2"].coords == frozenset({(0,)})
        assert first["default/dec-2"].slice_id == "gb"
    # a dead chip under dec-1, advertised
    kill(first["default/dec-1"])
    for a in s.advs.values():
        a.advertise_once()
    api.nodes = s.api.list_nodes()
    after = check()
    assert not after["default/dec-1"].healthy
    assert after["default/dec-1"].reason.startswith("dead chips")
    # pod IPs, a terminal phase, a deleting pod, an unscheduled one
    for i, p in enumerate(api.pods):
        p.setdefault("status", {})["podIP"] = f"10.0.0.{i}"
    api.pods[0]["status"]["phase"] = "Succeeded"
    api.pods[2]["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    api.pods[3]["spec"].pop("nodeName", None)
    now = check()
    assert now["default/dec-0"].reason == "terminal (Succeeded)"
    assert now["default/dec-2"].reason == "terminating"
    assert now["default/dec-3"].reason.startswith("unscheduled")
    assert now["default/dec-4"].addr == "10.0.0.4"
    # draining by the registry's verb and by the durable annotation
    jr.set_draining("default/dec-4")
    pr.set_draining("default/dec-4")
    assert check()["default/dec-4"].draining
    assert pr.draining_keys() == jr.draining_keys()
    api.patch_pod_annotations("default", "dec-4", {
        annotations.POD_DRAINING: ""})
    jr.set_draining("default/dec-4", False)
    pr.set_draining("default/dec-4", False)
    jr.set_role("default/dec-4", "decode")
    pr.set_role("default/dec-4", "decode")
    assert check()["default/dec-4"].role == "decode"
    with pytest.raises(ValueError, match="unknown role"):
        pr.set_role("default/dec-4", "other")
    # a data-plane probe with backoff on a fixed clock
    t = [0.0]
    for reg in (jr, pr):
        reg._clock = lambda: t[0]
        reg.probe = lambda info: ((False, "refused")
                                  if info.key.endswith("4") else (True, ""))
    assert not check()["default/dec-4"].healthy
    t[0] = 0.1
    assert "backing off" in check()["default/dec-4"].reason
    api.pods.pop(4)
    assert "default/dec-4" not in check()
    assert seen_p == seen_j


# ---------------------------------------------------------------------------
# the routers
# ---------------------------------------------------------------------------

def replicas_of(mod, kind: str) -> list:
    s, _ = cluster_objects(kind)
    reg = mod.ReplicaRegistry(ObjectsApi(s.api.list_nodes(),
                                         s.api.list_pods()), group="decode")
    reg.refresh()
    return reg.all()


def pick_trace(rmod, tier_mod, replicas, router_name, seed):
    """Picks of one router over a seeded sequence of requests, loads,
    exclusions and membership changes (as replica keys)."""
    rng = np.random.RandomState(seed)
    tier = None
    if router_name == "least":
        router = rmod.LeastOutstandingRouter()
    elif router_name == "affinity":
        router = rmod.SessionAffinityRouter()
    elif router_name == "hash":
        router = rmod.ConsistentHashRouter(vnodes=32)
    else:
        tier = tier_mod.PrefixTier(page=4)
        router = rmod.PrefixLocalityRouter(tier)
    keys = [r.key for r in replicas]
    prompts = [list(rng.randint(0, 50, size=int(rng.randint(3, 20))))
               for _ in range(12)]
    out = []
    for i in range(300):
        members = [r for r in replicas if rng.rand() < 0.8] or replicas[:1]
        load = {k: int(rng.randint(0, 4)) for k in keys}
        excl = frozenset(k for k in keys if rng.rand() < 0.15)
        p = prompts[rng.randint(len(prompts))]
        r = Req(f"q{i}", session=(f"s{rng.randint(25)}"
                                  if rng.rand() < 0.8 else None),
                prompt=p,
                preferred_slice=(members[0].slice_id
                                 if rng.rand() < 0.3 else None),
                preferred_replica=(keys[rng.randint(len(keys))]
                                   if rng.rand() < 0.3 else None))
        if tier is not None and rng.rand() < 0.3:
            k = keys[rng.randint(len(keys))]
            tier.note_warm(k, port_prefixtier.prompt_chain_keys(p, 4)[
                :int(rng.randint(1, 4))])
        if router_name == "affinity" and rng.rand() < 0.05:
            router.forget_replica(keys[rng.randint(len(keys))])
        choice = router.pick(r, members, load, excl)
        out.append(None if choice is None else choice.key)
    return out


@pytest.mark.parametrize("kind", ["tpu", "gpu"])
@pytest.mark.parametrize("router_name", ["least", "affinity", "hash",
                                         "prefix"])
def test_router_same_picks(kind, router_name):
    jreps = replicas_of(jax_registry, kind)
    preps = replicas_of(port_registry, kind)
    assert [dataclasses.astuple(r) for r in preps] == [
        dataclasses.astuple(r) for r in jreps]
    for seed in (0, 1):
        want = pick_trace(jax_router, jax_prefixtier, jreps,
                          router_name, seed)
        got = pick_trace(port_router, port_prefixtier, preps,
                         router_name, seed)
        assert got == want
        assert len(set(want) - {None}) >= 2


@pytest.mark.parametrize("kind", ["tpu", "gpu"])
def test_handoff_rank_key_same_order(kind):
    jreps = replicas_of(jax_registry, kind)
    preps = replicas_of(port_registry, kind)
    rng = np.random.RandomState(3)
    for _ in range(50):
        load = {r.key: int(rng.randint(0, 5)) for r in preps}
        a = int(rng.randint(-1, len(preps)))
        janchor = jreps[a] if a >= 0 else None
        panchor = preps[a] if a >= 0 else None
        assert ([port_router.handoff_rank_key(r, panchor, load)
                 for r in preps]
                == [jax_router.handoff_rank_key(r, janchor, load)
                    for r in jreps])


# ---------------------------------------------------------------------------
# the prefix tier's chain keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [0, 1, 4, 16, 32])
def test_prompt_chain_keys_bit_identical(page):
    rng = np.random.RandomState(page)
    for n in (0, 3, 31, 32, 100, 257):
        prompt = rng.randint(0, 32768, size=n).tolist()
        want = jax_prefixtier.prompt_chain_keys(prompt, page)
        assert port_prefixtier.prompt_chain_keys(prompt, page) == want
        assert port_prefixtier.prompt_chain_keys(
            np.asarray(prompt, np.int64), page) == want
        if page > 0:
            assert len(want) == n // page


def test_prompt_chain_keys_are_the_batchers_seal_keys():
    """The keys the gateway probes with are the ones the port's paged
    batcher seals its prompt pages under."""
    from kubegpu_tpu_torch.models.paging import chain_keys

    rng = np.random.RandomState(7)
    stream = rng.randint(0, 61, size=37).tolist()
    keys = chain_keys(np.asarray(stream, np.int32), 4, 9)
    assert port_prefixtier.prompt_chain_keys(stream, 4) == [
        k.hex() for k in keys]


# ---------------------------------------------------------------------------
# the gateway side stands without torch
# ---------------------------------------------------------------------------

def test_the_gateway_side_imports_no_torch():
    code = (
        "import sys\n"
        "import kubegpu_tpu_torch.gateway\n"
        "import kubegpu_tpu_torch.gateway.server\n"
        "import kubegpu_tpu_torch.gateway.tier\n"
        "import kubegpu_tpu_torch.gateway.sessionstore\n"
        "import kubegpu_tpu_torch.testing.fake_serving\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('torch', 'jax', 'kubegpu_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
