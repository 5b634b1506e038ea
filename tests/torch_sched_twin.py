"""Two scheduler extenders fed one stream, for the parity tests of the
port's control plane (tests/test_torch_grpalloc.py,
tests/test_torch_scheduler.py, tests/test_torch_extender.py): the JAX
package's ``Scheduler`` and the port's, each over its own in-memory API
server holding the same nodes, and the canonical form in which both
packages' results are compared.

Clusters are fabricated two ways:

- TPU slices, advertised by the JAX package's ``FakeSlice`` and
  ``Advertiser`` (the reference's own inputs);
- GPU hosts, advertised by the port's ``FakeGpuHost`` and ``Advertiser``
  (each host a slice of its own, its cards a line).

Either way the advertiser's node patches are recorded once and replayed
into both API servers, so the two extenders read the same bytes."""

import copy
import dataclasses
import enum
import json
import random

from kubegpu_tpu.plugins import Advertiser as JaxAdvertiser
from kubegpu_tpu.plugins import FakeSlice
from kubegpu_tpu.scheduler import Scheduler as JaxScheduler
from kubegpu_tpu.utils.apiserver import InMemoryApiServer as JaxApiServer
from kubegpu_tpu.utils.metrics import Metrics as JaxMetrics
from kubegpu_tpu_torch.plugins.advertiser import Advertiser
from kubegpu_tpu_torch.plugins.fake import FakeGpuHost
from kubegpu_tpu_torch.scheduler import Scheduler
from kubegpu_tpu_torch.types import annotations
from kubegpu_tpu_torch.types.resource import RES_TPU
from kubegpu_tpu_torch.utils.apiserver import InMemoryApiServer
from kubegpu_tpu_torch.utils.metrics import Metrics


def plain(x):
    """A package-free form of a result: dataclasses by class name and
    fields, enums by value, trees by their flat leaves, sets sorted,
    dict keys that are not strings JSON-encoded."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = {"__type__": type(x).__name__}
        for f in dataclasses.fields(x):
            out[f.name] = plain(getattr(x, f.name))
        return out
    if isinstance(x, enum.Enum):
        return x.value
    if hasattr(x, "to_flat") and hasattr(x, "walk"):
        return {"__tree__": x.to_flat()}
    if isinstance(x, dict):
        return {(k if isinstance(k, str) else json.dumps(plain(k))): plain(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((plain(v) for v in x), key=repr)
    return x


# -- fabricated hosts ---------------------------------------------------------

class _Recorder:
    """Takes an advertiser's node patches so they can be replayed."""

    def __init__(self):
        self.calls = []

    def patch_node_annotations(self, name, ann):
        self.calls.append(("patch_node_annotations", name, dict(ann)))

    def patch_node_capacity(self, name, capacity):
        self.calls.append(("patch_node_capacity", name, dict(capacity)))


class Fleet:
    """Fabricated device hosts of one kind: ``tpu`` slices (JAX
    ``FakeSlice`` of ``mesh``/``block``/``wrap``, ``n`` of them) or
    ``gpu`` hosts (the port's ``FakeGpuHost`` of ``cards``, ``n`` of
    them).  A device is ``(node, device_index)``."""

    def __init__(self, kind, n=1, mesh=(4, 4), block=(2, 2), cards=8,
                 wrap=None):
        self.kind = kind
        self.slices = {}
        self.hosts = {}
        if kind == "tpu":
            for i in range(n):
                sid = f"s{i}"
                self.slices[sid] = FakeSlice(slice_id=sid, mesh_shape=mesh,
                                             host_block=block, wrap=wrap)
        elif kind == "gpu":
            for i in range(n):
                name = f"gpu-{i}"
                self.hosts[name] = FakeGpuHost(name, cards=cards)
        else:
            raise ValueError(kind)

    def nodes(self):
        if self.kind == "tpu":
            return sorted(h for fs in self.slices.values() for h in fs.hosts())
        return sorted(self.hosts)

    def devices(self):
        out = []
        if self.kind == "tpu":
            for fs in self.slices.values():
                for ch in fs.topology.chips.values():
                    out.append((ch.host_id, ch.device_index))
        else:
            for name, host in self.hosts.items():
                out.extend((name, i) for i in range(len(host.uuids)))
        return sorted(out)

    def _chip(self, node, index):
        for fs in self.slices.values():
            for ch in fs.topology.host_chips(node):
                if ch.device_index == index:
                    return fs, ch.coords
        raise KeyError((node, index))

    def kill(self, node, index):
        if self.kind == "tpu":
            fs, coords = self._chip(node, index)
            fs.kill_chip(coords)
        else:
            self.hosts[node].kill_card(index)

    def revive(self, node, index):
        if self.kind == "tpu":
            fs, coords = self._chip(node, index)
            fs.revive_chip(coords)
        else:
            self.hosts[node].revive_card(index)

    def advertise(self, node):
        """The advertiser's patches for ``node`` (one cycle)."""
        rec = _Recorder()
        if self.kind == "tpu":
            fs = next(f for f in self.slices.values() if node in f.hosts())
            JaxAdvertiser(fs.provider_for(node), rec).advertise_once()
        else:
            Advertiser(self.hosts[node].provider(), rec).advertise_once()
        return rec.calls

    def node_objects(self):
        """Every node as an API server holds it after one advertisement."""
        api = InMemoryApiServer()
        for node in self.nodes():
            replay(api, self.advertise(node))
        return sorted(api.list_nodes(), key=lambda n: n["metadata"]["name"])


def replay(api, calls):
    for verb, name, payload in calls:
        getattr(api, verb)(name, payload)


# -- pods ---------------------------------------------------------------------

def pod_obj(name, chips, group=None, size=1, priority=0, contiguous=True,
            multislice=False, group_uid=None, extended=None, ns="default"):
    ann = {}
    if group:
        ann[annotations.POD_GROUP] = group
        ann[annotations.POD_GROUP_SIZE] = str(size)
        if group_uid:
            ann[annotations.POD_GROUP_UID] = group_uid
    if priority:
        ann[annotations.POD_PRIORITY] = str(priority)
    if not contiguous:
        ann[annotations.POD_CONTIGUOUS] = "false"
    if multislice:
        ann[annotations.POD_MULTISLICE] = "true"
    limits = {RES_TPU: str(chips)} if chips else {}
    limits.update(extended or {})
    return {
        "metadata": {"name": name, "namespace": ns, "uid": f"uid-{name}",
                     "annotations": ann},
        "spec": {"priority": priority, "containers": [
            {"name": "main", "resources": {"limits": limits}}]},
    }


# -- the two extenders ----------------------------------------------------------

def _normal_annotations(ann):
    """Pod annotations with the bind's wall-clock stamp taken out of the
    assignment (the two extenders bind a few microseconds apart)."""
    out = dict(ann or {})
    payload = out.get(annotations.POD_ASSIGNMENT)
    if payload:
        d = json.loads(payload)
        assert d.pop("bound_at", 0.0) > 0.0, d
        out[annotations.POD_ASSIGNMENT] = json.dumps(d, sort_keys=True)
    return out


def cached_assignments(sched):
    """The extender cache's assignments, each bind stamp reduced to
    whether it is set."""
    out = plain(sched.cache.assignments_snapshot())
    for a in out.values():
        a["bound_at"] = a["bound_at"] > 0.0
    return out


def api_state(api):
    """What an in-memory API server holds: each pod's node and
    annotations, each node's annotations and capacity, and the events'
    (object, reason, message, type) in order.  Read under the server's
    lock, not through its ``list_*`` verbs: their deep copies of every
    object would take most of a soak's time."""
    with api._lock:
        pods = {}
        for key, p in api._pods.items():
            pods[key] = ((p.get("spec") or {}).get("nodeName"),
                         _normal_annotations(p["metadata"].get("annotations")))
        nodes = {}
        for name, n in api._nodes.items():
            cap = (n.get("status") or {}).get("capacity")
            nodes[name] = (dict(n["metadata"].get("annotations") or {}),
                           None if cap is None else dict(cap))
        events = [(e["involvedObject"]["namespace"],
                   e["involvedObject"]["name"], e["reason"], e["message"],
                   e["type"]) for e in api._events]
    return {"pods": pods, "nodes": nodes, "events": events}


def pod_keys(api):
    """The ``namespace/name`` of every pod an in-memory API server holds,
    sorted (read under its lock, as :func:`api_state`)."""
    with api._lock:
        return sorted(api._pods)


class Twin:
    """The JAX package's extender (``jax``) and the port's (``port``),
    each over its own API server (``jax_api``, ``port_api``), given the
    same nodes, pods and calls.  Every verb returns both answers."""

    def __init__(self, fleet, extra_nodes=(), registries=(None, None),
                 **sched_kw):
        self.fleet = fleet
        self.registries = registries
        self.sched_kw = sched_kw
        self.jax_api = JaxApiServer()
        self.port_api = InMemoryApiServer()
        for obj in fleet.node_objects() + list(extra_nodes):
            self.jax_api.add_node(copy.deepcopy(obj))
            self.port_api.add_node(copy.deepcopy(obj))
        self.restart()

    # -- lifecycle
    def restart(self):
        """New scheduler processes over the same API servers: both
        rebuild their caches from the annotations.  ``registries`` are
        the two packages' plugin registries (None: the default)."""
        self.jax = JaxScheduler(self.jax_api, metrics=JaxMetrics(),
                                plugins=self.registries[0], **self.sched_kw)
        self.port = Scheduler(self.port_api, metrics=Metrics(),
                              plugins=self.registries[1], **self.sched_kw)
        self.jax.cache.refresh()
        self.port.cache.refresh()

    def both(self, fn):
        return fn(self.jax, self.jax_api), fn(self.port, self.port_api)

    # -- cluster
    def nodes(self):
        return self.fleet.nodes()

    def readvertise(self, node, watch=True):
        """One advertiser cycle of ``node`` into both API servers, then
        (``watch``) the node-watch event into both extenders."""
        calls = self.fleet.advertise(node)
        replay(self.jax_api, calls)
        replay(self.port_api, calls)
        if watch:
            return self.both(lambda s, a: s.on_node_updated(a.get_node(node)))
        return None, None

    def create(self, obj):
        self.jax_api.create_pod(copy.deepcopy(obj))
        self.port_api.create_pod(copy.deepcopy(obj))

    def delete(self, ns, name):
        def go(s, a):
            obj = a.get_pod(ns, name)
            a.delete_pod(ns, name)
            s.on_pod_deleted(obj)
        return self.both(go)

    # -- verbs
    def filter(self, obj, names=None):
        names = self.nodes() if names is None else names
        return self.both(lambda s, a: s.filter(copy.deepcopy(obj), list(names)))

    def prioritize(self, obj, names):
        return self.both(lambda s, a: s.prioritize(copy.deepcopy(obj),
                                                   list(names)))

    def bind(self, ns, name, node):
        return self.both(lambda s, a: s.bind(ns, name, node))

    def preemption_victims(self, obj, candidates=None):
        return self.both(lambda s, a: s.preemption_victims(
            copy.deepcopy(obj), candidates))

    def resync(self):
        return self.both(lambda s, a: s.resync())

    def schedule(self, obj):
        """kube-scheduler's cycle for one pending pod on both: filter,
        prioritize the feasible nodes, bind to the best (ties to the first
        name).  Returns the node bound, or None; asserts every answer
        equal on the way."""
        ns = obj["metadata"].get("namespace", "default")
        name = obj["metadata"]["name"]
        fj, fp = self.filter(self.jax_api.get_pod(ns, name))
        assert plain(fp) == plain(fj)
        if not fj.nodes:
            return None
        pj, pp = self.prioritize(self.jax_api.get_pod(ns, name), fj.nodes)
        assert pp == pj
        best = max(pj, key=lambda hs: hs[1])[0] if pj else fj.nodes[0]
        bj, bp = self.bind(ns, name, best)
        assert bp == bj
        return best if bj is None else None

    # -- state
    def assert_same(self):
        sj, sp = api_state(self.jax_api), api_state(self.port_api)
        assert sp["pods"] == sj["pods"]
        assert sp["nodes"] == sj["nodes"]
        assert sp["events"] == sj["events"]
        assert (cached_assignments(self.port)
                == cached_assignments(self.jax))
        assert self.port.cache.assumed_keys() == self.jax.cache.assumed_keys()
        assert (plain(self.port.groups.plans_snapshot())
                == plain(self.jax.groups.plans_snapshot()))
        return sp


def random_pod(rng, i, max_chips=4, multislice=False):
    """A seeded pod or gang: one pod (0-``max_chips`` chips, maybe
    non-contiguous, maybe a priority), or a gang of 2-4 pods of 1-2
    chips each.  Returns a list of pod objects."""
    prio = rng.choice([0, 0, 1, 5, 9])
    if rng.random() < 0.35:
        size = rng.choice([2, 3, 4])
        chips = rng.choice([1, 1, 2])
        ms = multislice and rng.random() < 0.5
        return [pod_obj(f"g{i}-{k}", chips, group=f"g{i}", size=size,
                        priority=prio, multislice=ms)
                for k in range(size)]
    chips = rng.choice(list(range(0, max_chips + 1)) + [1, 1, 2])
    return [pod_obj(f"p{i}", chips, priority=prio,
                    contiguous=rng.random() < 0.8)]


def soak(twin, seed, n_ops, max_chips=4, multislice=False):
    """``n_ops`` seeded operations on both extenders, the API-visible
    state compared after each: create a pod or a gang (and run
    kube-scheduler's cycle for it), delete a pod, kill or revive a
    device, re-advertise a node, resync, restart the schedulers.  Returns
    the count of each operation done."""
    rng = random.Random(seed)
    done = {}
    devices = twin.fleet.devices()
    dead = set()
    for i in range(n_ops):
        r = rng.random()
        pods = pod_keys(twin.port_api)
        if r < 0.45 or not pods:
            op = "create"
            objs = random_pod(rng, i, max_chips, multislice)
            for o in objs:
                twin.create(o)
            for o in objs:
                twin.schedule(o)
        elif r < 0.60:
            op = "delete"
            twin.delete(*rng.choice(pods).split("/"))
        elif r < 0.70:
            op = "kill"
            dev = rng.choice(devices)
            twin.fleet.kill(*dev)
            dead.add(dev)
            twin.readvertise(dev[0])
        elif r < 0.78 and dead:
            op = "revive"
            dev = rng.choice(sorted(dead))
            dead.discard(dev)
            twin.fleet.revive(*dev)
            twin.readvertise(dev[0])
        elif r < 0.85:
            op = "readvertise"
            twin.readvertise(rng.choice(twin.nodes()))
        elif r < 0.93:
            op = "resync"
            twin.resync()
        else:
            op = "restart"
            twin.restart()
        done[op] = done.get(op, 0) + 1
        twin.assert_same()
    return done
