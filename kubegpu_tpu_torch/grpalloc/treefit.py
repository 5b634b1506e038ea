"""The port's copy of the JAX package's ``grpalloc/treefit.py``.

Generic wildcard grouped-resource fit (capability parity).

The reference's grpalloc matched arbitrary request *trees* with wildcard
group indexes against a node's allocatable tree — e.g. request
``gpugrp0/*/gpu/*/cards×2`` means "two cards under any matching group"
(SURVEY.md §2 #3: scalar requests expand to wildcard tree requests).  The TPU
path doesn't need this generality (TpuRequest + mesh coords cover it), but
the capability is preserved for arbitrary grouped resources.

Matching wildcard requests to concrete leaves with quantities is a
transportation problem (greedy ordering gives false no-fits when a wildcard
steals leaves a more specific request needed), so feasibility is decided
exactly with a small max-flow: request leaves are sources (capacity = want),
concrete leaves are sinks (capacity = available), an edge where the pattern
matches.  Fits iff max flow == total requested.  Graphs are tiny (≤ a few
hundred leaves), so BFS augmenting paths are plenty.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from kubegpu_tpu_torch.types.resource import ResourcePath, ResourceTree


@dataclass
class TreeFitResult:
    fits: bool
    reason: str = ""
    # wildcard request path string -> list of (concrete path, qty taken)
    bindings: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)


def fit_request_tree(request: ResourceTree, allocatable: ResourceTree) -> TreeFitResult:
    """Exact feasibility + binding of a (possibly wildcarded) request tree
    against allocatable quantities, via integral max-flow."""
    reqs = [(p, q) for p, q in request.walk() if q > 0]
    avail = [(p, q) for p, q in allocatable.walk() if q > 0]
    want_total = sum(q for _, q in reqs)
    if want_total == 0:
        return TreeFitResult(fits=True)

    # Node ids: 0 = source, 1..R = requests, R+1..R+A = concrete, last = sink.
    R, A = len(reqs), len(avail)
    source, sink = 0, R + A + 1
    cap: Dict[Tuple[int, int], int] = {}

    def add_edge(u: int, v: int, c: int) -> None:
        cap[(u, v)] = cap.get((u, v), 0) + c
        cap.setdefault((v, u), 0)

    adj: Dict[int, List[int]] = {i: [] for i in range(R + A + 2)}

    def connect(u: int, v: int, c: int) -> None:
        if v not in adj[u]:
            adj[u].append(v)
            adj[v].append(u)
        add_edge(u, v, c)

    for i, (rp, rq) in enumerate(reqs):
        connect(source, 1 + i, rq)
        for j, (cp, _) in enumerate(avail):
            if rp.matches(cp):
                connect(1 + i, R + 1 + j, rq)
    for j, (_, cq) in enumerate(avail):
        connect(R + 1 + j, sink, cq)

    flow = 0
    while True:
        # BFS for an augmenting path
        parent = {source: -1}
        dq = deque([source])
        while dq and sink not in parent:
            u = dq.popleft()
            for v in adj[u]:
                if v not in parent and cap.get((u, v), 0) > 0:
                    parent[v] = u
                    dq.append(v)
        if sink not in parent:
            break
        # bottleneck
        b = None
        v = sink
        while v != source:
            u = parent[v]
            c = cap[(u, v)]
            b = c if b is None else min(b, c)
            v = u
        v = sink
        while v != source:
            u = parent[v]
            cap[(u, v)] -= b
            cap[(v, u)] += b
            v = u
        flow += b

    if flow < want_total:
        # name one unsatisfied request for the error message
        short = None
        for i, (rp, rq) in enumerate(reqs):
            unfilled = cap[(source, 1 + i)]
            if unfilled > 0:
                short = (rp, rq, rq - unfilled)
                break
        if short:
            rp, rq, got = short
            reason = f"request {rp} wants {rq}, only {got} assignable"
        else:
            reason = f"want {want_total} total, only {flow} assignable"
        return TreeFitResult(fits=False, reason=reason)

    result = TreeFitResult(fits=True)
    for i, (rp, _) in enumerate(reqs):
        got: List[Tuple[str, int]] = []
        for j, (cp, _) in enumerate(avail):
            back = cap.get((R + 1 + j, 1 + i), 0)
            if back > 0:
                got.append((str(cp), back))
        result.bindings[str(rp)] = got
    return result


def expand_scalar_request(resource: str, count: int, template: str) -> ResourceTree:
    """The reference's request-translation capability (SURVEY.md §2 #3):
    expand a scalar 'N devices' request into a wildcard tree request, e.g.
    template 'tpu-slice/*/host/*/chip/*/tpu' with count=4."""
    t = ResourceTree()
    path = ResourcePath.parse(template)
    if not path.has_wildcard:
        t.add(path, count)
        return t
    # wildcard paths bypass add()'s concrete-only check
    node = t
    for kind, idx in path.groups:
        node = node.child(kind, idx, create=True)
    node.leaves[path.leaf] = count
    return t
