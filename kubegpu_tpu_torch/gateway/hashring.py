"""The port's copy of the JAX package's ``gateway/hashring.py``.

Consistent hashing: the tier's coordination-free routing agreement.

With N gateways fronting one replica fleet, every gateway must route a
session to the SAME replica without talking to its siblings — a shared
pin table would be a coordination point and a single point of failure,
which is exactly what the tier exists to remove.  A consistent-hash
ring over the replica keys gives that agreement for free: the ring is a
pure function of the membership set (which every gateway already
observes through the shared registry view), so two gateways that see
the same replicas route every session identically, and a gateway that
has never seen a session routes it exactly where its sibling did.

The classic ring properties are the failover story:

- **stability**: a key's owner never changes while its owner stays in
  the ring — adding or removing OTHER nodes cannot move it;
- **bounded movement**: removing a node moves only the keys it owned
  (~1/N of them), each to the next node clockwise; adding a node steals
  ~1/N of the keyspace and nothing else.  Every moved session is a
  "mispin" the SessionKVStore restore path turns into a KV transfer
  instead of a cold prefill.

Hashes are ``hashlib`` (sha1), never Python ``hash()``: the ring must
agree ACROSS PROCESSES, and ``PYTHONHASHSEED`` randomizes ``hash()``
per interpreter.  ``vnodes`` virtual points per node smooth the
keyspace split (the standard variance fix; 64 keeps the max/min owned
fraction within ~2x for small fleets).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import FrozenSet, Iterable, List, Optional, Tuple


def _point(s: str) -> int:
    """Stable 64-bit ring coordinate for a string."""
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")


class ConsistentHashRing:
    """An immutable-by-convention hash ring: ``rebuild`` swaps the whole
    membership (the registry hands us snapshots, not deltas), ``lookup``
    walks clockwise from the key's point to the first non-excluded
    node.  Not thread-safe on its own — callers swap whole instances or
    hold their own lock (the routers do the latter)."""

    def __init__(self, nodes: Iterable[str] = (), vnodes: int = 64) -> None:
        if vnodes < 1:
            raise ValueError(f"vnodes ({vnodes}) must be >= 1")
        self.vnodes = vnodes
        self._nodes: FrozenSet[str] = frozenset()
        self._points: List[Tuple[int, str]] = []
        self._keys: List[int] = []
        self.rebuild(nodes)

    def rebuild(self, nodes: Iterable[str]) -> None:
        nodes = frozenset(nodes)
        if nodes == self._nodes:
            return
        points: List[Tuple[int, str]] = []
        for node in nodes:
            for i in range(self.vnodes):
                # ties on a point are broken by node name so the ring is
                # total and identical on every gateway
                points.append((_point(f"{node}#{i}"), node))
        points.sort()
        self._nodes = nodes
        self._points = points
        self._keys = [p for p, _ in points]

    def nodes(self) -> FrozenSet[str]:
        return self._nodes

    def lookup(self, key: str,
               exclude: FrozenSet[str] = frozenset()) -> Optional[str]:
        """The node owning ``key``; with ``exclude``, the first DISTINCT
        non-excluded node clockwise — the deterministic retry/hedge
        order every gateway agrees on.  None when everything is
        excluded (or the ring is empty)."""
        if not self._points:
            return None
        start = bisect.bisect_left(self._keys, _point(key)) % len(self._points)
        seen = set()
        for off in range(len(self._points)):
            node = self._points[(start + off) % len(self._points)][1]
            if node in seen:
                continue
            seen.add(node)
            if node not in exclude:
                return node
            if len(seen) == len(self._nodes):
                return None
        return None

    def preference(self, key: str, n: Optional[int] = None) -> List[str]:
        """The first ``n`` distinct nodes clockwise from ``key`` — the
        tier client's gateway failover order (home first, then the
        sibling every OTHER client would also pick next)."""
        if not self._points:
            return []
        limit = len(self._nodes) if n is None else min(n, len(self._nodes))
        start = bisect.bisect_left(self._keys, _point(key)) % len(self._points)
        out: List[str] = []
        for off in range(len(self._points)):
            node = self._points[(start + off) % len(self._points)][1]
            if node not in out:
                out.append(node)
                if len(out) >= limit:
                    break
        return out
