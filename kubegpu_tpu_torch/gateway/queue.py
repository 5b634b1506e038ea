"""The port's copy of the JAX package's ``gateway/queue.py``.

Bounded admission queue with per-tenant fairness and explicit backpressure.

The front door's first job is refusing work it cannot serve: an unbounded
queue converts overload into unbounded latency for EVERYONE (every queued
request eventually times out, after holding memory the whole wait).  This
queue is bounded twice — a global capacity and a per-tenant cap — and a
full queue raises ``QueueFull`` immediately, which the HTTP frontend maps
to 429 so clients back off instead of piling on.

Dequeue is round-robin across tenants with pending work (each tenant's own
requests stay FIFO): one tenant flooding its cap cannot starve another
tenant's single request behind its backlog.  This is the classic fair
front-door shape (c.f. WFQ in inference gateways); weightless round-robin
is enough at this queue's depth.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Deque, Dict, Optional


class QueueFull(Exception):
    """Explicit backpressure: the caller must surface this (HTTP 429),
    never swallow it — a silently dropped request is the failure mode the
    soak's I5 invariant hunts."""


class QueueClosed(Exception):
    pass


class AdmissionQueue:
    def __init__(self, capacity: int = 256,
                 per_tenant_cap: Optional[int] = None) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.per_tenant_cap = per_tenant_cap or capacity
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        # OrderedDict = round-robin ring: pop the first tenant with work,
        # re-append it after serving one request
        self._tenants: "OrderedDict[str, Deque]" = OrderedDict()
        self._depth = 0
        self._closed = False

    def put(self, request) -> None:
        """Admit or refuse NOW (no blocking): the producer is an HTTP
        handler thread that must answer its client either way."""
        tenant = getattr(request, "tenant", "") or ""
        with self._lock:
            if self._closed:
                raise QueueClosed("admission queue closed")
            if self._depth >= self.capacity:
                raise QueueFull(
                    f"queue at capacity ({self.capacity}); retry with backoff"
                )
            q = self._tenants.get(tenant)
            if q is None:
                q = deque()
                self._tenants[tenant] = q
            if len(q) >= self.per_tenant_cap:
                raise QueueFull(
                    f"tenant {tenant!r} at its cap ({self.per_tenant_cap})"
                )
            q.append(request)
            self._depth += 1
            # the admission-wait span: opened the moment the request is
            # durably queued, closed by get() when a dispatcher picks it
            # up — the span twin of gateway_queue_wait_seconds, but
            # per-request and in-tree
            trace = getattr(request, "trace", None)
            if trace is not None:
                request._admission_span = trace.child(
                    "admission_wait", tenant=tenant
                )
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None):
        """Next request, fair across tenants; None on timeout or close."""
        with self._not_empty:
            if self._depth == 0 and not self._closed:
                self._not_empty.wait(timeout)
            if self._depth == 0:
                return None
            # first tenant with work serves one request, then rotates to
            # the back of the ring; empty tenants fall out entirely
            for tenant in list(self._tenants):
                q = self._tenants[tenant]
                if not q:
                    del self._tenants[tenant]
                    continue
                req = q.popleft()
                self._depth -= 1
                del self._tenants[tenant]
                if q:
                    self._tenants[tenant] = q
                span = getattr(req, "_admission_span", None)
                if span is not None:
                    span.end()
                return req
            return None

    def depth(self) -> int:
        with self._lock:
            return self._depth

    def close(self) -> None:
        """Stop admitting; wake every blocked consumer."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
