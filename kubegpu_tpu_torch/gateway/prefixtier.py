"""The port's copy of the JAX package's ``gateway/prefixtier.py``.

Fleet-wide shared-prefix KV tier: prefill any hot prefix once, ever.

Every replica re-prefills hot shared prefixes (system prompts, RAG
corpus chunks, agent scaffolds) once per LOCAL cache lifetime, even
though sealed chains are content-addressed (the ``PrefixPageCache``
keys are cumulative sha256 over the token stream) and the external
store already moves sealed-KV payloads for session failover.  This
module promotes the store to a GLOBAL prefix tier:

- **publish**: when a replica seals a chain (any completed request),
  the gateway exports it (``client.export_sealed`` — the existing
  ``/v1/export`` sealed twin) and publishes it to the store keyed by
  the chain's cumulative content hash.  The store deduplicates payload
  bytes by content with refcounted references, gives prefixes their own
  TTL/eviction class (immortal-while-hot, popularity-weighted LRU —
  distinct from session leases), and quantized pools ride the int8
  half-width wire for free (the payload carries its ``scales``).
- **probe + import**: at dispatch, when the routed replica is not
  already warm for the request's prompt, the tier probes the store
  METADATA-FIRST (the longest stored chain sharing a prefix with the
  prompt — a point lookup per page key, walked longest-first) and
  imports the stored chain into the replica BEFORE prefill.  A hot
  system prompt therefore prefills ONCE fleet-wide; every other
  replica's first sight of it is a KV import, not a prefill.
- **locality**: the tier keeps an advisory per-replica warmth map
  (which chains were sealed on / imported into each replica) that
  ``PrefixLocalityRouter`` scores routes by — an agent fleet sharing
  one scaffold packs onto warm replicas instead of spraying imports.

Degradation contract (same discipline as the session store): the tier
is an OPTIMIZATION, never a dependency.  Store unreachable, a probe
error, an import refusal — every failure resolves as a counted cold
prefill (``gateway_prefix_tier_degraded_total{reason}`` plus the
``degraded_log`` audit trail), NEVER a request error.  The warmth map
is advisory the same way: a stale entry costs at most one skipped probe
or one cold route, never correctness — the replica's own content-keyed
cache is the ground truth at admission.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from kubegpu_tpu_torch.gateway.sessionstore import (
    InProcessStoreBackend,
    SessionStoreBackend,
)
from kubegpu_tpu_torch.utils.metrics import Metrics

log = logging.getLogger(__name__)

PREFIX_DEGRADE_REASONS = ("unreachable", "error")


def prompt_chain_keys(prompt, page: int) -> List[str]:
    """Cumulative chain keys of a prompt's full pages — the EXACT
    discipline ``PagedContinuousBatcher._chain_keys`` seals under (one
    sha256 updated per int32 page window, snapshot per page), so keys
    computed gateway-side hit chains sealed replica-side.  Only full
    pages have keys; a partial tail page is never sealed and never
    probes."""
    if page <= 0:
        return []
    stream = np.asarray(list(prompt), np.int32)
    n_full = stream.shape[0] // page
    h = hashlib.sha256()
    keys: List[str] = []
    for j in range(n_full):
        h.update(stream[j * page: (j + 1) * page].tobytes())
        keys.append(h.copy().hexdigest())
    return keys


class PrefixTier:
    """The gateway-side prefix-tier engine over a ``SessionStoreBackend``
    that implements the prefix namespace (``InProcessStoreBackend`` in
    one process, ``HttpStoreClient`` against the external store — the
    same object the ``SessionKVStore`` runs over, so one store serves
    both key classes).

    ``page`` is the fleet's KV page size (the chain-hash window).  The
    tier also LEARNS per-replica page sizes from payload geometry as
    publishes/imports flow, so mixed-page fleets probe with the right
    keys once a replica has spoken.

    Publishes run asynchronously off the result path (bounded queue,
    drop-oldest, deduped by chain key — the same insurance-not-blocking
    shape as ``SessionKVStore.capture_async``)."""

    def __init__(self, backend: Optional[SessionStoreBackend] = None,
                 page: int = 8,
                 metrics: Optional[Metrics] = None,
                 max_warm_chains: int = 4096,
                 max_published: int = 8192,
                 publish_queue: int = 64) -> None:
        self.backend = backend if backend is not None else (
            InProcessStoreBackend()
        )
        self.default_page = int(page)
        self.metrics = metrics
        self.max_warm_chains = max_warm_chains
        self.max_published = max_published
        self.publish_queue = publish_queue
        self._lock = threading.Lock()
        # replica key -> chain key (hex) -> pages covered (advisory
        # warmth: sealed-here / imported-here; dropped on any replica
        # lifecycle event — stale = one cold route, never wrong tokens)
        self._warm: Dict[str, "OrderedDict[str, int]"] = {}
        # replica key -> learned page size (payload geometry)
        self._replica_page: Dict[str, int] = {}
        # chain keys this gateway already published (bounded): a hot
        # prefix's thousandth completion must not re-export megabytes
        self._published: "OrderedDict[str, bool]" = OrderedDict()
        # every degrade event in order: (op, reason) — the audit trail
        # the soak holds against the metric
        self.degraded_log: List[Tuple[str, str]] = []
        self._cond = threading.Condition()
        self._queue: deque = deque()   # (client, replica_key, stream)
        self._inflight = 0
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    # -- accounting --------------------------------------------------------
    def _degrade(self, op: str, reason: str) -> None:
        with self._lock:
            self.degraded_log.append((op, reason))
        if self.metrics is not None:
            self.metrics.inc("gateway_prefix_tier_degraded_total",
                             reason=reason)

    # -- warmth map --------------------------------------------------------
    def page_for(self, replica_key: str) -> int:
        with self._lock:
            return self._replica_page.get(replica_key, self.default_page)

    def _learn_geometry(self, replica_key: str, payload) -> None:
        page = 0
        if isinstance(payload, dict):
            page = int((payload.get("geometry") or {}).get("page") or 0)
        if page > 0:
            with self._lock:
                self._replica_page[replica_key] = page

    def note_warm(self, replica_key: str, keys: Iterable[str]) -> None:
        """Record chain keys known resident on one replica (sealed there
        or imported there).  Advisory — bounded LRU per replica."""
        with self._lock:
            warm = self._warm.setdefault(replica_key, OrderedDict())
            for i, key in enumerate(keys):
                warm[str(key)] = i + 1
                warm.move_to_end(str(key))
            while len(warm) > self.max_warm_chains:
                warm.popitem(last=False)

    def warm_pages(self, replica_key: str, keys: List[str]) -> int:
        """Longest prefix of ``keys`` (a prompt's cumulative chain keys)
        believed warm on ``replica_key``, in pages.  Cumulative hashing
        means key j warm ⇒ pages 0..j warm — one lookup per key walked
        longest-first."""
        with self._lock:
            warm = self._warm.get(replica_key)
            if not warm:
                return 0
            for j in range(len(keys) - 1, -1, -1):
                if str(keys[j]) in warm:
                    warm.move_to_end(str(keys[j]))
                    return j + 1
        return 0

    def locality_scores(self, prompt,
                        replica_keys: Iterable[str]) -> Dict[str, int]:
        """Warm-page count per replica for one prompt — the router's
        scoring input.  Chain keys are computed once per distinct page
        size, not once per replica."""
        keys_by_page: Dict[int, List[str]] = {}
        out: Dict[str, int] = {}
        for rk in replica_keys:
            page = self.page_for(rk)
            if page not in keys_by_page:
                keys_by_page[page] = prompt_chain_keys(prompt, page)
            keys = keys_by_page[page]
            out[rk] = self.warm_pages(rk, keys) if keys else 0
        return out

    def forget_replica(self, replica_key: str) -> None:
        """Replica drained/died/cold-restarted: its warmth is gone (or
        unknowable, which is the same thing for an advisory map)."""
        with self._lock:
            self._warm.pop(replica_key, None)

    def sync_live(self, live) -> None:
        live = set(live)
        with self._lock:
            for key in [k for k in self._warm if k not in live]:
                self._warm.pop(key, None)

    # -- the dispatch-path read (probe + pre-prefill import) ---------------
    def ensure_warm(self, request, replica_key: str, client) -> bool:
        """Called at dispatch with the routed target: if the target is
        not already warm for this prompt, probe the tier for the longest
        stored prefix and import it BEFORE the attempt opens — so the
        replica's admission finds the pages already cached and prefills
        only the genuinely new tail.  True only when a payload actually
        landed.  Every store failure degrades to a counted cold
        prefill, never an error."""
        prompt = getattr(request, "prompt", None)
        if not prompt:
            return False
        page = self.page_for(replica_key)
        keys = prompt_chain_keys(prompt, page)
        if not keys:
            return False
        local = self.warm_pages(replica_key, keys)
        if local >= len(keys):
            return False   # locally warm: the replica's own cache serves
        try:
            probe = self.backend.probe_prefix(keys)
        except Exception:  # noqa: BLE001 - the tier must never raise
            self._degrade("probe", "error")
            return False
        if probe.status == "unreachable":
            self._degrade("probe", "unreachable")
            return False
        if probe.status != "ok" or not probe.entry:
            if self.metrics is not None:
                self.metrics.inc("gateway_prefix_tier_misses_total")
            return False
        if self.metrics is not None:
            self.metrics.inc("gateway_prefix_tier_hits_total")
        entry = probe.entry
        chain = entry.get("chain")
        match = int(entry.get("match_pages") or 0)
        if not chain or match <= local:
            return False   # the tier holds nothing beyond local warmth
        try:
            full = self.backend.get_prefix(str(chain))
        except Exception:  # noqa: BLE001
            self._degrade("fetch", "error")
            return False
        if full.status == "unreachable":
            self._degrade("fetch", "unreachable")
            return False
        if full.status != "ok" or not full.entry:
            return False   # evicted between probe and fetch: cold
        payload = full.entry.get("payload")
        if payload is None:
            return False
        try:
            imported = bool(client.import_sealed(replica_key, payload))
        except Exception:  # noqa: BLE001 - import is best-effort
            log.exception("prefix-tier import failed")
            imported = False
        if imported:
            if self.metrics is not None:
                self.metrics.inc("gateway_prefix_tier_imports_total")
            self._learn_geometry(replica_key, payload)
            self.note_warm(
                replica_key,
                [str(k) for k in full.entry.get("page_keys") or []],
            )
        return imported

    # -- the publish hook (sealed chains -> the tier) ----------------------
    def publish(self, client, replica_key: str, stream) -> bool:
        """Export the sealed chain for ``stream`` from the replica that
        just served it and publish it under its chain key.  Metadata-
        first: a chain the store already holds costs one meta GET, not a
        payload upload (and a re-publish store-side is a popularity
        bump, never a duplicate — the payload table is content-
        addressed and refcounted).  Best-effort end to end."""
        try:
            payload = client.export_sealed(replica_key, list(stream))
        except Exception:  # noqa: BLE001 - export is best-effort
            payload = None
        if not payload:
            return False
        page_keys = [str(k) for k in payload.get("page_keys") or []]
        if not page_keys:
            return False
        self._learn_geometry(replica_key, payload)
        self.note_warm(replica_key, page_keys)  # sealed here ⇒ warm here
        chain = page_keys[-1]
        with self._lock:
            if chain in self._published:
                self._published.move_to_end(chain)
                return False
        try:
            meta = self.backend.get_prefix(chain, meta=True)
        except Exception:  # noqa: BLE001
            self._degrade("publish", "error")
            return False
        if meta.status == "unreachable":
            self._degrade("publish", "unreachable")
            return False
        if meta.status == "ok":
            self._mark_published(chain)
            return False   # a sibling already published it
        try:
            res = self.backend.put_prefix(chain, {
                "payload": payload,
                "page_keys": page_keys,
                "pages": len(page_keys),
            })
        except Exception:  # noqa: BLE001
            self._degrade("publish", "error")
            return False
        if res.status == "unreachable":
            self._degrade("publish", "unreachable")
            return False
        if res.status != "ok":
            return False
        self._mark_published(chain)
        if self.metrics is not None:
            self.metrics.inc("gateway_prefix_tier_publishes_total")
        return True

    def _mark_published(self, chain: str) -> None:
        with self._lock:
            self._published[chain] = True
            self._published.move_to_end(chain)
            while len(self._published) > self.max_published:
                self._published.popitem(last=False)

    def publish_async(self, client, replica_key: str, stream) -> None:
        """Queue a publish off the result path (bounded, drop-oldest,
        deduped).  The cheap pre-gate: when the stream's chain key (at
        the replica's learned page size) was already published by this
        gateway, skip the queue entirely — a wrong learned page size
        only skips the OPTIMIZATION (the publish itself dedups)."""
        stream = [int(t) for t in stream]
        page = self.page_for(replica_key)
        n_full = max(0, (len(stream) - 1)) // page
        if n_full < 1:
            return   # nothing sealable: no full committed page
        keys = prompt_chain_keys(stream, page)
        chain = keys[n_full - 1] if len(keys) >= n_full else None
        with self._cond:
            if self._closed:
                return
            if chain is not None and chain in self._published:
                self._published.move_to_end(chain)
                return
            for i, (_, _, queued) in enumerate(self._queue):
                if queued == stream:
                    del self._queue[i]
                    break
            self._queue.append((client, replica_key, stream))
            dropped = 0
            while len(self._queue) > self.publish_queue:
                self._queue.popleft()
                dropped += 1
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._publish_loop, name="prefix-tier-publish",
                    daemon=True,
                )
                self._worker.start()
            self._cond.notify()
        if dropped and self.metrics is not None:
            self.metrics.inc(
                "gateway_prefix_tier_publish_drops_total", dropped
            )

    def _publish_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(0.1)
                if self._closed and not self._queue:
                    return
                client, replica_key, stream = self._queue.popleft()
                self._inflight += 1
            try:
                self.publish(client, replica_key, stream)
            except Exception:  # noqa: BLE001 - must never raise
                log.exception("async prefix publish failed")
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def flush_publishes(self, timeout: float = 10.0) -> bool:
        """Wait for every queued publish to land (tests, drains)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.1))
        return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- views -------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "warm_replicas": len(self._warm),
                "warm_chains": sum(len(w) for w in self._warm.values()),
                "published": len(self._published),
                "degraded": len(self.degraded_log),
            }
