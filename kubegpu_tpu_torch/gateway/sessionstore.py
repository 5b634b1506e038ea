"""The port's copy of the JAX package's ``gateway/sessionstore.py``.

Crash-durable session-KV insurance: the store behind the gateway tier.

A gateway tier sharing ONE in-process ``SessionKVStore`` instance
models the contract but not the deployment: sealed-KV failover insurance
captured by a gateway pod dies with that pod, so ``deploy/gateway.yaml
replicas: 2`` needs the store outside the gateways.  This
module externalizes the store so the insurance survives gateway death:

- ``SessionStoreBackend`` — the storage interface ``SessionKVStore``
  runs over.  Every op returns a ``StoreResult`` whose status names the
  failure mode (``absent`` / ``expired`` / ``conflict`` /
  ``unreachable``), because the CALLER's contract is graceful
  degradation: any store trouble resolves as a counted cold prefill
  (``gateway_session_store_degraded_total{reason}``), never a request
  error.
- ``InProcessStoreBackend`` — the default backend (one dict shared by
  the tier) AND the storage engine behind the HTTP
  server, so the two cannot drift: versioned compare-and-swap puts,
  per-session lease/TTL, the 256 MB byte-bounded payload LRU (oldest
  payloads drop, their tiny stream records stay — those sessions
  degrade to cold by design).
- ``StoreServer`` — the standalone HTTP store (``python -m
  kubegpu_tpu_torch.gateway.sessionstore``): one small pod any number of
  gateway pods share.  ``/healthz`` + ``/metrics`` like every other
  endpoint in this repo.
- ``HttpStoreClient`` — the gateway-side backend over that protocol:
  per-op deadlines, bounded retry with exponential backoff + jitter
  (the registry's probe-backoff shape, injectable clock), and a CIRCUIT
  BREAKER so a dead store costs one fast-fail per op, not a deadline
  per request — with the store down, serving degrades to cold prefill
  at full speed.
- ``SessionKVStore`` — the gateway's insurance ledger, now pluggable:
  captures are written through ASYNCHRONOUSLY off the result path
  (bounded queue, drop-oldest — capture is insurance, never
  admission-blocking) and ``restore_for`` reads through at dispatch.

Why compare-and-swap: two gateways can race a capture for the same
session (the tier routes any session through any gateway, and a sibling
retry re-homes mid-conversation).  A capture exports the replica's
sealed chain for the stream it READ at version v; by the time the
payload comes back, a newer turn may have superseded the entry.  The
put carries ``if_version=v`` so the stale capture LOSES (counted, not
retried — the newer turn's own capture is already queued) instead of
interleaving an old seal over a newer one.

Wire protocol (JSON bodies; payloads are relayed opaquely — the store
never decodes KV bytes):

    GET    /v1/session/<id>       -> 200 {"entry", "version"}
                                     404 {"reason": "absent"|"lease_expired"}
    PUT    /v1/session/<id>       {"entry", "if_version": v|null,
                                   "lease_s": s|null}
                                  -> 200 {"version"} | 409 (CAS conflict)
    DELETE /v1/session/<id>       -> 200 {"deleted": bool}
    GET    /v1/sessions?replica=k -> 200 {"sessions": [...]}
    POST   /v1/mark               {"replica": k} | {"live": [...]}
                                  -> 200 {"marked": n}   (lost-marking)
    POST   /v1/chaos              (only with --chaos) {"conflicts": n} |
                                  {"expire_all": true}
    GET    /healthz, /metrics

Prefix-tier namespace (``gateway/prefixtier.py``): sealed
chains keyed by CUMULATIVE CONTENT HASH, a key class distinct from
session leases.  Prefixes are immortal-while-hot: every probe hit or
fetch renews their (separate) TTL and bumps popularity, and eviction
under the prefix byte budget is popularity-weighted LRU — the coldest
entry goes first, a hot system prompt never does.  Payload BYTES are
deduplicated store-wide by content hash with refcounted references
(shared between the session and prefix namespaces), so a prefix
published by N replicas — or a chain captured by N sessions — rests
once:

    PUT    /v1/prefix/<chain_key> {"entry": {"payload", "page_keys",
                                   "pages"}}
                                  -> 200 {"stored": bool, "refs": n}
    POST   /v1/prefix/probe       {"keys": [k0..kn]}  (metadata-first)
                                  -> 200 {"chain", "match_pages",
                                          "pages"} | 404
    GET    /v1/prefix/<chain_key> (?meta=1)
                                  -> 200 {"entry"} | 404
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import logging
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple
from urllib.parse import parse_qs, quote, unquote

from kubegpu_tpu_torch.utils.metrics import Metrics

log = logging.getLogger(__name__)

DEGRADE_REASONS = ("unreachable", "cas_conflict", "lease_expired")


class StoreResult(NamedTuple):
    """One store op's outcome.  ``status``:

    - ``ok``          — op applied; ``entry``/``version`` meaningful
    - ``absent``      — no such session (not an error)
    - ``expired``     — the session's lease lapsed (entry dropped)
    - ``conflict``    — a CAS put lost its race (someone wrote version+1)
    - ``unreachable`` — the store could not be reached (or the breaker
      fast-failed); the caller degrades to cold, never errors
    """

    status: str
    entry: Optional[dict] = None
    version: int = 0


class SessionStoreBackend:
    """Storage interface for ``SessionKVStore``.  An entry is a plain
    dict ``{"replica", "stream", "payload", "lost"}`` — the backend
    wraps it with a monotonically increasing per-session version and an
    optional lease."""

    def get(self, session: str, meta: bool = False) -> StoreResult:
        """``meta=True`` strips the (potentially multi-megabyte) KV
        payload from the returned entry, adding ``payload_present``
        instead — the dispatch hot path's no-op check and the capture's
        read-modify-write both need only metadata."""
        raise NotImplementedError

    def put(self, session: str, entry: dict,
            if_version: Optional[int] = None) -> StoreResult:
        """``if_version=None`` is an unconditional overwrite (a new turn
        supersedes the old entry); an integer makes the put
        compare-and-swap against that version."""
        raise NotImplementedError

    def delete(self, session: str) -> StoreResult:
        raise NotImplementedError

    def sessions_on(self, replica_key: str) -> Optional[List[str]]:
        """Sessions homed on one replica, or None when unreachable."""
        raise NotImplementedError

    def mark_lost(self, replica_key: str) -> bool:
        """Mark every entry homed on ``replica_key`` lost (drain/death)."""
        raise NotImplementedError

    def sync_live(self, live) -> bool:
        """Mark every entry whose replica is NOT in ``live`` lost."""
        raise NotImplementedError

    # -- prefix-tier namespace -------------------------------------------
    def put_prefix(self, chain_key: str, entry: dict) -> StoreResult:
        """Publish a sealed chain under its cumulative content hash.
        ``entry``: ``{"payload", "page_keys", "pages"}``.  Idempotent —
        re-publishing an existing chain bumps its popularity instead of
        storing a duplicate."""
        raise NotImplementedError

    def probe_prefix(self, keys: List[str]) -> StoreResult:
        """Metadata-first: the LONGEST stored chain sharing a prefix
        with the prompt whose cumulative page keys are ``keys`` (in
        order).  Cumulative hashing makes this a point lookup per key,
        walked longest-first.  ``ok`` entries carry ``{"chain",
        "match_pages", "pages"}`` and the hit bumps popularity +
        renews the TTL (immortal-while-hot)."""
        raise NotImplementedError

    def get_prefix(self, chain_key: str, meta: bool = False) -> StoreResult:
        raise NotImplementedError

    def healthy(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# In-process backend (the default, and the HTTP server's engine)
# ---------------------------------------------------------------------------

def payload_bytes(payload) -> int:
    """Approximate retained bytes of a KV payload — host-numpy layers
    (in-memory lane) or base64 strings (wire lane).  Quantized
    (schema-v2) payloads carry a ``scales`` section next to their int8
    ``layers``; both count, or the byte budget would silently
    under-charge every quantized session."""
    if not isinstance(payload, dict):
        return 0
    total = 0
    for section in ("layers", "scales"):
        for entry in payload.get(section) or []:
            if isinstance(entry, dict):      # encoded wire payload
                total += len(entry.get("k") or "")
                total += len(entry.get("v") or "")
            else:                            # (k, v) host arrays
                for arr in entry:
                    total += getattr(arr, "nbytes", 0)
    return total


def payload_key(payload) -> Optional[str]:
    """Content address of a sealed-chain payload, REPRESENTATION-
    INDEPENDENT: the page keys are already cumulative content hashes of
    the token stream, so hashing them — plus the geometry, which
    distinguishes pools that hold the same tokens in different shapes
    (kv_dtype, page size, tp) — identifies the payload bytes whether
    the layers arrived as host numpy or base64 wire strings.  ``None``
    for payloads that carry no page keys (nothing to dedup by)."""
    if not isinstance(payload, dict):
        return None
    keys = payload.get("page_keys")
    if not keys:
        return None
    h = hashlib.sha256()
    for k in keys:
        h.update(str(k).encode())
    h.update(json.dumps(
        payload.get("geometry") or {}, sort_keys=True, default=str
    ).encode())
    return h.hexdigest()


class InProcessStoreBackend(SessionStoreBackend):
    """Versioned, leased, byte-bounded session-entry map.

    One implementation serves both deployments: the tier's default
    in-process store (the shared-dict semantics plus CAS versions) and the engine
    inside ``StoreServer`` — so the equivalence the tests assert
    (HTTP-vs-in-process, same capture/restore outcomes) holds by
    construction, not by parallel maintenance.

    ``lease_s``: entries expire that long after their last put (every
    put renews).  ``None`` = no expiry (the in-process default — the
    store dies with the process anyway).  The clock is injectable for
    fake-clock lease tests."""

    def __init__(self, max_sessions: int = 4096,
                 max_payload_bytes: int = 256 << 20,
                 lease_s: Optional[float] = None,
                 max_prefix_bytes: int = 256 << 20,
                 prefix_lease_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[Metrics] = None) -> None:
        self.max_sessions = max_sessions
        self.max_payload_bytes = max_payload_bytes
        self.lease_s = lease_s
        self.max_prefix_bytes = max_prefix_bytes
        # the prefix TTL is a SEPARATE eviction class from session
        # leases: renewed on every probe hit / fetch / re-publish, so a
        # hot prefix is immortal while traffic touches it and only a
        # genuinely cold one ages out
        self.prefix_lease_s = prefix_lease_s
        self.clock = clock
        self.metrics = metrics
        self._lock = threading.Lock()
        # session -> {"entry", "version", "expires", "bytes", "pkey"}
        self._records: "OrderedDict[str, dict]" = OrderedDict()
        self._payload_bytes = 0
        # content-addressed payload table: identical payload bytes rest
        # ONCE no matter how many sessions captured them or how many
        # replicas published them as a prefix.  pkey ->
        # {"payload", "bytes", "srefs", "prefs"} — per-namespace
        # refcounts so each budget charges a payload exactly once while
        # ANY of its refs live
        self._payloads: Dict[str, dict] = {}
        # chain_key -> {"pkey", "pages", "page_keys", "hits", "expires",
        # "last"} — the prefix namespace, popularity-weighted
        self._prefixes: "OrderedDict[str, dict]" = OrderedDict()
        # page_key -> set of chain keys whose chain contains that page:
        # the probe's point-lookup index (cumulative hashing means a
        # page-key match IS a shared-prefix match up to that page)
        self._page_index: Dict[str, set] = {}
        self._prefix_bytes = 0
        self._prefix_seq = 0
        # chaos knobs (soak/tests): fail the next N puts with a CAS
        # conflict; force-expire every lease
        self.force_conflicts = 0

    # -- internals ---------------------------------------------------------
    def _expired_locked(self, rec: dict) -> bool:
        return rec["expires"] is not None and self.clock() >= rec["expires"]

    def _payload_ref_locked(self, pkey: str, payload, ns: str):
        """Reference ``payload`` under ``pkey`` from namespace ``ns``
        (``srefs`` = sessions, ``prefs`` = prefixes); returns the
        CANONICAL payload object so duplicate bytes are garbage the
        moment the caller drops its copy.  Byte budgets charge on a
        namespace's 0->1 transition only."""
        field = "srefs" if ns == "session" else "prefs"
        rec = self._payloads.get(pkey)
        if rec is None:
            rec = {"payload": payload, "bytes": payload_bytes(payload),
                   "srefs": 0, "prefs": 0}
            self._payloads[pkey] = rec
        elif self.metrics is not None:
            self.metrics.inc("session_store_payload_dedup_total")
        if rec[field] == 0:
            if field == "srefs":
                self._payload_bytes += rec["bytes"]
            else:
                self._prefix_bytes += rec["bytes"]
        rec[field] += 1
        return rec["payload"]

    def _payload_unref_locked(self, pkey: Optional[str], ns: str) -> None:
        if pkey is None:
            return
        rec = self._payloads.get(pkey)
        if rec is None:
            return
        field = "srefs" if ns == "session" else "prefs"
        rec[field] -= 1
        if rec[field] == 0:
            if field == "srefs":
                self._payload_bytes -= rec["bytes"]
            else:
                self._prefix_bytes -= rec["bytes"]
        if rec["srefs"] <= 0 and rec["prefs"] <= 0:
            self._payloads.pop(pkey, None)

    def _session_payload_drop_locked(self, rec: dict) -> None:
        """Detach a session record's payload (LRU drop / overwrite):
        unref content-addressed payloads, un-charge direct ones."""
        if rec.get("pkey") is not None:
            self._payload_unref_locked(rec["pkey"], "session")
            rec["pkey"] = None
        else:
            self._payload_bytes -= rec["bytes"]
        rec["bytes"] = 0

    def _drop_locked(self, session: str, rec: dict) -> None:
        self._session_payload_drop_locked(rec)
        self._records.pop(session, None)

    def _gauges_locked(self) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge("session_store_sessions",
                                   len(self._records))
            self.metrics.set_gauge("session_store_payload_bytes",
                                   self._payload_bytes)
            self.metrics.set_gauge("session_store_prefixes",
                                   len(self._prefixes))
            self.metrics.set_gauge("prefix_tier_resident_bytes",
                                   self._prefix_bytes)

    def _reap_locked(self, session: str) -> Optional[dict]:
        """The session's record, lease-checked: an expired record is
        dropped (counted) and reads as gone."""
        rec = self._records.get(session)
        if rec is None:
            return None
        if self._expired_locked(rec):
            self._drop_locked(session, rec)
            if self.metrics is not None:
                self.metrics.inc("session_store_lease_expired_total")
            self._gauges_locked()
            return {"__expired__": True}
        return rec

    # -- SessionStoreBackend ----------------------------------------------
    def get(self, session: str, meta: bool = False) -> StoreResult:
        with self._lock:
            rec = self._reap_locked(session)
            if rec is None:
                return StoreResult("absent")
            if "__expired__" in rec:
                return StoreResult("expired")
            entry = dict(rec["entry"])
            if meta:
                entry["payload_present"] = entry.get("payload") is not None
                entry["payload"] = None
            return StoreResult("ok", entry, rec["version"])

    def put(self, session: str, entry: dict,
            if_version: Optional[int] = None) -> StoreResult:
        with self._lock:
            if self.force_conflicts > 0:
                self.force_conflicts -= 1
                if self.metrics is not None:
                    self.metrics.inc("session_store_cas_conflicts_total")
                return StoreResult("conflict")
            rec = self._reap_locked(session)
            expired = rec is not None and "__expired__" in rec
            if expired:
                rec = None
            if if_version is not None and (
                rec is None or rec["version"] != if_version
            ):
                # a CAS put against a vanished/expired/moved-on entry:
                # the writer's view is stale, its payload must not land
                if self.metrics is not None:
                    self.metrics.inc("session_store_cas_conflicts_total")
                return StoreResult("conflict")
            version = (rec["version"] if rec is not None else 0) + 1
            entry = dict(entry)
            payload = entry.get("payload")
            pkey = payload_key(payload) if payload is not None else None
            if rec is not None:
                self._session_payload_drop_locked(rec)
            if pkey is not None:
                # content-addressed: identical bytes captured by N
                # sessions rest once (refcounted — satellite fix)
                entry["payload"] = self._payload_ref_locked(
                    pkey, payload, "session"
                )
                nbytes = 0   # charged through the payload table
            else:
                nbytes = payload_bytes(payload)
                self._payload_bytes += nbytes
            self._records[session] = {
                "entry": entry, "version": version,
                "expires": (
                    self.clock() + self.lease_s
                    if self.lease_s is not None else None
                ),
                "bytes": nbytes, "pkey": pkey,
            }
            self._records.move_to_end(session)
            # byte-bounded LRU: oldest PAYLOADS drop, streams stay —
            # those sessions degrade to cold prefill on restore, which
            # is the designed fallback, never an error.  A shared
            # payload's bytes only free when its LAST reference drops,
            # so the walk may shed several references per overage.
            if self._payload_bytes > self.max_payload_bytes:
                for other_session, other in self._records.items():
                    if self._payload_bytes <= self.max_payload_bytes:
                        break
                    if (other_session == session
                            or other["entry"].get("payload") is None):
                        continue
                    self._session_payload_drop_locked(other)
                    other["entry"]["payload"] = None
                    if self.metrics is not None:
                        self.metrics.inc(
                            "session_store_payloads_dropped_total"
                        )
            while len(self._records) > self.max_sessions:
                dropped_session, dropped = next(iter(self._records.items()))
                self._drop_locked(dropped_session, dropped)
            self._gauges_locked()
            return StoreResult("ok", version=version)

    def delete(self, session: str) -> StoreResult:
        with self._lock:
            rec = self._records.get(session)
            if rec is None:
                return StoreResult("absent")
            self._drop_locked(session, rec)
            self._gauges_locked()
            return StoreResult("ok")

    def sessions_on(self, replica_key: str) -> Optional[List[str]]:
        with self._lock:
            out = []
            for session in list(self._records):
                rec = self._reap_locked(session)
                if rec is None or "__expired__" in rec:
                    continue
                if rec["entry"].get("replica") == replica_key:
                    out.append(session)
            return out

    def _mark_locked(self, predicate) -> int:
        marked = 0
        for session in list(self._records):
            rec = self._reap_locked(session)
            if rec is None or "__expired__" in rec:
                continue
            if predicate(rec["entry"]) and not rec["entry"].get("lost"):
                rec["entry"]["lost"] = True
                # a mark IS a write: a stale capture racing it must
                # lose its CAS (the session's fate changed under it)
                rec["version"] += 1
                marked += 1
        return marked

    def mark_lost(self, replica_key: str) -> bool:
        with self._lock:
            self._mark_locked(
                lambda e: e.get("replica") == replica_key
            )
            return True

    def sync_live(self, live) -> bool:
        live = set(live)
        with self._lock:
            self._mark_locked(
                lambda e: e.get("replica") not in live
            )
            return True

    # -- prefix-tier namespace -------------------------------------------
    def _prefix_touch_locked(self, rec: dict) -> None:
        """A hit IS heat: bump popularity, renew the TTL (immortal-
        while-hot), and advance the recency sequence."""
        rec["hits"] += 1
        self._prefix_seq += 1
        rec["last"] = self._prefix_seq
        if self.prefix_lease_s is not None:
            rec["expires"] = self.clock() + self.prefix_lease_s

    def _prefix_evict_locked(self, chain_key: str, rec: dict) -> None:
        self._prefixes.pop(chain_key, None)
        for pk in rec["page_keys"]:
            chains = self._page_index.get(pk)
            if chains is not None:
                chains.discard(chain_key)
                if not chains:
                    self._page_index.pop(pk, None)
        self._payload_unref_locked(rec["pkey"], "prefix")
        if self.metrics is not None:
            self.metrics.inc("session_store_prefix_evicted_total")

    def _reap_prefix_locked(self, chain_key: str) -> Optional[dict]:
        rec = self._prefixes.get(chain_key)
        if rec is None:
            return None
        if rec["expires"] is not None and self.clock() >= rec["expires"]:
            self._prefix_evict_locked(chain_key, rec)
            return None
        return rec

    def put_prefix(self, chain_key: str, entry: dict) -> StoreResult:
        payload = entry.get("payload") if isinstance(entry, dict) else None
        page_keys = [
            str(k) for k in (entry.get("page_keys") or [])
        ] if isinstance(entry, dict) else []
        if payload is None or not page_keys:
            return StoreResult("absent")
        with self._lock:
            rec = self._reap_prefix_locked(chain_key)
            if rec is not None:
                # double publish: a popularity signal, never a second
                # copy — the payload's refcount and bytes are unchanged
                self._prefix_touch_locked(rec)
                pl = self._payloads.get(rec["pkey"]) or {}
                self._gauges_locked()
                return StoreResult("ok", {
                    "stored": False, "hits": rec["hits"],
                    "refs": pl.get("srefs", 0) + pl.get("prefs", 0),
                }, 1)
            pkey = payload_key(payload) or f"chain:{chain_key}"
            self._payload_ref_locked(pkey, payload, "prefix")
            self._prefix_seq += 1
            self._prefixes[chain_key] = {
                "pkey": pkey, "page_keys": page_keys,
                "pages": int(entry.get("pages") or len(page_keys)),
                # the payload rides opaquely; its wire-codec tag must
                # ride with it or the GET side can't decode
                "payload_codec": entry.get("payload_codec"),
                "hits": 0, "last": self._prefix_seq,
                "expires": (
                    self.clock() + self.prefix_lease_s
                    if self.prefix_lease_s is not None else None
                ),
            }
            for pk in page_keys:
                self._page_index.setdefault(pk, set()).add(chain_key)
            # popularity-weighted LRU under the prefix byte budget: the
            # COLDEST chain goes first (fewest hits, least recent) — a
            # brand-new publish into a budget full of hotter chains
            # bounces, a hot one is never the victim
            while self._prefix_bytes > self.max_prefix_bytes and (
                self._prefixes
            ):
                victim = min(
                    self._prefixes.items(),
                    key=lambda kv: (kv[1]["hits"], kv[1]["last"]),
                )
                self._prefix_evict_locked(*victim)
            pl = self._payloads.get(pkey) or {}
            stored = chain_key in self._prefixes
            self._gauges_locked()
            return StoreResult("ok", {
                "stored": stored,
                "refs": pl.get("srefs", 0) + pl.get("prefs", 0),
            }, 1)

    def probe_prefix(self, keys: List[str]) -> StoreResult:
        with self._lock:
            for j in range(len(keys) - 1, -1, -1):
                chains = self._page_index.get(str(keys[j]))
                if not chains:
                    continue
                best: Optional[Tuple[str, dict]] = None
                for ck in list(chains):
                    rec = self._reap_prefix_locked(ck)
                    if rec is None:
                        continue
                    if best is None or (
                        (rec["hits"], rec["last"])
                        > (best[1]["hits"], best[1]["last"])
                    ):
                        best = (ck, rec)
                if best is None:
                    continue
                ck, rec = best
                self._prefix_touch_locked(rec)
                return StoreResult("ok", {
                    "chain": ck, "match_pages": j + 1,
                    "pages": rec["pages"],
                }, 1)
            return StoreResult("absent")

    def get_prefix(self, chain_key: str, meta: bool = False) -> StoreResult:
        with self._lock:
            rec = self._reap_prefix_locked(chain_key)
            if rec is None:
                return StoreResult("absent")
            entry = {"pages": rec["pages"],
                     "page_keys": list(rec["page_keys"]),
                     "hits": rec["hits"]}
            if rec.get("payload_codec") is not None:
                entry["payload_codec"] = rec["payload_codec"]
            if meta:
                entry["payload_present"] = rec["pkey"] in self._payloads
                return StoreResult("ok", entry, 1)
            pl = self._payloads.get(rec["pkey"])
            if pl is None:   # pragma: no cover - prefix refs pin payloads
                return StoreResult("absent")
            self._prefix_touch_locked(rec)
            entry["payload"] = pl["payload"]
            return StoreResult("ok", entry, 1)

    # -- chaos (soak/tests) ------------------------------------------------
    def expire_all(self) -> None:
        """Force every lease to lapse NOW (the soak's lease-expiry op)."""
        with self._lock:
            for rec in self._records.values():
                rec["expires"] = self.clock() - 1.0

    # -- views -------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "sessions": len(self._records),
                "payload_bytes": self._payload_bytes,
                "with_payload": sum(
                    1 for r in self._records.values()
                    if r["entry"].get("payload") is not None
                ),
                "unique_payloads": len(self._payloads),
                "prefixes": len(self._prefixes),
                "prefix_bytes": self._prefix_bytes,
            }

    def payload_refs(self, payload) -> int:
        """Total references (sessions + prefixes) held on this
        payload's content address — the dedup tests' oracle."""
        pkey = payload_key(payload)
        with self._lock:
            rec = self._payloads.get(pkey) if pkey else None
            return (rec["srefs"] + rec["prefs"]) if rec else 0


# ---------------------------------------------------------------------------
# Payload wire codec (client-side): numpy layers <-> JSON-safe base64
# ---------------------------------------------------------------------------

def _encode_entry_for_wire(entry: dict) -> dict:
    """JSON-safe copy of an entry.  In-memory-lane payloads carry host
    numpy layers; they ride base64 on the wire (the dataplane codec) and
    the codec tag makes the GET side symmetric.  Payloads that are
    ALREADY wire-encoded (an ``HttpReplicaClient.export_sealed`` result
    — the common production case) pass through untouched: the store and
    the gateway both relay them opaquely."""
    payload = entry.get("payload")
    out = dict(entry)
    if not isinstance(payload, dict):
        out.pop("payload_codec", None)
        return out
    layers = payload.get("layers")
    if layers and not isinstance(layers[0], dict):
        from kubegpu_tpu_torch.gateway.dataplane import encode_kv_payload

        out["payload"] = encode_kv_payload(payload)
        out["payload_codec"] = "b64"
    else:
        out["payload_codec"] = "wire"
    return out


def _decode_entry_from_wire(entry: dict) -> dict:
    out = dict(entry)
    codec = out.pop("payload_codec", None)
    if codec == "b64" and isinstance(out.get("payload"), dict):
        from kubegpu_tpu_torch.gateway.dataplane import decode_kv_payload

        out["payload"] = decode_kv_payload(out["payload"])
    return out


# ---------------------------------------------------------------------------
# Circuit breaker + HTTP client backend
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Consecutive-failure breaker: after ``threshold`` failures in a
    row the breaker OPENS for ``cooldown_s`` — every op in the window
    fast-fails without touching the network (a dead store must cost the
    serving path microseconds, not a connect timeout per request).
    After the cooldown one trial op is let through (half-open): success
    closes the breaker, failure re-opens it for another window.  The
    clock is injectable for fake-clock tests."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._lock = threading.Lock()
        self.failures = 0
        self.open_until = 0.0
        self.trips = 0
        # half-open: exactly ONE trial op holds this token; every other
        # caller keeps fast-failing until the trial reports back — N
        # dispatcher threads must not all stall an op deadline against
        # a hung store at every cooldown expiry
        self._trial_inflight = False

    def allow(self) -> bool:
        """May this op touch the network?  Claims the half-open trial
        token when the cooldown just expired — the caller MUST report
        back via ``success()``/``failure()`` after a True."""
        with self._lock:
            if self.open_until == 0.0:
                return True
            if self.clock() < self.open_until:
                return False
            if self._trial_inflight:
                return False
            self._trial_inflight = True
            return True

    @property
    def open(self) -> bool:
        with self._lock:
            return (self.open_until != 0.0
                    and self.clock() < self.open_until)

    def success(self) -> None:
        with self._lock:
            self.failures = 0
            self.open_until = 0.0
            self._trial_inflight = False

    def failure(self) -> None:
        with self._lock:
            self._trial_inflight = False
            self.failures += 1
            if self.failures >= self.threshold:
                self.open_until = self.clock() + self.cooldown_s
                self.trips += 1


class _Unreachable(Exception):
    pass


class HttpStoreClient(SessionStoreBackend):
    """``SessionStoreBackend`` over the store's HTTP protocol.

    Failure discipline (the whole point of this class): every op has a
    per-op DEADLINE (``timeout_s`` socket timeout), transport errors
    retry a bounded number of times with exponential backoff + jitter
    (the registry probe-backoff shape: ``base * 2^k``, capped, jitter
    in [0.5, 1.5)x, injectable clock/sleep/rng), and a circuit breaker
    turns a dead store into one fast-fail per op.  Nothing here raises
    to the caller: ops resolve ``StoreResult("unreachable")`` and the
    ``SessionKVStore`` above degrades the session to cold prefill."""

    def __init__(self, url: str, timeout_s: float = 1.0,
                 retries: int = 1,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 0.5,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None,
                 metrics: Optional[Metrics] = None) -> None:
        addr = url
        for prefix in ("http://", "https://"):
            if addr.startswith(prefix):
                addr = addr[len(prefix):]
        addr = addr.rstrip("/")
        host, _, port = addr.rpartition(":")
        if not host:
            raise ValueError(
                f"session-store url {url!r} must be host:port (or "
                "http://host:port)"
            )
        self.host, self.port = host, int(port)
        self.timeout_s = timeout_s
        self.retries = retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random(0)
        self.metrics = metrics
        self.breaker = CircuitBreaker(
            breaker_threshold, breaker_cooldown_s, clock=clock
        )
        # small keep-alive pool (the store answers HTTP/1.1 with
        # Content-Length): a per-dispatch metadata GET must not pay a
        # TCP setup each time.  Transport errors flush the WHOLE pool —
        # a restarted store leaves every pooled socket stale.
        self._conn_lock = threading.Lock()
        self._conns: List[http.client.HTTPConnection] = []

    # -- transport ---------------------------------------------------------
    def _checkout(self) -> http.client.HTTPConnection:
        with self._conn_lock:
            if self._conns:
                return self._conns.pop()
        return http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout_s
        )

    def _checkin(self, conn: http.client.HTTPConnection) -> None:
        with self._conn_lock:
            if len(self._conns) < 8:
                self._conns.append(conn)
                return
        conn.close()

    def _flush_pool(self) -> None:
        with self._conn_lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            conn.close()

    def _do(self, method: str, path: str,
            body: Optional[dict] = None) -> Tuple[int, dict]:
        """One HTTP round-trip under the per-op deadline, on a pooled
        keep-alive connection.  Raises ``OSError`` flavors on transport
        failure; monkeypatch target for the fake-clock breaker/backoff
        units."""
        conn = self._checkout()
        try:
            conn.request(
                method, path,
                json.dumps(body) if body is not None else None,
                {"Content-Type": "application/json"} if body is not None
                else {},
            )
            resp = conn.getresponse()
            raw = resp.read()
        except Exception:
            conn.close()
            self._flush_pool()
            raise
        try:
            payload = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            payload = {}
        self._checkin(conn)
        return resp.status, payload

    def _call(self, method: str, path: str,
              body: Optional[dict] = None) -> Tuple[int, dict]:
        """Breaker + bounded-retry wrapper around ``_do``.  Raises
        ``_Unreachable`` when the op could not be served."""
        if not self.breaker.allow():
            if self.metrics is not None:
                self.metrics.inc("gateway_session_store_fastfail_total")
            raise _Unreachable("session store breaker open")
        delay = self.backoff_base_s
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                status, payload = self._do(method, path, body)
            except Exception as e:  # noqa: BLE001 - every transport
                # failure mode must release the breaker's half-open
                # trial token (a leaked token = permanent fast-fail)
                # and resolve as "unreachable", never propagate
                self.breaker.failure()
                last = e
                if attempt < self.retries and self.breaker.allow():
                    if self.metrics is not None:
                        self.metrics.inc(
                            "gateway_session_store_retries_total"
                        )
                    self._sleep(delay * (0.5 + self._rng.random()))
                    delay = min(delay * 2, self.backoff_cap_s)
                    continue
                raise _Unreachable(str(e)) from e
            self.breaker.success()
            return status, payload
        raise _Unreachable(str(last))   # pragma: no cover - loop exits above

    # -- SessionStoreBackend ----------------------------------------------
    def get(self, session: str, meta: bool = False) -> StoreResult:
        try:
            status, payload = self._call(
                "GET",
                f"/v1/session/{quote(session, safe='')}"
                + ("?meta=1" if meta else ""),
            )
        except _Unreachable:
            return StoreResult("unreachable")
        if status == 200:
            return StoreResult(
                "ok",
                _decode_entry_from_wire(payload.get("entry") or {}),
                int(payload.get("version", 0)),
            )
        if status == 404 and payload.get("reason") == "lease_expired":
            return StoreResult("expired")
        if status == 404:
            return StoreResult("absent")
        return StoreResult("unreachable")

    def put(self, session: str, entry: dict,
            if_version: Optional[int] = None) -> StoreResult:
        try:
            status, payload = self._call(
                "PUT", f"/v1/session/{quote(session, safe='')}",
                {"entry": _encode_entry_for_wire(entry),
                 "if_version": if_version},
            )
        except _Unreachable:
            return StoreResult("unreachable")
        if status == 200:
            return StoreResult("ok", version=int(payload.get("version", 0)))
        if status == 409:
            return StoreResult("conflict")
        return StoreResult("unreachable")

    def delete(self, session: str) -> StoreResult:
        try:
            status, _ = self._call(
                "DELETE", f"/v1/session/{quote(session, safe='')}"
            )
        except _Unreachable:
            return StoreResult("unreachable")
        return StoreResult("ok" if status == 200 else "absent")

    def sessions_on(self, replica_key: str) -> Optional[List[str]]:
        try:
            status, payload = self._call(
                "GET", f"/v1/sessions?replica={quote(replica_key, safe='')}"
            )
        except _Unreachable:
            return None
        if status != 200:
            return None
        return [str(s) for s in payload.get("sessions", [])]

    def mark_lost(self, replica_key: str) -> bool:
        try:
            status, _ = self._call(
                "POST", "/v1/mark", {"replica": replica_key}
            )
        except _Unreachable:
            return False
        return status == 200

    def sync_live(self, live) -> bool:
        try:
            status, _ = self._call(
                "POST", "/v1/mark", {"live": sorted(live)}
            )
        except _Unreachable:
            return False
        return status == 200

    # -- prefix-tier namespace --------------------------------------------
    def put_prefix(self, chain_key: str, entry: dict) -> StoreResult:
        try:
            status, payload = self._call(
                "PUT", f"/v1/prefix/{quote(chain_key, safe='')}",
                {"entry": _encode_entry_for_wire(entry)},
            )
        except _Unreachable:
            return StoreResult("unreachable")
        if status == 200:
            return StoreResult("ok", dict(payload), 1)
        return StoreResult("unreachable" if status >= 500 else "absent")

    def probe_prefix(self, keys: List[str]) -> StoreResult:
        try:
            status, payload = self._call(
                "POST", "/v1/prefix/probe",
                {"keys": [str(k) for k in keys]},
            )
        except _Unreachable:
            return StoreResult("unreachable")
        if status == 200:
            return StoreResult("ok", dict(payload), 1)
        if status == 404:
            return StoreResult("absent")
        return StoreResult("unreachable")

    def get_prefix(self, chain_key: str, meta: bool = False) -> StoreResult:
        try:
            status, payload = self._call(
                "GET",
                f"/v1/prefix/{quote(chain_key, safe='')}"
                + ("?meta=1" if meta else ""),
            )
        except _Unreachable:
            return StoreResult("unreachable")
        if status == 200:
            return StoreResult(
                "ok",
                _decode_entry_from_wire(payload.get("entry") or {}),
                1,
            )
        if status == 404:
            return StoreResult("absent")
        return StoreResult("unreachable")

    def healthy(self) -> bool:
        try:
            status, _ = self._call("GET", "/healthz")
        except _Unreachable:
            return False
        return status == 200

    def close(self) -> None:
        self._flush_pool()


# ---------------------------------------------------------------------------
# SessionKVStore: the gateway's insurance ledger over a pluggable backend
# ---------------------------------------------------------------------------

class SessionKVStore:
    """The gateway's failover insurance for session KV: per session, the
    replica that last served it, the stream it ended on (prompt +
    generated tokens — the chain identity), and the last SEALED EXPORT
    captured from that replica (``client.export_sealed``).  When the
    replica later dies — or is drained, or cold-restarts under the same
    name — and the session dispatches again, the dispatcher imports the
    stored payload into the target BEFORE the attempt opens, so turn 2
    hits warm pages instead of cold-restarting prefill.

    Storage is a ``SessionStoreBackend``: the default in-process backend
    is one dict (a single gateway, or an in-process tier sharing one
    instance); ``HttpStoreClient`` points every gateway POD at one
    external ``StoreServer`` so the insurance survives gateway death.

    The robustness contract is graceful degradation END TO END: store
    unreachable, a CAS conflict, a lapsed lease — every store failure
    resolves as a cold prefill with
    ``gateway_session_store_degraded_total{reason}`` incremented (and a
    ``degraded_log`` entry the soak audits), NEVER a request error.

    Captures write through asynchronously (``capture_async``): a bounded
    queue drained by one background thread, drop-OLDEST on overflow —
    capture is insurance, and must never block the result path or grow
    without bound when the store browns out."""

    def __init__(self, max_sessions: int = 4096,
                 max_payload_bytes: int = 256 << 20,
                 backend: Optional[SessionStoreBackend] = None,
                 metrics: Optional[Metrics] = None,
                 capture_queue: int = 64) -> None:
        self.max_sessions = max_sessions
        self.max_payload_bytes = max_payload_bytes
        self.backend = backend if backend is not None else (
            InProcessStoreBackend(
                max_sessions=max_sessions,
                max_payload_bytes=max_payload_bytes,
            )
        )
        self.metrics = metrics
        self.capture_queue = capture_queue
        # per-GATEWAY session→home hint cache: the healthy-home no-op is
        # the dispatch hot path's common case, and against an external
        # store it costs a metadata GET per dispatch.  A hint records
        # "this session's entry is home=replica, not lost" so repeat
        # dispatches to the SAME replica skip the store round-trip
        # entirely.  Invalidation is aggressive — any ring movement
        # (mark_lost/sync_live), any degrade, any restore, any read that
        # contradicts the hint drops it — because a stale hint costs at
        # most one skipped mispin-restore (a perf blip), never
        # correctness: the replica's own caches and the cold-prefill
        # fallback stay sound.  In the multi-process deployment each
        # gateway pod holds its own SessionKVStore, so this cache is
        # per-gateway by construction.
        self._hints: Dict[str, str] = {}
        # every degrade event, in order: (session, reason) — the soak's
        # audit trail ("every degraded session completed cold, counted")
        self.degraded_log: List[Tuple[str, str]] = []
        self._cond = threading.Condition()
        self._queue: deque = deque()          # (client, session)
        self._inflight_captures = 0
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    # -- degradation accounting -------------------------------------------
    def _degrade(self, session: str, reason: str) -> None:
        with self._cond:
            self.degraded_log.append((session, reason))
            self._hints.pop(session, None)
        if self.metrics is not None:
            self.metrics.inc(
                "gateway_session_store_degraded_total", reason=reason
            )

    # -- the ledger --------------------------------------------------------
    def record(self, session: str, replica_key: str, stream) -> None:
        """A sessionful turn completed: remember where and on what
        stream.  A new turn supersedes the old entry (the chain grew) —
        an UNCONDITIONAL put, which is exactly what makes stale captures
        lose their CAS."""
        entry = {
            "replica": replica_key,
            "stream": [int(t) for t in stream],
            "payload": None,
            "lost": False,
        }
        res = self.backend.put(session, entry, if_version=None)
        if res.status == "unreachable":
            self._degrade(session, "unreachable")
            return
        # the turn just completed HERE: the healthy home is known
        # without asking the store again
        with self._cond:
            self._hints[session] = replica_key
            if len(self._hints) > self.max_sessions:
                self._hints.clear()

    def capture(self, client, session: str) -> bool:
        """Export the session's sealed chain from its home replica and
        write it through — the insurance premium, paid while the
        replica is alive.  Best-effort: False leaves the entry
        payload-less (a later death then degrades to cold prefill).
        The put is CAS-guarded against the version the stream was READ
        at, so a capture racing a newer turn (possibly on a sibling
        gateway) can never interleave a stale payload over a newer
        seal.  A metadata read suffices: the capture needs the stream
        and the version, and OVERWRITES the payload anyway."""
        res = self.backend.get(session, meta=True)
        if res.status == "unreachable":
            self._degrade(session, "unreachable")
            return False
        if res.status == "expired":
            self._degrade(session, "lease_expired")
            return False
        if res.status != "ok":
            return False
        entry, version = res.entry, res.version
        try:
            payload = client.export_sealed(
                entry["replica"], list(entry["stream"])
            )
        except Exception:  # noqa: BLE001 - capture is best-effort
            log.exception("sealed-chain export failed")
            return False
        if payload is None:
            return False
        new = dict(entry)
        new.pop("payload_present", None)   # meta-read artifact
        new["payload"] = payload
        put = self.backend.put(session, new, if_version=version)
        if put.status == "conflict":
            self._degrade(session, "cas_conflict")
            return False
        if put.status == "unreachable":
            self._degrade(session, "unreachable")
            return False
        return put.status == "ok"

    # -- async write-through ----------------------------------------------
    def capture_async(self, client, session: str) -> None:
        """Queue a capture off the result path.  Bounded, drop-OLDEST
        (the newest capture is the one a restore most likely needs),
        deduped by session (a burst of turns folds into one export)."""
        with self._cond:
            if self._closed:
                return
            for i, (_, queued_session) in enumerate(self._queue):
                if queued_session == session:
                    del self._queue[i]
                    break
            self._queue.append((client, session))
            dropped = 0
            while len(self._queue) > self.capture_queue:
                self._queue.popleft()
                dropped += 1
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._capture_loop, name="session-kv-capture",
                    daemon=True,
                )
                self._worker.start()
            self._cond.notify()
        if dropped and self.metrics is not None:
            self.metrics.inc(
                "gateway_session_store_capture_drops_total", dropped
            )

    def _capture_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(0.1)
                if self._closed and not self._queue:
                    return
                client, session = self._queue.popleft()
                self._inflight_captures += 1
            try:
                self.capture(client, session)
            except Exception:  # noqa: BLE001 - insurance must never raise
                log.exception("async capture failed for %s", session)
            finally:
                with self._cond:
                    self._inflight_captures -= 1
                    self._cond.notify_all()

    def flush_captures(self, timeout: float = 10.0) -> bool:
        """Wait for every queued capture to land (tests, drains)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._queue or self._inflight_captures:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 0.1))
        return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        close_backend = getattr(self.backend, "close", None)
        if close_backend is not None:
            close_backend()

    # -- lifecycle marks ---------------------------------------------------
    def sessions_on(self, replica_key: str) -> List[str]:
        return self.backend.sessions_on(replica_key) or []

    def mark_lost(self, replica_key: str) -> None:
        """The replica is going (drain) or gone (death): its sessions'
        next dispatch may restore elsewhere — or back into the SAME pod
        name once it cold-restarts.  Ring movement invalidates the
        whole hint cache: a hint that survived a membership change
        could mask the very restore the movement calls for."""
        with self._cond:
            self._hints.clear()
        self.backend.mark_lost(replica_key)

    def sync_live(self, live) -> None:
        """Registry subscription: sessions homed on replicas that left
        the live set become restorable.  Clears the hint cache (ring
        movement — see ``mark_lost``)."""
        with self._cond:
            self._hints.clear()
        self.backend.sync_live(live)

    # -- restore (the read-through, on the dispatch path) ------------------
    def restore_for(self, request, target_key: str, client,
                    mispin_restore: bool = True) -> bool:
        """Called at dispatch time with the routed target: if this
        request's session is dispatching AWAY from its recorded home —
        or back to a home that was LOST (death, drain, cold restart
        under the same pod name) — and a sealed export was captured,
        import it into the target (idempotent — the import dedups
        against pages already cached there) and re-home the entry.
        ``mispin_restore=False`` is for load-balancing routers with NO
        session affinity: only a LOST home restores there.  True only
        when a payload actually landed.  Every store failure on this
        path degrades to cold prefill, counted — never an error.

        Two-phase read: this runs on the DISPATCH hot path for every
        sessionful request, and the common case is the healthy-home
        no-op — so the decision is made on a METADATA read (no payload
        bytes moved), and only an actual restore pays the full fetch.
        Hotter still, the per-gateway hint cache skips even that GET
        when the routed target IS the session's last known healthy home
        (hints drop on any ring movement, degrade, or restore — see
        ``_hints``), so steady healthy-home traffic costs the store
        nothing per dispatch."""
        session = getattr(request, "session", None)
        if not session:
            return False
        with self._cond:
            if self._hints.get(session) == target_key:
                return False    # healthy home, hinted: skip the store GET
        res = self.backend.get(session, meta=True)
        if res.status == "unreachable":
            self._degrade(session, "unreachable")
            return False
        if res.status == "expired":
            self._degrade(session, "lease_expired")
            return False
        if res.status != "ok":
            return False
        lost = bool(res.entry.get("lost"))
        if res.entry.get("replica") == target_key and not lost:
            # healthy home: the replica has its own cache.  Remember it
            # so the next dispatch here skips the metadata GET entirely.
            with self._cond:
                self._hints[session] = target_key
                if len(self._hints) > self.max_sessions:
                    self._hints.clear()
            return False
        with self._cond:
            self._hints.pop(session, None)
        if not lost and not mispin_restore:
            return False
        if not res.entry.get("payload_present"):
            return False    # nothing sealed: cold prefill, by design
        full = self.backend.get(session)
        if full.status == "unreachable":
            self._degrade(session, "unreachable")
            return False
        if full.status == "expired":
            self._degrade(session, "lease_expired")
            return False
        if full.status != "ok":
            return False
        e, version = full.entry, full.version
        payload = e.get("payload")
        if payload is None:
            return False    # evicted between the two reads: cold
        try:
            if not client.import_sealed(target_key, payload):
                return False
        except Exception:  # noqa: BLE001 - restore is best-effort
            log.exception("sealed-chain import failed")
            return False
        new = dict(e)
        new["replica"] = target_key
        new["lost"] = False
        # re-home CAS-guarded: losing this race just means a newer turn
        # (or a sibling's restore) already owns the entry — the import
        # itself landed either way, so no degrade
        self.backend.put(session, new, if_version=version)
        return True

    # -- test/diagnostic views --------------------------------------------
    def entry(self, session: str) -> Optional[dict]:
        res = self.backend.get(session)
        return dict(res.entry) if res.status == "ok" else None

    def set_payload(self, session: str, payload) -> bool:
        """Inject an insurance payload directly (tests)."""
        res = self.backend.get(session)
        if res.status != "ok":
            return False
        e = dict(res.entry)
        e["payload"] = payload
        return self.backend.put(
            session, e, if_version=res.version
        ).status == "ok"


# ---------------------------------------------------------------------------
# The standalone HTTP store
# ---------------------------------------------------------------------------

def make_store_handler(backend: InProcessStoreBackend, metrics: Metrics,
                       chaos: bool = False):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # keep-alive clients (HttpStoreClient pools connections) would
        # otherwise pay a ~40 ms Nagle/delayed-ACK stall per op on the
        # server's buffered response writes — measured 44 ms/op reused
        # vs 0.2 ms with NODELAY
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            log.debug("session store: " + fmt, *args)

        def _read_json(self) -> Optional[dict]:
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                return json.loads(raw) if raw else {}
            except (ValueError, json.JSONDecodeError):
                return None

        def _send(self, code: int, payload,
                  content_type="application/json") -> None:
            body = (
                json.dumps(payload).encode()
                if content_type == "application/json"
                else payload.encode()
            )
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _session_of(self, path: str) -> Optional[str]:
            prefix = "/v1/session/"
            if not path.startswith(prefix) or len(path) <= len(prefix):
                return None
            return unquote(path[len(prefix):])

        def _prefix_of(self, path: str) -> Optional[str]:
            prefix = "/v1/prefix/"
            if not path.startswith(prefix) or len(path) <= len(prefix):
                return None
            return unquote(path[len(prefix):])

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                self._send(200, "ok", content_type="text/plain")
                return
            if path == "/metrics":
                self._send(200, metrics.render(), content_type="text/plain")
                return
            if path == "/v1/sessions":
                metrics.inc("session_store_requests_total", verb="list")
                replica = (parse_qs(query).get("replica") or [""])[0]
                sessions = backend.sessions_on(replica)
                self._send(200, {"sessions": sessions or []})
                return
            chain = self._prefix_of(path)
            if chain is not None:
                metrics.inc("session_store_requests_total",
                            verb="prefix_get")
                meta = (parse_qs(query).get("meta") or ["0"])[0] == "1"
                res = backend.get_prefix(chain, meta=meta)
                if res.status == "ok":
                    self._send(200, {"entry": res.entry})
                else:
                    self._send(404, {"error": f"no prefix {chain!r}",
                                     "reason": "absent"})
                return
            session = self._session_of(path)
            if session is None:
                self._send(404, {"error": f"no route {path}"})
                return
            metrics.inc("session_store_requests_total", verb="get")
            # ?meta=1: metadata only — the dispatch hot path's "is a
            # restore even needed" check must not download the payload
            meta = (parse_qs(query).get("meta") or ["0"])[0] == "1"
            res = backend.get(session, meta=meta)
            if res.status == "ok":
                self._send(200, {"entry": res.entry,
                                 "version": res.version})
            elif res.status == "expired":
                self._send(404, {"error": f"session {session!r} lease "
                                 "expired", "reason": "lease_expired"})
            else:
                self._send(404, {"error": f"no session {session!r}",
                                 "reason": "absent"})

        def do_PUT(self):
            chain = self._prefix_of(self.path.partition("?")[0])
            if chain is not None:
                metrics.inc("session_store_requests_total",
                            verb="prefix_put")
                body = self._read_json()
                if body is None or not isinstance(body.get("entry"), dict):
                    self._send(400, {"error": "entry required"})
                    return
                # the payload rides opaquely (wire-encoded by the
                # client) — the store never decodes KV bytes
                res = backend.put_prefix(chain, body["entry"])
                if res.status == "ok":
                    self._send(200, dict(res.entry or {}))
                else:
                    self._send(400, {"error": "unusable prefix entry"})
                return
            session = self._session_of(self.path.partition("?")[0])
            if session is None:
                self._send(404, {"error": f"no route {self.path}"})
                return
            metrics.inc("session_store_requests_total", verb="put")
            body = self._read_json()
            if body is None or not isinstance(body.get("entry"), dict):
                self._send(400, {"error": "entry required"})
                return
            if_version = body.get("if_version")
            if if_version is not None:
                try:
                    if_version = int(if_version)
                except (TypeError, ValueError):
                    self._send(400, {"error": "if_version must be an int"})
                    return
            res = backend.put(session, body["entry"], if_version=if_version)
            if res.status == "ok":
                self._send(200, {"version": res.version})
            elif res.status == "conflict":
                self._send(409, {"error": "version conflict",
                                 "reason": "cas_conflict"})
            else:   # pragma: no cover - in-process backend cannot fail
                self._send(500, {"error": res.status})

        def do_DELETE(self):
            session = self._session_of(self.path.partition("?")[0])
            if session is None:
                self._send(404, {"error": f"no route {self.path}"})
                return
            metrics.inc("session_store_requests_total", verb="delete")
            res = backend.delete(session)
            self._send(200, {"deleted": res.status == "ok"})

        def do_POST(self):
            path = self.path.partition("?")[0]
            if path == "/v1/prefix/probe":
                metrics.inc("session_store_requests_total",
                            verb="prefix_probe")
                body = self._read_json()
                if body is None or not isinstance(body.get("keys"), list):
                    self._send(400, {"error": "keys required"})
                    return
                res = backend.probe_prefix(
                    [str(k) for k in body["keys"]]
                )
                if res.status == "ok":
                    self._send(200, dict(res.entry or {}))
                else:
                    self._send(404, {"reason": "absent"})
                return
            if path == "/v1/mark":
                metrics.inc("session_store_requests_total", verb="mark")
                body = self._read_json()
                if body is None:
                    self._send(400, {"error": "malformed JSON body"})
                    return
                if body.get("replica"):
                    backend.mark_lost(str(body["replica"]))
                elif body.get("live") is not None:
                    backend.sync_live([str(k) for k in body["live"]])
                else:
                    self._send(400, {"error": "replica or live required"})
                    return
                self._send(200, {"marked": True})
                return
            if path == "/v1/chaos" and chaos:
                body = self._read_json() or {}
                if body.get("conflicts"):
                    backend.force_conflicts += int(body["conflicts"])
                if body.get("expire_all"):
                    backend.expire_all()
                self._send(200, {"ok": True})
                return
            self._send(404, {"error": f"no route {path}"})

    return Handler


class StoreServer:
    """The standalone session-KV store process: one
    ``InProcessStoreBackend`` behind a threaded HTTP server.  ``listen``
    port 0 picks an ephemeral port (tests); ``stop()`` closes the
    listener — entries are in-memory (the store is INSURANCE: losing it
    degrades every session to cold prefill, which the gateway handles
    by design, so a store restart is an availability blip, not a
    correctness event)."""

    def __init__(self, listen: Tuple[str, int] = ("127.0.0.1", 0),
                 max_sessions: int = 4096,
                 max_payload_bytes: int = 256 << 20,
                 lease_s: Optional[float] = 3600.0,
                 max_prefix_bytes: int = 256 << 20,
                 prefix_lease_s: Optional[float] = None,
                 metrics: Optional[Metrics] = None,
                 backend: Optional[InProcessStoreBackend] = None,
                 chaos: bool = False) -> None:
        from http.server import ThreadingHTTPServer

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

            def handle_error(self, request, client_address):
                log.debug("store connection error from %s", client_address,
                          exc_info=True)

        self.metrics = metrics if metrics is not None else Metrics()
        self.backend = backend if backend is not None else (
            InProcessStoreBackend(
                max_sessions=max_sessions,
                max_payload_bytes=max_payload_bytes,
                lease_s=lease_s,
                max_prefix_bytes=max_prefix_bytes,
                prefix_lease_s=prefix_lease_s,
                metrics=self.metrics,
            )
        )
        if self.backend.metrics is None:
            self.backend.metrics = self.metrics
        self.httpd = _Server(
            listen, make_store_handler(self.backend, self.metrics,
                                       chaos=chaos)
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    @property
    def port(self) -> int:
        return self.address[1]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "StoreServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# CLI: python -m kubegpu_tpu_torch.gateway.sessionstore
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Standalone session-KV store for the gateway tier "
        "(deploy/session-store.yaml): versioned CAS puts, per-session "
        "leases, byte-bounded payload LRU.  Gateways point at it with "
        "--session-store http://host:port."
    )
    ap.add_argument("--listen", default="127.0.0.1:8650")
    ap.add_argument("--max-sessions", type=int, default=4096)
    ap.add_argument(
        "--max-payload-bytes", type=int, default=256 << 20,
        help="total retained KV payload bytes across sessions; over "
        "budget the OLDEST payloads drop (their stream records stay — "
        "those sessions degrade to cold prefill on restore)",
    )
    ap.add_argument(
        "--lease", type=float, default=3600.0,
        help="per-session lease seconds (every put renews; an expired "
        "session reads as gone and its next turn cold-prefills).  "
        "<= 0 disables leasing",
    )
    ap.add_argument(
        "--max-prefix-bytes", type=int, default=256 << 20,
        help="retained bytes for the shared-prefix tier (a SEPARATE "
        "budget from session payloads); over budget the COLDEST chain "
        "evicts first — popularity-weighted LRU, a hot system prompt "
        "is never the victim",
    )
    ap.add_argument(
        "--prefix-lease", type=float, default=0.0,
        help="prefix-chain TTL seconds, renewed on every probe hit / "
        "fetch / re-publish (immortal-while-hot).  <= 0 disables "
        "expiry (the default — eviction is then purely byte-budgeted)",
    )
    ap.add_argument(
        "--chaos", action="store_true",
        help="enable POST /v1/chaos (forced CAS conflicts, lease "
        "expiry) — soak/test harnesses only, never production",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO
    )
    host, _, port = args.listen.rpartition(":")
    server = StoreServer(
        listen=(host or "127.0.0.1", int(port)),
        max_sessions=args.max_sessions,
        max_payload_bytes=args.max_payload_bytes,
        lease_s=args.lease if args.lease > 0 else None,
        max_prefix_bytes=args.max_prefix_bytes,
        prefix_lease_s=args.prefix_lease if args.prefix_lease > 0 else None,
        chaos=args.chaos,
    )
    server.start()
    print(f"SESSION_STORE_SERVING port={server.port} "
          f"lease={args.lease if args.lease > 0 else 0}", flush=True)
    import signal

    shutdown = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: shutdown.set())
    try:
        # timeout loop so the main thread keeps servicing signals (a
        # bare wait() can park in an uninterruptible acquire)
        while not shutdown.wait(0.2):
            pass
    except KeyboardInterrupt:
        pass
    server.stop()


if __name__ == "__main__":
    main()
