"""The port's copy of the JAX package's ``utils/leaderelection.py``.

Lease-based leader election over ``coordination.k8s.io/v1``.

The extender's no-double-allocation invariant assumes exactly ONE process
serves verbs: the cluster cache is in-memory per process, so two replicas
each assuming the same chips would silently double-allocate (VERDICT r3
missing #1).  ``deploy/device-scheduler.yaml``'s ``replicas: 1`` was the
only guard — one typo, or the overlap window of a rolling update, away
from breaking.  This module is the k8s-native fix, mirroring client-go's
``leaderelection`` semantics (kube-scheduler/kube-controller-manager HA):

- one Lease object names the leader (``spec.holderIdentity``);
- acquire when unheld or expired — expiry judged by the holder's record
  sitting UNCHANGED for ``leaseDurationSeconds`` on the OBSERVER's own
  monotonic clock (client-go's observedRenewTime), never by comparing the
  lease's wall-clock stamps against local time (inter-node clock skew
  would corrupt the window); renew while held;
- every write is compare-and-swap via the object's ``resourceVersion``
  (the API server's optimistic concurrency) — two racing acquirers cannot
  both win;
- on clean shutdown the holder releases (clears holderIdentity), so a
  rolling update hands off immediately instead of waiting out the lease.

``is_leader()`` is deliberately conservative: leadership is claimed only
within ``lease_duration_s`` of the LAST SUCCESSFUL renew, stamped from
BEFORE the renew write was issued (monotonic clock).  On API-server
trouble the leader therefore STOPS CLAIMING leadership no later than the
moment a standby could first legitimately acquire — the two can overlap
in "nobody serves" (safe, kube-scheduler retries) but never both pass
the verb gate.  A Lease is still not a true fencing token: a durable
write ISSUED while leading can land after the window closes.  The
extender narrows that to the API round-trip (bind re-checks the gate
immediately before its annotation write — ``Scheduler.serving_gate``)
and the conflict sweep's durable double-annotation eviction resolves
any residue.

SURVEY.md §1's data-flow contract (all durable state in the API server)
is what makes warm standby cheap: the loser keeps its cache fresh via
resync but serves nothing and evicts nothing; on acquiring it replays
annotations and is immediately correct.
"""

from __future__ import annotations

import logging
import threading
import time
from datetime import datetime, timezone
from typing import Callable, Optional

from kubegpu_tpu_torch.utils.apiserver import ApiServer, Conflict, NotFound

log = logging.getLogger(__name__)

_TS = "%Y-%m-%dT%H:%M:%S.%fZ"  # k8s MicroTime


def _now_utc() -> datetime:
    return datetime.now(timezone.utc)


def _fmt(ts: datetime) -> str:
    return ts.strftime(_TS)


class LeaderElector:
    def __init__(
        self,
        api: ApiServer,
        identity: str,
        namespace: str = "kube-system",
        name: str = "kubegpu-tpu-scheduler",
        lease_duration_s: float = 15.0,
        renew_period_s: float = 5.0,
        retry_period_s: float = 2.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> None:
        assert renew_period_s < lease_duration_s, (
            "renew must fit inside the lease or leadership flaps"
        )
        self.api = api
        self.identity = identity
        self.namespace = namespace
        self.name = name
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.retry_period_s = retry_period_s
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._lock = threading.Lock()
        self._held = False
        # monotonic stamp taken BEFORE the renew write was issued: the
        # leadership window must start when the write left, not when it
        # returned — measuring after the PUT would let a slow round-trip
        # extend our claim past the instant a standby may legitimately
        # acquire (their clock starts from the lease content we wrote)
        self._last_renew = 0.0
        # another holder's lease record as last observed + when (monotonic,
        # OUR clock): expiry is judged by "unchanged for leaseDuration on
        # my own clock" — client-go's observedRenewTime semantics — never
        # by comparing the lease's wall-clock timestamps against ours,
        # which inter-node clock skew would corrupt
        self._observed: Optional[tuple] = None
        self._observed_at = 0.0

    # -- state -------------------------------------------------------------
    def is_leader(self) -> bool:
        """Conservative leadership: held AND renewed within the lease
        window.  A leader that cannot reach the API server stops claiming
        leadership no later than a standby could first acquire."""
        with self._lock:
            return (
                self._held
                and time.monotonic() - self._last_renew < self.lease_duration_s
            )

    def _set_held(self, held: bool, stamp: Optional[float] = None) -> None:
        with self._lock:
            if held:
                self._held = True
                self._last_renew = (
                    stamp if stamp is not None else time.monotonic()
                )
            else:
                self._held = False

    # -- lease mechanics ---------------------------------------------------
    def _lease_spec(self, transitions: int, acquire_time: Optional[str]) -> dict:
        now = _fmt(_now_utc())
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_duration_s),
            "acquireTime": acquire_time or now,
            "renewTime": now,
            "leaseTransitions": transitions,
        }

    def _expired(self, spec: dict) -> bool:
        """Another holder's lease is expired when its record has sat
        UNCHANGED for leaseDurationSeconds on OUR monotonic clock
        (client-go's observedRenewTime).  The lease's own wall-clock
        timestamps are never compared against our clock — skew between
        nodes would otherwise shrink (unsafe) or stretch the window."""
        if not spec.get("renewTime") and not spec.get("acquireTime"):
            return True  # never-renewed husk (e.g. released pre-timestamps)
        rec = (
            spec.get("holderIdentity"),
            spec.get("renewTime"),
            spec.get("acquireTime"),
        )
        now = time.monotonic()
        with self._lock:
            if rec != self._observed:
                # the record moved: its holder is alive — restart our timer
                self._observed = rec
                self._observed_at = now
                return False
            dur = float(
                spec.get("leaseDurationSeconds") or self.lease_duration_s
            )
            return now - self._observed_at > dur

    def try_acquire_or_renew(self) -> str:
        """One acquire/renew attempt.  Returns ``"ok"`` (we hold the lease),
        ``"lost"`` (someone else positively holds it / won the CAS race), or
        ``"error"`` (API trouble — unknown).  Every write goes through
        create (POST, conflicts if it exists) or update-with-
        resourceVersion (CAS) — losing a race is a clean "lost", never a
        shared lease.  The tri-state matters for the run loop: a DEFINITE
        loss drops leadership immediately, while a transient error leaves
        the is_leader() lease-window timeout in charge (client-go's
        renewDeadline semantics) — one API blip must not flap a healthy
        leader."""
        try:
            lease = self.api.get_lease(self.namespace, self.name)
        except NotFound:
            obj = {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {"name": self.name, "namespace": self.namespace},
                "spec": self._lease_spec(0, None),
            }
            try:
                self.api.create_lease(obj)
                return "ok"
            except Conflict:
                return "lost"  # lost the creation race
            except Exception as e:  # noqa: BLE001
                log.warning("lease create failed: %s", e)
                return "error"
        except Exception as e:  # noqa: BLE001
            log.warning("lease read failed: %s", e)
            return "error"

        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity") or ""
        if holder and holder != self.identity and not self._expired(spec):
            return "lost"  # someone else holds a live lease
        transitions = int(spec.get("leaseTransitions") or 0)
        if holder != self.identity:
            transitions += 1
        lease["spec"] = self._lease_spec(
            transitions,
            spec.get("acquireTime") if holder == self.identity else None,
        )
        try:
            self.api.update_lease(self.namespace, self.name, lease)
            return "ok"
        except (Conflict, NotFound):
            return "lost"  # a racing writer got there first
        except Exception as e:  # noqa: BLE001
            log.warning("lease update failed: %s", e)
            return "error"

    def release(self) -> None:
        """Best-effort immediate handoff on clean shutdown: clear the
        holder so a standby acquires on its next retry instead of waiting
        out the lease."""
        try:
            lease = self.api.get_lease(self.namespace, self.name)
            spec = lease.get("spec") or {}
            if spec.get("holderIdentity") != self.identity:
                return
            spec["holderIdentity"] = ""
            spec["renewTime"] = _fmt(_now_utc())
            self.api.update_lease(self.namespace, self.name, lease)
        except Exception:  # noqa: BLE001 - shutdown: nothing left to do
            pass
        self._set_held(False)

    # -- loop --------------------------------------------------------------
    def run(self, stop: threading.Event) -> None:
        """Block acquiring/renewing until ``stop``; thread target.  On exit
        a held lease is released (rolling-update handoff)."""
        while not stop.is_set():
            was = self.is_leader()
            t0 = time.monotonic()  # window starts when the write is ISSUED
            outcome = self.try_acquire_or_renew()
            if outcome == "ok":
                if not was and self.on_started_leading:
                    # promotion readiness BEFORE the verb gate opens: a
                    # fresh leader must replay API-server state (the
                    # callback is the cache refresh) before is_leader()
                    # lets the first bind through — or it binds against a
                    # cache up to a resync interval stale
                    try:
                        self.on_started_leading()
                    except Exception:  # noqa: BLE001
                        log.exception(
                            "on_started_leading failed; holding the lease "
                            "but deferring promotion to the next cycle"
                        )
                        self._set_held(False)
                        if stop.wait(self.retry_period_s):
                            break
                        continue
                self._set_held(True, stamp=t0)
            elif outcome == "lost":
                # positively observed another holder (or lost a CAS race):
                # drop NOW, don't coast on the lease window
                self._set_held(False)
            # "error": keep the claim; is_leader()'s lease-window timeout
            # retires it before a standby could legitimately acquire
            now = self.is_leader()
            if now and not was:
                log.info("acquired leadership as %s", self.identity)
            elif was and not now:
                log.warning("lost leadership as %s", self.identity)
                if self.on_stopped_leading:
                    self.on_stopped_leading()
            if stop.wait(self.renew_period_s if now else self.retry_period_s):
                break
        if self._held:
            self.release()
            if self.on_stopped_leading:
                self.on_stopped_leading()
