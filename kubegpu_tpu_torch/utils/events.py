"""The port's copy of the JAX package's ``utils/events.py``.

Kubernetes Events: the operator-facing record of scheduling decisions.

kube-scheduler explains itself through v1 Events (`kubectl describe pod`
shows Scheduled/FailedScheduling/Preempted); this recorder gives the
extender the same voice for the decisions only IT can explain — gang
planning, chip-health evictions, stranded-gang rollbacks, preemptions.
Events are best-effort by k8s convention: emission failures are logged and
swallowed, never allowed to fail a scheduling verb.  Identical
(object, reason, message) emissions within ``dedup_s`` are suppressed —
the resync loop re-observes conditions every 30 s and must not spam one
event per tick.
"""

from __future__ import annotations

import logging
import threading
import time
from datetime import datetime, timezone
from typing import Dict, Optional, Tuple

log = logging.getLogger(__name__)


class EventRecorder:
    def __init__(
        self,
        api,
        component: str = "kubegpu-tpu-scheduler",
        dedup_s: float = 300.0,
    ) -> None:
        self.api = api
        self.component = component
        self.dedup_s = dedup_s
        self._lock = threading.Lock()
        self._seen: Dict[Tuple[str, str, str], float] = {}

    def pod_event(
        self,
        namespace: str,
        name: str,
        reason: str,
        message: str,
        type_: str = "Normal",
        uid: str = "",
    ) -> None:
        """Emit one v1 Event against a Pod; dedup + best-effort."""
        key = (f"{namespace}/{name}", reason, message)
        now = time.monotonic()
        with self._lock:
            last = self._seen.get(key)
            if last is not None and now - last < self.dedup_s:
                return
            self._seen[key] = now
            # bound the memory: drop entries past their dedup window
            if len(self._seen) > 4096:
                self._seen = {
                    k: v for k, v in self._seen.items()
                    if now - v < self.dedup_s
                }
        stamp = datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        # name suffix = wall-clock nanoseconds (kube-scheduler's own
        # convention): unique across restarts and HA replicas, where a
        # resettable counter would collide with a live same-named event
        # and the 409 would silently swallow the new emission.  The pod-
        # name prefix is truncated so the whole event name stays within
        # the DNS-1123 subdomain limit (253) — a real API server 422s
        # over-long names and the best-effort swallow would silently drop
        # the record exactly for long-named pods.
        suffix = f".{time.time_ns():x}"
        obj = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {
                "name": f"{name[: 253 - len(suffix)]}{suffix}",
                "namespace": namespace,
            },
            "involvedObject": {
                "apiVersion": "v1",
                "kind": "Pod",
                "namespace": namespace,
                "name": name,
                "uid": uid,
            },
            "reason": reason,
            "message": message,
            "type": type_,
            "source": {"component": self.component},
            "firstTimestamp": stamp,
            "lastTimestamp": stamp,
            "count": 1,
        }
        try:
            self.api.create_event(obj)
        except NotImplementedError:
            pass  # API fake without an events surface: stay silent
        except Exception:  # noqa: BLE001 - events are best-effort
            log.debug("event emission failed for %s/%s %s", namespace, name, reason)
