"""Prometheus-style metrics registry of the port: its own copy of the JAX
package's ``utils/metrics.py``, so the replica's ``/metrics`` renders
byte for byte what a JAX replica renders for the same calls.

Three instrument kinds: counters (``inc``), gauges (``set_gauge``) and
histograms (``observe``, or the ``timer`` context), each with optional
keyword labels; a labeled series is independent of the unlabeled one
under the same name.  ``render()`` is the Prometheus text exposition,
sorted by name and label set, label values escaped
(``escape_label_value``); histograms render as the ``summary`` shape
(``_count``, ``_sum`` and reservoir quantiles of the most recent
``RESERVOIR_SIZE`` observations).  Every name the port emits is listed
in ``utils/metric_names.py``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict, List, Tuple

# Quantiles come from a bounded reservoir of the most recent observations;
# count/sum are exact running totals.  A long-lived extender must not grow
# (or re-sort) an unbounded list on the scheduling hot path.
RESERVOIR_SIZE = 1024

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, str]) -> _Key:
    return (name, tuple(sorted(labels.items())))


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash first (or
    the other escapes' backslashes would double-escape)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels
    )
    return "{" + inner + "}"


class _Histogram:
    __slots__ = ("count", "total", "recent")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.recent: deque = deque(maxlen=RESERVOIR_SIZE)


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = defaultdict(float)
        self._gauges: Dict[_Key, float] = {}
        self._histograms: Dict[_Key, _Histogram] = defaultdict(_Histogram)

    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        with self._lock:
            self._counters[_key(name, labels)] += value

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        """Gauges overwrite (current level, not a running total): queue
        depth, live-replica count — values that go down as well as up."""
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def gauge(self, name: str, **labels: str) -> float:
        with self._lock:
            return self._gauges.get(_key(name, labels), 0.0)

    @contextmanager
    def timer(self, name: str, **labels: str):
        """Observe the wall time of a ``with`` block into histogram
        ``name`` — the phase-timer idiom (e.g. speculative draft vs
        verify seconds); callers fencing device work must read the
        result back inside the block or the timer measures dispatch."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.observe(name, time.monotonic() - t0, **labels)

    def observe(self, name: str, value: float, **labels: str) -> None:
        with self._lock:
            h = self._histograms[_key(name, labels)]
            h.count += 1
            h.total += value
            h.recent.append(value)

    def get(self, name: str, **labels: str) -> float:
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def quantile(self, name: str, q: float, **labels: str) -> float:
        """Reservoir quantile of a histogram series (0.0 if never
        observed) — the programmatic twin of the exposition lines, for
        bench rows and tests that assert on latency percentiles."""
        with self._lock:
            h = self._histograms.get(_key(name, labels))
            if h is None or not h.recent:
                return 0.0
            s = sorted(h.recent)
            return s[min(len(s) - 1, int(q * len(s)))]

    def histogram_count(self, name: str, **labels: str) -> int:
        with self._lock:
            h = self._histograms.get(_key(name, labels))
            return h.count if h is not None else 0

    def histogram_sum(self, name: str, **labels: str) -> float:
        """Exact running sum of a histogram series (0.0 if never
        observed) — with ``histogram_count`` it yields the mean, e.g.
        mean submit→first-chunk wait from ``serve_prefill_wait_seconds``."""
        with self._lock:
            h = self._histograms.get(_key(name, labels))
            return h.total if h is not None else 0.0

    def render(self) -> str:
        """Prometheus text exposition (stable-ordered: sorted by metric
        name, then label set)."""
        out: List[str] = []

        def line(name, labels, v):
            out.append(f"{name}{_label_str(labels)} {v}")

        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                line(name, labels, v)
            typed = set()
            for (name, labels), v in sorted(self._gauges.items()):
                if name not in typed:
                    # gauges carry an explicit TYPE line: a scraper must
                    # not apply rate() to them the way it does to the
                    # (untyped, counter-by-convention) names above
                    out.append(f"# TYPE {name} gauge")
                    typed.add(name)
                line(name, labels, v)
            typed = set()
            for (name, labels), h in sorted(self._histograms.items()):
                if name not in typed:
                    # count/sum/quantile samples are the SUMMARY shape;
                    # "histogram" would require _bucket/le series and
                    # fail strict parsers (see module docstring)
                    out.append(f"# TYPE {name} summary")
                    typed.add(name)
                out.append(f"{name}_count{_label_str(labels)} {h.count}")
                out.append(f"{name}_sum{_label_str(labels)} {h.total}")
                if h.recent:
                    s = sorted(h.recent)
                    for q in (0.5, 0.9, 0.99):
                        idx = min(len(s) - 1, int(q * len(s)))
                        qlabels = labels + (("quantile", str(q)),)
                        out.append(f"{name}{_label_str(qlabels)} {s[idx]}")
        return "\n".join(out) + "\n"


# process-global default registry
default_metrics = Metrics()
