"""Process-wide telemetry: a thread-safe metrics registry + trace spans.

The port's own copy of ``repro.runtime.telemetry``: the two packages keep
separate registries, so a process that runs both never mixes their series.

One registry serves the whole engine (every Session, Feed, compactor thread,
and kernel dispatch in the process writes to it), mirroring what a metrics
sidecar would scrape from a serving AsterixDB node:

  * **counters** — monotone event counts (plan-cache hits per level,
    compaction attempts / CAS conflicts / retries, kernel launches, ...);
  * **gauges**   — last-known values (retired-component device bytes,
    stall pressure, resident run counts, last-execute wall time);
  * **histograms** — latency/size distributions with fixed exponential
    buckets (flush build time, write-stall duration, query phases);
  * **spans**    — lightweight structured traces (name, labels, start,
    duration, parent) kept in a bounded ring; every finished span also
    feeds the ``<name>_seconds`` histogram, so phase timers and traces
    are one call site.

Series are labeled: ``inc("kernel.launches_total", kernel="filter_count")``
creates the series ``kernel.launches_total{kernel=filter_count}``. Label
sets are expected to be low-cardinality (dataset names, levels, modes).

Overhead contract: ``enabled`` gates everything that costs real time —
span capture (``perf_counter`` pairs, ring appends) and histogram
observation are no-ops when disabled. Counters and gauges always record:
they ARE the engine's operational state (``Session.stats``,
``Catalog.gc_stats`` and the ingest/compactor mirrors are thin views over
them), and an increment is one locked dict add. Disable with
``set_enabled(False)`` or the ``REPRO_TELEMETRY=0`` environment variable.

``snapshot()`` exports everything as one JSON-serializable dict; benchmarks
attach it to their result files and CI asserts on the series.
``snapshot(normalize=True)`` zeroes every time-valued field (histogram
sum/min/max/buckets, span start/duration, ``*seconds*`` gauges) so two runs
of the same deterministic workload produce identical snapshots — the form
golden tests compare.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

# Exponential latency buckets (seconds): 100µs .. 10s, the range between a
# cached plan bind and a stalled flush. Sizes (rows/bytes) reuse the same
# histogram type; their buckets are irrelevant and dropped on normalize.
DEFAULT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0)


def series_key(name: str, labels: dict) -> str:
    """Canonical series id: ``name{k1=v1,k2=v2}`` with sorted label keys —
    snapshot keys are deterministic strings, not tuples."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Histogram:
    __slots__ = ("count", "total", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets = [0] * (len(DEFAULT_BUCKETS) + 1)  # last = +inf

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        for i, le in enumerate(DEFAULT_BUCKETS):
            if value <= le:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    def snapshot(self, normalize: bool = False) -> dict:
        if normalize:  # timing-dependent fields zeroed, event count kept
            return {"count": self.count, "sum": 0.0, "min": 0.0, "max": 0.0}
        out = {"count": self.count, "sum": self.total,
               "min": self.min if self.count else 0.0,
               "max": self.max if self.count else 0.0,
               "buckets": {}}
        for le, n in zip(DEFAULT_BUCKETS, self.buckets):
            if n:
                out["buckets"][str(le)] = n
        if self.buckets[-1]:
            out["buckets"]["+inf"] = self.buckets[-1]
        return out


class _NoopSpan:
    """Shared do-nothing span: what ``span()`` hands out when telemetry is
    disabled — enter/exit touch no clock and allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    __slots__ = ("_registry", "name", "labels", "start", "duration", "parent")

    def __init__(self, registry: "MetricsRegistry", name: str, labels: dict):
        self._registry = registry
        self.name = name
        self.labels = labels
        self.start = 0.0
        self.duration = 0.0
        self.parent: Optional[str] = None

    def __enter__(self) -> "Span":
        stack = self._registry._span_stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.duration = time.perf_counter() - self.start
        stack = self._registry._span_stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._registry._finish_span(self)
        return False


class MetricsRegistry:
    def __init__(self, enabled: bool = True, max_spans: int = 1024):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Histogram] = {}
        self._spans: deque = deque(maxlen=max_spans)
        self._tls = threading.local()

    # -- recording ----------------------------------------------------------

    def inc(self, name: str, value=1, **labels) -> None:
        """Counter add. Unconditional (see module docstring): the engine's
        back-compat stats surfaces read these even with telemetry off."""
        key = series_key(name, labels)
        with self._lock:  # int() keeps numpy scalars out of JSON snapshots
            self._counters[key] = self._counters.get(key, 0) + int(value)

    def set_gauge(self, name: str, value, **labels) -> None:
        key = series_key(name, labels)
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Histogram observation — gated: observations carry timings/sizes
        whose capture is exactly the overhead ``enabled`` exists to avoid."""
        if not self.enabled:
            return
        key = series_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram()
            h.observe(value)

    def span(self, name: str, **labels):
        """Context manager timing one phase. On exit the span lands in the
        trace ring AND observes the ``<name>_seconds`` histogram (same
        labels). Returns the shared no-op when disabled."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, labels)

    # -- reading ------------------------------------------------------------

    def counter_value(self, name: str, **labels):
        with self._lock:
            return self._counters.get(series_key(name, labels), 0)

    def gauge_value(self, name: str, default=None, **labels):
        with self._lock:
            return self._gauges.get(series_key(name, labels), default)

    def counters(self, prefix: str = "") -> dict:
        with self._lock:
            return {k: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def gauges(self, prefix: str = "") -> dict:
        with self._lock:
            return {k: v for k, v in self._gauges.items()
                    if k.startswith(prefix)}

    def spans(self, name: Optional[str] = None) -> list[dict]:
        with self._lock:
            out = list(self._spans)
        return out if name is None else [s for s in out if s["name"] == name]

    def snapshot(self, normalize: bool = False, include_spans: bool = True) -> dict:
        """One JSON-serializable dict of every series. ``normalize=True``
        zeroes time-valued fields (histogram sum/min/max/buckets, span
        start/duration, gauges whose name contains "seconds") so
        deterministic workloads snapshot identically."""
        with self._lock:
            counters = dict(sorted(self._counters.items()))
            gauges = dict(sorted(self._gauges.items()))
            hists = {k: h.snapshot(normalize)
                     for k, h in sorted(self._hists.items())}
            spans = list(self._spans) if include_spans else []
        if normalize:
            gauges = {k: (0.0 if "seconds" in k else v)
                      for k, v in gauges.items()}
            spans = [dict(s, start=0.0, duration=0.0) for s in spans]
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "spans": spans}

    def to_json(self, normalize: bool = False, **kw) -> str:
        return json.dumps(self.snapshot(normalize), **kw)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._spans.clear()

    # -- span plumbing ------------------------------------------------------

    def _span_stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _finish_span(self, span: Span) -> None:
        record = {"name": span.name, "labels": dict(span.labels),
                  "start": span.start, "duration": span.duration,
                  "parent": span.parent}
        key = series_key(span.name + "_seconds", span.labels)
        with self._lock:
            self._spans.append(record)
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Histogram()
            h.observe(span.duration)


# -- the process-wide registry -----------------------------------------------

REGISTRY = MetricsRegistry(
    enabled=os.environ.get("REPRO_TELEMETRY", "1").lower()
    not in ("0", "false", "off"))


def registry() -> MetricsRegistry:
    return REGISTRY


def set_enabled(on: bool) -> None:
    REGISTRY.enabled = bool(on)


def enabled() -> bool:
    return REGISTRY.enabled


# Module-level conveniences: call sites write `tel.inc(...)` without holding
# the registry object.

def inc(name: str, value=1, **labels) -> None:
    REGISTRY.inc(name, value, **labels)


def set_gauge(name: str, value, **labels) -> None:
    REGISTRY.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    REGISTRY.observe(name, value, **labels)


def span(name: str, **labels):
    return REGISTRY.span(name, **labels)


def counter_value(name: str, **labels):
    return REGISTRY.counter_value(name, **labels)


def gauge_value(name: str, default=None, **labels):
    return REGISTRY.gauge_value(name, default, **labels)


def snapshot(normalize: bool = False, include_spans: bool = True) -> dict:
    return REGISTRY.snapshot(normalize, include_spans)
