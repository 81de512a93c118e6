"""Metrics registry (a copy of ``repro.obs.metrics``): counters, gauges (timelines) and exact-percentile
histograms, exportable to a plain dict/JSON.

Complements ``obs.trace``: the tracer answers *where did this request's
microseconds go*, the registry answers *what were the distributions and
running totals* — TTFT/queue-wait percentiles, pool occupancy over
time, admission outcomes. Like the tracer it is **off by default**:
instrumented code does ``reg = metrics.get()`` and skips recording when
that returns None, so the disabled hot path is one global read.

Naming scheme (used by every instrumented subsystem; see
docs/observability.md):

    <subsystem>/<object>/<metric>[_<unit>]

e.g. ``serve/req/ttft_us`` (histogram), ``serve/pool/pages`` (gauge
timeline, one sample per decode step), ``serve/sched/page_stalls``
(counter), ``train/step/wall_us`` (histogram),
``dist/csb_partition/imbalance`` (gauge).

Percentiles are **exact** — histograms keep raw samples (bounded by
``max_samples``, reservoir-free: the cap is far above any serve run
this repo times) and quantiles use the nearest-rank method, so p50 of
[1, 2] is 1.0, not an interpolation artifact, and tiny sample counts
(0, 1, 2 — the edge cases tests pin) behave predictably.
"""
from __future__ import annotations

import dataclasses
import json
import math


@dataclasses.dataclass
class Counter:
    """Monotonic event count."""

    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-value metric that also keeps its set() history — the
    timeline view (pool occupancy per decode step) the final-summary
    stats can't give."""

    __slots__ = ("last", "series", "max_series", "dropped")

    def __init__(self, max_series: int = 65536):
        self.last: float | None = None
        self.series: list[float] = []
        self.max_series = max_series
        self.dropped = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.last = v
        if len(self.series) < self.max_series:
            self.series.append(v)
        else:
            self.dropped += 1


class Histogram:
    """Raw-sample histogram with exact nearest-rank percentiles."""

    __slots__ = ("samples", "max_samples", "dropped", "_sum")

    def __init__(self, max_samples: int = 262144):
        self.samples: list[float] = []
        self.max_samples = max_samples
        self.dropped = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self._sum += v
        if len(self.samples) < self.max_samples:
            self.samples.append(v)
        else:
            self.dropped += 1

    @property
    def count(self) -> int:
        return len(self.samples) + self.dropped

    def percentile(self, q: float) -> float | None:
        """Exact nearest-rank percentile: the ceil(q/100 * n)-th
        smallest sample. None when empty."""
        s = sorted(self.samples)
        if not s:
            return None
        rank = max(math.ceil(q / 100.0 * len(s)), 1)
        return s[min(rank, len(s)) - 1]

    def summary(self) -> dict:
        n = len(self.samples)
        if n == 0:
            return {"count": self.count, "min": None, "max": None,
                    "mean": None, "p50": None, "p95": None, "p99": None}
        return {
            "count": self.count,
            "min": min(self.samples),
            "max": max(self.samples),
            "mean": self._sum / self.count,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Get-or-create store for the three metric kinds; a name is bound
    to one kind for the registry's lifetime (mixing raises)."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _claim(self, name: str, own: dict) -> None:
        for kind in (self._counters, self._gauges, self._histograms):
            if kind is not own and name in kind:
                raise ValueError(
                    f"metric {name!r} already registered as another kind")

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            self._claim(name, self._counters)
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            self._claim(name, self._gauges)
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            self._claim(name, self._histograms)
            h = self._histograms[name] = Histogram()
        return h

    def to_dict(self, series: bool = True) -> dict:
        """Plain-dict export (JSON-serializable). ``series=False``
        drops gauge timelines (summary-only view)."""
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {
                k: ({"last": g.last, "n": len(g.series) + g.dropped,
                     "series": list(g.series)} if series
                    else {"last": g.last, "n": len(g.series) + g.dropped})
                for k, g in self._gauges.items()},
            "histograms": {k: h.summary()
                           for k, h in self._histograms.items()},
        }

    def to_json(self, series: bool = True) -> str:
        return json.dumps(self.to_dict(series=series))


# ---------------------------------------------------------------------------
# process-global registry, off by default (mirrors obs.trace)
# ---------------------------------------------------------------------------

_registry: MetricsRegistry | None = None


def enable() -> MetricsRegistry:
    """Install a fresh process-global registry and return it."""
    global _registry
    _registry = MetricsRegistry()
    return _registry


def disable() -> MetricsRegistry | None:
    global _registry
    r, _registry = _registry, None
    return r


def enabled() -> bool:
    return _registry is not None


def get() -> MetricsRegistry | None:
    """The live registry, or None when metrics are off. Instrumented
    code branches on ``is not None`` — the disabled fast path."""
    return _registry


def registry() -> MetricsRegistry:
    """The live registry, enabling on first use (for interactive /
    docs flows; instrumentation uses :func:`get` and never
    auto-enables)."""
    global _registry
    if _registry is None:
        _registry = MetricsRegistry()
    return _registry


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "enable", "disable", "enabled", "get", "registry"]
