"""Process-wide metrics registry: counters, gauges, histograms, labels.

The port's copy of the part of ``photon_tpu/obs/metrics.py`` that the
serving engine's ``stats()`` reads: labelled counters, gauges and
bucketed histograms with interpolated quantiles, and one registry
``snapshot()``. The Prometheus exporter and the cross-process merge are
not carried over.

All operations take one lock; increments are host-side and happen at
batch granularity, never inside a kernel.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Prometheus-style default buckets, extended upward for compile times
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

LabelItems = Tuple[Tuple[str, str], ...]


def _label_items(labels: Dict[str, str]) -> LabelItems:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_suffix(items: LabelItems) -> str:
    if not items:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + inner + "}"


class Counter:
    """Monotone sum. ``inc`` only (negative deltas rejected)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError(f"counter increments must be >= 0, got {delta}")
        with self._lock:
            self.value += delta


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: le upper bounds
    plus an implicit +Inf bucket; ``sum``/``count`` ride along)."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self._lock = lock
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts: List[int] = [0] * (len(self.buckets) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.counts[bisect.bisect_left(self.buckets, value)] += 1
            self.sum += value
            self.count += 1


def bucket_quantile(buckets: Sequence[float], counts: Sequence[int],
                    q: float) -> Optional[float]:
    """Prometheus-style estimated quantile: find the bucket holding rank
    q*count, interpolate linearly inside it (lower bound 0 for the first
    bucket; the +Inf bucket clamps to the last finite bound). None when
    empty. Estimation error is bounded by bucket width — pick latency
    buckets accordingly (serving uses ~1.3x geometric steps)."""
    total = sum(counts)
    if total == 0:
        return None
    target = q * total
    cumulative = 0
    for i, c in enumerate(counts):
        prev = cumulative
        cumulative += c
        if cumulative >= target and c > 0:
            if i >= len(buckets):            # +Inf bucket
                return float(buckets[-1]) if buckets else None
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i]
            frac = (target - prev) / c
            return float(lo + (hi - lo) * frac)
    return float(buckets[-1]) if buckets else None


class MetricsRegistry:
    """Thread-safe name+labels -> metric registry.

    The first registration of a name fixes its kind; re-registering the
    same (name, labels) returns the same instance, so call sites can do
    ``registry.counter("jitcache.hits").inc()`` on every event.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[Tuple[str, LabelItems], object] = {}
        self._kinds: Dict[str, str] = {}

    def _get(self, kind: str, name: str, labels: Dict[str, str], factory):
        key = (name, _label_items(labels))
        with self._lock:
            existing_kind = self._kinds.get(name)
            if existing_kind is not None and existing_kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {existing_kind}, "
                    f"requested {kind}")
            metric = self._metrics.get(key)
            if metric is None:
                metric = self._metrics[key] = factory()
                self._kinds[name] = kind
            return metric

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get("counter", name, labels,
                         lambda: Counter(self._lock))

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get("gauge", name, labels, lambda: Gauge(self._lock))

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(self._lock, buckets))

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()

    # -- export ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} with
        ``name{label="v"}`` keys — the RunReport's ``metrics`` section."""
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = list(self._metrics.items())
        for (name, labels), metric in sorted(items, key=lambda kv: kv[0]):
            key = name + _label_suffix(labels)
            if isinstance(metric, Counter):
                out["counters"][key] = metric.value
            elif isinstance(metric, Gauge):
                out["gauges"][key] = metric.value
            else:
                assert isinstance(metric, Histogram)
                h = {
                    "buckets": list(metric.buckets),
                    "counts": list(metric.counts),
                    "sum": metric.sum,
                    "count": metric.count,
                }
                if metric.count:
                    for name_q, q in (("p50", 0.5), ("p95", 0.95),
                                      ("p99", 0.99)):
                        h[name_q] = bucket_quantile(h["buckets"],
                                                    h["counts"], q)
                out["histograms"][key] = h
        return out


# process-wide default registry: every subsystem records here
registry = MetricsRegistry()
