"""Low-overhead metrics registry: counters, gauges, log-bucketed histograms.

Design constraints (the serving loop records on its hot path):

* **O(1) recording** — a histogram observation is one ``log10`` plus an
  integer bucket increment; counters and gauges are single float ops.  No
  sample lists are kept anywhere.
* **Fixed bucket layout** — every histogram shares one geometric grid:
  ``N_DECADES`` decades from ``BUCKET_LO_MS`` upward, ``PER_DECADE``
  buckets per decade (~1.21x per step), plus one overflow bucket —
  :data:`N_BUCKETS` (~O(100)) total.  Because the layout is global and
  static, any two snapshots are *mergeable* by elementwise addition
  (:meth:`HistogramSnapshot.merge`) — cross-replica and cross-run
  aggregation without resampling.
* **Percentile accessor** — :meth:`Histogram.percentile` interpolates
  linearly inside the winning bucket, the histogram analogue of the
  shared :func:`repro_torch.observability.quantile.quantile` convention
  (resolution is the bucket width: ~±10%).

Metrics are identified by ``(name, labels)``; :class:`MetricsRegistry`
hands out get-or-create handles so instrumentation sites can call
``registry.counter("x", tenant="ui").inc()`` without caching anything.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "BUCKET_LO_MS",
    "PER_DECADE",
    "N_DECADES",
    "N_BUCKETS",
    "bucket_upper_ms",
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramSnapshot",
    "MetricsRegistry",
]

# The shared histogram grid: 0.01 ms .. 1e6 ms (~17 min) in 12
# buckets/decade — 96 finite buckets + 1 overflow = 97 (~O(100)).
BUCKET_LO_MS = 1e-2
PER_DECADE = 12
N_DECADES = 8
N_BUCKETS = N_DECADES * PER_DECADE + 1  # finite grid + overflow

_LOG_LO = math.log10(BUCKET_LO_MS)


def bucket_index(value_ms: float) -> int:
    """O(1): which fixed bucket a value lands in (underflow → 0)."""
    if value_ms <= BUCKET_LO_MS:
        return 0
    idx = int((math.log10(value_ms) - _LOG_LO) * PER_DECADE)
    # A value exactly on a bucket edge belongs to the bucket above it in
    # float terms either way; clamp the top into the overflow bucket.
    return min(idx, N_BUCKETS - 1)


def bucket_upper_ms(index: int) -> float:
    """Upper bound of bucket ``index`` (inf for the overflow bucket)."""
    if index >= N_BUCKETS - 1:
        return math.inf
    return 10.0 ** (_LOG_LO + (index + 1) / PER_DECADE)


def bucket_lower_ms(index: int) -> float:
    if index <= 0:
        return 0.0
    return 10.0 ** (_LOG_LO + index / PER_DECADE)


class Counter:
    """Monotone accumulator."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


@dataclasses.dataclass(frozen=True)
class HistogramSnapshot:
    """Immutable histogram state; mergeable because the layout is fixed."""

    counts: Tuple[int, ...]
    count: int
    sum: float

    def merge(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        return HistogramSnapshot(
            counts=tuple(a + b for a, b in zip(self.counts, other.counts)),
            count=self.count + other.count,
            sum=self.sum + other.sum,
        )

    def percentile(self, q: float) -> float:
        return _percentile(self.counts, self.count, q)


def _percentile(counts, count: int, q: float) -> float:
    """Linear interpolation inside the winning bucket (NaN when empty)."""
    if count == 0:
        return float("nan")
    # The same rank convention as numpy's 'linear' method: the target
    # rank is q/100 * (n-1), counted over the ordered observations.
    rank = (q / 100.0) * (count - 1)
    seen = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if seen + c > rank:
            lo = bucket_lower_ms(i)
            hi = bucket_upper_ms(i)
            if math.isinf(hi):  # overflow bucket: its lower edge is honest
                return lo
            frac = (rank - seen + 0.5) / c  # midpoint-spread within bucket
            return lo + min(max(frac, 0.0), 1.0) * (hi - lo)
        seen += c
    return bucket_lower_ms(N_BUCKETS - 1)  # pragma: no cover - defensive


class Histogram:
    """Fixed-layout log-bucketed latency histogram (no sample list)."""

    __slots__ = ("counts", "count", "sum")

    def __init__(self):
        self.counts = [0] * N_BUCKETS
        self.count = 0
        self.sum = 0.0

    def record(self, value_ms: float) -> None:
        self.counts[bucket_index(value_ms)] += 1
        self.count += 1
        self.sum += value_ms

    def percentile(self, q: float) -> float:
        """Approximate percentile (bucket-resolution, ~±10%)."""
        return _percentile(self.counts, self.count, q)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def snapshot(self) -> HistogramSnapshot:
        return HistogramSnapshot(tuple(self.counts), self.count, self.sum)


LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, object]) -> LabelsKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Get-or-create handles for ``(name, labels)``-keyed metrics.

    Creation order is preserved (deterministic export); handle lookup is
    one dict get under a lock, and the returned objects are lock-free —
    all mutation happens on the serving loop's tick thread, matching the
    single-writer discipline the breakers already rely on.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, LabelsKey], object] = {}

    def _get(self, kind: str, name: str, labels: Dict, factory):
        key = (kind, name, _labels_key(labels))
        with self._lock:
            obj = self._metrics.get(key)
            if obj is None:
                obj = self._metrics[key] = factory()
            return obj

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels, Histogram)

    # -- export surface --------------------------------------------------------
    def items(self) -> List[Tuple[str, str, Dict[str, str], object]]:
        """``(kind, name, labels, metric)`` in creation order."""
        with self._lock:
            return [
                (kind, name, dict(labels), obj)
                for (kind, name, labels), obj in self._metrics.items()
            ]

    def snapshot(self) -> Dict:
        """JSON-able point-in-time state (the metrics-snapshot export)."""
        out: Dict[str, List] = {"counters": [], "gauges": [], "histograms": []}
        for kind, name, labels, obj in self.items():
            if kind == "counter":
                out["counters"].append(
                    {"name": name, "labels": labels, "value": obj.value}
                )
            elif kind == "gauge":
                out["gauges"].append(
                    {"name": name, "labels": labels, "value": obj.value}
                )
            else:
                out["histograms"].append(
                    {
                        "name": name,
                        "labels": labels,
                        "count": obj.count,
                        "sum": obj.sum,
                        "counts": list(obj.counts),
                        "p50": obj.percentile(50),
                        "p99": obj.percentile(99),
                    }
                )
        return out

    def get_value(self, kind: str, name: str, **labels) -> Optional[float]:
        """Test/inspection helper: a metric's value, None if absent."""
        key = (kind, name, _labels_key(labels))
        with self._lock:
            obj = self._metrics.get(key)
        if obj is None:
            return None
        return obj.count if kind == "histogram" else obj.value
