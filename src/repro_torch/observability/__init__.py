"""Observability for the port's serving stack: tracing, metrics, exporters.

The JAX package's observability layer, carried over with its names and
formats (pure Python, no torch): the same spans, counters and exports, so
one ``benchmarks/validate_obs.py`` checks both packages' files.

* :mod:`repro_torch.observability.trace` — ``Tracer``/``Span`` with explicit
  parent links and ``perf_counter``-ms stamps: one span tree per request
  plus loop-tick / controller / transport-worker spans.  Which spans time
  device work (closed after a stream synchronization) and which time host
  work only is set out there.
* :mod:`repro_torch.observability.metrics` — counters, gauges, and fixed-layout
  log-bucketed latency histograms (O(1) recording, mergeable snapshots,
  percentile accessor).
* :mod:`repro_torch.observability.export` — Chrome ``trace_event`` JSON
  (``chrome://tracing`` / Perfetto), Prometheus text, JSONL span sink,
  and the request-conservation audit.
* :mod:`repro_torch.observability.quantile` — the one shared, empty-input-safe
  percentile helper every summary path uses.

:class:`Observability` bundles one tracer + one registry; it is threaded
through the stack as an *optional* handle (``observability=None``
everywhere by default): with it unset, every instrumented layer takes its
untraced path, decision-identical to a run without tracing
(``tests/test_torch_observability.py`` pins this, and the JAX package's
decisions beside it).
"""
from __future__ import annotations

from repro_torch.observability.export import (
    chrome_trace,
    prometheus_text,
    request_conservation,
    write_chrome_trace,
    write_jsonl_spans,
    write_metrics_snapshot,
    write_prometheus,
)
from repro_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    HistogramSnapshot,
    MetricsRegistry,
    N_BUCKETS,
)
from repro_torch.observability.quantile import percentiles, quantile
from repro_torch.observability.trace import Span, Tracer, now_wall_ms

__all__ = [
    "Observability",
    "Tracer",
    "Span",
    "now_wall_ms",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramSnapshot",
    "N_BUCKETS",
    "quantile",
    "percentiles",
    "chrome_trace",
    "prometheus_text",
    "request_conservation",
    "write_chrome_trace",
    "write_jsonl_spans",
    "write_metrics_snapshot",
    "write_prometheus",
]


class Observability:
    """One tracer + one metrics registry: the handle the stack threads.

    Attach it once at the top (``ServingLoop(...,
    observability=obs)``) — the loop propagates it to the admission
    queue, tenant lanes, controller, scheduler, cluster (and through it
    each replica's breaker and transport), and the backend's slot cache.
    """

    def __init__(self):
        self.tracer = Tracer()
        self.metrics = MetricsRegistry()

    # Convenience passthroughs for the hot instrumentation sites.
    def counter(self, name: str, **labels):
        return self.metrics.counter(name, **labels)

    def gauge(self, name: str, **labels):
        return self.metrics.gauge(name, **labels)

    def histogram(self, name: str, **labels):
        return self.metrics.histogram(name, **labels)
