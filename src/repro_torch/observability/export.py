"""Exporters: Chrome ``trace_event`` JSON, Prometheus text, JSONL spans.

Three sinks over the in-memory :class:`~repro_torch.observability.trace.Tracer`
and :class:`~repro_torch.observability.metrics.MetricsRegistry`:

* :func:`chrome_trace` — the Chrome ``trace_event`` JSON object format
  (loadable in ``chrome://tracing`` / Perfetto).  Every distinct span
  ``track`` becomes one named thread row (``tid``) under a single
  ``pid`` — one track per replica (``replica:<id>``), one per tenant
  lane (``tenant:<lane>``), plus the ``loop`` track — with timestamps in
  microseconds as the format requires.
* :func:`prometheus_text` — a Prometheus exposition-format snapshot:
  counters/gauges verbatim, histograms as cumulative ``_bucket{le=...}``
  series plus ``_sum`` / ``_count``.
* :func:`write_jsonl_spans` — one JSON object per span per line (the raw
  span sink for offline analysis).

:func:`request_conservation` is the trace-side accounting check the CI
smoke gate uses: every ``request`` root span must carry exactly one
terminal instant (``resolve`` | ``shed`` | ``cancel``) — submitted ==
resolved + rejected + cancelled, no request dropped on the floor.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional

from repro_torch.observability.metrics import (
    MetricsRegistry,
    bucket_upper_ms,
)
from repro_torch.observability.trace import Span, Tracer

__all__ = [
    "chrome_trace",
    "write_chrome_trace",
    "prometheus_text",
    "write_prometheus",
    "write_jsonl_spans",
    "write_metrics_snapshot",
    "request_conservation",
]

DEFAULT_TRACK = "loop"
_TERMINAL_NAMES = ("resolve", "shed", "cancel")


def _spans_of(source) -> List[Span]:
    return list(source.spans) if isinstance(source, Tracer) else list(source)


# -- Chrome trace_event ------------------------------------------------------
def chrome_trace(source, process_name: str = "repro-serving") -> Dict:
    """Build the Chrome ``trace_event`` JSON object for a span set.

    Unfinished spans are exported as zero-duration events at their start
    stamp (an interrupted run still loads).  ``args`` carries each span's
    ``span_id`` / ``parent_id`` so the tree survives the flat format.
    """
    spans = _spans_of(source)
    tracks: Dict[str, int] = {}
    events: List[Dict] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": 0,
            "tid": 0,
            "args": {"name": process_name},
        }
    ]

    def tid_for(track: Optional[str]) -> int:
        name = track if track is not None else DEFAULT_TRACK
        if name not in tracks:
            tracks[name] = len(tracks)
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": 0,
                    "tid": tracks[name],
                    "args": {"name": name},
                }
            )
        return tracks[name]

    for s in spans:
        tid = tid_for(s.track)
        args = dict(s.args)
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        base = {
            "name": s.name,
            "cat": s.cat or "span",
            "pid": 0,
            "tid": tid,
            "ts": s.start_ms * 1e3,  # trace_event timestamps are in µs
            "args": args,
        }
        if s.is_instant:
            base.update(ph="i", s="t")  # thread-scoped instant
        else:
            end = s.start_ms if s.end_ms is None else s.end_ms
            base.update(ph="X", dur=max(end - s.start_ms, 0.0) * 1e3)
        events.append(base)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, source, **kw) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(source, **kw), f)


# -- Prometheus text ---------------------------------------------------------
def _fmt_labels(labels: Dict[str, str], extra: Optional[Dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update({k: str(v) for k, v in extra.items()})
    if not merged:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry) -> str:
    """Prometheus exposition-format snapshot of the whole registry."""
    lines: List[str] = []
    typed: Dict[str, str] = {}  # metric name -> emitted TYPE
    for kind, name, labels, obj in registry.items():
        if name not in typed:
            typed[name] = kind
            lines.append(f"# TYPE {name} {kind}")
        if kind in ("counter", "gauge"):
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(obj.value)}")
            continue
        # Histogram: cumulative le-buckets on the fixed grid.  Empty
        # buckets are elided (le series stays cumulative regardless).
        cum = 0
        for i, c in enumerate(obj.counts):
            cum += c
            if c == 0:
                continue
            le = _fmt_value(bucket_upper_ms(i))
            lines.append(
                f"{name}_bucket{_fmt_labels(labels, {'le': le})} {cum}"
            )
        lines.append(
            f"{name}_bucket{_fmt_labels(labels, {'le': '+Inf'})} {obj.count}"
        )
        lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(obj.sum)}")
        lines.append(f"{name}_count{_fmt_labels(labels)} {obj.count}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, registry: MetricsRegistry) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(registry))


# -- JSONL span sink ---------------------------------------------------------
def write_jsonl_spans(path: str, source) -> None:
    with open(path, "w") as f:
        for s in _spans_of(source):
            f.write(json.dumps(s.to_dict()) + "\n")


def write_metrics_snapshot(path: str, registry: MetricsRegistry) -> None:
    with open(path, "w") as f:
        json.dump(registry.snapshot(), f, indent=1)


# -- conservation ------------------------------------------------------------
def request_conservation(source) -> Dict[str, int]:
    """Audit the request span trees: one terminal instant per root.

    Returns ``{"submitted", "resolved", "rejected", "cancelled", "open",
    "extra_terminals"}`` where ``open`` counts roots with *no* terminal
    and ``extra_terminals`` counts terminals beyond one per root.  A
    conserving trace has ``open == extra_terminals == 0`` and
    ``submitted == resolved + rejected + cancelled``.
    """
    spans = _spans_of(source)
    roots = [s for s in spans if s.name == "request"]
    terminals: Dict[int, List[str]] = {}
    for s in spans:
        if s.name in _TERMINAL_NAMES and s.parent_id is not None:
            terminals.setdefault(s.parent_id, []).append(s.name)
    counts = {"resolve": 0, "shed": 0, "cancel": 0}
    open_roots = 0
    extra = 0
    for r in roots:
        t = terminals.get(r.span_id, [])
        if not t:
            open_roots += 1
            continue
        counts[t[0]] += 1
        extra += len(t) - 1
    return {
        "submitted": len(roots),
        "resolved": counts["resolve"],
        "rejected": counts["shed"],
        "cancelled": counts["cancel"],
        "open": open_roots,
        "extra_terminals": extra,
    }


def iter_request_roots(source) -> Iterable[Span]:
    return (s for s in _spans_of(source) if s.name == "request")
