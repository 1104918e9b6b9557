"""SLA / aggregate-accuracy metrics (paper §III "key metrics")."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.observability.quantile import quantile

__all__ = ["ReplicaRow", "TenantRow", "RequestMetrics", "summarize"]

# Lane name charged for untagged requests under tenancy — mirrors
# repro_torch.serving.tenancy.DEFAULT_TENANT (core must not import serving).
_DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class ReplicaRow:
    """Per-replica aggregates for a replicated execution cluster."""

    share: float  # fraction of completions this replica served
    goodput_share: float  # fraction of all SLA-attained completions
    utilization: float  # rows served / rows on the busiest replica
    p99_inflight: float  # p99 queue depth (rows) at dispatch


@dataclasses.dataclass(frozen=True)
class TenantRow:
    """Per-tenant aggregates for a multi-tenant admission stage."""

    priority: str  # dominant priority class of the tenant's served rows
    share: float  # fraction of completions this tenant received
    shed_rate: float  # tenant rejects / tenant submits (served + rejected)
    goodput: float  # SLA-attained served / tenant submits
    p99_latency_ms: float
    n_requests: int = 0
    n_rejected: int = 0


@dataclasses.dataclass(frozen=True)
class RequestMetrics:
    """Aggregated quality/latency metrics over a batch of requests."""

    n_requests: int
    aggregate_accuracy: float  # mean accuracy of the models that answered
    sla_attainment: float  # fraction of requests answered within the SLA
    ondevice_reliance: float  # fraction answered by the duplicate (0 w/o dup)
    mean_latency_ms: float
    std_latency_ms: float
    p50_latency_ms: float
    p99_latency_ms: float
    model_usage: Dict[str, float]  # model name -> fraction of requests
    mean_queue_wait_ms: float = 0.0  # scheduling-tick wait (0 when untracked)
    p99_queue_wait_ms: float = 0.0
    # Fraction of requests per race outcome ("remote_won" / "ondevice_won" /
    # "unhedged" / "degraded"); empty when the front doesn't track races.
    race_resolution: Dict[str, float] = dataclasses.field(default_factory=dict)
    mean_time_to_schedule_ms: float = 0.0  # admission -> scheduling tick
    # Overload accounting (bounded admission): rejected requests are not in
    # n_requests — shed_rate is their fraction of everything *submitted*,
    # and goodput is the fraction of submitted requests answered within the
    # SLA (attainment over answered ∩ survived admission).  Without
    # rejections goodput == sla_attainment.
    n_rejected: int = 0
    shed_rate: float = 0.0
    goodput: float = 0.0
    # Per-replica rows (replicated execution cluster): replica id ->
    # utilization / goodput share / inflight p99.  Empty when the serving
    # front runs a single unclustered backend.
    replica_rows: Dict[int, ReplicaRow] = dataclasses.field(
        default_factory=dict
    )
    # Per-tenant rows (multi-tenant admission): lane name -> share /
    # shed_rate / goodput / p99 split.  Empty when the serving front runs
    # the single-class FIFO (no tenants configured, no tagged requests).
    tenant_rows: Dict[str, TenantRow] = dataclasses.field(
        default_factory=dict
    )
    # p99 latency split by priority class ("interactive" / "batch") —
    # per-class isolation, not averages, is what holds tail latency.
    # Populated only alongside tenant_rows.
    priority_p99: Dict[str, float] = dataclasses.field(default_factory=dict)

    def row(self) -> str:
        return (
            f"acc={self.aggregate_accuracy:6.2f}%  sla={self.sla_attainment*100:6.2f}%  "
            f"ondev={self.ondevice_reliance*100:5.2f}%  "
            f"lat={self.mean_latency_ms:7.1f}±{self.std_latency_ms:5.1f}ms  "
            f"p99={self.p99_latency_ms:7.1f}ms"
        )


def summarize(
    *,
    accuracy_used: np.ndarray,
    latency_ms: np.ndarray,
    t_sla_ms: float | np.ndarray,
    model_names: list[str],
    model_index: np.ndarray,
    used_remote: np.ndarray | None = None,
    queue_wait_ms: np.ndarray | None = None,
    race_resolution: np.ndarray | None = None,
    time_to_schedule_ms: np.ndarray | None = None,
    n_rejected: int = 0,
    replica: np.ndarray | None = None,
    replica_inflight: np.ndarray | None = None,
    tenant: np.ndarray | None = None,
    priority: np.ndarray | None = None,
    rejected_tenants: Dict[str, int] | None = None,
) -> RequestMetrics:
    """Build :class:`RequestMetrics` from per-request outcomes.

    ``queue_wait_ms`` (per-request scheduling-tick wait),
    ``race_resolution`` (per-request "remote_won" / "ondevice_won" /
    "unhedged" / "degraded" strings), and ``time_to_schedule_ms`` are
    optional — trace-driven simulation has no queue or race bookkeeping,
    so their aggregates default to empty/0.  ``t_sla_ms`` may be a
    per-request vector when requests carry individual SLAs.

    ``n_rejected`` counts requests the admission queue shed (REJECTED
    terminal state) — they have no latency/accuracy rows, but they *do*
    count against ``shed_rate`` and ``goodput``.  The per-request arrays
    may be empty when every request of a tick was shed.

    ``replica`` (per-request cluster replica id, ``-1`` for requests that
    never rode a pool replica — i.e. degrade-lane rows; a hedged row that
    lost the race still carries the replica that ran its remote leg) and
    ``replica_inflight`` (the replica's queue depth at dispatch) feed the
    per-replica ``replica_rows`` aggregates; both optional and safe on
    empty batches.

    ``tenant`` (per-request lane names, ``None`` entries charged to the
    implicit ``"default"`` lane), ``priority`` (per-request
    ``"interactive"`` / ``"batch"`` class strings), and
    ``rejected_tenants`` (lane name -> rejects this summary covers) feed
    ``tenant_rows`` and ``priority_p99``.  Both stay empty unless some
    request actually carried a tenant tag or a tenant was charged a
    reject — an untenanted front produces metrics identical to the
    pre-tenancy ones.
    """
    accuracy_used = np.asarray(accuracy_used, dtype=np.float64)
    latency_ms = np.asarray(latency_ms, dtype=np.float64)
    n = len(latency_ms)
    # The one SLA-attainment predicate: sla_attainment, goodput, and the
    # per-replica goodput_share rows must all agree on who attained.
    attained_mask = latency_ms <= np.asarray(t_sla_ms) + 1e-9
    attained = float(attained_mask.mean()) if n else 0.0
    reliance = (
        0.0
        if used_remote is None or not n
        else float(1.0 - np.mean(used_remote))
    )
    submitted = n + n_rejected

    usage: Dict[str, float] = {}
    counts = np.bincount(
        np.asarray(model_index, dtype=np.int64), minlength=len(model_names)
    )
    for name, c in zip(model_names, counts):
        if c:
            usage[name] = float(c) / n

    replica_rows: Dict[int, ReplicaRow] = {}
    if replica is not None and n:
        rep = np.asarray(replica, dtype=np.int64)
        n_attained = int(attained_mask.sum())
        ids = sorted(int(r) for r in np.unique(rep) if r >= 0)
        if ids:
            per_rows = {r: int(np.sum(rep == r)) for r in ids}
            busiest = max(per_rows.values())
            inflight = (
                None
                if replica_inflight is None
                else np.asarray(replica_inflight, dtype=np.float64)
            )
            for r in ids:
                mask = rep == r
                replica_rows[r] = ReplicaRow(
                    share=per_rows[r] / n,
                    goodput_share=(
                        float(np.sum(attained_mask & mask)) / n_attained
                        if n_attained
                        else 0.0
                    ),
                    utilization=per_rows[r] / busiest,
                    p99_inflight=(
                        quantile(inflight[mask], 99, default=0.0)
                        if inflight is not None
                        else 0.0
                    ),
                )

    tenant_rows: Dict[str, TenantRow] = {}
    priority_p99: Dict[str, float] = {}
    rejected_tenants = rejected_tenants or {}
    tenancy_active = bool(rejected_tenants) or (
        tenant is not None and any(t is not None for t in tenant)
    )
    if tenancy_active:
        names_arr = np.asarray(
            [
                _DEFAULT_TENANT if t is None else str(t)
                for t in (
                    tenant if tenant is not None else [None] * n
                )
            ],
            dtype=object,
        )
        prio_arr = (
            None
            if priority is None
            else np.asarray([str(p) for p in priority], dtype=object)
        )
        lane_names = sorted(
            set(names_arr.tolist()) | set(rejected_tenants)
        )
        for lane in lane_names:
            mask = names_arr == lane if n else np.zeros(0, dtype=bool)
            served = int(mask.sum())
            rejects = int(rejected_tenants.get(lane, 0))
            lane_submitted = served + rejects
            lane_attained = (
                int((attained_mask & mask).sum()) if served else 0
            )
            if served and prio_arr is not None:
                classes, counts_c = np.unique(
                    prio_arr[mask], return_counts=True
                )
                dominant = str(classes[int(np.argmax(counts_c))])
            else:
                dominant = "interactive"
            tenant_rows[lane] = TenantRow(
                priority=dominant,
                share=served / n if n else 0.0,
                shed_rate=(
                    rejects / lane_submitted if lane_submitted else 0.0
                ),
                goodput=(
                    lane_attained / lane_submitted if lane_submitted else 0.0
                ),
                p99_latency_ms=quantile(
                    latency_ms[mask] if served else (), 99, default=0.0
                ),
                n_requests=served,
                n_rejected=rejects,
            )
        if prio_arr is not None and n:
            for cls in np.unique(prio_arr):
                cmask = prio_arr == cls
                priority_p99[str(cls)] = quantile(
                    latency_ms[cmask], 99, default=0.0
                )

    return RequestMetrics(
        n_requests=n,
        aggregate_accuracy=float(accuracy_used.mean()) if n else 0.0,
        sla_attainment=attained,
        ondevice_reliance=reliance,
        mean_latency_ms=float(latency_ms.mean()) if n else 0.0,
        std_latency_ms=float(latency_ms.std()) if n else 0.0,
        p50_latency_ms=quantile(latency_ms, 50, default=0.0),
        p99_latency_ms=quantile(latency_ms, 99, default=0.0),
        model_usage=usage,
        mean_queue_wait_ms=(
            0.0
            if queue_wait_ms is None or not n
            else float(np.mean(queue_wait_ms))
        ),
        p99_queue_wait_ms=(
            0.0
            if queue_wait_ms is None or not n
            else quantile(queue_wait_ms, 99, default=0.0)
        ),
        race_resolution=(
            {}
            if race_resolution is None
            else {
                outcome: (
                    float(np.mean(np.asarray(race_resolution) == outcome))
                    if n
                    else 0.0
                )
                for outcome in (
                    "remote_won", "ondevice_won", "unhedged", "degraded"
                )
            }
        ),
        mean_time_to_schedule_ms=(
            0.0
            if time_to_schedule_ms is None or not n
            else float(np.mean(time_to_schedule_ms))
        ),
        n_rejected=int(n_rejected),
        shed_rate=(float(n_rejected) / submitted if submitted else 0.0),
        goodput=(attained * n / submitted if submitted else 0.0),
        replica_rows=replica_rows,
        tenant_rows=tenant_rows,
        priority_p99=priority_p99,
    )
