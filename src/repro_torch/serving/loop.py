"""Event-loop serving front: admission → decide → dispatch → resolve ticks.

:class:`ServingLoop` is the middle layer of the three-layer serving stack
(client / loop / backend).  Requests are *submitted* (admission — they
become :class:`repro_torch.serving.lifecycle.InferenceFuture` objects in QUEUED
state) and served by *ticks*: one tick schedules the pending chunk with a
single ``decide_batch`` call, dispatches every variant group — and the
hedged rows' on-device duplicate — through the async
:meth:`repro_torch.serving.backend.ExecutionBackend.submit_batch` protocol, then
collects, observes, and resolves.

Admission is a first-class, capacity-bounded stage
(:class:`repro_torch.serving.admission.AdmissionQueue`): ``max_pending`` bounds
the persistent multi-tick queue, ``max_chunk`` caps how much one tick may
take (a burst no longer inflates a single batch without limit), and
``max_inflight_ticks`` gates ``wait=False`` dispatch.  At capacity the
overload policy decides: ``block`` (client-side backpressure — futures
wait un-admitted), ``shed`` (deadline-aware REJECTED resolution), or
``degrade`` (overflow served by the on-device tier alone, no remote leg).
The default is the unbounded compatibility behavior: every tick drains
everything, byte-identical to the pre-admission loop.

Because *all* batches of a tick are submitted before any is waited on, the
remote batch and the on-device duplicate genuinely run concurrently
(``dispatch="async"``, worker threads): ``resolve_chunk`` races
first-completion wall times measured over the same interval, instead of
two serialized measurements.  Both tiers' race clocks start at the
dispatch tick — the queue wait is charged to each exactly once
(previously the duplicate's wall clock silently started after the remote
batch finished; see ``TickStats`` for the overlap evidence).

``dispatch="sync"`` is the serialized fallback: ``submit_batch`` executes
inline, keeping CI runs and the equivalence references deterministic.
:meth:`ServingEngine.serve_queue <repro_torch.serving.engine.ServingEngine.serve_queue>`
is a thin shim over one sync-collected tick of this loop.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.sla import RequestMetrics, summarize
from repro_torch.serving.admission import AdmissionConfig, AdmissionQueue
from repro_torch.serving.backend import BatchHandle, ExecutionBackend, OnDeviceBackend
from repro_torch.serving.cluster import NoHealthyReplica
from repro_torch.serving.transport import (
    FailedBatchHandle,
    ReplicaDied,
    TransportError,
)
from repro_torch.serving.lifecycle import (
    CompletedRequest,
    InferenceFuture,
    QueuedRequest,
    RequestState,
)
from repro_torch.serving.loadgen import LoadTrace, iter_windows
from repro_torch.serving.scheduler import pad_to_pow2
from repro_torch.serving.tenancy import DEFAULT_TENANT

__all__ = ["ServingLoop", "TickResult", "TickStats"]

_DEGRADE_EXEC_FLOOR_MS = 0.1  # matches the scheduler's sampled-exec floor


def _pad_batch(requests, rows_idx, pad_rows: bool = True) -> Tuple[np.ndarray, int]:
    """Right-pad a group's prompts into one (pow2-rows, width) batch.

    ``pad_rows=False`` skips the power-of-two row padding — the
    continuous-batching backend decomposes row counts onto its own ladder
    internally, so loop-side padding would just burn decode slots."""
    width = max(len(requests[i].tokens) for i in rows_idx)
    n_rows = pad_to_pow2(len(rows_idx)) if pad_rows else len(rows_idx)
    batch = np.zeros((n_rows, width), dtype=np.int32)
    for row, i in enumerate(rows_idx):
        t = np.asarray(requests[i].tokens, dtype=np.int32)
        batch[row, : len(t)] = t
    steps = max(requests[i].n_steps for i in rows_idx)
    return batch, steps


def _replica_array(completions) -> np.ndarray:
    """Per-completion cluster replica ids for summarize (-1: unrouted —
    single-backend rows and degrade-lane rows; a hedged row that lost the
    race still carries the replica that ran its remote leg)."""
    return np.asarray(
        [-1 if c.replica is None else c.replica for c in completions],
        dtype=np.int64,
    )


def _replica_inflight_array(completions) -> np.ndarray:
    return np.asarray(
        [
            0 if c.replica_inflight is None else c.replica_inflight
            for c in completions
        ],
        dtype=np.int64,
    )


def _tenant_array(completions) -> np.ndarray:
    """Per-completion tenant lane names for summarize (None: untagged)."""
    return np.asarray([c.tenant for c in completions], dtype=object)


def _priority_array(completions) -> np.ndarray:
    return np.asarray([c.priority for c in completions], dtype=object)


def _make_stream_cb(batch: List[InferenceFuture], part: np.ndarray):
    """Per-group token callback: backend row index -> that row's future.

    The group's batch rows are exactly ``part``'s futures (streaming
    backends pad internally, so no phantom rows exist); a guard keeps a
    misbehaving backend from indexing past the group.
    """
    futures = [batch[int(i)] for i in part]

    def on_token(row: int, token: int, wall_ms: float) -> None:
        if 0 <= row < len(futures):
            futures[row]._push_chunk(token, wall_ms)

    return on_token


def _rejected_tenant_counts(shed_info, default_lane: bool) -> Dict[str, int]:
    """Fold per-shed (tenant, priority) pairs into lane -> reject counts.

    Untagged sheds are charged to the implicit ``"default"`` lane only
    when tenancy is configured (``default_lane``) — an untenanted,
    untagged front keeps producing metrics with no tenant rows at all.
    """
    counts: Dict[str, int] = {}
    for tenant, _ in shed_info:
        if tenant is None:
            if not default_lane:
                continue
            tenant = DEFAULT_TENANT
        counts[tenant] = counts.get(tenant, 0) + 1
    return counts


@dataclasses.dataclass
class TickStats:
    """Wall-clock evidence of one tick's dispatch behavior.

    ``span_wall_ms`` (first dispatch → last completion) versus
    ``serialized_wall_ms`` (sum of the tiers' individual wall times) is the
    overlap witness: async dispatch gives ``span < serialized`` on any
    hedged tick, a serialized tick gives ``span ≈ serialized``.
    """

    n_requests: int
    n_hedged: int
    remote_wall_ms: float  # sum of the remote variant batches' wall times
    hedge_wall_ms: Optional[float]  # duplicate batch wall time (measured)
    span_wall_ms: float  # first dispatch -> last batch completion
    dispatch_spread_wall_ms: float  # max - min dispatch stamp across tiers
    hedge_dispatched_before_remote_done: Optional[bool]
    n_shed: int = 0  # rejected by admission at this tick (shed policy)
    n_degraded: int = 0  # served on-device-only at this tick (degrade policy)
    # Fault accounting: rows whose remote batch was lost to a replica
    # failure this tick, and how many of those went back to admission
    # (the rest resolved through their measured hedge duplicate).
    n_lost: int = 0
    n_requeued: int = 0
    # Rows dispatched per cluster replica this tick (empty: unclustered
    # backend — every remote row then counts as one replica's work).
    replica_rows: Dict[int, int] = dataclasses.field(default_factory=dict)
    # Continuous-batching accounting (zero on classic whole-batch tiers):
    # requests grafted into the persistent decode batch since the last
    # collection, slots recycled back to the pool since the last
    # collection, and the backend's *absolute* compiled-executable count —
    # constant after warmup is the zero-recompile invariant CI gates on.
    n_joined: int = 0
    n_recycled: int = 0
    compile_count: int = 0

    @property
    def serialized_wall_ms(self) -> float:
        return self.remote_wall_ms + (self.hedge_wall_ms or 0.0)

    @property
    def hedge_rows(self) -> int:
        """Live rows in the measured duplicate batch (0: no hedge tier)."""
        return self.n_hedged if self.hedge_wall_ms is not None else 0

    @property
    def max_replica_rows(self) -> int:
        """Rows on the tick's busiest replica — the parallel-server
        makespan unit a service model should charge (falls back to the
        whole tick's rows on an unclustered backend)."""
        return (
            max(self.replica_rows.values())
            if self.replica_rows
            else self.n_requests
        )


@dataclasses.dataclass
class TickResult:
    """Outcome of one scheduling tick."""

    completions: List[CompletedRequest]  # resolved, submission order
    metrics: Optional[RequestMetrics]  # None for an empty / all-cancelled tick
    stats: TickStats


@dataclasses.dataclass
class _InflightTick:
    """A dispatched-but-uncollected tick (async mode can carry these)."""

    futures: List[InferenceFuture]
    requests: List[QueuedRequest]
    decision: object  # BatchDecision, or None for a degrade-only tick
    queue_wait: np.ndarray
    t_sla: object  # scalar or (n,) vector raced at resolution
    now_ms: float
    groups: List[Tuple[int, np.ndarray, BatchHandle]]  # (model, rows, handle)
    row_handles: List[BatchHandle]  # request index -> its remote handle
    hedged_rows: np.ndarray
    hedge_handle: Optional[BatchHandle]
    # Overload-degraded rows: served by the on-device tier alone.
    degraded_futures: List[InferenceFuture] = dataclasses.field(
        default_factory=list
    )
    degrade_queue_wait: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )
    degrade_handle: Optional[BatchHandle] = None
    n_shed: int = 0
    # (tenant lane, priority class) of each request shed at this tick —
    # per-tenant rejection accounting for summarize.
    shed_info: List[Tuple[Optional[str], str]] = dataclasses.field(
        default_factory=list
    )
    # Observability (all None/empty with tracing off): the tick span, the
    # per-group batch spans (index-aligned with ``groups``), and the
    # hedge / degrade batch spans — opened at dispatch, closed at collect.
    tick_span: object = None
    group_spans: List[object] = dataclasses.field(default_factory=list)
    hedge_span: object = None
    degrade_span: object = None

    def poll(self) -> bool:
        handles = [h for _, _, h in self.groups]
        for h in (self.hedge_handle, self.degrade_handle):
            if h is not None:
                handles.append(h)
        return all(h.poll() for h in handles)


class ServingLoop:
    """Admission → ``decide_batch`` → concurrent dispatch → resolution.

    Parameters
    ----------
    scheduler:
        The policy half (:class:`repro_torch.serving.scheduler.MDInferenceScheduler`).
    backend:
        The remote tier.
    hedge_backend:
        Optional on-device tier; without it hedges resolve on profile
        samples (the simulation reference).
    dispatch:
        ``"async"`` (worker threads, tiers overlap — the default) or
        ``"sync"`` (inline execution, deterministic serialized fallback).
    admission:
        An :class:`repro_torch.serving.admission.AdmissionConfig` (or a prebuilt
        :class:`~repro_torch.serving.admission.AdmissionQueue`).  ``None`` is the
        unbounded compatibility default — every submit admitted, every
        tick drains everything.
    controller:
        An optional :class:`repro_torch.serving.controller.AdmissionController`
        closing the loop over the admission queue: each collected tick is
        observed, and due retunes (bounded AIMD over ``max_pending`` /
        ``shed_headroom_ms``) are applied at the top of the next tick
        before admission take.  ``None`` — the default — keeps the static
        config byte-identical to the pre-controller loop
        (regression-pinned).
    observability:
        An optional :class:`repro_torch.observability.Observability` handle.
        The loop is the fan-out point: it attaches the handle to the
        admission queue, controller, scheduler, both backend tiers (a
        cluster propagates to every replica's breaker and transport), and
        instruments its own tick/dispatch/collect path — request span
        trees, tick and batch spans, and the loop's counters/histograms.
        ``None`` — the default — keeps every layer on its exact
        pre-observability path (regression-pinned byte identity).
    """

    def __init__(
        self,
        scheduler,
        backend: ExecutionBackend,
        hedge_backend: Optional[OnDeviceBackend] = None,
        *,
        dispatch: str = "async",
        admission: Optional[AdmissionConfig | AdmissionQueue] = None,
        controller=None,
        observability=None,
    ):
        if dispatch not in ("async", "sync", "stepped"):
            raise ValueError(
                "dispatch must be 'async', 'sync' or 'stepped', "
                f"got {dispatch!r}"
            )
        self.scheduler = scheduler
        self.backend = backend
        self.hedge_backend = hedge_backend
        self.dispatch = dispatch
        self.now_ms = 0.0
        # Continuous-batching counters seen at the last collection (for the
        # per-tick n_joined / n_recycled deltas in TickStats).
        self._joined_seen = getattr(backend, "joined_total", 0)
        self._recycled_seen = getattr(backend, "recycled_total", 0)
        if admission is None:
            admission = AdmissionConfig()
        self.admission = (
            admission
            if isinstance(admission, AdmissionQueue)
            else AdmissionQueue(admission)
        )
        self.controller = controller
        self._inflight: List[_InflightTick] = []
        self._rid = itertools.count()
        self.observability = None
        if observability is not None:
            self.attach_observability(observability)

    def attach_observability(self, obs) -> None:
        """Thread one observability handle through the whole stack.

        The loop owns the fan-out so callers attach exactly once: the
        admission queue (and through it the tenant lanes), the controller,
        the scheduler's EWMA gauges, and both backend tiers — a clustered
        remote tier forwards to each replica's breaker and transport, a
        continuous tier to its slot-cache ledger.
        """
        self.observability = obs
        self.admission.attach_observability(obs)
        self.scheduler.observability = obs
        if self.controller is not None:
            self.controller.observability = obs
        for tier, track in (
            (self.backend, "remote"),
            (self.hedge_backend, "ondevice"),
        ):
            attach = getattr(tier, "attach_observability", None)
            if attach is not None:
                attach(obs, track=track)

    # -- admission ------------------------------------------------------------
    def next_rid(self) -> int:
        return next(self._rid)

    def submit(self, request: QueuedRequest) -> InferenceFuture:
        """Submit a request to the admission queue.

        Under the unbounded default the future is admitted immediately and
        waits QUEUED for the next tick.  A bounded queue at capacity
        applies its overload policy instead: the future may come back
        not-yet-admitted (``block`` — check
        :attr:`~repro_torch.serving.lifecycle.InferenceFuture.admitted`), already
        REJECTED (``shed``), or routed to the on-device-only degrade lane.
        """
        future = InferenceFuture(request, loop=self)
        obs = self.observability
        if obs is not None:
            tracer = obs.tracer
            track = (
                f"tenant:{request.tenant}"
                if request.tenant is not None
                else "requests"
            )
            future._tracer = tracer
            future.span = tracer.start(
                "request",
                cat="request",
                track=track,
                rid=request.rid,
                tenant=request.tenant,
                arrival_ms=request.arrival_ms,
            )
            future._queued_span = tracer.start(
                "queued", parent=future.span, cat="request", track=track
            )
            obs.counter("loop_submitted_total").inc()
        self.admission.offer(future)
        return future

    @property
    def pending(self) -> int:
        """Admitted requests waiting for a tick (≤ ``max_pending``)."""
        return self.admission.pending

    @property
    def blocked(self) -> int:
        """Backpressured requests waiting un-admitted (block policy)."""
        return self.admission.blocked

    @property
    def backlog(self) -> int:
        """Everything waiting for a tick across all admission lanes."""
        return self.admission.backlog

    @property
    def inflight(self) -> int:
        return sum(
            len(t.futures) + len(t.degraded_futures) for t in self._inflight
        )

    def _usage_names(self) -> List[str]:
        """Model-usage key space: the remote zoo plus the on-device tier
        (degraded completions are attributed to the duplicate)."""
        return list(self.scheduler.names) + [self.scheduler.ondevice.name]

    # -- cluster integration (inert on a single unclustered backend) ----------
    def _eligible_mask(self) -> Optional[np.ndarray]:
        """Selection-eligibility mask from the backend's zoo placement.

        A cluster backend with partial zoo slices exposes ``hosted_mask``:
        variants no live replica hosts are masked out of selection, so
        routing never has to place a row on a replica that doesn't host
        its variant.  Plain backends return ``None`` — the unmasked path,
        preserving the pre-cluster behavior bit-for-bit.
        """
        hosted = getattr(self.backend, "hosted_mask", None)
        if hosted is None:
            return None
        return hosted(self.scheduler.names)

    def _fan_out(self, name: str, rows: np.ndarray) -> List[np.ndarray]:
        """Split one variant group across the backend's replica fan-out.

        A cluster backend reports ``fan_out(name)`` (its hosting replica
        count); the group is split into that many near-equal row slices,
        each routed independently — the per-replica fan-out within one
        tick.  Plain backends (and one-replica pools) keep the single
        undivided batch, byte-identical to the pre-cluster dispatch.
        """
        fan = getattr(self.backend, "fan_out", None)
        k = 1 if fan is None else max(1, min(int(fan(name)), len(rows)))
        if k == 1:
            return [rows]
        return [part for part in np.array_split(rows, k) if part.size]

    # -- the event loop -------------------------------------------------------
    def tick(
        self, now_ms: Optional[float] = None, *, wait: bool = True
    ) -> Optional[TickResult]:
        """Run one scheduling tick over the pending chunk.

        ``now_ms`` is the tick's loop-clock timestamp (e.g. the close of an
        arrival window); it defaults to the chunk's latest arrival.  With
        ``wait=True`` the tick's batches are collected and resolved before
        returning (the continuous-batching semantics of the old
        ``serve_queue``).  ``wait=False`` returns ``None`` right after
        dispatch — futures stay EXECUTING and are resolved by a later
        :meth:`poll` / :meth:`drain` (the genuinely-async event loop).

        A bounded admission queue shapes what one tick may take: at most
        ``max_chunk`` requests (the rest stay queued across ticks), no new
        dispatch while ``max_inflight_ticks`` are in flight, and the shed /
        degrade overload policies resolve or reroute the overflow.  A tick
        that *only* sheds (every schedulable request rejected) returns its
        :class:`TickResult` immediately even with ``wait=False`` — there
        is nothing in flight to poll for, but the shed accounting
        (``stats.n_shed``, ``metrics.n_rejected``) must reach observers.
        """
        cfg = self.admission.cfg
        if (
            cfg.max_inflight_ticks is not None
            and len(self._inflight) >= cfg.max_inflight_ticks
        ):
            return None  # dispatch gate: requests stay queued for later
        # Closed-loop adaptivity: enact any retune the controller owes
        # from the last collected tick *before* this tick's admission
        # take, so the new capacity/margin govern this tick's offers and
        # sheds.  Inert (byte-identical path) without a controller.
        if self.controller is not None:
            self.controller.apply(self.admission)
        # The admission queue hands one tick's work over atomically: a
        # submit() racing this tick from another thread lands in either
        # this chunk or a later one, never vanishes.
        take = self.admission.take(
            now_ms,
            default_sla_ms=self.scheduler.cfg.t_sla_ms,
            # Cheapest remote execution; the shed predicate also considers
            # the network-free on-device duplicate — on a bad network the
            # hedge is exactly what still attains the SLA.
            service_floor_ms=float(np.min(self.scheduler.mu)),
            ondevice_floor_ms=float(self.scheduler.ondevice_mu),
        )
        if not take and not take.shed:
            return None
        now_ms = take.now_ms
        self.now_ms = max(self.now_ms, now_ms)
        obs = self.observability
        tick_span = None
        if obs is not None:
            tick_span = obs.tracer.start(
                "tick",
                cat="loop",
                track="loop",
                now_ms=now_ms,
                n_taken=len(take.chunk),
                n_degraded=len(take.degraded),
                n_shed=len(take.shed),
            )
        # Feed the loop clock to a clustered backend: breaker cooldowns,
        # drain state, and the hosted mask are all evaluated at tick time,
        # so membership transitions are visible the same tick they happen.
        advance = getattr(self.backend, "advance_clock", None)
        if advance is not None:
            advance(self.now_ms)
        # Atomic QUEUED -> SCHEDULED claim: a cancel() racing this tick from
        # another thread loses its slot here, never in a dispatched batch.
        batch = [f for f in take.chunk if f._try_schedule(now_ms)]
        degraded = [f for f in take.degraded if f._try_schedule(now_ms)]
        # Whole-pool outage: when no variant has a routable replica (every
        # hosting replica dead/draining), decide_batch has nothing to
        # select — divert the entire chunk to the on-device degrade lane
        # instead of crashing the tick.  Partial outages flow through
        # decide_batch's eligibility masking as usual.
        eligible = self._eligible_mask()
        if batch and eligible is not None and not eligible.any():
            degraded.extend(batch)
            batch = []
        if not batch and not degraded:
            if take.shed:  # all-shed tick: surface the rejection accounting
                return self._collect(
                    _InflightTick(
                        futures=[], requests=[], decision=None,
                        queue_wait=np.zeros(0), t_sla=self.scheduler.cfg.t_sla_ms,
                        now_ms=now_ms, groups=[], row_handles=[],
                        hedged_rows=np.zeros(0, dtype=np.int64),
                        hedge_handle=None, n_shed=len(take.shed),
                        shed_info=[
                            (f.request.tenant, f.priority) for f in take.shed
                        ],
                        tick_span=tick_span,
                    )
                )
            if tick_span is not None:
                obs.tracer.end(tick_span)
            return None
        # Dispatch modes: "sync" runs everything inline; "async" overlaps
        # tiers on worker threads; "stepped" is the continuous-batching
        # mode — remote rows join the persistent decode batch (prefill +
        # graft at submit, decode advanced by poll()'s pump), thread-free
        # and deterministic, while the hedge tier stays inline.
        sync = self.dispatch == "sync"
        hedge_sync = self.dispatch in ("sync", "stepped")

        decision = None
        t_sla: object = self.scheduler.cfg.t_sla_ms
        queue_wait = np.zeros(len(batch))
        groups: List[Tuple[int, np.ndarray, BatchHandle]] = []
        group_spans: List[object] = []
        hedge_span = None
        row_handles: List[Optional[BatchHandle]] = [None] * len(batch)
        hedged_rows = np.zeros(0, dtype=np.int64)
        hedge_handle: Optional[BatchHandle] = None
        requests = [f.request for f in batch]
        if batch:
            arrivals = np.asarray([r.arrival_ms for r in requests])
            queue_wait = np.maximum(now_ms - arrivals, 0.0)

            # Per-request SLA: selection budgets come from t_sla - est - wait,
            # expressed as an effective estimate offset against the loop SLA.
            loop_sla = self.scheduler.cfg.t_sla_ms
            slas = np.asarray(
                [
                    loop_sla if r.sla_ms is None else float(r.sla_ms)
                    for r in requests
                ]
            )
            t_sla = slas if np.any(slas != loop_sla) else loop_sla
            est = np.asarray([r.t_nw_est_ms for r in requests])
            decision = self.scheduler.decide_batch(
                est + queue_wait + (loop_sla - slas),
                eligible=eligible,
            )

            # Dispatch every batch of the tick before waiting on any of
            # them: the remote variant groups and the hedged rows'
            # duplicate all start at this tick — the shared origin of both
            # race clocks.  A cluster backend fans each variant group out
            # across its hosting replicas (one routed sub-batch per
            # replica the group can spread over), so several replicas run
            # concurrently within one tick.
            pad_rows = not getattr(self.backend, "pads_internally", False)
            streaming = getattr(self.backend, "supports_streaming", False)
            for m in np.unique(decision.model_index):
                rows = np.flatnonzero(decision.model_index == m)
                name = self.scheduler.names[int(m)]
                for part in self._fan_out(name, rows):
                    gbatch, steps = _pad_batch(requests, part, pad_rows=pad_rows)
                    # Streaming tier: route each backend row's emitted
                    # tokens onto its future's chunk channel.  Only passed
                    # to backends advertising supports_streaming, so the
                    # cluster/transport submit_batch signatures are
                    # untouched.
                    kwargs = (
                        {"on_token": _make_stream_cb(batch, part)}
                        if streaming
                        else {}
                    )
                    gspan = None
                    if obs is not None:
                        gspan = obs.tracer.start(
                            f"batch:{name}",
                            parent=tick_span,
                            cat="dispatch",
                            variant=name,
                            rows=int(part.size),
                        )
                    try:
                        # The group span is the ambient parent during
                        # submit so transport/backend spans nest under it
                        # even across the async path's worker thread.
                        if gspan is not None:
                            with obs.tracer.bind(gspan):
                                handle = self.backend.submit_batch(
                                    name, gbatch, steps, sync=sync, **kwargs
                                )
                        else:
                            handle = self.backend.submit_batch(
                                name, gbatch, steps, sync=sync, **kwargs
                            )
                    except NoHealthyReplica as e:
                        # The eligible mask was computed at the top of the
                        # tick; a same-tick health transition (e.g. the
                        # sole hosting replica's half-open probe already
                        # claimed) can still empty the routable set here.
                        # The rows are handled like any lost batch at
                        # collection (hedge failover or requeue).
                        handle = FailedBatchHandle(
                            name, int(gbatch.shape[0]), e
                        )
                        if gspan is not None:
                            gspan.args["error"] = "no_healthy_replica"
                    if gspan is not None:
                        replica = getattr(handle, "replica", None)
                        if replica is not None:
                            gspan.track = f"replica:{replica}"
                            gspan.args["replica"] = replica
                    groups.append((int(m), part, handle))
                    group_spans.append(gspan)
                    for i in part:
                        row_handles[i] = handle

            hedged_rows = np.flatnonzero(decision.hedged)
            if self.hedge_backend is not None and hedged_rows.size > 0:
                hbatch, hsteps = _pad_batch(requests, hedged_rows)
                if obs is not None:
                    hedge_span = obs.tracer.start(
                        "batch:hedge",
                        parent=tick_span,
                        cat="dispatch",
                        track="ondevice",
                        rows=int(hedged_rows.size),
                    )
                    with obs.tracer.bind(hedge_span):
                        hedge_handle = self.hedge_backend.submit_hedge(
                            hbatch, hsteps, sync=hedge_sync
                        )
                else:
                    hedge_handle = self.hedge_backend.submit_hedge(
                        hbatch, hsteps, sync=hedge_sync
                    )

        # Overload-degraded rows: the on-device tier alone answers — no
        # remote leg, no hedge race.  Without a hedge backend the duplicate
        # is simulated from the live on-device profile at collection.
        degrade_handle: Optional[BatchHandle] = None
        degrade_span = None
        degrade_queue_wait = np.zeros(len(degraded))
        if degraded:
            dreqs = [f.request for f in degraded]
            degrade_queue_wait = np.maximum(
                now_ms - np.asarray([r.arrival_ms for r in dreqs]), 0.0
            )
            if self.hedge_backend is not None:
                dbatch, dsteps = _pad_batch(dreqs, range(len(dreqs)))
                if obs is not None:
                    degrade_span = obs.tracer.start(
                        "batch:degrade",
                        parent=tick_span,
                        cat="dispatch",
                        track="ondevice",
                        rows=len(degraded),
                    )
                    with obs.tracer.bind(degrade_span):
                        degrade_handle = self.hedge_backend.submit_hedge(
                            dbatch, dsteps, sync=hedge_sync
                        )
                else:
                    degrade_handle = self.hedge_backend.submit_hedge(
                        dbatch, dsteps, sync=hedge_sync
                    )

        for i, f in enumerate(batch):
            tiers = {"remote": row_handles[i].dispatch_wall_ms}
            if hedge_handle is not None and decision.hedged[i]:
                tiers["ondevice"] = hedge_handle.dispatch_wall_ms
            f._mark_executing(tiers)
        for f in degraded:
            f._mark_executing(
                {}
                if degrade_handle is None
                else {"ondevice": degrade_handle.dispatch_wall_ms}
            )

        tick = _InflightTick(
            futures=batch,
            requests=requests,
            decision=decision,
            queue_wait=queue_wait,
            t_sla=t_sla,
            now_ms=now_ms,
            groups=groups,
            row_handles=row_handles,
            hedged_rows=hedged_rows,
            hedge_handle=hedge_handle,
            degraded_futures=degraded,
            degrade_queue_wait=degrade_queue_wait,
            degrade_handle=degrade_handle,
            n_shed=len(take.shed),
            shed_info=[(f.request.tenant, f.priority) for f in take.shed],
            tick_span=tick_span,
            group_spans=group_spans,
            hedge_span=hedge_span,
            degrade_span=degrade_span,
        )
        if not wait:
            self._inflight.append(tick)
            return None
        return self._collect(tick)

    def poll(self) -> List[TickResult]:
        """Resolve every in-flight tick whose batches all finished.

        Never blocks.  On a continuous-batching backend this is also the
        decode clock: each poll advances the persistent decode batch one
        step boundary (``pump``), then releases the slots of hedged rows
        whose race the duplicate has already won — their pages go back to
        the pool *now*, not at batch end.
        """
        pump = getattr(self.backend, "pump", None)
        if pump is not None:
            pump()
        for t in self._inflight:
            self._release_hedge_wins(t)
        # Evaluate poll() once per tick: a batch finishing between two
        # evaluations must land in exactly one of the two lists.
        ready = {id(t): t.poll() for t in self._inflight}
        done = [t for t in self._inflight if ready[id(t)]]
        self._inflight = [t for t in self._inflight if not ready[id(t)]]
        return [self._collect(t) for t in done]

    def _release_hedge_wins(self, tick: _InflightTick) -> None:
        """Recycle slots of hedged rows whose race is already decided.

        Once the on-device duplicate has finished, a hedged row still
        decoding remotely whose elapsed wall time has exhausted its SLA
        budget (``t_sla - queue_wait - t_nw``) can never resolve remote-won
        — the duplication rule (:func:`repro_torch.core.duplication.resolve_duplication`)
        will pick the duplicate regardless of when the remote leg lands.
        Releasing the slot *now* frees its pages for the next join instead
        of carrying a dead row to ``n_steps``.  Inert on handles without
        per-row release (the classic whole-batch tiers)."""
        if tick.hedge_handle is None or not tick.hedge_handle.poll():
            return
        if tick.decision is None:
            return
        now_wall = time.perf_counter() * 1e3
        for _, rows, handle in tick.groups:
            release = getattr(handle, "release_rows", None)
            if release is None:
                continue
            elapsed = now_wall - handle.dispatch_wall_ms
            stale = []
            for row, i in enumerate(rows):
                if not tick.decision.hedged[i] or handle.done_rows[row]:
                    continue
                sla_i = (
                    float(tick.t_sla)
                    if np.isscalar(tick.t_sla)
                    else float(np.asarray(tick.t_sla)[i])
                )
                budget = (
                    sla_i
                    - tick.queue_wait[i]
                    - tick.requests[i].t_nw_actual_ms
                )
                if elapsed > budget:
                    stale.append(row)
            if stale:
                release(stale, "hedge_win")

    def drain(self) -> List[TickResult]:
        """Block until every in-flight tick resolves; returns their results."""
        inflight, self._inflight = self._inflight, []
        return [self._collect(t) for t in inflight]

    def flush(self) -> List[TickResult]:
        """Drive the loop until nothing is backlogged or in flight.

        The backlog spans every admission lane — the bounded pending
        queue, the block policy's overflow room, and the degrade lane — so
        a backpressured future still resolves through ``result()``.
        """
        results = self.drain()
        while self.backlog:
            before = self.backlog
            r = self.tick()
            if r is not None:
                results.append(r)
            results.extend(self.drain())
            if r is None and self.backlog >= before:
                break  # nothing schedulable (e.g. all raced to cancel)
        return results

    # -- replica health feedback ----------------------------------------------
    def _note_replica(
        self, replica: Optional[int], ok: bool, error: Optional[Exception] = None
    ) -> None:
        """Report a routed batch's outcome to a clustered backend's health
        layer (inert on plain backends and unrouted handles)."""
        if replica is None:
            return
        if ok:
            note = getattr(self.backend, "note_success", None)
            if note is not None:
                note(replica)
        else:
            note = getattr(self.backend, "note_failure", None)
            if note is not None:
                note(replica, str(error), fatal=isinstance(error, ReplicaDied))

    # -- observability emission (all call sites obs-guarded) ------------------
    def _note_request_tiers(self, f: InferenceFuture, c: CompletedRequest):
        """Per-request tier legs + TTFT instant on the request's span tree.

        The legs replay the future's recorded per-tier wall stamps — both
        race clocks start at the dispatch tick, so the spans make the
        overlap (or a serialized fallback's lack of it) visible per row.
        """
        tracer = self.observability.tracer
        disp, done = f.tier_dispatch_wall_ms, f.tier_done_wall_ms
        if "remote" in disp:
            track = (
                f"replica:{c.replica}" if c.replica is not None else "remote"
            )
            span = tracer.start(
                "remote", parent=f.span, cat="tier", track=track,
                t0_ms=disp["remote"], variant=c.model_name,
            )
            tracer.end(span, t1_ms=done.get("remote", disp["remote"]))
        if "ondevice" in disp:
            span = tracer.start(
                "ondevice", parent=f.span, cat="tier", track="ondevice",
                t0_ms=disp["ondevice"],
            )
            tracer.end(span, t1_ms=done.get("ondevice", disp["ondevice"]))
        if c.ttft_ms is not None:
            base = disp.get("remote")
            tracer.instant(
                "ttft", parent=f.span, cat="request",
                t_ms=None if base is None else base + c.ttft_ms,
                ttft_ms=c.ttft_ms,
            )

    def _note_tick(self, stats: TickStats, n_completions: int) -> None:
        """Fold one collected tick into the loop's metric families."""
        obs = self.observability
        obs.counter("loop_ticks_total").inc()
        obs.histogram("loop_tick_wall_ms").record(stats.span_wall_ms)
        for name, value in (
            ("loop_completions_total", n_completions),
            ("loop_shed_total", stats.n_shed),
            ("loop_degraded_total", stats.n_degraded),
            ("loop_hedged_total", stats.n_hedged),
            ("loop_lost_rows_total", stats.n_lost),
            ("loop_requeued_total", stats.n_requeued),
        ):
            if value:
                obs.counter(name).inc(value)
        obs.gauge("loop_inflight_ticks").set(len(self._inflight))

    # -- collection / resolution ---------------------------------------------
    def _collect(self, tick: _InflightTick) -> TickResult:
        obs = self.observability
        requests, decision = tick.requests, tick.decision
        n = len(requests)
        exec_ms = np.empty(n)
        lost = np.zeros(n, dtype=bool)  # rows whose remote batch was lost
        # Continuous-batching bookkeeping: rows released early from the
        # persistent decode batch (hedge win / cancel — their slot was
        # recycled before n_steps), and per-row time-to-first-token.
        released = np.zeros(n, dtype=bool)
        ttft = np.full(n, np.nan)
        gen_tokens: List[Optional[np.ndarray]] = [None] * n
        remote_wall_sum = 0.0
        for gi, (m, rows, handle) in enumerate(tick.groups):
            gspan = tick.group_spans[gi] if tick.group_spans else None
            try:
                out, wall_ms = handle.wait()
            except (TransportError, NoHealthyReplica) as e:
                # The batch never produced tokens: a dead/failed replica
                # (or a routing hole that opened mid-tick).  exec=inf makes
                # the vectorized race resolution treat the remote leg as
                # never arriving — hedged rows fail over to their measured
                # duplicate; unhedged rows are requeued below.  Replica
                # accounting was already reconciled by the transport
                # (inflight rows drained on failure), so only the breaker
                # needs the report.
                lost[rows] = True
                exec_ms[rows] = np.inf
                self._note_replica(handle.replica, ok=False, error=e)
                if gspan is not None:
                    gspan.args["error"] = repr(e)
                    obs.tracer.end(gspan)
                    obs.counter("loop_batches_lost_total").inc()
                continue
            remote_wall_sum += wall_ms
            exec_ms[rows] = wall_ms
            rel = getattr(handle, "released_rows", None)
            row_ttft = getattr(handle, "ttft_wall_ms", None)
            for row, i in enumerate(rows):
                gen_tokens[i] = out[row, : requests[i].n_steps]
                if row_ttft is not None and row_ttft[row] is not None:
                    ttft[i] = row_ttft[row]
                if rel and row in rel:
                    # The slot was recycled before n_steps: the remote leg
                    # never produced a full answer.  exec=inf routes the
                    # race to the duplicate without marking the row lost.
                    released[i] = True
                    exec_ms[i] = np.inf
            self._note_replica(handle.replica, ok=True)
            if gspan is not None:
                obs.tracer.end(gspan, t1_ms=handle.done_wall_ms)
            if obs is not None:
                replica = handle.replica if handle.replica is not None else -1
                obs.histogram(
                    "cluster_batch_wall_ms", replica=str(replica)
                ).record(float(wall_ms))

        completions: List[CompletedRequest] = []
        t_sla_live: List[float] = []  # per live completion, for summarize
        measured = tick.hedge_handle is not None
        hedge_wall: Optional[float] = None
        names = self.scheduler.names
        requeue: List[InferenceFuture] = []
        if n:
            # Lost batches and early-released rows have no honest wall
            # time: fold only surviving rows into the live profiles (the
            # no-failure path keeps the exact pre-fault call, preserving
            # the rng/EWMA stream the byte-identity regression pins).
            dead = lost | released
            if dead.any():
                if not dead.all():
                    self.scheduler.observe_batch(
                        decision.model_index[~dead], exec_ms[~dead]
                    )
            else:
                self.scheduler.observe_batch(decision.model_index, exec_ms)
            joined = ~np.isnan(ttft)
            if joined.any():
                self.scheduler.observe_join(
                    decision.model_index[joined], ttft[joined]
                )

            remote_ms = (
                tick.queue_wait
                + np.asarray([r.t_nw_actual_ms for r in requests])
                + exec_ms
            )

            ondevice_in: Optional[np.ndarray] = None
            hedge_tokens: Dict[int, np.ndarray] = {}
            if measured:
                out, hedge_wall = tick.hedge_handle.wait()
                if tick.hedge_span is not None:
                    obs.tracer.end(
                        tick.hedge_span, t1_ms=tick.hedge_handle.done_wall_ms
                    )
                for row, i in enumerate(tick.hedged_rows):
                    hedge_tokens[int(i)] = out[row, : requests[i].n_steps]
                ondevice_in = np.full(n, hedge_wall)
                self.scheduler.observe_ondevice(
                    np.full(tick.hedged_rows.size, hedge_wall)
                )

            # Both tiers launch at the dispatch tick, so queue wait charges
            # the duplicate's race clock too — and with async dispatch that
            # is also true of the *wall* clocks (see TickStats / the
            # regression test).
            acc_used, latency, used_remote, ondevice_ms = (
                self.scheduler.resolve_chunk(
                    decision, remote_ms, ondevice_ms=ondevice_in,
                    ondevice_wait_ms=tick.queue_wait, t_sla_ms=tick.t_sla,
                )
            )

            for i, f in enumerate(tick.futures):
                if lost[i] and not (measured and decision.hedged[i]):
                    # No tokens exist for this row anywhere (its hedge, if
                    # any, was only a simulated sample) — back through
                    # admission for a later tick on a surviving replica.
                    requeue.append(f)
                    continue
                done_walls = {}
                if tick.row_handles[i].done_wall_ms is not None:
                    done_walls["remote"] = tick.row_handles[i].done_wall_ms
                if measured and decision.hedged[i]:
                    done_walls["ondevice"] = tick.hedge_handle.done_wall_ms
                f.tier_done_wall_ms.update(done_walls)
                c = CompletedRequest(
                    rid=requests[i].rid,
                    model_name=names[int(decision.model_index[i])],
                    model_index=int(decision.model_index[i]),
                    tokens=(
                        hedge_tokens[i]
                        if i in hedge_tokens and not used_remote[i]
                        else gen_tokens[i]
                    ),
                    exec_ms=float(exec_ms[i]),
                    remote_ms=float(remote_ms[i]),
                    latency_ms=float(latency[i]),
                    accuracy=float(acc_used[i]),
                    used_remote=bool(used_remote[i]),
                    hedged=bool(decision.hedged[i]),
                    queue_wait_ms=float(tick.queue_wait[i]),
                    ondevice_ms=(
                        float(ondevice_ms[i]) if decision.hedged[i] else None
                    ),
                    hedge_measured=measured and bool(decision.hedged[i]),
                    time_to_schedule_ms=float(
                        tick.now_ms - requests[i].arrival_ms
                    ),
                    race_resolution=(
                        "unhedged" if not decision.hedged[i]
                        else "remote_failed" if lost[i]
                        else ("remote_won" if used_remote[i] else "ondevice_won")
                    ),
                    replica=tick.row_handles[i].replica,
                    replica_inflight=tick.row_handles[i].inflight_at_dispatch,
                    ttft_ms=None if np.isnan(ttft[i]) else float(ttft[i]),
                    tenant=requests[i].tenant,
                    priority=f.priority,
                )
                if obs is not None and f.span is not None:
                    self._note_request_tiers(f, c)
                f._mark_resolved(c)
                if f.state is RequestState.RESOLVED:
                    completions.append(c)
                    t_sla_live.append(
                        float(tick.t_sla)
                        if np.isscalar(tick.t_sla)
                        else float(np.asarray(tick.t_sla)[i])
                    )

        completions, t_sla_live = self._collect_degraded(
            tick, completions, t_sla_live
        )

        # Lost-batch recovery: the rows go back to the *front* of the
        # admission queue (they already invested queue wait) and are
        # rescheduled by a later tick — conservation holds because a
        # requeued request is backlog again, not a resolution.  A racing
        # cancel() wins inside _requeue (the row cancels instead).
        n_requeued = 0
        if requeue:
            back = [f for f in requeue if f._requeue()]
            if back:
                self.admission.requeue(back)
            n_requeued = len(back)

        metrics = None
        if completions or tick.n_shed:
            metrics = summarize(
                accuracy_used=np.asarray([c.accuracy for c in completions]),
                latency_ms=np.asarray([c.latency_ms for c in completions]),
                t_sla_ms=np.asarray(t_sla_live),
                model_names=self._usage_names(),
                model_index=np.asarray(
                    [c.model_index for c in completions], dtype=np.int64
                ),
                used_remote=np.asarray([c.used_remote for c in completions]),
                queue_wait_ms=np.asarray(
                    [c.queue_wait_ms for c in completions]
                ),
                race_resolution=np.asarray(
                    [c.race_resolution for c in completions]
                ),
                time_to_schedule_ms=np.asarray(
                    [c.time_to_schedule_ms for c in completions]
                ),
                n_rejected=tick.n_shed,
                replica=_replica_array(completions),
                replica_inflight=_replica_inflight_array(completions),
                tenant=_tenant_array(completions),
                priority=_priority_array(completions),
                rejected_tenants=_rejected_tenant_counts(
                    tick.shed_info,
                    default_lane=self.admission.cfg.tenants is not None,
                ),
            )

        # Continuous-batching deltas since the last collection (global to
        # the backend, so overlapping stepped ticks never double-count).
        n_joined = n_recycled = 0
        joined_now = getattr(self.backend, "joined_total", None)
        if joined_now is not None:
            n_joined = int(joined_now - self._joined_seen)
            self._joined_seen = joined_now
        recycled_now = getattr(self.backend, "recycled_total", None)
        if recycled_now is not None:
            n_recycled = int(recycled_now - self._recycled_seen)
            self._recycled_seen = recycled_now

        replica_rows: Dict[int, int] = {}
        for _, rows, handle in tick.groups:
            if handle.replica is not None:
                replica_rows[handle.replica] = (
                    replica_rows.get(handle.replica, 0) + len(rows)
                )

        dispatch_stamps = [h.dispatch_wall_ms for _, _, h in tick.groups]
        # A lost batch never finished — its handle has no done stamp.
        group_done = [
            h.done_wall_ms
            for _, _, h in tick.groups
            if h.done_wall_ms is not None
        ]
        done_stamps = list(group_done)
        for h in (tick.hedge_handle, tick.degrade_handle):
            if h is not None:
                dispatch_stamps.append(h.dispatch_wall_ms)
                done_stamps.append(h.done_wall_ms)
        stats = TickStats(
            n_requests=n,
            n_hedged=int(tick.hedged_rows.size),
            remote_wall_ms=remote_wall_sum,
            hedge_wall_ms=hedge_wall,
            span_wall_ms=(
                max(done_stamps) - min(dispatch_stamps) if done_stamps else 0.0
            ),
            dispatch_spread_wall_ms=(
                max(dispatch_stamps) - min(dispatch_stamps)
                if dispatch_stamps
                else 0.0
            ),
            hedge_dispatched_before_remote_done=(
                tick.hedge_handle.dispatch_wall_ms < max(group_done)
                if tick.hedge_handle is not None and group_done
                else None
            ),
            n_shed=tick.n_shed,
            n_degraded=len(tick.degraded_futures),
            n_lost=int(lost.sum()),
            n_requeued=n_requeued,
            replica_rows=replica_rows,
            n_joined=n_joined,
            n_recycled=n_recycled,
            compile_count=int(getattr(self.backend, "compile_count", 0)),
        )
        result = TickResult(
            completions=completions, metrics=metrics, stats=stats
        )
        if obs is not None:
            self._note_tick(stats, len(completions))
            if tick.tick_span is not None:
                tick.tick_span.args.update(
                    n_completions=len(completions),
                    n_lost=stats.n_lost,
                    n_requeued=stats.n_requeued,
                )
                obs.tracer.end(tick.tick_span)
        if self.controller is not None:
            self.controller.observe(
                result,
                scheduler=self.scheduler,
                backend=self.backend,
                now_ms=tick.now_ms,
                backlog=self.admission.backlog,
            )
        return result

    def _collect_degraded(
        self,
        tick: _InflightTick,
        completions: List[CompletedRequest],
        t_sla_live: List[float],
    ) -> Tuple[List[CompletedRequest], List[float]]:
        """Resolve the tick's on-device-only (overload-degraded) rows.

        With a real hedge backend the duplicate batch executed for real and
        its measured wall time folds into the live on-device EWMA profile;
        without one the execution is simulated from the profile (zero
        tokens — simulation only), mirroring the sampled-hedge fallback.
        There is no network leg: the duplicate runs on the device, so
        latency is queue wait + on-device execution.
        """
        nd = len(tick.degraded_futures)
        if not nd:
            return completions, t_sla_live
        obs = self.observability
        dreqs = [f.request for f in tick.degraded_futures]
        sched = self.scheduler
        if tick.degrade_handle is not None:
            dout, dwall = tick.degrade_handle.wait()
            if tick.degrade_span is not None:
                obs.tracer.end(
                    tick.degrade_span, t1_ms=tick.degrade_handle.done_wall_ms
                )
            d_exec = np.full(nd, dwall)
            d_tokens = [dout[row, : r.n_steps] for row, r in enumerate(dreqs)]
            sched.observe_ondevice(d_exec)
        else:
            d_exec = np.maximum(
                sched.ondevice_mu
                + sched.ondevice_sigma * sched.rng.standard_normal(nd),
                _DEGRADE_EXEC_FLOOR_MS,
            )
            d_tokens = [np.zeros(r.n_steps, dtype=np.int32) for r in dreqs]
        d_latency = tick.degrade_queue_wait + d_exec
        loop_sla = sched.cfg.t_sla_ms
        degrade_index = len(sched.names)  # the on-device slot in _usage_names
        for j, f in enumerate(tick.degraded_futures):
            if tick.degrade_handle is not None:
                f.tier_done_wall_ms.update(
                    {"ondevice": tick.degrade_handle.done_wall_ms}
                )
            r = dreqs[j]
            c = CompletedRequest(
                rid=r.rid,
                model_name=sched.ondevice.name,
                model_index=degrade_index,
                tokens=d_tokens[j],
                exec_ms=float(d_exec[j]),
                remote_ms=float(d_latency[j]),  # no remote leg: wait + exec
                latency_ms=float(d_latency[j]),
                accuracy=float(sched.ondevice.accuracy),
                used_remote=False,
                hedged=False,
                queue_wait_ms=float(tick.degrade_queue_wait[j]),
                ondevice_ms=float(d_latency[j]),
                hedge_measured=tick.degrade_handle is not None,
                time_to_schedule_ms=float(tick.now_ms - r.arrival_ms),
                race_resolution="degraded",
                tenant=r.tenant,
                priority=f.priority,
            )
            if obs is not None and f.span is not None:
                self._note_request_tiers(f, c)
            f._mark_resolved(c)
            if f.state is RequestState.RESOLVED:
                completions.append(c)
                t_sla_live.append(
                    loop_sla if r.sla_ms is None else float(r.sla_ms)
                )
        return completions, t_sla_live

    # -- loadgen integration --------------------------------------------------
    def drain_trace(
        self,
        trace: LoadTrace,
        window_ms: float,
        *,
        tokens_for: Callable[[int], np.ndarray],
        n_steps: int,
        on_tick: Optional[Callable[[float, TickResult], None]] = None,
        service_model: Optional[Callable[[TickResult], float]] = None,
    ) -> Tuple[List[CompletedRequest], Optional[RequestMetrics]]:
        """Drain a :mod:`repro_torch.serving.loadgen` trace through the tick path.

        Each arrival window becomes one tick fired at the window's close;
        the wait until then is charged against each request's budget and
        latency.  ``on_tick(tick_ms, result)`` observes each tick.  Returns
        all completions plus trace-level aggregate metrics (including
        ``shed_rate`` / ``goodput`` when the admission queue rejected
        requests).

        ``service_model(result) -> ms`` couples service time into the loop
        clock: after each tick the server is busy for that long, and the
        next tick cannot fire earlier — so offered load beyond the service
        rate builds real queue wait instead of being absorbed into one
        instantaneous mega-batch.  This is what makes overload *visible*
        to the admission policies (and to ``bench_serving.py``'s
        ``serving/admission`` rows); ``None`` keeps the pre-admission
        windows-only clock.

        A bounded admission queue can leave a backlog after the last
        arrival window; the drain keeps ticking (one window's width at a
        time, service-coupled) until every lane is empty.
        """
        completions: List[CompletedRequest] = []
        rejected_before = self.admission.n_rejected
        tenant_rejected_before = dict(self.admission.tenant_rejected)
        busy_until_ms = 0.0
        tick_ms = 0.0

        def fire(t: float) -> float:
            nonlocal busy_until_ms
            if service_model is not None:
                t = max(t, busy_until_ms)
            result = self.tick(now_ms=float(t))
            if result is not None:
                if service_model is not None:
                    busy_until_ms = t + max(float(service_model(result)), 0.0)
                if on_tick is not None:
                    on_tick(float(t), result)
                completions.extend(result.completions)
            return t

        for window in iter_windows(trace, window_ms):
            for i in window:
                self.submit(
                    QueuedRequest(
                        rid=int(i),
                        tokens=tokens_for(int(i)),
                        n_steps=n_steps,
                        t_nw_est_ms=float(trace.t_nw_est_ms[i]),
                        t_nw_actual_ms=float(trace.t_nw_ms[i]),
                        arrival_ms=float(trace.arrival_ms[i]),
                        tenant=(
                            None
                            if trace.tenant is None or trace.tenant[i] is None
                            else str(trace.tenant[i])
                        ),
                    )
                )
            tick_ms = fire(
                (trace.arrival_ms[window[0]] // window_ms + 1) * window_ms
            )

        stalled = 0
        while self.backlog and stalled < 3:
            before = self.backlog
            tick_ms = fire(tick_ms + window_ms)
            stalled = stalled + 1 if self.backlog >= before else 0

        metrics = None
        n_rejected = self.admission.n_rejected - rejected_before
        if completions or n_rejected:
            metrics = summarize(
                accuracy_used=np.asarray([c.accuracy for c in completions]),
                latency_ms=np.asarray([c.latency_ms for c in completions]),
                t_sla_ms=self.scheduler.cfg.t_sla_ms,
                model_names=self._usage_names(),
                model_index=np.asarray([c.model_index for c in completions]),
                used_remote=np.asarray([c.used_remote for c in completions]),
                queue_wait_ms=np.asarray([c.queue_wait_ms for c in completions]),
                race_resolution=np.asarray(
                    [c.race_resolution for c in completions]
                ),
                time_to_schedule_ms=np.asarray(
                    [c.time_to_schedule_ms for c in completions]
                ),
                n_rejected=n_rejected,
                replica=_replica_array(completions),
                replica_inflight=_replica_inflight_array(completions),
                tenant=_tenant_array(completions),
                priority=_priority_array(completions),
                rejected_tenants={
                    name: count - tenant_rejected_before.get(name, 0)
                    for name, count in self.admission.tenant_rejected.items()
                    if count - tenant_rejected_before.get(name, 0) > 0
                },
            )
        return completions, metrics
