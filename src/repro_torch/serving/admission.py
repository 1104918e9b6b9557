"""Bounded admission with explicit backpressure — the loop's front door.

The event loop (:class:`repro_torch.serving.loop.ServingLoop`) used to drain its
*entire* pending list every tick: a burst from ``loadgen`` inflated batch
sizes and queue waits without limit.  :class:`AdmissionQueue` makes
admission a first-class, capacity-bounded stage:

* ``max_pending`` — the bounded FIFO of admitted-but-unscheduled requests.
  What happens at capacity is the *overload policy* (below).
* ``max_chunk`` — per-tick scheduling cap: one tick takes at most this
  many requests; the rest stay queued across ticks (the persistent
  multi-tick queue).
* ``max_inflight_ticks`` — dispatch gate for the ``wait=False`` event
  loop: no new tick is dispatched while this many are already in flight.

Overload policies (engaged only when ``max_pending`` is set):

* ``"unbounded"`` — no capacity bound; byte-identical to the pre-admission
  loop (the compatibility default, and the reference the regression tests
  pin).
* ``"block"`` — client-side backpressure: ``submit`` returns a future that
  is *not yet admitted* (``InferenceFuture.admitted`` is False); it waits
  in an overflow room and is admitted FIFO as capacity frees.  No work is
  dropped — the queue is pushed back to the client.
* ``"shed"`` — deadline-aware rejection: a request at capacity, or one
  whose queue wait already makes its SLA unreachable
  (:func:`sla_unreachable`), resolves immediately with the terminal
  :attr:`repro_torch.serving.lifecycle.RequestState.REJECTED` state.  Served
  requests keep a bounded wait — the policy trades goodput for tail
  latency.
* ``"degrade"`` — accuracy-for-latency: overflow routes to the on-device
  tier *alone* (no remote leg, no two-tier hedge).  The server queue stays
  bounded and every request is answered, at the duplicate's accuracy.

The shed predicate is deliberately *monotone in queue wait*: a request shed
at wait ``w`` would also be shed at any wait ``> w`` (property-tested in
``tests/test_admission.py``) — so shedding never resurrects a request that
a longer wait would have doomed.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serving.lifecycle import InferenceFuture, RequestState
from repro_torch.serving.tenancy import TenantConfig, TenantLanes

__all__ = [
    "OVERLOAD_POLICIES",
    "AdmissionConfig",
    "AdmissionBatch",
    "AdmissionQueue",
    "sla_unreachable",
]

OVERLOAD_POLICIES = ("unbounded", "block", "shed", "degrade")

_UNSET = object()  # retune(): "leave this knob alone" sentinel


def sla_unreachable(
    queue_wait_ms: float,
    sla_ms: float,
    t_nw_est_ms: float = 0.0,
    service_floor_ms: float = 0.0,
    headroom_ms: float = 0.0,
    ondevice_floor_ms: Optional[float] = None,
) -> bool:
    """True when a request's SLA cannot be met even by the fastest path.

    The cheapest completion estimate is the better of the two execution
    paths: the remote leg (``t_nw_est_ms`` network round trip + the
    fastest model's expected execution ``service_floor_ms``) and — when a
    hedge tier exists (``ondevice_floor_ms``) — the on-device duplicate,
    which has *no* network leg.  On a terrible network the duplicate is
    exactly what rescues the request, so shedding must not charge it the
    network estimate.  ``headroom_ms`` adds a safety margin.  Monotone in
    ``queue_wait_ms`` by construction — no other term depends on the wait.
    """
    best_ms = t_nw_est_ms + service_floor_ms
    if ondevice_floor_ms is not None:
        best_ms = min(best_ms, ondevice_floor_ms)
    return queue_wait_ms + best_ms + headroom_ms > sla_ms


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Capacity bounds + overload policy for an :class:`AdmissionQueue`.

    The default (everything ``None``, policy ``"unbounded"``) reproduces
    the pre-admission loop exactly: every submit is admitted immediately
    and every tick drains the whole pending queue.
    """

    max_pending: Optional[int] = None  # bounded FIFO capacity (None: ∞)
    max_chunk: Optional[int] = None  # per-tick scheduling cap (None: all)
    max_inflight_ticks: Optional[int] = None  # wait=False dispatch gate
    policy: str = "unbounded"  # what happens at max_pending capacity
    shed_headroom_ms: float = 0.0  # extra margin in the shed predicate
    # Multi-tenant QoS: per-tenant lanes drained strict-priority +
    # deficit-weighted-fair (None — the default — keeps the single-class
    # FIFO path, byte-identical to the pre-tenancy queue).
    tenants: Optional[Tuple[TenantConfig, ...]] = None

    def __post_init__(self):
        if self.policy not in OVERLOAD_POLICIES:
            raise ValueError(
                f"policy must be one of {OVERLOAD_POLICIES}, got {self.policy!r}"
            )
        if self.tenants is not None:
            object.__setattr__(self, "tenants", tuple(self.tenants))
            for t in self.tenants:
                if not isinstance(t, TenantConfig):
                    raise TypeError(f"tenants must be TenantConfig, got {t!r}")
        tenant_bounded = self.tenants is not None and any(
            t.max_pending is not None for t in self.tenants
        )
        if (
            self.policy != "unbounded"
            and self.max_pending is None
            and not tenant_bounded
        ):
            raise ValueError(
                f"policy {self.policy!r} requires max_pending (the capacity "
                "whose overflow it governs) — globally or on some tenant"
            )
        for field in ("max_pending", "max_chunk", "max_inflight_ticks"):
            v = getattr(self, field)
            if v is not None and v < 1:
                raise ValueError(f"{field} must be >= 1 or None, got {v}")

    @property
    def bounded(self) -> bool:
        return self.max_pending is not None and self.policy != "unbounded"


@dataclasses.dataclass
class AdmissionBatch:
    """What one tick takes from the admission queue."""

    chunk: List[InferenceFuture]  # requests for the remote/hedged path
    degraded: List[InferenceFuture]  # requests for the on-device-only path
    shed: List[InferenceFuture]  # rejected this take (already REJECTED)
    now_ms: float  # the tick's loop-clock timestamp

    def __bool__(self) -> bool:
        return bool(self.chunk or self.degraded)


class AdmissionQueue:
    """Bounded FIFO admission stage with pluggable overload policies.

    Thread-safe: :meth:`offer` may race :meth:`take` from another thread —
    a submitted future lands in exactly one of (admitted queue, overflow
    room, degrade lane, rejected), never vanishes.  Conservation holds at
    all times::

        n_submitted == n_resolved + n_rejected + n_cancelled + backlog + in-flight
    """

    def __init__(self, cfg: AdmissionConfig = AdmissionConfig()):
        self.cfg = cfg
        self._obs = None  # Observability handle; None keeps the bare path
        self._lock = threading.Lock()
        self._admitted: Deque[InferenceFuture] = deque()
        self._overflow: Deque[InferenceFuture] = deque()  # block policy
        self._degraded: Deque[InferenceFuture] = deque()  # degrade policy
        # Tenancy: per-tenant lanes replace the single admitted FIFO when
        # the config names tenants (None keeps the FIFO path untouched).
        self._lanes: Optional[TenantLanes] = (
            None if cfg.tenants is None else TenantLanes(cfg.tenants)
        )
        self.n_submitted = 0
        self.n_rejected = 0  # overflow-rejected + deadline-shed
        self.n_degraded = 0  # routed to the on-device-only lane
        self.n_requeued = 0  # lost-batch rows returned by the loop
        # Per-tenant accounting (lane name -> count); empty without lanes.
        self.tenant_submitted: Dict[str, int] = {}
        self.tenant_rejected: Dict[str, int] = {}

    # -- bookkeeping -----------------------------------------------------------
    @staticmethod
    def _queued(q: Deque[InferenceFuture]) -> int:
        return sum(1 for f in q if f.state is RequestState.QUEUED)

    @property
    def pending(self) -> int:
        """Admitted requests waiting for a tick (bounded by max_pending)."""
        with self._lock:
            if self._lanes is not None:
                return self._lanes.n_queued()
            return self._queued(self._admitted)

    @property
    def blocked(self) -> int:
        """Not-yet-admitted requests waiting in the overflow room."""
        with self._lock:
            return self._queued(self._overflow)

    @property
    def degrade_pending(self) -> int:
        """Requests waiting in the on-device-only degrade lane."""
        with self._lock:
            return self._queued(self._degraded)

    @property
    def backlog(self) -> int:
        """Everything still waiting for a tick, across all lanes."""
        with self._lock:
            admitted = (
                self._lanes.n_queued()
                if self._lanes is not None
                else self._queued(self._admitted)
            )
            return (
                admitted
                + self._queued(self._overflow)
                + self._queued(self._degraded)
            )

    def tenant_pending(self, name: str) -> int:
        """Queued requests in one tenant's lane (0 without tenancy)."""
        with self._lock:
            if self._lanes is None:
                return 0
            return self._lanes.n_queued(name)

    @staticmethod
    def _admit_stamp(future: InferenceFuture) -> None:
        future.admitted = True
        future.admitted_wall_ms = time.perf_counter() * 1e3

    # -- observability ---------------------------------------------------------
    def attach_observability(self, obs) -> None:
        """Attach a :class:`repro_torch.observability.Observability` handle.

        Offer dispositions, take-side shed counts, queue-wait histograms,
        and lane-depth gauges are emitted through it.  Never attached
        (the default), every path is the exact pre-observability one.
        """
        self._obs = obs

    def _note_offer(self, disposition: str) -> None:
        self._obs.counter(
            "admission_offers_total", disposition=disposition
        ).inc()

    def _note_take(self, batch: AdmissionBatch) -> None:
        """Record one take's outcome (only called with ``_obs`` attached)."""
        obs = self._obs
        wait_hist = obs.histogram("admission_queue_wait_ms")
        for f in batch.chunk:
            wait_hist.record(max(batch.now_ms - f.request.arrival_ms, 0.0))
        if batch.shed:
            obs.counter("admission_shed_total").inc(len(batch.shed))
        if batch.degraded:
            obs.counter("admission_degraded_taken_total").inc(
                len(batch.degraded)
            )
        obs.gauge("admission_pending").set(self.pending)
        obs.gauge("admission_blocked").set(self.blocked)
        if self._lanes is not None:
            for f in batch.chunk:
                obs.counter(
                    "tenant_selected_total", tenant=self._lanes.name_of(f)
                ).inc()
            with self._lock:
                depths = self._lanes.depths()
            for name, depth in depths.items():
                obs.gauge("tenant_lane_depth", tenant=name).set(depth)

    # -- adaptive retuning -----------------------------------------------------
    def retune(
        self,
        *,
        max_pending=_UNSET,
        max_chunk=_UNSET,
        shed_headroom_ms=_UNSET,
    ) -> AdmissionConfig:
        """Replace the queue's *capacity* knobs mid-run — the surface the
        adaptive :class:`repro_torch.serving.controller.AdmissionController`
        drives.  Returns the config now in effect.

        Only capacity knobs are retunable; policy, tenants, and the
        inflight gate are structural and keep their configured values.
        The swap is atomic under the queue lock and re-validated by
        :class:`AdmissionConfig` (shrinking ``max_pending`` below 1, or
        dropping it while a bounded policy is active, raises instead of
        wedging the queue).  Already-admitted requests are never
        retro-shed by a shrink: capacity is only consulted on *offer*,
        and the shed predicate is monotone in the margin — a smaller
        ``shed_headroom_ms`` sheds a strict subset of what the old
        margin would have (regression-tested in
        ``tests/test_admission.py``).
        """
        kw = {}
        if max_pending is not _UNSET:
            kw["max_pending"] = max_pending
        if max_chunk is not _UNSET:
            kw["max_chunk"] = max_chunk
        if shed_headroom_ms is not _UNSET:
            kw["shed_headroom_ms"] = float(shed_headroom_ms)
        with self._lock:
            if kw:
                self.cfg = dataclasses.replace(self.cfg, **kw)
            return self.cfg

    # -- submit side -----------------------------------------------------------
    def offer(self, future: InferenceFuture) -> str:
        """Place one submitted future; returns its disposition:
        ``"admitted"`` | ``"blocked"`` | ``"degraded"`` | ``"rejected"``.
        """
        disposition = (
            self._offer_tenant(future)
            if self._lanes is not None
            else self._offer_fifo(future)
        )
        if self._obs is not None:
            self._note_offer(disposition)
        return disposition

    def _offer_fifo(self, future: InferenceFuture) -> str:
        with self._lock:
            self.n_submitted += 1
            if not self.cfg.bounded:
                self._admitted.append(future)
                self._admit_stamp(future)
                return "admitted"
            if self._queued(self._admitted) < self.cfg.max_pending:
                self._admitted.append(future)
                self._admit_stamp(future)
                return "admitted"
            if self.cfg.policy == "block":
                self._overflow.append(future)
                return "blocked"
            if self.cfg.policy == "degrade":
                self._degraded.append(future)
                self._admit_stamp(future)
                self.n_degraded += 1
                return "degraded"
        # shed: capacity tail-drop — the queue never grows past
        # max_pending, and the newest request is the one with the least
        # wait invested.  The terminal transition runs outside the lock
        # (it may wake waiters) and can lose to a racing cancel(), so the
        # counter only tracks transitions that actually happened.
        if future._mark_rejected():
            with self._lock:
                self.n_rejected += 1
                self._charge_tenant_reject(future)
            return "rejected"
        return "cancelled"

    def _charge_tenant_reject(self, future: InferenceFuture) -> None:
        """Under self._lock: per-tenant reject accounting.

        In lanes mode every reject is charged to its lane; in FIFO mode
        only *tagged* requests are counted (an untagged single-class run
        keeps its accounting — and metrics — exactly as before tenancy).
        """
        if self._lanes is not None:
            name = self._lanes.name_of(future)
        else:
            name = future.request.tenant
            if name is None:
                return
        self.tenant_rejected[name] = self.tenant_rejected.get(name, 0) + 1

    # -- tenancy (cfg.tenants set) --------------------------------------------
    def _over_capacity(self, lane) -> bool:
        """Under self._lock: is this lane's next admit over capacity —
        globally (max_pending across all lanes) or per-tenant?"""
        if self.cfg.policy == "unbounded":
            return False
        if (
            self.cfg.max_pending is not None
            and self._lanes.n_queued() >= self.cfg.max_pending
        ):
            return True
        return (
            lane.cfg.max_pending is not None
            and lane.n_queued >= lane.cfg.max_pending
        )

    def _offer_tenant(self, future: InferenceFuture) -> str:
        """Lane-routing offer: the tenant's lane (and its bound) replaces
        the single FIFO; the overload policies keep their meaning, applied
        when either the global or the tenant's capacity is exceeded."""
        with self._lock:
            self.n_submitted += 1
            lane = self._lanes.resolve(future)
            name = lane.cfg.name
            self.tenant_submitted[name] = (
                self.tenant_submitted.get(name, 0) + 1
            )
            if not self._over_capacity(lane):
                self._lanes.append(lane, future)
                self._admit_stamp(future)
                return "admitted"
            if self.cfg.policy == "block":
                self._overflow.append(future)
                return "blocked"
            if self.cfg.policy == "degrade":
                self._degraded.append(future)
                self._admit_stamp(future)
                self.n_degraded += 1
                return "degraded"
        # shed — same outside-the-lock transition as the FIFO path.
        if future._mark_rejected():
            with self._lock:
                self.n_rejected += 1
                self._charge_tenant_reject(future)
            return "rejected"
        return "cancelled"

    def _refill_lanes(self) -> None:
        """Under self._lock: admit overflow-room futures whose lane has
        capacity again (block policy).  Unlike the single-FIFO refill this
        may skip over the head — one tenant's full lane must not block
        another tenant's admission (no cross-tenant head-of-line)."""
        if self.cfg.policy != "block" or not self._overflow:
            return
        kept: Deque[InferenceFuture] = deque()
        while self._overflow:
            f = self._overflow.popleft()
            lane = self._lanes.resolve(f)
            if not self._over_capacity(lane):
                self._lanes.append(lane, f)
                self._admit_stamp(f)
            else:
                kept.append(f)
        self._overflow = kept

    def _shed_lanes(
        self,
        now_ms: float,
        default_sla_ms: float,
        service_floor_ms: float,
        ondevice_floor_ms: Optional[float],
    ) -> List[InferenceFuture]:
        """Under self._lock: collect SLA-unreachable requests across every
        lane (same predicate as the FIFO shed) and drop them."""
        shed = []
        for f in self._lanes.all_queued():
            r = f.request
            wait = max(now_ms - r.arrival_ms, 0.0)
            sla = default_sla_ms if r.sla_ms is None else r.sla_ms
            if sla_unreachable(
                wait, sla, r.t_nw_est_ms, service_floor_ms,
                self.cfg.shed_headroom_ms, ondevice_floor_ms,
            ):
                shed.append(f)
        self._lanes.discard(shed)
        return shed

    def _take_tenant(
        self,
        now_ms: Optional[float],
        *,
        default_sla_ms: float,
        service_floor_ms: float,
        ondevice_floor_ms: Optional[float],
    ) -> AdmissionBatch:
        """Tenancy-mode take: same phases as the FIFO take, but the chunk
        comes from :meth:`TenantLanes.select` — strict interactive-over-
        batch priority, deficit-weighted-fair within a class — and shed
        rejections are charged to their tenant."""
        shed: List[InferenceFuture] = []
        lanes = self._lanes
        with self._lock:
            lanes.prune()
            self._prune()  # overflow + degrade deques
            self._refill_lanes()
            if self.cfg.policy == "shed":
                shed_now = now_ms
                if shed_now is None:
                    # The would-be chunk's latest arrival (a pure peek —
                    # lane deficits don't advance).
                    peek = lanes.select(self.cfg.max_chunk, commit=False)
                    if peek:
                        shed_now = max(f.request.arrival_ms for f in peek)
                if shed_now is not None:
                    shed = self._shed_lanes(
                        float(shed_now), default_sla_ms, service_floor_ms,
                        ondevice_floor_ms,
                    )
                    self._refill_lanes()
            chunk = lanes.select(self.cfg.max_chunk)
            self._refill_lanes()  # the chunk's slots free immediately
            if chunk and now_ms is None:
                now_ms = max(f.request.arrival_ms for f in chunk)
            degraded = self._take_degraded()
        shed = [f for f in shed if f._mark_rejected()]
        if shed:
            with self._lock:
                self.n_rejected += len(shed)
                for f in shed:
                    self._charge_tenant_reject(f)
        if now_ms is None and degraded:
            now_ms = max(f.request.arrival_ms for f in degraded)
        return AdmissionBatch(
            chunk=chunk, degraded=degraded, shed=shed,
            now_ms=0.0 if now_ms is None else float(now_ms),
        )

    def requeue(self, futures: List[InferenceFuture]) -> None:
        """Return lost-batch futures to the *front* of the admitted queue.

        Called by the loop when a replica failure loses a dispatched
        batch: the rows already went through admission once (they are
        counted in ``n_submitted`` and invested real queue wait), so they
        re-enter at the head — ahead of younger arrivals — and bypass the
        ``max_pending`` capacity check (they held a slot when first
        admitted; bouncing them to the overload policy would turn a
        replica fault into spurious shed/degrade).  Conservation is
        unchanged: a requeued request is backlog again, not a new submit.
        """
        with self._lock:
            for f in reversed(futures):
                if self._lanes is not None:
                    self._lanes.append_front(f)
                else:
                    self._admitted.appendleft(f)
            self.n_requeued += len(futures)
        if self._obs is not None and futures:
            self._obs.counter("admission_requeued_total").inc(len(futures))

    # -- tick side -------------------------------------------------------------
    def take(
        self,
        now_ms: Optional[float],
        *,
        default_sla_ms: float,
        service_floor_ms: float = 0.0,
        ondevice_floor_ms: Optional[float] = None,
    ) -> AdmissionBatch:
        """One tick's admission work: prune, refill, (shed,) select.

        1. Drop futures that left QUEUED state (cancelled) from every lane.
        2. Refill the admitted queue FIFO from the overflow room (block).
        3. Under ``shed``: reject every admitted request — including the
           would-be chunk — whose wait at the tick clock makes its SLA
           unreachable, then refill freed capacity again.
        4. Select the first ``max_chunk`` surviving requests as the tick's
           chunk; ``now_ms`` defaults to the chunk's latest arrival (the
           pre-admission loop's convention).
        5. Take up to ``max_chunk`` requests from the degrade lane.

        The returned futures are still QUEUED — the loop claims them with
        ``_try_schedule`` (so a racing ``cancel()`` keeps its guarantee).

        With tenancy enabled (``cfg.tenants``) step 4's selection is the
        strict-priority deficit-weighted-fair lane drain instead of the
        FIFO prefix; everything else keeps its semantics.
        """
        if self._lanes is not None:
            batch = self._take_tenant(
                now_ms,
                default_sla_ms=default_sla_ms,
                service_floor_ms=service_floor_ms,
                ondevice_floor_ms=ondevice_floor_ms,
            )
        else:
            batch = self._take_fifo(
                now_ms,
                default_sla_ms=default_sla_ms,
                service_floor_ms=service_floor_ms,
                ondevice_floor_ms=ondevice_floor_ms,
            )
        if self._obs is not None:
            self._note_take(batch)
        return batch

    def _take_fifo(
        self,
        now_ms: Optional[float],
        *,
        default_sla_ms: float,
        service_floor_ms: float,
        ondevice_floor_ms: Optional[float],
    ) -> AdmissionBatch:
        shed: List[InferenceFuture] = []
        with self._lock:
            self._prune()
            self._refill()
            if self.cfg.policy == "shed":
                # The shed clock: the caller's tick time, or the would-be
                # chunk's latest arrival (what _select_chunk would pick).
                shed_now = now_ms
                if shed_now is None and self._admitted:
                    shed_now = max(
                        f.request.arrival_ms for f in self._chunk_prefix()
                    )
                if shed_now is not None:
                    shed = self._shed(
                        float(shed_now), default_sla_ms, service_floor_ms,
                        ondevice_floor_ms,
                    )
                    self._refill()
            chunk = self._chunk_prefix()
            for _ in chunk:
                self._admitted.popleft()
            self._refill()  # the chunk's slots free immediately
            if chunk and now_ms is None:
                now_ms = max(f.request.arrival_ms for f in chunk)
            degraded = self._take_degraded()
        # The terminal transitions run outside the lock (they may wake
        # waiters); a racing cancel() can win, in which case the future is
        # CANCELLED, not REJECTED — only real transitions are counted.
        shed = [f for f in shed if f._mark_rejected()]
        if shed:
            with self._lock:
                self.n_rejected += len(shed)
                for f in shed:
                    self._charge_tenant_reject(f)
        if now_ms is None and degraded:
            now_ms = max(f.request.arrival_ms for f in degraded)
        return AdmissionBatch(
            chunk=chunk, degraded=degraded, shed=shed,
            now_ms=0.0 if now_ms is None else float(now_ms),
        )

    # The helpers below run under self._lock.
    def _prune(self) -> None:
        for q in (self._admitted, self._overflow, self._degraded):
            stale = any(f.state is not RequestState.QUEUED for f in q)
            if stale:
                kept = [f for f in q if f.state is RequestState.QUEUED]
                q.clear()
                q.extend(kept)

    def _refill(self) -> None:
        if not self.cfg.bounded or self.cfg.policy != "block":
            return
        while self._overflow and len(self._admitted) < self.cfg.max_pending:
            future = self._overflow.popleft()
            self._admitted.append(future)
            self._admit_stamp(future)

    def _chunk_prefix(self) -> List[InferenceFuture]:
        cap = self.cfg.max_chunk
        n = len(self._admitted) if cap is None else min(cap, len(self._admitted))
        return [self._admitted[i] for i in range(n)]

    def _shed(
        self,
        now_ms: float,
        default_sla_ms: float,
        service_floor_ms: float,
        ondevice_floor_ms: Optional[float] = None,
    ) -> List[InferenceFuture]:
        shed, kept = [], []
        for f in self._admitted:
            r = f.request
            wait = max(now_ms - r.arrival_ms, 0.0)
            sla = default_sla_ms if r.sla_ms is None else r.sla_ms
            if sla_unreachable(
                wait, sla, r.t_nw_est_ms, service_floor_ms,
                self.cfg.shed_headroom_ms, ondevice_floor_ms,
            ):
                shed.append(f)
            else:
                kept.append(f)
        if shed:
            self._admitted.clear()
            self._admitted.extend(kept)
        return shed

    def _take_degraded(self) -> List[InferenceFuture]:
        cap = self.cfg.max_chunk
        n = len(self._degraded) if cap is None else min(cap, len(self._degraded))
        return [self._degraded.popleft() for _ in range(n)]
