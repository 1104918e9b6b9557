"""Request lifecycle: the per-request objects of the async serving API.

A request moves through explicit states::

    QUEUED ──▶ SCHEDULED ──▶ EXECUTING ──▶ RESOLVED
       │ │          │             │
       │ └──────────┴─────────────┴──────▶ CANCELLED
       └─────────────────────────────────▶ REJECTED

* **QUEUED** — submitted to :class:`repro_torch.serving.loop.ServingLoop` (or an
  :class:`repro_torch.serving.client.InferenceClient`), waiting for a scheduling
  tick.  Under a bounded admission queue
  (:class:`repro_torch.serving.admission.AdmissionQueue`) a queued future may
  not be *admitted* yet (``admitted`` False — parked in the overflow room
  by the ``block`` policy); ``admitted_wall_ms`` stamps the admission.
  :meth:`InferenceFuture.cancel` here frees the request entirely — it
  never occupies a batch slot on either tier.
* **REJECTED** — terminal: the admission queue refused the request (at
  capacity under the ``shed`` policy, or because its queue wait already
  made the SLA unreachable).  :meth:`InferenceFuture.result` raises
  :class:`RequestRejected`.  Only a QUEUED request can be rejected.
* **SCHEDULED** — a tick picked it up; ``decide_batch`` chose its variant.
* **EXECUTING** — dispatched to the execution tier(s); per-tier dispatch
  wall timestamps are recorded on the future.  Cancellation from here on
  cannot recall the batched execution, but the result is discarded at
  resolution (the measurement still folds into the live EWMA profiles —
  the work really happened).  A batch lost to a dead/failed replica sends
  its unhedged rows *back* to QUEUED (``_requeue`` — the loop re-admits
  them at the front of the admission queue), so replica failure loses no
  request.
* **RESOLVED** — hedged duplication resolved; :meth:`InferenceFuture.result`
  returns the :class:`CompletedRequest`.

The dataclasses :class:`QueuedRequest` / :class:`CompletedRequest` are the
wire format between the client, the loop, and the compatibility shim
(:meth:`repro_torch.serving.engine.ServingEngine.serve_queue`).
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

__all__ = [
    "RequestState",
    "RequestCancelled",
    "RequestRejected",
    "InferenceFuture",
    "QueuedRequest",
    "CompletedRequest",
    "StreamChunk",
]


class RequestState(enum.Enum):
    QUEUED = "queued"
    SCHEDULED = "scheduled"
    EXECUTING = "executing"
    RESOLVED = "resolved"
    CANCELLED = "cancelled"
    REJECTED = "rejected"


class RequestCancelled(RuntimeError):
    """Raised by :meth:`InferenceFuture.result` for a cancelled request."""


class RequestRejected(RuntimeError):
    """Raised by :meth:`InferenceFuture.result` for a request the admission
    queue refused (overload shedding / unreachable SLA)."""


@dataclasses.dataclass
class QueuedRequest:
    """One pending inference request in the serving queue."""

    rid: int
    tokens: np.ndarray  # (S,) prompt tokens
    n_steps: int
    t_nw_est_ms: float
    t_nw_actual_ms: float
    arrival_ms: float = 0.0
    sla_ms: Optional[float] = None  # per-request SLA (None: the loop's)
    # Tenancy: which admission lane the request rides (None: the implicit
    # "default" lane) and its priority class — "interactive" | "batch"
    # (None: the lane's configured class).
    tenant: Optional[str] = None
    priority: Optional[str] = None


@dataclasses.dataclass
class CompletedRequest:
    """Resolved outcome of one served request."""

    rid: int
    model_name: str
    model_index: int
    # (n_steps,) generated tokens.  With a real hedge tier (hedge_measured)
    # these come from the tier that answered; in the sampled-hedge
    # simulation there is no duplicate execution, so they are always the
    # remote model's output even when the simulated duplicate "wins".
    tokens: np.ndarray
    exec_ms: float  # wall time of the variant batch this request rode in
    remote_ms: float  # queue wait + network + execution
    latency_ms: float  # user-observed (post-duplication)
    accuracy: float  # quality of the result actually used
    used_remote: bool
    hedged: bool
    queue_wait_ms: float = 0.0  # dispatch tick - arrival (charged to budget)
    ondevice_ms: Optional[float] = None  # duplicate's latency (hedged only)
    hedge_measured: bool = False  # True: ondevice_ms is real wall time
    time_to_schedule_ms: float = 0.0  # scheduling tick - arrival
    race_resolution: str = "unhedged"  # remote_won | ondevice_won | unhedged
    # Cluster routing: which pool replica ran the remote batch (None on a
    # single unclustered backend and for degrade-lane rows — the on-device
    # hedge singleton is never a routable replica), and the replica's
    # queue depth in rows, this batch included, at dispatch.
    replica: Optional[int] = None
    replica_inflight: Optional[int] = None
    # Continuous-batching tier: wall time from dispatch to this row's first
    # token (prefill + graft into the persistent decode batch).  None on
    # the classic whole-batch tiers, where no first token exists before
    # batch end.
    ttft_ms: Optional[float] = None
    # Tenancy: the admission lane that served the request (None: untagged)
    # and its effective priority class at admission.
    tenant: Optional[str] = None
    priority: str = "interactive"


@dataclasses.dataclass(frozen=True)
class StreamChunk:
    """One decode token pushed to a streaming consumer before resolution.

    ``wall_ms`` is the absolute ``time.perf_counter()`` stamp (in ms) at
    which the token was emitted by the backend — the same stamp the
    continuous tier uses for its TTFT accounting, so for the first chunk
    ``wall_ms - future.tier_dispatch_wall_ms["remote"]`` equals the
    completion's ``ttft_ms``.
    """

    index: int  # position in the decode stream (0 = first token)
    token: int
    wall_ms: float


class InferenceFuture:
    """Handle to one in-flight request; resolved by the serving loop.

    Carries the loop-clock lifecycle timestamps (``submitted_ms``,
    ``scheduled_ms``, ``resolved_ms``) plus per-tier *wall-clock* dispatch
    and completion timestamps (``tier_dispatch_wall_ms`` /
    ``tier_done_wall_ms``, keys ``"remote"`` and ``"ondevice"``) — the raw
    material for race-clock assertions: with async dispatch both tiers'
    entries differ by thread-submit overhead, not by a serialized batch.
    """

    def __init__(self, request: QueuedRequest, loop=None):
        self.request = request
        self.state = RequestState.QUEUED
        self.submitted_ms: float = request.arrival_ms
        self.scheduled_ms: Optional[float] = None
        self.resolved_ms: Optional[float] = None
        # Admission bookkeeping: a bounded queue's "block" policy parks the
        # future un-admitted (backpressure); admitted_wall_ms stamps the
        # moment it actually entered the bounded pending queue.
        self.admitted: bool = False
        self.admitted_wall_ms: Optional[float] = None
        self.tier_dispatch_wall_ms: Dict[str, float] = {}
        self.tier_done_wall_ms: Dict[str, float] = {}
        # Effective priority class: the request's explicit priority, else
        # "interactive"; a tenancy-enabled admission queue re-stamps this
        # with the tenant lane's configured class at offer time.
        self.priority: str = (
            "interactive" if request.priority is None else request.priority
        )
        self._loop = loop
        # Observability: the request's root span and the tracer it lives
        # in — set by the loop at submit when tracing is enabled (both
        # stay None otherwise; every emission below is guarded).  The
        # lifecycle transitions are the single source of truth for the
        # terminal instants (resolve / shed / cancel) the conservation
        # check counts, and for the requeue back-edge mark.
        self.span = None
        self._tracer = None
        # The queued-period child span (submit → tick claim); reopened by
        # a lost-batch requeue so the tree shows every wait separately.
        self._queued_span = None
        self._event = threading.Event()
        # Streaming channel: decode tokens pushed by the backend (via the
        # loop's per-batch on_token callback) before resolution.
        self._chunks: List[StreamChunk] = []
        # Guards the QUEUED -> SCHEDULED / QUEUED -> CANCELLED transition:
        # cancel() may race the loop's tick from another thread, and a
        # request whose cancel() returned True must never be dispatched.
        self._state_lock = threading.Lock()
        self._completion: Optional[CompletedRequest] = None
        self._cancel_requested = False
        # How many times a replica failure sent this request back to
        # QUEUED (lost-batch recovery); diagnostic, not a retry budget.
        self.requeues = 0

    # -- inspection -----------------------------------------------------------
    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def tenant(self) -> Optional[str]:
        return self.request.tenant

    def done(self) -> bool:
        """True once the request is RESOLVED or CANCELLED (never blocks)."""
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self.state is RequestState.CANCELLED

    def rejected(self) -> bool:
        return self.state is RequestState.REJECTED

    @property
    def time_to_schedule_ms(self) -> Optional[float]:
        if self.scheduled_ms is None:
            return None
        return self.scheduled_ms - self.submitted_ms

    # -- cancellation ---------------------------------------------------------
    def cancel(self) -> bool:
        """Request cancellation.

        Returns True when the request was still QUEUED — it is dropped
        immediately and will never occupy a batch slot on either tier.
        Later states return False: the batched execution cannot be
        recalled, but the result is discarded at resolution (the loser- and
        winner-tier measurements still fold into the EWMA profiles) and
        :meth:`result` raises :class:`RequestCancelled`.
        """
        with self._state_lock:
            if self.done():
                return False
            if self.state is RequestState.QUEUED:
                self._mark_cancelled()
                return True
            self._cancel_requested = True
            return False

    # -- result ---------------------------------------------------------------
    def result(self, timeout: Optional[float] = None) -> CompletedRequest:
        """Block until resolved.

        With ``timeout=None`` (blocking mode) the call *drives* the
        attached loop — a single-threaded caller never deadlocks.  With a
        ``timeout`` (wall-clock seconds) it only waits on the resolution
        event — ticks must be driven elsewhere — and raises
        :class:`TimeoutError` when the timeout elapses; driving the loop
        here could run unbounded batch work past the deadline.  Raises
        :class:`RequestCancelled` for a cancelled request.
        """
        if timeout is None and not self._event.is_set() and self._loop is not None:
            self._loop.flush()
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request.rid} unresolved after {timeout}s "
                f"(state={self.state.value})"
            )
        if self.state is RequestState.CANCELLED:
            raise RequestCancelled(f"request {self.request.rid} was cancelled")
        if self.state is RequestState.REJECTED:
            raise RequestRejected(
                f"request {self.request.rid} was rejected by admission "
                "(overload shed / unreachable SLA)"
            )
        assert self._completion is not None
        return self._completion

    # -- streaming ------------------------------------------------------------
    def _push_chunk(self, token: int, wall_ms: float) -> None:
        """Backend-side token emission (appended in decode order).

        Called from the dispatching thread (sync / stepped modes) while the
        future is still EXECUTING — list append is atomic under the GIL, so
        a concurrently iterating :meth:`stream` sees a consistent prefix.
        """
        self._chunks.append(
            StreamChunk(len(self._chunks), int(token), float(wall_ms))
        )
        if self._tracer is not None:
            self._tracer.instant(
                "stream.token",
                parent=self.span,
                cat="stream",
                t_ms=wall_ms,
                index=len(self._chunks) - 1,
            )

    @property
    def chunks(self) -> List[StreamChunk]:
        """Chunks streamed so far (decode order; grows until resolution)."""
        return list(self._chunks)

    def stream(self) -> Iterator[StreamChunk]:
        """Yield :class:`StreamChunk` tokens as the backend emits them.

        On a streaming-capable backend (the continuous-batching tier) every
        decode token is pushed *before* the future resolves — under stepped
        dispatch each ``poll()`` pump surfaces one more token, so a
        cooperative consumer observes genuinely incremental delivery; under
        sync dispatch the whole stream is pushed during the tick (still
        before ``_mark_resolved``) and yielded in order right after.

        Like ``result(timeout=None)``, the generator *drives* the attached
        loop when progress stalls (tick un-dispatched work, poll in-flight
        work), so a single-threaded consumer never deadlocks.  On backends
        with no token channel the stream degrades gracefully: it yields the
        completion's tokens as one burst stamped at consumption time.

        Note: the stream is the *remote* decode stream.  A hedged row whose
        duplicate wins the race may stream fewer tokens than ``n_steps``
        (its slot is released early); ``result()`` remains the
        authoritative answer.
        """
        i = 0
        while True:
            while i < len(self._chunks):
                chunk = self._chunks[i]
                i += 1
                yield chunk
            if self.done():
                break
            if self._loop is None:
                # Externally driven (a server thread owns the loop): just
                # wait for more chunks or resolution.
                self._event.wait(0.001)
                continue
            if self.state is RequestState.QUEUED:
                # Dispatch without collecting when the loop steps its
                # backend (chunks then flow incrementally via poll); the
                # whole-batch modes resolve us within the tick.
                stepped = self._loop.dispatch == "stepped"
                self._loop.tick(wait=not stepped)
                if self.state is RequestState.QUEUED and not self.done():
                    # Not taken this tick (inflight gate / backpressure).
                    self._loop.poll()
                    if (
                        self.state is RequestState.QUEUED
                        and not self._loop._inflight
                    ):
                        self._loop.flush()
            else:
                self._loop.poll()
        if i == 0 and self.state is RequestState.RESOLVED:
            # No token channel on the serving tier: degrade to one burst of
            # the completion's tokens, stamped now.
            now_ms = time.perf_counter() * 1e3
            for tok in np.asarray(self._completion.tokens).ravel():
                self._push_chunk(int(tok), now_ms)
            while i < len(self._chunks):
                chunk = self._chunks[i]
                i += 1
                yield chunk

    # -- loop-side transitions ------------------------------------------------
    def _try_schedule(self, now_ms: float) -> bool:
        """Atomically claim a QUEUED future for a tick; False if a racing
        cancel() (or a previous tick) got there first."""
        with self._state_lock:
            if self.state is not RequestState.QUEUED:
                return False
            self.state = RequestState.SCHEDULED
            self.scheduled_ms = now_ms
            if self._tracer is not None:
                self._end_queued()
                self._tracer.instant(
                    "scheduled", parent=self.span, cat="request",
                    now_ms=now_ms,
                )
            return True

    def _mark_executing(self, tier_dispatch_wall_ms: Dict[str, float]) -> None:
        self.state = RequestState.EXECUTING
        self.tier_dispatch_wall_ms.update(tier_dispatch_wall_ms)

    def _mark_resolved(self, completion: CompletedRequest) -> None:
        # Under the lock: a cancel() that returned False *after* observing
        # EXECUTING must still win (result discarded), never be overtaken
        # by a concurrent resolution.
        with self._state_lock:
            if self._cancel_requested:
                self._mark_cancelled()
                return
            self.state = RequestState.RESOLVED
            self._completion = completion
            self.resolved_ms = self.request.arrival_ms + completion.latency_ms
            if self._tracer is not None:
                self._tracer.instant(
                    "resolve",
                    parent=self.span,
                    cat="request",
                    race_resolution=completion.race_resolution,
                    latency_ms=completion.latency_ms,
                    model=completion.model_name,
                )
                self._tracer.end(self.span)
            self._event.set()

    def _end_queued(self) -> None:
        """Close the queued-period span (idempotent; no-op untraced)."""
        if self._tracer is not None and self._queued_span is not None:
            self._tracer.end(self._queued_span)

    def _mark_cancelled(self) -> None:
        self.state = RequestState.CANCELLED
        if self._tracer is not None:
            self._end_queued()
            self._tracer.instant("cancel", parent=self.span, cat="request")
            self._tracer.end(self.span)
        self._event.set()

    def _requeue(self) -> bool:
        """Send a SCHEDULED/EXECUTING request back to QUEUED — its batch
        was lost to a replica failure and it holds no result.

        A ``cancel()`` that raced the lost execution wins here (the
        request will never produce a result to discard, so it cancels
        now).  Returns True iff the request is QUEUED again and should
        re-enter the admission queue.
        """
        with self._state_lock:
            if self.done():
                return False
            if self._cancel_requested:
                self._mark_cancelled()
                return False
            if self.state not in (
                RequestState.SCHEDULED, RequestState.EXECUTING
            ):
                return False
            self.state = RequestState.QUEUED
            self.scheduled_ms = None
            self.requeues += 1
            if self._tracer is not None:
                self._tracer.instant(
                    "requeue", parent=self.span, cat="request",
                    requeues=self.requeues,
                )
                self._queued_span = self._tracer.start(
                    "queued",
                    parent=self.span,
                    cat="request",
                    track=self.span.track if self.span is not None else None,
                    requeue=self.requeues,
                )
            return True

    def _mark_rejected(self) -> bool:
        """Admission-side terminal transition (overload shed).

        Only a QUEUED request can be rejected — it never reached a batch,
        so there is no execution to discard.  A racing ``cancel()`` keeps
        its meaning: whoever takes ``_state_lock`` first wins the terminal
        state.  Returns True iff this call performed the transition (the
        admission queue's rejection counters track only real rejections).
        """
        with self._state_lock:
            if self.state is not RequestState.QUEUED:
                return False
            self.state = RequestState.REJECTED
            if self._tracer is not None:
                self._end_queued()
                self._tracer.instant("shed", parent=self.span, cat="request")
                self._tracer.end(self.span)
            self._event.set()
            return True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"InferenceFuture(rid={self.request.rid}, state={self.state.value})"
        )
