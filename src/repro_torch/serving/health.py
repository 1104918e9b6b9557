"""Per-replica health state: circuit breakers + drain flags.

The pool becomes *dynamic* here: every :class:`repro_torch.serving.cluster.Replica`
carries a :class:`ReplicaHealth`, and routing consults it each pick — a
replica leaves the eligible set the same tick its breaker opens or a drain
begins, and rejoins the same tick a half-open probe succeeds.

The breaker is the classic three-state machine::

        failure (fatal, or consecutive >= threshold)
    CLOSED ──────────────────────────────────────────▶ OPEN (reason, open_until)
      ▲                                                  │ cooldown elapses
      │ probe succeeds                                   ▼
      └───────────────────────────────────────────── HALF_OPEN
                 probe fails ──▶ back to OPEN (cooldown backs off)

* **closed** — healthy; every completion feeds the consecutive-failure
  counter (any success resets it).
* **open** — not routable; carries the trip ``reason`` and ``open_until_ms``
  (loop-clock).  Fatal trips (worker death, timeout) open immediately;
  ordinary execution errors must accumulate ``failure_threshold``
  consecutively.  Repeated trips back the cooldown off exponentially, so a
  flapping replica converges to long quarantines instead of oscillating.
* **half_open** — the cooldown elapsed; exactly *one* probe batch may be
  routed (``on_dispatch`` claims it).  Success closes the breaker and
  resets the backoff; failure re-opens with the next-longer cooldown.

A *permanent* trip (``open_until_ms = inf`` — an operator ``kill``) never
half-opens; only an explicit :meth:`CircuitBreaker.reset` (rejoin) recovers
it.  Draining is orthogonal: a draining replica is unroutable regardless of
breaker state, but its in-flight batches finish normally.

All timing is in loop-clock milliseconds (the serving loop's trace time,
fed through ``ClusterBackend.advance_clock``), so breaker behavior is
deterministic under the sync/CI dispatch mode.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

__all__ = ["BreakerConfig", "CircuitBreaker", "ReplicaHealth"]


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Tunables of one replica's circuit breaker."""

    failure_threshold: int = 3  # consecutive errors that trip a closed breaker
    cooldown_ms: float = 1_000.0  # first open period (loop-clock ms)
    backoff: float = 2.0  # cooldown multiplier per consecutive trip
    max_cooldown_ms: float = 30_000.0  # backoff ceiling

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {self.failure_threshold}"
            )
        if self.cooldown_ms <= 0:
            raise ValueError(f"cooldown_ms must be > 0, got {self.cooldown_ms}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")


class CircuitBreaker:
    """Three-state (closed / open / half-open) failure isolator.

    Not internally locked: all transitions happen on the serving loop's
    tick thread (routing, completion collection) — the cluster layer is
    the single writer.
    """

    def __init__(self, cfg: BreakerConfig = BreakerConfig()):
        self.cfg = cfg
        self.state = "closed"
        self.reason: Optional[str] = None
        self.open_until_ms: Optional[float] = None
        self.consecutive_failures = 0
        self.trips = 0  # lifetime trip count (drives the cooldown backoff)
        self._probe_inflight = False
        # Optional observability hookup (set by the cluster layer, which
        # knows the replica id).  None keeps transitions metric-free.
        self._obs = None
        self._obs_labels: dict = {}
        self._obs_track: Optional[str] = None

    def attach_observability(self, obs, track: Optional[str] = None, **labels):
        """Wire trip/recovery events to a metrics+trace handle.

        ``labels`` (e.g. ``replica="2"``) tag the counters; ``track``
        places the ``breaker.trip`` instants on that trace row.
        """
        self._obs = obs
        self._obs_labels = labels
        self._obs_track = track

    # -- inspection -----------------------------------------------------------
    @property
    def healthy(self) -> bool:
        return self.state == "closed"

    @property
    def permanently_open(self) -> bool:
        return self.state == "open" and self.open_until_ms == math.inf

    # -- routing-side ---------------------------------------------------------
    def routable(self, now_ms: float) -> bool:
        """Whether a batch may be routed here at ``now_ms``.

        An open breaker whose cooldown elapsed transitions to half-open
        *here* (routing is the observer of time); half-open admits exactly
        one probe at a time — claimed by :meth:`on_dispatch`, not by this
        check, so pure eligibility queries (``hosted_mask``) never consume
        the probe slot.
        """
        if self.state == "closed":
            return True
        if self.state == "open":
            if self.open_until_ms is not None and now_ms >= self.open_until_ms:
                self.state = "half_open"
                self._probe_inflight = False
                return True
            return False
        return not self._probe_inflight  # half_open: one probe at a time

    def on_dispatch(self, now_ms: float) -> None:
        """A batch was routed here; a half-open breaker's probe slot is
        now claimed until that batch completes."""
        if self.state == "half_open":
            self._probe_inflight = True

    # -- completion-side ------------------------------------------------------
    def on_success(self, now_ms: float) -> None:
        """A routed batch completed: close the breaker, reset the backoff."""
        if self._obs is not None and self.state != "closed":
            self._obs.counter(
                "breaker_recoveries_total", **self._obs_labels
            ).inc()
        self.state = "closed"
        self.reason = None
        self.open_until_ms = None
        self.consecutive_failures = 0
        self.trips = 0
        self._probe_inflight = False

    def on_failure(self, now_ms: float, reason: str, fatal: bool = False) -> None:
        """A routed batch failed.

        ``fatal`` (worker death, timeout) trips immediately; ordinary
        errors trip after ``failure_threshold`` consecutive failures.  A
        half-open probe failure always re-opens (that is the probe's job).
        """
        if self.permanently_open:
            return  # a killed replica stays killed until reset()
        self.consecutive_failures += 1
        if (
            fatal
            or self.state == "half_open"
            or self.consecutive_failures >= self.cfg.failure_threshold
        ):
            self.trip(now_ms, reason)

    def trip(self, now_ms: float, reason: str, permanent: bool = False) -> None:
        """Open the breaker (cooldown backs off per consecutive trip)."""
        if self._obs is not None:
            self._obs.counter(
                "breaker_trips_total", **self._obs_labels
            ).inc()
            self._obs.tracer.instant(
                "breaker.trip",
                cat="health",
                track=self._obs_track,
                reason=reason,
                permanent=permanent,
                now_ms=now_ms,
                **self._obs_labels,
            )
        self.trips += 1
        self.state = "open"
        self.reason = reason
        self._probe_inflight = False
        if permanent:
            self.open_until_ms = math.inf
        else:
            cooldown = min(
                self.cfg.cooldown_ms * self.cfg.backoff ** (self.trips - 1),
                self.cfg.max_cooldown_ms,
            )
            self.open_until_ms = now_ms + cooldown

    def reset(self) -> None:
        """Operator rejoin: forget all failure history and close."""
        self.state = "closed"
        self.reason = None
        self.open_until_ms = None
        self.consecutive_failures = 0
        self.trips = 0
        self._probe_inflight = False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        extra = f", reason={self.reason!r}" if self.reason else ""
        return f"CircuitBreaker({self.state}{extra})"


class ReplicaHealth:
    """One replica's routability: breaker state + drain flag.

    ``draining`` removes the replica from routing without tripping the
    breaker — in-flight batches complete, nothing new arrives, and
    ``undrain``/rejoin restores it instantly (drain is an operator
    action, not a failure).
    """

    def __init__(self, breaker: Optional[CircuitBreaker] = None):
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.draining = False

    def routable(self, now_ms: float) -> bool:
        return not self.draining and self.breaker.routable(now_ms)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        drain = ", draining" if self.draining else ""
        return f"ReplicaHealth({self.breaker.state}{drain})"
