"""Closed-loop adaptive admission control (drift tracking).

MDInference's latency bound is conditional on *variability*: the paper's
university-vs-LTE gap is a network drifting under the client, and "A Note
on Latency Variability of DNNs for Mobile Inference" measures per-replica
service times swinging 30x.  A statically tuned
:class:`~repro_torch.serving.admission.AdmissionConfig` is therefore wrong most
of the time: capacity sized for the diurnal trough over-admits at the
peak, capacity sized for the peak over-sheds in the shoulders.

:class:`AdmissionController` closes the loop.  Each tick it reads the
live signals the stack already produces —

* per-completion queue waits + shed counts from the tick's
  :class:`~repro_torch.serving.loop.TickResult`,
* the scheduler's live service-rate EWMAs (``mu`` / ``ondevice_mu``) and
  join-TTFT EWMA (:class:`~repro_torch.serving.scheduler.MDInferenceScheduler`),
* per-replica ``ewma_wall_ms`` from backend load accounting
  (:meth:`~repro_torch.serving.cluster.ClusterBackend.snapshot`) —

and retunes the queue's ``max_pending`` capacity and ``shed_headroom_ms``
margin through :meth:`AdmissionQueue.retune
<repro_torch.serving.admission.AdmissionQueue.retune>` with a bounded
AIMD-style law:

* **overload** (wait EWMA above the high watermark, or the tick shed) for
  ``hysteresis`` consecutive ticks → *multiplicative decrease* of
  capacity, and the shed margin tightens by the observed wait excess
  (shed earlier, keep the served tail short);
* **underload** (wait EWMA below the low watermark, shed-free) for
  ``hysteresis`` consecutive ticks → *additive increase* of capacity and
  a *multiplicative decay* of the margin (stop over-shedding);
* everything clamped to ``[min_pending, max_pending]`` /
  ``[0, max headroom]``, with the hysteresis streaks resetting on any
  neutral tick — a single spike never flaps the queue.

``controller=None`` on the loop is the compatibility default and is
byte-identical to the static config (regression-pinned).  The controller
itself is deterministic: no randomness, no wall clock — two seeded runs
retune identically (the drift gauntlet's seeded-twin pin).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serving.admission import AdmissionQueue

__all__ = ["ControllerConfig", "AdmissionController"]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Law constants for :class:`AdmissionController` (all clamped)."""

    # The wait target: queue wait should stay below this fraction of the
    # loop SLA (served requests keep most of their budget for execution).
    target_wait_frac: float = 0.2
    low_water: float = 0.5  # underload below low_water x target wait
    high_water: float = 1.0  # overload above high_water x target wait
    wait_alpha: float = 0.4  # EWMA fold for the observed tick wait
    hysteresis: int = 2  # consecutive breaches before the law acts
    # Capacity law (AIMD): additive increase / multiplicative decrease,
    # clamped to [min_pending, max_pending].
    increase_step: int = 4
    decrease_factor: float = 0.5
    min_pending: int = 2
    max_pending: int = 4096
    # Shed-margin law: under overload the margin tightens by the larger
    # of a service-scaled floor step and the observed wait *excess* over
    # target (so a 30x service swing takes one proportional bite, not
    # thirty fixed ones); in calm it decays multiplicatively.  Clamped to
    # a fraction of SLA.
    headroom_step_frac: float = 0.5
    headroom_decay: float = 0.5
    max_headroom_frac: float = 0.8

    def __post_init__(self):
        if not 0.0 < self.target_wait_frac <= 1.0:
            raise ValueError(
                f"target_wait_frac must be in (0, 1], got {self.target_wait_frac}"
            )
        if not 0.0 <= self.low_water < self.high_water:
            raise ValueError(
                "need 0 <= low_water < high_water, got "
                f"{self.low_water} / {self.high_water}"
            )
        if not 0.0 < self.wait_alpha <= 1.0:
            raise ValueError(f"wait_alpha must be in (0, 1], got {self.wait_alpha}")
        if self.hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {self.hysteresis}")
        if self.increase_step < 1:
            raise ValueError(
                f"increase_step must be >= 1, got {self.increase_step}"
            )
        if not 0.0 < self.decrease_factor < 1.0:
            raise ValueError(
                f"decrease_factor must be in (0, 1), got {self.decrease_factor}"
            )
        if not 1 <= self.min_pending <= self.max_pending:
            raise ValueError(
                "need 1 <= min_pending <= max_pending, got "
                f"{self.min_pending} / {self.max_pending}"
            )
        if not 0.0 <= self.headroom_decay < 1.0:
            raise ValueError(
                f"headroom_decay must be in [0, 1), got {self.headroom_decay}"
            )
        if self.headroom_step_frac < 0 or self.max_headroom_frac < 0:
            raise ValueError("headroom fractions must be >= 0")


class AdmissionController:
    """Bounded AIMD retuner for a live :class:`AdmissionQueue`.

    The loop drives it in two phases per tick: :meth:`observe` folds the
    collected tick's signals into the wait/service EWMAs (and advances
    the hysteresis streaks), :meth:`apply` — called at the top of the
    *next* tick, before admission take — enacts any due retune.  Both are
    no-ops on an unbounded queue (there is no capacity to tune).
    """

    def __init__(self, cfg: Optional[ControllerConfig] = None):
        self.cfg = cfg if cfg is not None else ControllerConfig()
        self.wait_ewma_ms: Optional[float] = None  # observed tick waits
        self.service_est_ms: float = 0.0  # live service estimate (for steps)
        self.sla_ms: float = 0.0  # loop SLA seen at the last observe
        self._over = 0  # consecutive overload ticks
        self._under = 0  # consecutive underload ticks
        self._shed_last = False  # last observed tick shed something
        self._tightened_last = False  # previous retune was a tighten
        self.n_ticks = 0
        self.n_retunes = 0
        # (now_ms, max_pending, shed_headroom_ms) after each retune —
        # the gauntlet's evidence that the law actually moved the knobs.
        self.log: List[Tuple[float, int, float]] = []
        # Optional repro_torch.observability.Observability handle (set by the
        # loop); None keeps observe/apply free of metric writes.
        self.observability = None

    # -- phase 1: fold one collected tick's signals ------------------------
    def observe(
        self,
        result,
        *,
        scheduler,
        backend=None,
        now_ms: float = 0.0,
        backlog: int = 0,
    ) -> None:
        """Fold one :class:`~repro_torch.serving.loop.TickResult` into the law's
        EWMAs and hysteresis streaks.  Reads the scheduler's live
        service/join EWMAs and — on a clustered backend — the per-replica
        ``ewma_wall_ms`` load accounting."""
        cfg = self.cfg
        self.n_ticks += 1
        self.sla_ms = float(scheduler.cfg.t_sla_ms)
        self._now_ms = float(now_ms)

        # Live service estimate: the fastest remote variant's EWMA mu,
        # lifted by what the replicas actually report (a slow replica's
        # wall EWMA) and the continuous tier's join TTFT.  This scales the
        # margin steps, so a 30x service swing takes 30x bigger margin
        # bites without retuning the law's constants.
        floor = float(np.min(scheduler.mu))
        walls = []
        snapshot = getattr(backend, "snapshot", None)
        if snapshot is not None:
            walls = [
                s.ewma_wall_ms
                for s in snapshot()
                if s.ewma_wall_ms is not None
                and s.health != "open"
                and not s.draining
            ]
        else:
            wall = getattr(backend, "ewma_wall_ms", None)
            if wall is not None:
                walls = [wall]
        join = np.asarray(
            getattr(scheduler, "join_ttft_mu", 0.0), dtype=float
        )
        finite = join[np.isfinite(join)] if join.size else join
        join_mu = float(np.max(finite)) if finite.size else 0.0
        self.service_est_ms = max(
            floor, max(walls) if walls else 0.0, join_mu
        )

        # Tick wait signal: the *max* completion wait (tail-sensitive) —
        # a tick that only shed carries the previous EWMA forward.
        waits = [c.queue_wait_ms for c in result.completions]
        if waits:
            w = max(waits)
            self.wait_ewma_ms = (
                w
                if self.wait_ewma_ms is None
                else cfg.wait_alpha * w
                + (1.0 - cfg.wait_alpha) * self.wait_ewma_ms
            )
        self._shed_last = result.stats.n_shed > 0

        obs = self.observability
        if obs is not None:
            if self.wait_ewma_ms is not None:
                obs.histogram("controller_wait_ewma_ms").record(
                    self.wait_ewma_ms
                )
            obs.gauge("controller_service_est_ms").set(self.service_est_ms)

        target = cfg.target_wait_frac * self.sla_ms
        wait = self.wait_ewma_ms if self.wait_ewma_ms is not None else 0.0
        overload = self._shed_last or wait > cfg.high_water * target
        underload = (
            not self._shed_last
            and wait < cfg.low_water * target
            and backlog == 0
        )
        if overload:
            self._over += 1
            self._under = 0
        elif underload:
            self._under += 1
            self._over = 0
        else:
            # Neutral zone: both streaks reset — hysteresis demands
            # *consecutive* evidence, so a lone spike never retunes.
            self._over = 0
            self._under = 0

    # -- phase 2: enact any due retune -------------------------------------
    def apply(self, queue: AdmissionQueue) -> bool:
        """Retune ``queue`` if a hysteresis streak is complete.  Returns
        True when a retune happened.  No-op on unbounded queues."""
        cfg = self.cfg
        qcfg = queue.cfg
        if qcfg.max_pending is None or qcfg.policy == "unbounded":
            return False
        pending = qcfg.max_pending
        headroom = qcfg.shed_headroom_ms
        max_headroom = cfg.max_headroom_frac * self.sla_ms
        target = cfg.target_wait_frac * self.sla_ms
        wait = self.wait_ewma_ms if self.wait_ewma_ms is not None else 0.0
        # Proportional tightening: one bite the size of the wait excess
        # (floored by a service-scaled step) reaches the drifted operating
        # point in O(1) retunes instead of O(drift / step).
        step = max(
            cfg.headroom_step_frac * self.service_est_ms, wait - target
        )
        if self._over >= cfg.hysteresis:
            new_pending = max(
                cfg.min_pending, int(pending * cfg.decrease_factor)
            )
            # Bounded escalation: overload that *persists through a
            # tighten* (another full hysteresis streak after the last
            # bite) means the backlog is still draining late — jump the
            # margin to its clamp so the queued tail is trimmed now
            # instead of ratcheting down one drain-interval at a time.
            if self._tightened_last:
                new_headroom = max_headroom
            else:
                new_headroom = min(headroom + step, max_headroom)
            self._tightened_last = True
        elif self._under >= cfg.hysteresis:
            new_pending = min(cfg.max_pending, pending + cfg.increase_step)
            new_headroom = headroom * cfg.headroom_decay
            if new_headroom < 1e-6:
                new_headroom = 0.0
            self._tightened_last = False
        else:
            return False
        self._over = 0
        self._under = 0
        if new_pending == pending and new_headroom == headroom:
            return False
        queue.retune(
            max_pending=new_pending, shed_headroom_ms=new_headroom
        )
        self.n_retunes += 1
        now_ms = getattr(self, "_now_ms", 0.0)
        self.log.append((now_ms, new_pending, new_headroom))
        if self.observability is not None:
            obs = self.observability
            direction = "tighten" if self._tightened_last else "relax"
            obs.counter(
                "controller_retunes_total", direction=direction
            ).inc()
            obs.gauge("controller_max_pending").set(new_pending)
            obs.gauge("controller_shed_headroom_ms").set(new_headroom)
            obs.tracer.instant(
                "controller.retune",
                cat="controller",
                now_ms=now_ms,
                direction=direction,
                max_pending=new_pending,
                shed_headroom_ms=new_headroom,
            )
        return True
