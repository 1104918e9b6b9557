"""Trace-driven load generation for the serving front.

Produces :class:`LoadTrace` objects — per-request arrival timestamps plus
network times (and the server's estimate of them) — that drive both the
offline scheduler (``MDInferenceScheduler.run_trace`` consumes the network
columns) and the live engine (``ServingEngine.serve_queue`` consumes
arrival-windowed chunks, i.e. continuous batching ticks).

Arrival processes:

* :class:`PoissonArrivals` — memoryless open-loop traffic at a target rate.
* :class:`BurstyArrivals` — a two-state Markov-modulated Poisson process:
  most of the time the base rate, occasionally a burst at
  ``burst_factor`` × the base rate (flash crowds / synchronized clients).
* :class:`OverloadArrivals` — a sustained overload phase: base-rate
  Poisson, then ``overload_factor`` × the base rate for a contiguous span
  of the stream, then base again (the adversarial input for the bounded
  admission queue's backpressure policies).
* :class:`RampArrivals` — the rate ramps linearly from ``rate_start_rps``
  to ``rate_end_rps`` across the stream (capacity-crossing sweeps: find
  where a policy starts shedding).
* :class:`DiurnalArrivals` — a smooth ramp-up-and-back-down (half-sine)
  rate profile: trough → peak → trough across the stream, the
  diurnal-drift input for the adaptive admission controller.
* :class:`SpikeArrivals` — steady Poisson arrivals paired with a
  *service-time* spike schedule (:meth:`SpikeArrivals.service_factor`):
  for a contiguous span of the horizon service times multiply by
  ``spike_factor`` (the 30x per-replica swings of "A Note on Latency
  Variability of DNNs for Mobile Inference").  The arrival stream itself
  stays steady — the drift is in the service model.
* :class:`MixedTenantArrivals` — two concurrent *tagged* lanes: an
  interactive Poisson lane plus a batch flood lane, each request carrying
  its tenant name (the adversarial input for the multi-tenant QoS lanes:
  does the flood destroy the interactive tenant's p99?).

Units: every rate parameter (``rate_rps``, ``rate_start_rps``, …) is in
**requests per second**; every timestamp and gap these processes emit is
in **milliseconds** (mean gap = ``1e3 / rate_rps`` ms).  Doubling a rate
halves the expected gaps, i.e. a 2x-rate trace yields ~2x the arrivals
inside any fixed horizon.

Network times come from any :class:`repro_torch.core.network.NetworkModel`; the
named paper traces (university / residential / LTE) are exposed through
:data:`repro_torch.core.network.NAMED_TRACES`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.network import Estimator, NetworkModel

__all__ = [
    "ArrivalProcess",
    "PoissonArrivals",
    "BurstyArrivals",
    "OverloadArrivals",
    "RampArrivals",
    "DiurnalArrivals",
    "SpikeArrivals",
    "MixedTenantArrivals",
    "LoadTrace",
    "make_trace",
    "iter_windows",
]


class ArrivalProcess:
    """Samples per-request arrival timestamps (ms, non-decreasing).

    Rate parameters on all subclasses are in requests per *second*
    (``*_rps``); emitted timestamps are in *milliseconds*.
    """

    def sample_arrivals_ms(self, rng: np.random.Generator, n: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless open-loop traffic: exponential gaps with mean
    ``1e3 / rate_rps`` ms (``rate_rps`` is in requests per second)."""

    rate_rps: float = 100.0

    def sample_arrivals_ms(self, rng, n):
        gaps = rng.exponential(1e3 / self.rate_rps, size=n)
        return np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """Two-state MMPP: base-rate Poisson with exponential-length bursts.

    ``p_enter`` / ``p_exit`` are per-request transition probabilities, so
    the expected burst length is ``1 / p_exit`` requests.
    """

    rate_rps: float = 100.0
    burst_factor: float = 8.0
    p_enter: float = 0.02
    p_exit: float = 0.2

    def sample_arrivals_ms(self, rng, n):
        base_gap = 1e3 / self.rate_rps
        burst_gap = base_gap / self.burst_factor
        gaps = np.empty(n)
        flips = rng.random(n)
        raw = rng.exponential(1.0, size=n)
        in_burst = False
        for i in range(n):
            if in_burst:
                if flips[i] < self.p_exit:
                    in_burst = False
            elif flips[i] < self.p_enter:
                in_burst = True
            gaps[i] = raw[i] * (burst_gap if in_burst else base_gap)
        return np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class OverloadArrivals(ArrivalProcess):
    """Sustained overload: a contiguous span of the stream arrives at
    ``overload_factor`` × the base rate.

    ``rate_rps`` is in requests per **second** (arrival timestamps are in
    ms; the overloaded span's mean gap is
    ``1e3 / (rate_rps * overload_factor)`` ms).
    ``overload_start`` / ``overload_stop`` are fractions of the *request
    stream* (not wall time): requests with index in
    ``[start*n, stop*n)`` use the overloaded rate.  The default is a
    2× overload over the middle half — long enough that an unbounded
    pending queue visibly diverges while bounded policies stay flat.
    """

    rate_rps: float = 100.0
    overload_factor: float = 2.0
    overload_start: float = 0.25
    overload_stop: float = 0.75

    def __post_init__(self):
        if not 0.0 <= self.overload_start <= self.overload_stop <= 1.0:
            raise ValueError(
                "need 0 <= overload_start <= overload_stop <= 1, got "
                f"[{self.overload_start}, {self.overload_stop})"
            )
        if self.overload_factor <= 0:
            raise ValueError(
                f"overload_factor must be > 0, got {self.overload_factor}"
            )

    def sample_arrivals_ms(self, rng, n):
        idx = np.arange(n)
        in_overload = (idx >= self.overload_start * n) & (
            idx < self.overload_stop * n
        )
        rate = np.where(
            in_overload, self.rate_rps * self.overload_factor, self.rate_rps
        )
        gaps = rng.exponential(1.0, size=n) * (1e3 / rate)
        return np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class RampArrivals(ArrivalProcess):
    """Linear rate ramp across the stream: ``rate_start_rps`` for the first
    request through ``rate_end_rps`` for the last (Poisson gaps at the
    instantaneous rate).  Both rates are in requests per **second**; the
    emitted arrival timestamps are in ms (instantaneous mean gap
    ``1e3 / rate_rps``).  Sweeps the offered load through the serving
    tier's capacity — where queue wait starts growing is the knee.
    """

    rate_start_rps: float = 50.0
    rate_end_rps: float = 200.0

    def __post_init__(self):
        if self.rate_start_rps <= 0 or self.rate_end_rps <= 0:
            raise ValueError(
                "ramp rates must be > 0, got "
                f"{self.rate_start_rps} -> {self.rate_end_rps}"
            )

    def sample_arrivals_ms(self, rng, n):
        frac = np.arange(n) / max(n - 1, 1)
        rate = self.rate_start_rps + frac * (
            self.rate_end_rps - self.rate_start_rps
        )
        gaps = rng.exponential(1.0, size=n) * (1e3 / rate)
        return np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Half-sine diurnal profile: the rate ramps smoothly from
    ``trough_rps`` up to ``peak_rps`` at mid-stream and back down
    (``rate(i) = trough + (peak - trough) * sin(pi * i / n)``).

    Rates are in requests per **second**; arrival timestamps are in ms.
    This is the slow-drift input for the adaptive admission controller: a
    static capacity tuned for the trough over-admits at the peak, one
    tuned for the peak over-sheds in the shoulders.
    """

    trough_rps: float = 50.0
    peak_rps: float = 300.0

    def __post_init__(self):
        if self.trough_rps <= 0 or self.peak_rps <= 0:
            raise ValueError(
                "diurnal rates must be > 0, got "
                f"{self.trough_rps} / {self.peak_rps}"
            )

    def sample_arrivals_ms(self, rng, n):
        frac = np.arange(n) / max(n - 1, 1)
        rate = self.trough_rps + (self.peak_rps - self.trough_rps) * np.sin(
            np.pi * frac
        )
        gaps = rng.exponential(1.0, size=n) * (1e3 / rate)
        return np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class SpikeArrivals(ArrivalProcess):
    """Steady Poisson arrivals plus a *service-time* spike schedule.

    Arrivals are plain Poisson at ``rate_rps`` (requests per second, ms
    timestamps) — the drift lives in the service model:
    :meth:`service_factor` returns ``spike_factor`` for loop-clock times
    inside ``[spike_start, spike_stop)`` (fractions of a given horizon)
    and ``1.0`` outside it.  Scenario harnesses fold it into the
    ``drain_trace`` ``service_model`` (and the backend's reported wall
    times) to realize a 30x per-replica service swing without changing
    the offered load.
    """

    rate_rps: float = 100.0
    spike_factor: float = 30.0
    spike_start: float = 0.4
    spike_stop: float = 0.6

    def __post_init__(self):
        if not 0.0 <= self.spike_start <= self.spike_stop <= 1.0:
            raise ValueError(
                "need 0 <= spike_start <= spike_stop <= 1, got "
                f"[{self.spike_start}, {self.spike_stop})"
            )
        if self.spike_factor <= 0:
            raise ValueError(
                f"spike_factor must be > 0, got {self.spike_factor}"
            )

    def sample_arrivals_ms(self, rng, n):
        gaps = rng.exponential(1e3 / self.rate_rps, size=n)
        return np.cumsum(gaps)

    def service_factor(self, t_ms: float, horizon_ms: float) -> float:
        """Service-time multiplier at loop-clock time ``t_ms`` of a run
        whose trace spans ``horizon_ms``."""
        if horizon_ms <= 0:
            return 1.0
        frac = t_ms / horizon_ms
        if self.spike_start <= frac < self.spike_stop:
            return float(self.spike_factor)
        return 1.0


@dataclasses.dataclass(frozen=True)
class MixedTenantArrivals(ArrivalProcess):
    """Two concurrent tagged lanes: interactive Poisson + a batch flood.

    Both lanes run over the same horizon; of ``n`` sampled requests, the
    lanes get counts proportional to their rates (so the merged stream
    realizes both offered rates simultaneously).  :meth:`sample_tagged`
    returns ``(arrival_ms, tenant)`` with per-request tenant names —
    :func:`make_trace` detects it and emits a tagged
    :class:`LoadTrace` that :meth:`repro_torch.serving.loop.ServingLoop.drain_trace`
    forwards into each request's ``tenant`` field.
    """

    interactive_rps: float = 50.0
    batch_rps: float = 200.0
    interactive_tenant: str = "interactive"
    batch_tenant: str = "batch"

    def __post_init__(self):
        if self.interactive_rps <= 0 or self.batch_rps <= 0:
            raise ValueError(
                "lane rates must be > 0, got "
                f"{self.interactive_rps} / {self.batch_rps}"
            )

    def sample_tagged(self, rng, n):
        """Sample ``(arrival_ms, tenant)`` — merged, arrival-sorted."""
        if n == 0:
            return np.zeros(0), np.zeros(0, dtype=object)
        frac = self.interactive_rps / (self.interactive_rps + self.batch_rps)
        n_int = int(round(n * frac))
        if n >= 2:  # both lanes present whenever there is room for both
            n_int = min(max(n_int, 1), n - 1)
        n_bat = n - n_int
        t_int = np.cumsum(
            rng.exponential(1e3 / self.interactive_rps, size=n_int)
        )
        t_bat = np.cumsum(rng.exponential(1e3 / self.batch_rps, size=n_bat))
        arrival = np.concatenate([t_int, t_bat])
        tenant = np.asarray(
            [self.interactive_tenant] * n_int + [self.batch_tenant] * n_bat,
            dtype=object,
        )
        order = np.argsort(arrival, kind="stable")
        return arrival[order], tenant[order]

    def sample_arrivals_ms(self, rng, n):
        return self.sample_tagged(rng, n)[0]


@dataclasses.dataclass(frozen=True)
class LoadTrace:
    """One generated request stream (arrival-ordered)."""

    arrival_ms: np.ndarray  # (R,) non-decreasing arrival timestamps
    t_nw_ms: np.ndarray  # (R,) actual round-trip network times
    t_nw_est_ms: np.ndarray  # (R,) server-side estimates of t_nw_ms
    # (R,) per-request tenant names (object dtype), or None for an
    # untagged single-class stream — the compatibility default.
    tenant: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.arrival_ms)

    @property
    def duration_ms(self) -> float:
        return float(self.arrival_ms[-1]) if len(self.arrival_ms) else 0.0

    @property
    def offered_rps(self) -> float:
        d = self.duration_ms
        return len(self) / (d / 1e3) if d > 0 else float("inf")


def make_trace(
    n: int,
    arrivals: ArrivalProcess,
    network: NetworkModel,
    estimator: Optional[Estimator] = None,
    seed: int = 0,
) -> LoadTrace:
    """Draw a request stream: arrivals x network times x estimates.

    ``arrivals`` rate parameters are in requests per **second**; all
    columns of the returned :class:`LoadTrace` (``arrival_ms``,
    ``t_nw_ms``, ``t_nw_est_ms``) are in **milliseconds**.
    """
    rng = np.random.default_rng(seed)
    tenant = None
    sample_tagged = getattr(arrivals, "sample_tagged", None)
    if sample_tagged is not None:
        arrival_ms, tenant = sample_tagged(rng, n)
    else:
        arrival_ms = arrivals.sample_arrivals_ms(rng, n)
    t_nw = network.sample(rng, n)
    t_est = t_nw if estimator is None else estimator.estimate(rng, t_nw)
    return LoadTrace(
        arrival_ms=np.asarray(arrival_ms, dtype=np.float64),
        t_nw_ms=np.asarray(t_nw, dtype=np.float64),
        t_nw_est_ms=np.asarray(t_est, dtype=np.float64),
        tenant=tenant,
    )


def iter_windows(trace: LoadTrace, window_ms: float) -> Iterator[np.ndarray]:
    """Group a trace into scheduling-tick windows (continuous batching).

    Yields index arrays: all requests whose arrival falls in
    ``[k*window_ms, (k+1)*window_ms)``, in arrival order, skipping empty
    windows.  Every request appears in exactly one window.
    """
    if window_ms <= 0:
        raise ValueError(f"window_ms must be > 0, got {window_ms}")
    n = len(trace)
    if n == 0:
        return
    buckets = np.floor_divide(trace.arrival_ms, window_ms).astype(np.int64)
    start = 0
    while start < n:
        stop = int(np.searchsorted(buckets, buckets[start], side="right"))
        yield np.arange(start, stop)
        start = stop
