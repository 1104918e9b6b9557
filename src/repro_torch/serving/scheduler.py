"""MDInference as a first-class serving scheduler — batched online core.

Online version of the paper's algorithm: per request it estimates the
network time, budgets, runs the three-stage selection, and hedges with the
fast tier (straggler mitigation).  Unlike the offline simulator it also
*updates* the latency profiles from observed execution times (EWMA on mu and
sigma) — the paper's stage-3 exploration exists precisely so that stale
profiles (queueing transients, concept drift, §V-A) get re-discovered; the
online update closes that loop.

Batched API
-----------
The scheduler operates on *chunks* of requests at once:

* :meth:`MDInferenceScheduler.decide_batch` — vectorized selection for a
  chunk of network-time estimates.  Selection probabilities come from the
  torch float32 policy registry
  (:data:`repro_torch.core.baselines.POLICY_PROBABILITIES`, ``mdinference``
  by default, on the CPU); the concrete model per request is sampled
  host-side by inverse-CDF against a pre-drawn uniform, so the random
  stream is *independent of chunking*.
* :meth:`MDInferenceScheduler.observe_batch` — folds a chunk of observed
  execution times into the live EWMA profiles, replaying each model's
  observations in arrival order (bit-identical to scalar ``observe`` calls).
* :meth:`MDInferenceScheduler.run_trace` — chunked trace-driven loop.  All
  randomness (selection uniforms, execution z-scores, on-device z-scores)
  is drawn up-front, so ``chunk_size=1`` and ``chunk_size=1024`` consume
  identical draws.  With ``profile_ewma=0`` the two produce *identical*
  model choices and metrics; with EWMA on, chunking freezes the profiles
  within a chunk (selection sees chunk-start profiles) and the paths agree
  within statistical tolerance.

``chunk_size=1`` is the scalar reference path; the per-request
:meth:`decide` / :meth:`observe` methods are thin wrappers over the chunk
API and remain the convenient interface for interactive use.

Two-tier hedge resolution
-------------------------
:meth:`MDInferenceScheduler.resolve_chunk` resolves hedged requests against
the on-device duplicate.  The *primary* path receives measured on-device
wall times (``ondevice_ms``) from a real hedge-tier execution
(:class:`repro_torch.serving.backend.OnDeviceBackend` via
``ServingEngine.serve_queue``); sampling the on-device latency profile
survives only as the simulator fallback (``ondevice_ms=None`` — what
:meth:`run_trace` uses).  Measured hedge executions fold into a live
on-device EWMA profile (:meth:`observe_ondevice`) exactly like remote
observations fold into the per-model profiles.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.baselines import get_policy_probabilities
from repro_torch.core.duplication import HedgePolicy, resolve_duplication
from repro_torch.core.registry import ModelProfile, ModelRegistry
from repro_torch.core.sla import RequestMetrics, summarize

__all__ = [
    "SchedulerConfig",
    "MDInferenceScheduler",
    "Decision",
    "BatchDecision",
    "pad_to_pow2",
]

_EXEC_FLOOR_MS = 0.1


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    t_sla_ms: float = 250.0
    utility_power: float = 1.0
    hedge: HedgePolicy = dataclasses.field(default_factory=HedgePolicy)
    profile_ewma: float = 0.05  # 0 disables online profile updates
    seed: int = 0
    algorithm: str = "mdinference"  # any repro_torch.core.baselines policy
    chunk_size: int = 256  # 1 == scalar reference path
    # Sub-chunk profile refresh for run_trace: selection normally sees the
    # chunk-start profile snapshot for the whole chunk; with this set, a
    # chunk is served in sub-chunks of this many requests and the EWMA
    # snapshot refreshes between them — drift shows up mid-chunk instead
    # of one whole chunk late.  Mechanically this caps the effective
    # serving stride at min(chunk_size, subchunk_refresh): it exists as a
    # separate knob so callers can bound snapshot *staleness* without
    # redefining the batching granularity their jit shapes / callers are
    # tuned to (the pre-drawn randomness makes the two commute; see the
    # identity test).  None keeps the frozen-snapshot behavior.
    subchunk_refresh: Optional[int] = None

    def __post_init__(self):
        if self.subchunk_refresh is not None and self.subchunk_refresh < 1:
            raise ValueError(
                "subchunk_refresh must be >= 1 or None, "
                f"got {self.subchunk_refresh}"
            )


@dataclasses.dataclass
class Decision:
    model_index: int
    model_name: str
    hedged: bool
    t_budget_ms: float
    fallback: bool


@dataclasses.dataclass
class BatchDecision:
    """Vectorized scheduling decision for a chunk of requests."""

    model_index: np.ndarray  # (C,) int — model chosen per request
    base_index: np.ndarray  # (C,) int — stage-1 base (hedging reference)
    hedged: np.ndarray  # (C,) bool
    t_budget_ms: np.ndarray  # (C,) float
    fallback: np.ndarray  # (C,) bool

    def __len__(self) -> int:
        return len(self.model_index)

    def scalar(self, i: int, names: list[str]) -> Decision:
        return Decision(
            model_index=int(self.model_index[i]),
            model_name=names[int(self.model_index[i])],
            hedged=bool(self.hedged[i]),
            t_budget_ms=float(self.t_budget_ms[i]),
            fallback=bool(self.fallback[i]),
        )


@functools.lru_cache(maxsize=None)
def _policy(algorithm: str, utility_power: float):
    """The (probs, base, fallback) function of one (policy, power)."""
    fn = get_policy_probabilities(algorithm)

    def run(accuracy, mu, sigma, t_sla, t_budget):
        return fn(
            accuracy, mu, sigma, t_sla, t_budget, utility_power=utility_power
        )

    return run


def pad_to_pow2(n: int) -> int:
    """Round a chunk/batch length up to a power of two.

    The serving loop pads generate batches to these row counts, which
    bounds the set of batch shapes a backend warms up.
    """
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


class MDInferenceScheduler:
    def __init__(
        self,
        registry: ModelRegistry,
        ondevice: ModelProfile,
        cfg: SchedulerConfig = SchedulerConfig(),
    ):
        self.base_registry = registry
        self.ondevice = ondevice
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # Live profile estimates (start from the registry's priors).  The
        # EWMA tracks the variance; ``sigma`` is its derived view (kept in
        # sync so the fold avoids lossy sqrt/square round trips).
        self.mu = registry.mu.astype(np.float64).copy()
        self.sigma = registry.sigma.astype(np.float64).copy()
        self._var = self.sigma**2
        # Live on-device (hedge-tier) profile: seeded from the prior, refined
        # by measured hedge executions (observe_ondevice).
        self.ondevice_mu = float(ondevice.mu_ms)
        self.ondevice_sigma = float(ondevice.sigma_ms)
        self._ondevice_var = self.ondevice_sigma**2
        self.accuracy = registry.accuracy.astype(np.float64).copy()
        self.names = registry.names
        self._policy = _policy(cfg.algorithm, cfg.utility_power)
        # Mid-flight join accounting (continuous-batching tier): per-model
        # EWMA of time-to-first-token for requests grafted into the
        # persistent decode batch.  Purely observational — selection stays
        # a function of the execution profiles — but it is the signal a
        # future admission policy would gate joins on, and the bench
        # reports it alongside the latency rows.
        self.join_ttft_mu = np.full(len(self.names), np.nan)
        self._join_var = np.zeros(len(self.names))
        self.join_count = np.zeros(len(self.names), dtype=np.int64)
        self._log: list[dict] = []
        # Optional repro_torch.observability.Observability handle (set by the
        # serving loop).  None keeps every path free of metric writes.
        self.observability = None

    # -- batched decision path ----------------------------------------------
    def decide_batch(
        self,
        t_nw_est_ms: np.ndarray,
        *,
        uniforms: Optional[np.ndarray] = None,
        eligible: Optional[np.ndarray] = None,
    ) -> BatchDecision:
        """Vectorized selection for a chunk of network-time estimates.

        ``uniforms`` (one U[0,1) draw per request) lets callers pre-draw the
        sampling randomness; when omitted the scheduler's own rng is used.

        ``eligible`` is an optional bool mask over the zoo (one entry per
        model): selection places zero probability on masked-out models.
        The serving loop passes the cluster's hosted-variant mask
        (:meth:`repro_torch.serving.cluster.ClusterBackend.hosted_mask`) so a
        partial zoo sharding constrains selection — routing never has to
        place a row on a replica that doesn't host its variant.  An
        all-True mask is exactly the unmasked path (bit-identical); a
        request whose eligible models all have zero selection mass falls
        back to the fastest eligible model (``fallback`` set).
        """
        t_nw_est_ms = np.atleast_1d(np.asarray(t_nw_est_ms, dtype=np.float64))
        n = len(t_nw_est_ms)
        budgets = self.cfg.t_sla_ms - t_nw_est_ms
        if uniforms is None:
            uniforms = self.rng.random(n)
        if eligible is not None:
            eligible = np.asarray(eligible, dtype=bool)
            if eligible.shape != (len(self.names),):
                raise ValueError(
                    f"eligible mask must have shape ({len(self.names)},), "
                    f"got {eligible.shape}"
                )
            if not eligible.any():
                raise ValueError("eligible mask excludes every model")
            if eligible.all():
                eligible = None  # the unmasked path, bit-identical

        # The policy runs in float32 on the CPU over the float64 live
        # profiles (rows are independent: no padding needed without jit).
        probs, base, fallback = self._policy(
            torch.as_tensor(self.accuracy, dtype=torch.float32),
            torch.as_tensor(self.mu, dtype=torch.float32),
            torch.as_tensor(self.sigma, dtype=torch.float32),
            torch.tensor(self.cfg.t_sla_ms, dtype=torch.float32),
            torch.as_tensor(budgets, dtype=torch.float32),
        )
        probs = probs.numpy().astype(np.float64)
        base = base.numpy().astype(np.int64)
        fallback = fallback.numpy()

        if eligible is not None:
            # Placement-aware selection: zero the masked-out models.  A
            # request left with no selection mass falls back to the
            # fastest eligible model; the hedging reference (base) is
            # remapped there too when the stage-1 base is ineligible.
            probs = np.where(eligible[None, :], probs, 0.0)
            fastest = int(
                np.flatnonzero(eligible)[np.argmin(self.mu[eligible])]
            )
            dead = probs.sum(axis=1) <= 0.0
            if dead.any():
                probs[dead, fastest] = 1.0
                fallback = fallback | dead
            base = np.where(eligible[base], base, fastest)

        # Inverse-CDF sampling against the pre-drawn uniforms: the result for
        # request i depends only on (profiles, budget_i, u_i), never on chunk
        # boundaries.  `<=` (not `<`) so u == 0.0 still lands on the first
        # positive-mass index rather than unconditionally picking index 0.
        cum = np.cumsum(probs, axis=1)
        total = cum[:, -1:]
        idx = np.minimum(
            (cum <= uniforms[:, None] * total).sum(axis=1), probs.shape[1] - 1
        ).astype(np.int64)

        hedged = np.asarray(
            self.cfg.hedge.should_hedge(budgets, self.mu[base], self.sigma[base]),
            dtype=bool,
        )
        return BatchDecision(
            model_index=idx,
            base_index=base,
            hedged=hedged,
            t_budget_ms=budgets,
            fallback=fallback,
        )

    # -- the paper's per-request path (scalar wrappers) ----------------------
    def decide(self, t_nw_est_ms: float) -> Decision:
        d = self.decide_batch(np.asarray([t_nw_est_ms]))
        return d.scalar(0, self.names)

    def _ewma_fold(self, mu: float, var: float, xs: np.ndarray) -> tuple[float, float]:
        a = self.cfg.profile_ewma
        for x in xs:
            delta = x - mu
            mu += a * delta
            var = max((1 - a) * (var + a * delta * delta), 1e-6)
        return mu, var

    def observe_batch(self, model_index: np.ndarray, exec_ms: np.ndarray):
        """Fold a chunk of observations into the EWMA profiles.

        Observations are replayed per model in arrival order, so the result
        is identical to issuing scalar :meth:`observe` calls one by one.
        """
        obs = self.observability
        if obs is not None:
            mi = np.atleast_1d(np.asarray(model_index))
            ex = np.atleast_1d(np.asarray(exec_ms, dtype=np.float64))
            for m, x in zip(mi, ex):
                obs.histogram(
                    "scheduler_observed_exec_ms", model=self.names[int(m)]
                ).record(float(x))
        if self.cfg.profile_ewma <= 0:
            return
        model_index = np.atleast_1d(np.asarray(model_index))
        exec_ms = np.atleast_1d(np.asarray(exec_ms, dtype=np.float64))
        for m in np.unique(model_index):
            self.mu[m], self._var[m] = self._ewma_fold(
                self.mu[m], self._var[m], exec_ms[model_index == m]
            )
            self.sigma[m] = np.sqrt(self._var[m])
            if obs is not None:
                obs.gauge(
                    "scheduler_mu_ms", model=self.names[int(m)]
                ).set(float(self.mu[m]))

    def observe(self, model_index: int, exec_ms: float):
        """EWMA profile update from an observed execution (drift handling)."""
        self.observe_batch(np.asarray([model_index]), np.asarray([exec_ms]))

    def observe_ondevice(self, exec_ms: np.ndarray):
        """Fold measured hedge-tier executions into the live on-device profile.

        Same EWMA as :meth:`observe_batch`, applied to the duplicate tier:
        the sampled-hedge fallback (and hedging heuristics built on the
        on-device profile) track the real hedge variant instead of a
        static prior.
        """
        if self.cfg.profile_ewma <= 0:
            return
        self.ondevice_mu, self._ondevice_var = self._ewma_fold(
            self.ondevice_mu,
            self._ondevice_var,
            np.atleast_1d(np.asarray(exec_ms, dtype=np.float64)),
        )
        self.ondevice_sigma = float(np.sqrt(self._ondevice_var))
        if self.observability is not None:
            self.observability.gauge("scheduler_ondevice_mu_ms").set(
                self.ondevice_mu
            )

    def observe_join(self, model_index: np.ndarray, ttft_ms: np.ndarray):
        """Fold mid-flight continuous-batching joins into the TTFT profile.

        ``ttft_ms`` is each joined request's measured prefill-to-first-token
        wall time (stamped by the continuous backend at graft).  Same
        per-model replay-in-order EWMA as :meth:`observe_batch`."""
        if self.cfg.profile_ewma <= 0:
            return
        model_index = np.atleast_1d(np.asarray(model_index))
        ttft_ms = np.atleast_1d(np.asarray(ttft_ms, dtype=np.float64))
        for m in np.unique(model_index):
            xs = ttft_ms[model_index == m]
            mu = self.join_ttft_mu[m]
            if np.isnan(mu):  # first observation seeds the EWMA
                mu, self._join_var[m] = float(xs[0]), 0.0
                xs = xs[1:]
            self.join_ttft_mu[m], self._join_var[m] = self._ewma_fold(
                mu, self._join_var[m], xs
            )
            self.join_count[m] += int((model_index == m).sum())
            if self.observability is not None:
                self.observability.gauge(
                    "scheduler_join_ttft_mu_ms", model=self.names[int(m)]
                ).set(float(self.join_ttft_mu[m]))

    # -- outcome resolution ---------------------------------------------------
    def resolve_chunk(
        self,
        decision: BatchDecision,
        remote_latency_ms: np.ndarray,
        ondevice_ms: Optional[np.ndarray] = None,
        ondevice_wait_ms: float | np.ndarray = 0.0,
        t_sla_ms: float | np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Resolve a chunk through hedged duplication.

        ``ondevice_ms`` is the duplicate's *execution* latency per request —
        measured wall times from a real hedge-tier execution on the primary
        path (``ServingEngine.serve_queue`` with an ``OnDeviceBackend``).
        When omitted the duplicate is *simulated* by sampling the live
        on-device profile — the fallback used by :meth:`run_trace` and the
        reference behavior for equivalence tests.

        ``ondevice_wait_ms`` is the delay before the duplicate *starts*
        (the serving front passes each request's queue wait: the duplicate
        is launched at the dispatch tick, not at arrival).  It is added to
        the duplicate's race clock so SLA accounting stays honest under
        queueing; pure simulation has no queue and leaves it 0.

        ``t_sla_ms`` overrides the scheduler-wide SLA — a scalar or a
        per-request vector (the serving loop passes per-request SLAs from
        :attr:`repro_torch.serving.lifecycle.QueuedRequest.sla_ms`).

        Returns ``(accuracy_used, latency_ms, used_remote, ondevice_ms)``;
        the last element echoes the duplicate's from-arrival latencies
        actually raced (wait + execution).  Non-hedged requests keep their
        remote outcome; hedged requests race the on-device duplicate via
        :func:`resolve_duplication`.
        """
        remote_latency_ms = np.asarray(remote_latency_ms, dtype=np.float64)
        n = len(remote_latency_ms)
        if ondevice_ms is None:
            ondevice_ms = np.maximum(
                self.ondevice_mu
                + self.ondevice_sigma * self.rng.standard_normal(n),
                _EXEC_FLOOR_MS,
            )
        ondevice_ms = np.asarray(ondevice_ms, dtype=np.float64) + ondevice_wait_ms
        if t_sla_ms is None:
            t_sla_ms = self.cfg.t_sla_ms
        sel_acc = self.accuracy[decision.model_index]
        out = resolve_duplication(
            remote_latency_ms,
            sel_acc,
            ondevice_ms,
            self.ondevice.accuracy,
            t_sla_ms,
        )
        acc_used = np.where(decision.hedged, out.accuracy, sel_acc)
        latency = np.where(decision.hedged, out.latency_ms, remote_latency_ms)
        used_remote = np.where(decision.hedged, out.used_remote, True)
        return acc_used, latency, used_remote, ondevice_ms

    # -- trace-driven loop ----------------------------------------------------
    def run_trace(
        self,
        t_nw_actual: np.ndarray,
        t_nw_est: Optional[np.ndarray] = None,
        exec_sampler: Optional[Callable[[int, np.random.Generator], float]] = None,
        chunk_size: Optional[int] = None,
    ) -> RequestMetrics:
        """Serve a trace of requests (one per network sample), in chunks.

        All randomness is pre-drawn up-front, so the outcome with
        ``profile_ewma=0`` is independent of ``chunk_size``; with EWMA
        enabled, ``chunk_size=1`` is the scalar reference behavior.

        With :attr:`SchedulerConfig.subchunk_refresh` set, each chunk is
        served in sub-chunks of that many requests, folding observations
        in *between* them: selection no longer sees a profile snapshot
        frozen at chunk start, so drift (queueing transients, §V-A) is
        re-discovered mid-chunk.  With ``profile_ewma=0`` the refresh is a
        no-op and the outcome is bit-identical (the randomness is
        pre-drawn per request, not per chunk).
        """
        t_nw_actual = np.asarray(t_nw_actual, dtype=np.float64)
        if t_nw_est is None:
            t_nw_est = t_nw_actual
        t_nw_est = np.asarray(t_nw_est, dtype=np.float64)
        chunk = self.cfg.chunk_size if chunk_size is None else chunk_size
        if chunk < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk}")
        # Sub-chunk refresh: serve in smaller strides so the EWMA snapshot
        # selection sees is at most `subchunk_refresh` requests stale.
        refresh = self.cfg.subchunk_refresh
        if refresh is not None:
            chunk = min(chunk, refresh)
        n = len(t_nw_actual)

        # Pre-drawn randomness: selection uniforms, execution z-scores,
        # on-device z-scores.  One draw per request regardless of chunking.
        u_sel = self.rng.random(n)
        z_exec = self.rng.standard_normal(n)
        z_ondev = self.rng.standard_normal(n)

        acc_used = np.empty(n)
        lat = np.empty(n)
        used_remote = np.empty(n, bool)
        idxs = np.empty(n, np.int64)

        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            sl = slice(lo, hi)
            d = self.decide_batch(t_nw_est[sl], uniforms=u_sel[sl])
            idxs[sl] = d.model_index
            if exec_sampler is None:
                exec_ms = np.maximum(
                    self.mu[d.model_index]
                    + self.sigma[d.model_index] * z_exec[sl],
                    _EXEC_FLOOR_MS,
                )
            else:
                exec_ms = np.asarray(
                    [exec_sampler(int(m), self.rng) for m in d.model_index]
                )
            self.observe_batch(d.model_index, exec_ms)
            remote = t_nw_actual[sl] + exec_ms
            ondev_ms = np.maximum(
                self.ondevice_mu + self.ondevice_sigma * z_ondev[sl],
                _EXEC_FLOOR_MS,
            )
            acc_used[sl], lat[sl], used_remote[sl], _ = self.resolve_chunk(
                d, remote, ondev_ms
            )
            for j in range(hi - lo):
                self._log.append(
                    {
                        "model": self.names[int(d.model_index[j])],
                        "hedged": bool(d.hedged[j]),
                        "remote_ms": float(remote[j]),
                        "latency_ms": float(lat[lo + j]),
                    }
                )

        return summarize(
            accuracy_used=acc_used,
            latency_ms=lat,
            t_sla_ms=self.cfg.t_sla_ms,
            model_names=self.names,
            model_index=idxs,
            used_remote=used_remote,
        )

    @property
    def log(self):
        return list(self._log)
