"""Empirically-driven simulation engine (paper §VI methodology), the JAX
package's ``core/simulator.py``.

Per simulation: draw ``n_requests`` network times from a network model,
estimate them (the server's 2xT_input measurement), run a selection
algorithm over the zoo, sample execution latencies ~ N(mu, sigma), and
aggregate SLA / accuracy metrics, optionally resolving each request through
the on-device duplication mechanism.

The selection step runs vectorized in torch on ``device`` (``"cuda"``
unless the caller asks for the CPU); the surrounding sampling is NumPy.
The NumPy stream is consumed exactly as the JAX package consumes it
(network, estimate, execution normals, queue spikes, on-device normals),
so every draw outside selection equals the reference's.  Selection's
uniforms come from a generator of their own, seeded from ``cfg.seed`` and
drawn on the host, so the card and the CPU choose the same models.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import baselines
from repro_torch.core.duplication import DEFAULT_ON_DEVICE, resolve_duplication
from repro_torch.core.network import Estimator, ExactEstimator, NetworkModel
from repro_torch.core.registry import ModelProfile, ModelRegistry
from repro_torch.core.sla import RequestMetrics, summarize
from repro_torch.device import resolve_device

__all__ = ["SimConfig", "SimResult", "run_simulation"]

# Offsets the selection generator's seed from the main stream's.
_SELECTION_STREAM = 0x5E1EC7


@dataclasses.dataclass(frozen=True)
class SimConfig:
    registry: ModelRegistry
    algorithm: Union[str, Callable] = "mdinference"
    t_sla_ms: float = 250.0
    n_requests: int = 10_000
    network: NetworkModel = None  # required
    estimator: Estimator = dataclasses.field(default_factory=ExactEstimator)
    duplication: bool = False
    ondevice: ModelProfile = DEFAULT_ON_DEVICE
    seed: int = 0
    utility_power: float = 1.0  # 1.0 == paper-faithful Eq. 4
    queue_delay_mean_ms: float = 0.0  # optional server queueing transients
    queue_spike_prob: float = 0.0


@dataclasses.dataclass(frozen=True)
class SimResult:
    metrics: RequestMetrics
    model_index: np.ndarray  # (R,) selected model per request
    fallback: np.ndarray  # (R,) stage-1 infeasible
    t_nw_ms: np.ndarray  # (R,) actual network time
    exec_ms: np.ndarray  # (R,) remote execution time
    remote_latency_ms: np.ndarray  # (R,) network + execution (+ queue)
    used_remote: Optional[np.ndarray]  # (R,) or None when duplication off


def _run_selection(fn, uniforms, reg: ModelRegistry, t_sla, t_budget, utility_power, device):
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    args = (uniforms, f32(reg.accuracy), f32(reg.mu), f32(reg.sigma), f32(t_sla), f32(t_budget))
    if fn is baselines.mdinference:
        idx, fallback = fn(*args, utility_power=utility_power)
    else:
        idx, fallback = fn(*args)
    return idx.cpu().numpy(), fallback.cpu().numpy()


def run_simulation(cfg: SimConfig, device=None) -> SimResult:
    if cfg.network is None:
        raise ValueError("SimConfig.network is required")
    dev = resolve_device("cuda" if device is None else device)
    rng = np.random.default_rng(cfg.seed)
    reg = cfg.registry
    n = cfg.n_requests

    # 1. Network times and the server's estimate of them.
    t_nw = cfg.network.sample(rng, n)
    t_nw_est = cfg.estimator.estimate(rng, t_nw)
    t_budget = cfg.t_sla_ms - t_nw_est

    # 2. Model selection (vectorized, on the device).
    fn = (
        baselines.get_algorithm(cfg.algorithm)
        if isinstance(cfg.algorithm, str)
        else cfg.algorithm
    )
    uniforms = np.random.default_rng([_SELECTION_STREAM, cfg.seed]).random(n)
    idx, fallback = _run_selection(fn, uniforms, reg, cfg.t_sla_ms, t_budget,
                                   cfg.utility_power, dev)

    # 3. Remote execution latency ~ N(mu, sigma), optional queueing spikes.
    exec_ms = np.maximum(rng.normal(reg.mu[idx], reg.sigma[idx]), 0.1)
    if cfg.queue_spike_prob > 0.0:
        spike = rng.random(n) < cfg.queue_spike_prob
        exec_ms = exec_ms + spike * rng.exponential(cfg.queue_delay_mean_ms, size=n)
    remote_latency = t_nw + exec_ms

    # 4. Resolve (with or without duplication) and summarize.
    if cfg.duplication:
        ondev_ms = np.maximum(
            rng.normal(cfg.ondevice.mu_ms, cfg.ondevice.sigma_ms, size=n), 0.1
        )
        out = resolve_duplication(
            remote_latency_ms=remote_latency,
            remote_accuracy=reg.accuracy[idx],
            ondevice_latency_ms=ondev_ms,
            ondevice_accuracy=cfg.ondevice.accuracy,
            t_sla_ms=cfg.t_sla_ms,
        )
        metrics = summarize(
            accuracy_used=out.accuracy,
            latency_ms=out.latency_ms,
            t_sla_ms=cfg.t_sla_ms,
            model_names=reg.names,
            model_index=idx,
            used_remote=out.used_remote,
        )
        used_remote = out.used_remote
    else:
        metrics = summarize(
            accuracy_used=reg.accuracy[idx],
            latency_ms=remote_latency,
            t_sla_ms=cfg.t_sla_ms,
            model_names=reg.names,
            model_index=idx,
        )
        used_remote = None

    return SimResult(
        metrics=metrics,
        model_index=idx,
        fallback=fallback,
        t_nw_ms=t_nw,
        exec_ms=exec_ms,
        remote_latency_ms=remote_latency,
        used_remote=used_remote,
    )
