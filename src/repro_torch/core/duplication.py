"""Request duplication — the latency-bounding half of MDInference (§V-B).

Every request is executed twice: remotely (with the selected model) and
locally on a fast "on-device" model.  Whichever of the following happens
resolves the request:

* the remote response arrives before the SLA expires  -> remote result used;
* the SLA expires first                               -> on-device result used.

With an on-device model faster than the SLA this bounds *every* request's
latency at the SLA — the paper's "no SLA violations" claim.  In datacenter
terms this is hedged execution (Sparrow / power-of-two-choices [29, 30]) and
doubles as our straggler mitigation in the serving layer.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.core.registry import ModelProfile

__all__ = ["OnDeviceModel", "DuplicationOutcome", "resolve_duplication"]


# The paper's on-device duplicate: MobileNetV1_128 0.25, the model "most
# likely to complete within any SLA for all tested mobile devices"; top-1
# 41.4 % on ILSVRC-2012 (TFLite hosted-models table).  Mobile execution
# latency ~=30 ms on the devices of Fig 2.
DEFAULT_ON_DEVICE = ModelProfile(
    name="MobileNetV1_128 0.25 (on-device)", accuracy=41.4, mu_ms=30.0, sigma_ms=3.0
)

OnDeviceModel = ModelProfile  # alias: any profile may serve as the duplicate


class DuplicationOutcome(NamedTuple):
    """Vectorized resolution of duplicated requests.

    Carries the per-tier latencies the race was resolved on — with a real
    hedge tier these are *measured* wall times (one per execution tier),
    with the simulator they are profile samples.
    """

    used_remote: np.ndarray  # (R,) bool — remote result arrived within SLA
    accuracy: np.ndarray  # (R,) accuracy of the result actually used
    latency_ms: np.ndarray  # (R,) user-observed response latency
    violation: np.ndarray  # (R,) bool — SLA missed even with duplication
    remote_ms: np.ndarray  # (R,) remote tier's end-to-end latency
    ondevice_ms: np.ndarray  # (R,) on-device duplicate's latency


def resolve_duplication(
    remote_latency_ms: np.ndarray,
    remote_accuracy: np.ndarray,
    ondevice_latency_ms: np.ndarray,
    ondevice_accuracy: float,
    t_sla_ms: float,
) -> DuplicationOutcome:
    """Resolve each duplicated request.

    Args:
      remote_latency_ms: (R,) end-to-end remote latency (network + execution).
      remote_accuracy: (R,) accuracy of the remotely-selected models.
      ondevice_latency_ms: (R,) local execution latency of the duplicate —
        measured hedge-tier wall time on the serving path, a profile sample
        in simulation.
      ondevice_accuracy: accuracy of the on-device model.
      t_sla_ms: the response-time SLA.
    """
    remote_latency_ms = np.asarray(remote_latency_ms)
    ondevice_latency_ms = np.asarray(ondevice_latency_ms)
    used_remote = remote_latency_ms <= t_sla_ms
    accuracy = np.where(used_remote, remote_accuracy, ondevice_accuracy)
    # If the remote result misses, the framework returns the duplicate's
    # result when the SLA expires (or when the duplicate finishes, if later).
    fallback_latency = np.maximum(ondevice_latency_ms, t_sla_ms)
    latency = np.where(used_remote, remote_latency_ms, fallback_latency)
    # A violation with duplication requires the on-device model itself to be
    # slower than the SLA (possible only for SLAs below ~the duplicate's mu).
    violation = ~used_remote & (ondevice_latency_ms > t_sla_ms)
    return DuplicationOutcome(
        used_remote=used_remote,
        accuracy=accuracy,
        latency_ms=latency,
        violation=violation,
        remote_ms=remote_latency_ms,
        ondevice_ms=ondevice_latency_ms,
    )


@dataclasses.dataclass(frozen=True)
class HedgePolicy:
    """Serving-layer knob: when to issue the duplicate.

    ``always`` reproduces the paper.  ``deadline_headroom_ms`` is a
    beyond-paper energy/cost optimization (paper §VII "Energy Consumption"):
    skip the duplicate when the estimated budget leaves at least this much
    headroom over the base model's mu+3sigma, i.e. when the hedge is very
    unlikely to be needed.
    """

    always: bool = True
    deadline_headroom_ms: float = 0.0

    def should_hedge(
        self, t_budget_ms: np.ndarray, base_mu: np.ndarray, base_sigma: np.ndarray
    ) -> np.ndarray:
        if self.always:
            return np.ones(np.shape(t_budget_ms), dtype=bool)
        slack = np.asarray(t_budget_ms) - (base_mu + 3.0 * base_sigma)
        return slack < self.deadline_headroom_ms
