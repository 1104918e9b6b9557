"""Model registry: profiles of functionally-equivalent models.

A *profile* is what MDInference's selection algorithm consumes: an accuracy
(quality) score plus the mean/stddev of the model's execution latency
(Table I of the paper: ``A(m)``, ``mu(m)``, ``sigma(m)``).

The registry is the serving-side catalog.  In the faithful reproduction the
profiles come from the paper's Table III (measured on an EC2 p2.xlarge GPU
server); in the TPU serving integration they are derived from the roofline
analysis of the compiled LM zoo (see ``repro_torch.serving.profiles``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "ModelProfile",
    "ModelRegistry",
]


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """One functionally-equivalent model variant.

    Attributes:
      name: human-readable identifier.
      accuracy: quality score in *percent* (paper uses top-1 %).
      mu_ms: mean execution latency in milliseconds.
      sigma_ms: standard deviation of execution latency in milliseconds.
    """

    name: str
    accuracy: float
    mu_ms: float
    sigma_ms: float

    def fits(self, budget_ms: float) -> bool:
        """Stage-1 eligibility: ``mu + sigma < T_budget`` (paper Eq. 2)."""
        return self.mu_ms + self.sigma_ms < budget_ms


class ModelRegistry:
    """An ordered collection of :class:`ModelProfile` with array views.

    The array views (``accuracy``, ``mu``, ``sigma``) are what the vectorized
    selection math consumes; the list view preserves identity for reporting.
    """

    def __init__(self, profiles: Iterable[ModelProfile]):
        self._profiles: list[ModelProfile] = list(profiles)
        if not self._profiles:
            raise ValueError("registry must contain at least one model")
        names = [p.name for p in self._profiles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names in registry: {names}")

    # -- list-ish API -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._profiles)

    def __iter__(self):
        return iter(self._profiles)

    def __getitem__(self, idx: int) -> ModelProfile:
        return self._profiles[idx]

    @property
    def profiles(self) -> Sequence[ModelProfile]:
        return tuple(self._profiles)

    @property
    def names(self) -> list[str]:
        return [p.name for p in self._profiles]

    def index_of(self, name: str) -> int:
        return self.names.index(name)

    # -- array views --------------------------------------------------------
    @property
    def accuracy(self) -> np.ndarray:
        return np.asarray([p.accuracy for p in self._profiles], dtype=np.float32)

    @property
    def mu(self) -> np.ndarray:
        return np.asarray([p.mu_ms for p in self._profiles], dtype=np.float32)

    @property
    def sigma(self) -> np.ndarray:
        return np.asarray([p.sigma_ms for p in self._profiles], dtype=np.float32)

    # -- derived ------------------------------------------------------------
    @property
    def fastest_index(self) -> int:
        return int(np.argmin(self.mu))

    @property
    def most_accurate_index(self) -> int:
        return int(np.argmax(self.accuracy))

    def without(self, *names: str) -> "ModelRegistry":
        drop = set(names)
        return ModelRegistry([p for p in self._profiles if p.name not in drop])

    def with_profiles(self, extra: Iterable[ModelProfile]) -> "ModelRegistry":
        return ModelRegistry(list(self._profiles) + list(extra))

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        rows = ", ".join(
            f"{p.name}(A={p.accuracy:.1f},mu={p.mu_ms:.2f})" for p in self._profiles
        )
        return f"ModelRegistry([{rows}])"
