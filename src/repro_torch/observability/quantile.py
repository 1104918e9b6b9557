"""Shared quantile math for summaries, CLIs, and histograms.

Every layer that reports a tail — :func:`repro_torch.core.sla.summarize`, the
``launch/serve`` summary block, the benchmark derived strings, and the
log-bucketed histograms' percentile accessor — routes through this one
helper, so "p99" means the same interpolation everywhere (NumPy's
``linear`` method: the historical ``np.percentile`` default every
regression pin was measured under).

The helpers are *empty-input-safe*: an empty sample returns ``default``
(NaN unless overridden) instead of raising — a shed-everything tick or a
zero-completion run reports an honest "no data" rather than crashing the
summary path.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["quantile", "percentiles"]


def quantile(values, q: float, default: float = float("nan")) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear interpolation.

    Matches ``np.percentile(values, q)`` exactly on non-empty input;
    returns ``default`` on an empty sample.
    """
    arr = np.asarray(values, dtype=float).ravel()
    if arr.size == 0:
        return float(default)
    return float(np.percentile(arr, q))


def percentiles(
    values, qs: Sequence[float], default: float = float("nan")
) -> List[float]:
    """Vector form of :func:`quantile`: one value per entry of ``qs``."""
    arr = np.asarray(values, dtype=float).ravel()
    if arr.size == 0:
        return [float(default)] * len(qs)
    return [float(v) for v in np.percentile(arr, list(qs))]
