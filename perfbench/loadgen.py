"""The one traffic generator: a mix's parameter file in, a request stream out.

A mix (``perfbench/traffic/<name>.json``) gives the arrival process, the
prompt and answer length distributions, the network model, the SLA, the
scheduling window and the cache length.  Every seed gets the same set of
requests in an order of its own: the inter-arrival gaps, prompt lengths,
answer lengths and network times are equally spaced quantiles of their
distributions (so the count and the sizes, the work, are the same on every
seed), and the seed draws the order of each, independently, and the
prompts' tokens.  Due times fall where the gaps put them, on no grid.

Arrival processes: ``poisson``, exponential gaps at ``rate_rps``.

The network model ``residential`` is a frozen copy of the serving stack's
residential trace (gamma body of mean 100 ms and CV 0.56, plus 1.25 % drawn
uniformly from 260-1500 ms; the paper's Table IV calibration).
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np

_MIN_NW_MS = 1.0


def residential_trace(seed: int = 1, n: int = 5000) -> np.ndarray:
    """The residential network trace (ms): the serving stack's
    ``core/network.residential_trace`` with its defaults, frozen here."""
    rng = np.random.default_rng(seed)
    shape = 1.0 / 0.56**2
    body = rng.gamma(shape, 100.0 / shape, size=n)
    tail = rng.uniform(260.0, 1500.0, size=n)
    is_tail = rng.random(n) < 0.0125
    return np.maximum(np.where(is_tail, tail, body), _MIN_NW_MS)


NETWORKS = {"residential": residential_trace}


@dataclasses.dataclass
class Stream:
    """A cell's requests in due order.  Times in ms from the window's start."""

    due_ms: np.ndarray  # (N,) float64, ascending
    prompts: List[np.ndarray]  # N int32 token arrays
    n_steps: np.ndarray  # (N,) answer tokens per request
    nw_ms: np.ndarray  # (N,) network time of each request
    sla_ms: float
    window_ms: float
    max_len: int

    def __len__(self) -> int:
        return len(self.due_ms)


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def arrival_times_ms(arr: dict, seconds: float, rng: np.random.Generator) -> np.ndarray:
    """``round(rate * seconds)`` arrivals whose gaps are the exponential
    distribution's equally spaced quantiles, in an order drawn from
    ``rng``, scaled to span the window; each request comes halfway
    through its gap."""
    if arr["kind"] != "poisson":
        raise ValueError(f"unknown arrival process {arr['kind']!r}")
    n = int(math.floor(float(arr["rate_rps"]) * seconds + 0.5))
    if n == 0:
        return np.zeros(0)
    gaps = -np.log1p(-_quantiles(n))[rng.permutation(n)]
    return (np.cumsum(gaps) - gaps / 2) / gaps.sum() * seconds * 1e3


def prompt_lengths(spec: dict, n: int) -> np.ndarray:
    """Lognormal lengths at the ``n`` equally spaced quantiles, clipped."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    z = np.asarray([NormalDist().inv_cdf(q) for q in _quantiles(n)])
    lengths = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(lengths), spec["min"], spec["max"]).astype(np.int64)


def answer_lengths(spec: dict, n: int) -> np.ndarray:
    """Uniform on ``min..max``: each value as nearly equally often as ``n``
    allows (the remainder from the middle of the quantile grid)."""
    lo, hi = int(spec["min"]), int(spec["max"])
    return lo + np.floor(_quantiles(n) * (hi - lo + 1)).astype(np.int64)


def network_times(name: str, n: int) -> np.ndarray:
    trace = np.sort(NETWORKS[name]())
    idx = np.minimum((_quantiles(n) * len(trace)).astype(np.int64), len(trace) - 1)
    return trace[idx]


def make_stream(mix: dict, seconds: float, seed: int) -> Stream:
    """The cell's request stream over a window of ``seconds``, ordered and
    filled with tokens from ``seed``."""
    rng = np.random.default_rng(seed)
    due = arrival_times_ms(mix["arrivals"], seconds, rng)
    n = len(due)
    lens = prompt_lengths(mix["prompt_tokens"], n)[rng.permutation(n)]
    steps = answer_lengths(mix["answer_tokens"], n)[rng.permutation(n)]
    nw = network_times(mix["network"], n)[rng.permutation(n)]
    vocab = int(mix["token_ids_below"])
    prompts = [rng.integers(0, vocab, int(s), dtype=np.int32) for s in lens]
    if int(lens.max(initial=0)) + int(steps.max(initial=0)) > mix["max_len"]:
        raise ValueError("a prompt and its answer overrun max_len")
    return Stream(due_ms=due, prompts=prompts, n_steps=steps, nw_ms=nw,
                  sla_ms=float(mix["sla_ms"]), window_ms=float(mix["window_ms"]),
                  max_len=int(mix["max_len"]))
