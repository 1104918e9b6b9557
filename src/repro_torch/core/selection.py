"""MDInference's three-stage probabilistic model selection (paper §V-A).

Two implementations are provided:

* :func:`select_ref` — a direct, readable Python transliteration of the
  paper's algorithm.  One request at a time.  This is the oracle used in
  tests.
* :func:`selection_probabilities` — stages 1–3 vectorized over a batch of
  requests in torch float32 (the serving scheduler samples from its rows).
  The keyed sampler ``select_batch`` of the JAX package serves only the
  simulator and is not ported yet.

Stage 1 (greedy base, Eq. 1–2):
    maximize A(m) subject to mu(m) + sigma(m) < T_budget.
    If no model satisfies the constraint the *fastest* model is chosen and
    execution begins immediately (no exploration).

Stage 2 (exploration set, Eq. 3):
    M_E = { m : mu(m) in [mu(m_b) - sigma(m_b), mu(m_b) + sigma(m_b)] }.

Stage 3 (utility sampling, Eq. 4):
    U(m) = A(m) * (T_budget - (mu(m)+sigma(m))) / |T_budget - mu(m)|,
    normalized over M_E, sampled.

Notes on faithfulness:
  * Eq. 4 can yield negative utilities for M_E members that violate the
    latency constraint; a negative selection probability is meaningless, so
    we clamp utilities at zero before normalizing (the paper's stage 3 is
    described as "accounting for" such members — clamping removes them).
    If *every* utility clamps to zero we fall back to the base model.
  * ``utility_power`` (default 1.0) is a beyond-paper knob: probabilities are
    proportional to ``U**utility_power``.  1.0 reproduces Eq. 4 exactly;
    larger values sharpen selection toward the max-utility model.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.registry import ModelRegistry

__all__ = [
    "SelectionResult",
    "compute_budget",
    "select_ref",
    "selection_probabilities",
]

_EPS = 1e-9


def compute_budget(t_sla_ms, t_nw_ms):
    """``T_budget = T_sla - T_nw`` (paper §V-A)."""
    return t_sla_ms - t_nw_ms


@dataclasses.dataclass(frozen=True)
class SelectionResult:
    """Outcome of one selection."""

    index: int  # model chosen for execution
    base_index: int  # stage-1 base model m_b
    fallback: bool  # True when stage 1 found no feasible model
    exploration_set: tuple[int, ...]  # indices of M_E (empty on fallback)
    probabilities: tuple[float, ...]  # selection probs aligned with M_E


# ---------------------------------------------------------------------------
# Reference (per-request, plain Python) implementation.
# ---------------------------------------------------------------------------
def select_ref(
    registry: ModelRegistry,
    t_budget_ms: float,
    rng: np.random.Generator,
    *,
    utility_power: float = 1.0,
) -> SelectionResult:
    """Paper-faithful single-request selection."""
    profiles = registry.profiles

    # Stage 1: greedy base model.
    eligible = [i for i, p in enumerate(profiles) if p.mu_ms + p.sigma_ms < t_budget_ms]
    if not eligible:
        fastest = registry.fastest_index
        return SelectionResult(
            index=fastest,
            base_index=fastest,
            fallback=True,
            exploration_set=(),
            probabilities=(),
        )
    base = max(eligible, key=lambda i: (profiles[i].accuracy, -profiles[i].mu_ms))
    mu_b, sig_b = profiles[base].mu_ms, profiles[base].sigma_ms

    # Stage 2: exploration set around the base model.
    explore = [
        i
        for i, p in enumerate(profiles)
        if mu_b - sig_b <= p.mu_ms <= mu_b + sig_b
    ]

    # Stage 3: utility-weighted sampling.
    utils = []
    for i in explore:
        p = profiles[i]
        denom = abs(t_budget_ms - p.mu_ms) + _EPS
        u = p.accuracy * (t_budget_ms - (p.mu_ms + p.sigma_ms)) / denom
        utils.append(max(u, 0.0) ** utility_power if u > 0 else 0.0)
    total = sum(utils)
    if total <= 0.0:
        return SelectionResult(
            index=base,
            base_index=base,
            fallback=False,
            exploration_set=tuple(explore),
            probabilities=tuple(0.0 for _ in explore),
        )
    probs = [u / total for u in utils]
    choice = explore[int(rng.choice(len(explore), p=probs))]
    return SelectionResult(
        index=choice,
        base_index=base,
        fallback=False,
        exploration_set=tuple(explore),
        probabilities=tuple(probs),
    )


# ---------------------------------------------------------------------------
# Vectorized (batched) implementation, torch float32.
# ---------------------------------------------------------------------------
def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def selection_probabilities(
    accuracy,
    mu,
    sigma,
    t_budget,
    *,
    utility_power: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stages 1–3 without sampling.

    Args:
      accuracy, mu, sigma: (N,) model profile arrays (cast to float32).
      t_budget: (R,) per-request budgets in ms (cast to float32).

    Returns:
      (probs (R, N) float32, base_index (R,) int32, fallback (R,) bool).
      On fallback rows ``probs`` is a one-hot of the fastest model.
    """
    accuracy, mu, sigma = _f32(accuracy), _f32(mu), _f32(sigma)
    t_budget = _f32(t_budget)
    squeeze = t_budget.dim() == 0
    t_budget = torch.atleast_1d(t_budget)[:, None]  # (R, 1)
    n = mu.shape[0]

    fits = (mu + sigma)[None, :] < t_budget  # (R, N)
    any_fit = fits.any(dim=-1)  # (R,)

    # Stage 1: among feasible models maximize accuracy, tie-break on lower mu.
    score = accuracy[None, :] - _EPS * mu[None, :]
    base_index = torch.argmax(torch.where(fits, score, float("-inf")), dim=-1)
    fastest = torch.argmin(mu)
    base_index = torch.where(any_fit, base_index, fastest).to(torch.int32)

    # Stage 2: exploration set around the base model.
    mu_b = mu[base_index.long()][:, None]  # (R, 1)
    sig_b = sigma[base_index.long()][:, None]
    in_me = (mu[None, :] >= mu_b - sig_b) & (mu[None, :] <= mu_b + sig_b)

    # Stage 3: utilities (Eq. 4), clamped at zero, normalized over M_E.
    denom = torch.abs(t_budget - mu[None, :]) + _EPS
    util = accuracy[None, :] * (t_budget - (mu + sigma)[None, :]) / denom
    util = torch.where(in_me, torch.clamp_min(util, 0.0), 0.0)
    util = torch.where(util > 0, util**utility_power, 0.0)
    total = util.sum(dim=-1, keepdim=True)

    base_onehot = F.one_hot(base_index.long(), n).to(util.dtype)
    fastest_onehot = F.one_hot(torch.full_like(base_index.long(), int(fastest)), n).to(util.dtype)
    probs = torch.where(total > 0, util / torch.clamp_min(total, _EPS), base_onehot)
    probs = torch.where(any_fit[:, None], probs, fastest_onehot)
    if squeeze:
        return probs[0], base_index[0], ~any_fit[0]
    return probs, base_index, ~any_fit
