"""Baseline selection algorithms the paper compares against (§VI), in
probability form.

Every algorithm is exposed via :data:`POLICY_PROBABILITIES`:

    fn(accuracy, mu, sigma, t_sla, t_budget, utility_power=...)
        -> (probs (R, N), base_index (R,), fallback (R,))

Each row of ``probs`` is the per-request selection distribution over the
zoo (deterministic policies yield one-hot rows), computed in torch
float32.  The batched online scheduler samples from these rows host-side
with a pre-drawn uniform per request, which keeps its random stream
independent of chunking.  ``t_sla`` is the raw SLA (the *static greedy*
baseline ignores the network and budgets against the full SLA);
``t_budget`` is the network-aware budget.  ``fallback`` marks requests for
which stage 1 found no feasible model.

The keyed samplers of the JAX package (``ALGORITHMS``) serve only the
simulator and are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.selection import selection_probabilities

__all__ = [
    "POLICY_PROBABILITIES",
    "get_policy_probabilities",
]

_EPS = 1e-9


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _greedy_at(accuracy, mu, sigma, budget):
    """argmax accuracy s.t. mu+sigma < budget; fastest if none fits."""
    budget = torch.atleast_1d(budget)[:, None]
    fits = (mu + sigma)[None, :] < budget
    any_fit = fits.any(dim=-1)
    score = accuracy[None, :] - _EPS * mu[None, :]
    idx = torch.argmax(torch.where(fits, score, float("-inf")), dim=-1)
    idx = torch.where(any_fit, idx, torch.argmin(mu)).to(torch.int32)
    return idx, ~any_fit


def _exploration_mask(accuracy, mu, sigma, t_budget):
    """Stages 1+2 shared by the related-* ablations."""
    probs, base_index, fallback = selection_probabilities(
        accuracy, mu, sigma, t_budget
    )
    mu_b = mu[base_index.long()][:, None]
    sig_b = sigma[base_index.long()][:, None]
    in_me = (mu[None, :] >= mu_b - sig_b) & (mu[None, :] <= mu_b + sig_b)
    return in_me, base_index, fallback


def _one_hot_rows(index, n):
    return F.one_hot(index.long(), n).to(torch.float32)


def _full_index(t_budget, value):
    return torch.full(t_budget.shape, int(value), dtype=torch.int32)


def mdinference_probs(accuracy, mu, sigma, t_sla, t_budget, *, utility_power=1.0):
    return selection_probabilities(
        accuracy, mu, sigma, torch.atleast_1d(_f32(t_budget)),
        utility_power=utility_power,
    )


def static_greedy_probs(accuracy, mu, sigma, t_sla, t_budget, *, utility_power=1.0):
    accuracy, mu, sigma, t_budget = map(_f32, (accuracy, mu, sigma, t_budget))
    idx, fb = _greedy_at(accuracy, mu, sigma, torch.broadcast_to(_f32(t_sla), t_budget.shape))
    return _one_hot_rows(idx, accuracy.shape[0]), idx, fb


def budget_greedy_probs(accuracy, mu, sigma, t_sla, t_budget, *, utility_power=1.0):
    accuracy, mu, sigma, t_budget = map(_f32, (accuracy, mu, sigma, t_budget))
    idx, fb = _greedy_at(accuracy, mu, sigma, t_budget)
    return _one_hot_rows(idx, accuracy.shape[0]), idx, fb


def static_accuracy_probs(accuracy, mu, sigma, t_sla, t_budget, *, utility_power=1.0):
    accuracy, t_budget = _f32(accuracy), _f32(t_budget)
    idx = _full_index(t_budget, torch.argmax(accuracy))
    return (_one_hot_rows(idx, accuracy.shape[0]), idx,
            torch.zeros(t_budget.shape, dtype=torch.bool))


def static_latency_probs(accuracy, mu, sigma, t_sla, t_budget, *, utility_power=1.0):
    accuracy, mu, t_budget = _f32(accuracy), _f32(mu), _f32(t_budget)
    idx = _full_index(t_budget, torch.argmin(mu))
    return (_one_hot_rows(idx, accuracy.shape[0]), idx,
            torch.zeros(t_budget.shape, dtype=torch.bool))


def pure_random_probs(accuracy, mu, sigma, t_sla, t_budget, *, utility_power=1.0):
    accuracy, mu, t_budget = _f32(accuracy), _f32(mu), _f32(t_budget)
    n = accuracy.shape[0]
    probs = torch.full(t_budget.shape + (n,), 1.0 / n, dtype=torch.float32)
    # No stage-1 base: hedging decisions fall back to the fastest profile.
    base = _full_index(t_budget, torch.argmin(mu))
    return probs, base, torch.zeros(t_budget.shape, dtype=torch.bool)


def related_random_probs(accuracy, mu, sigma, t_sla, t_budget, *, utility_power=1.0):
    accuracy, mu, sigma, t_budget = map(_f32, (accuracy, mu, sigma, t_budget))
    in_me, base, fb = _exploration_mask(accuracy, mu, sigma, t_budget)
    count = torch.clamp_min(in_me.sum(dim=-1, keepdim=True), 1)
    probs = torch.where(in_me, 1.0 / count.to(torch.float32), 0.0).to(torch.float32)
    fastest_onehot = _one_hot_rows(_full_index(t_budget, torch.argmin(mu)), accuracy.shape[0])
    probs = torch.where(fb[:, None], fastest_onehot, probs)
    return probs, base, fb


def related_accurate_probs(accuracy, mu, sigma, t_sla, t_budget, *, utility_power=1.0):
    accuracy, mu, sigma, t_budget = map(_f32, (accuracy, mu, sigma, t_budget))
    in_me, base, fb = _exploration_mask(accuracy, mu, sigma, t_budget)
    score = accuracy[None, :] - _EPS * mu[None, :]
    idx = torch.argmax(torch.where(in_me, score, float("-inf")), dim=-1)
    idx = torch.where(fb, torch.argmin(mu), idx).to(torch.int32)
    return _one_hot_rows(idx, accuracy.shape[0]), base, fb


POLICY_PROBABILITIES: Dict[str, Callable] = {
    "mdinference": mdinference_probs,
    "static_greedy": static_greedy_probs,
    "budget_greedy": budget_greedy_probs,
    "static_accuracy": static_accuracy_probs,
    "static_latency": static_latency_probs,
    "pure_random": pure_random_probs,
    "related_random": related_random_probs,
    "related_accurate": related_accurate_probs,
    "oracle": budget_greedy_probs,
}


def get_policy_probabilities(name: str) -> Callable:
    try:
        return POLICY_PROBABILITIES[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; available: {sorted(POLICY_PROBABILITIES)}"
        ) from None
