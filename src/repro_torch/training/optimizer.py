"""AdamW + LR schedule, the JAX package's ``training/optimizer.py`` in PyTorch.

Optimizer moments are f32 whatever the parameter dtype; the update is
computed in f32 and cast back (bf16-weight training).  Global-norm clipping
is fused into the update.  ``torch.optim.AdamW`` is not used: it keeps its
moments in the parameter dtype and orders the arithmetic differently.

Unlike the JAX package, whose arrays are immutable, :func:`adamw_update`
updates the parameter and moment tensors **in place** (and returns the
same tensors): at full width a second copy of the f32 moments would not
fit beside the first.  Leaves are updated in slices of at most
``_SLICE_ELEMS`` elements so the f32 temporaries stay small.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["OptimizerConfig", "init_opt_state", "adamw_update", "lr_at"]

_F32 = torch.float32
_SLICE_ELEMS = 1 << 26  # 64 Mi elements: 256 MiB per f32 temporary


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio * lr`` (f32 scalar)."""
    step = torch.as_tensor(step, dtype=_F32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    frac = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = frac.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def init_opt_state(params):
    """f32 zero moments shaped like ``params`` and an int32 step count."""
    zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.stack([g.float().square().sum() for g in tree_leaves(tree)]).sum().sqrt()


def _slices(t: torch.Tensor):
    """Row slices of ``t`` (views) of at most ``_SLICE_ELEMS`` elements."""
    if t.dim() == 0 or t.numel() <= _SLICE_ELEMS:
        return [t]
    rows = max(1, _SLICE_ELEMS // max(t[0].numel(), 1))
    return list(t.split(rows))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params, grads, opt_state, gnorm=None):
    """One AdamW step, in place.  Returns ``(params, opt_state, metrics)``:
    the same parameter and moment tensors, updated, the incremented step
    and ``{"grad_norm", "lr"}`` (f32 scalars).  ``gnorm``: the clip's global
    norm when ``grads`` hold shards of the gradient (the sharded train
    step passes the norm over every shard); by default ``global_norm``.
    On meta tensors (the dry-run) the schedule is taken at step 1."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-9), max=1.0)

    b1, b2 = cfg.beta1, cfg.beta2
    step_f = torch.tensor(1 if step.is_meta else int(step), dtype=_F32)
    corr1 = float(1.0 - torch.tensor(b1, dtype=_F32) ** step_f)
    corr2 = float(1.0 - torch.tensor(b2, dtype=_F32) ** step_f)
    lr_t = lr_at(cfg, step_f)
    lr = float(lr_t)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])):
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            gf = gs.float() * scale
            ms.mul_(b1).add_((1 - b1) * gf)
            vs.mul_(b2).add_((1 - b2) * gf * gf)
            delta = (ms / corr1) / ((vs / corr2).sqrt_().add_(cfg.eps))
            pf = ps.float()
            if cfg.weight_decay:
                delta.add_(cfg.weight_decay * pf)
            ps.copy_(pf - lr * delta)
    new_opt = {"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}
    return params, new_opt, {"grad_norm": gnorm, "lr": lr_t}
