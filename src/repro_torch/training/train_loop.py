"""Train-step factory, the JAX package's ``training/train_loop.py`` in PyTorch.

``make_train_step`` closes over the model / optimizer configs and returns
``train_step(state, batch) -> (state, metrics)``: gradients of
:func:`repro_torch.models.transformer.loss_fn` (remat per period, as the
config says), optional microbatch accumulation in f32, optional int8
gradient compression with error feedback, then AdamW.  PyTorch runs
eagerly, so there is nothing to jit; the state is updated in place (see
:mod:`repro_torch.training.optimizer`).  On one GPU there is no mesh: the
JAX package's ``state_axes`` / ``state_shardings`` / ``batch_shardings``
wait for the multi-GPU tooling.

The train state is ``{"params", "opt": {"mu", "nu", "step"}}`` plus
``"error_fb"`` under compression, the JAX package's tree; parameters are
leaf tensors with ``requires_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import compression
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import OptimizerConfig, adamw_update, init_opt_state
from repro_torch.tree import named_leaves, tree_map

__all__ = ["TrainConfig", "init_train_state", "train_state_from_numpy", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1  # gradient accumulation over the batch's lead dim
    grad_compression: bool = False  # int8 + error feedback on the exchange


def _trainable(params):
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def init_train_state(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                     train_cfg: TrainConfig = TrainConfig(), device="cuda"):
    """Seeded parameters (``transformer.init_params``), zero f32 moments,
    step 0, and zero error feedback under compression, on ``device``."""
    params = _trainable(transformer.init_params(cfg, generator, device=device))
    state = {"params": params, "opt": init_opt_state(params)}
    if train_cfg.grad_compression:
        state["error_fb"] = compression.init_error_feedback(params)
    return state


def train_state_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The train-state bridge: the JAX package's ``init_train_state`` tree
    mapped to numpy (``jax.tree.map(np.asarray, state)``) as this package's
    train state.  Parameters go through ``transformer.params_from_numpy``;
    the moments and the error feedback stay f32; the step is an int32
    scalar.  Starts both packages from the same state."""
    dev = resolve_device(device)
    params = _trainable(transformer.params_from_numpy(cfg, tree["params"], device=dev))

    def f32(like, arr):
        t = transformer.numpy_to_torch(arr)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"shape {tuple(t.shape)} != parameter shape {tuple(like.shape)}")
        return t.to(device=dev, dtype=torch.float32)

    opt = tree["opt"]
    state = {
        "params": params,
        "opt": {
            "mu": tree_map(f32, params, opt["mu"]),
            "nu": tree_map(f32, params, opt["nu"]),
            "step": torch.tensor(int(opt["step"]), dtype=torch.int32, device=dev),
        },
    }
    if "error_fb" in tree:
        state["error_fb"] = tree_map(f32, params, tree["error_fb"])
    return state


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    train_cfg: TrainConfig = TrainConfig()):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``
    holds ``tokens`` and ``labels`` (B, S) on the state's device; the
    metrics are ``loss``, ``grad_norm``, ``lr``, ``xent``, ``aux`` and
    ``tokens`` (f32 scalars)."""

    unreached = transformer.unreached_leaves(cfg)

    def grads_of(params, batch):
        loss, metrics = transformer.loss_fn(cfg, params, batch)
        # A leaf no input reaches gets a zero gradient, as jax.grad gives
        # it; any other leaf cut off from the loss makes autograd raise.
        leaves = list(named_leaves(params))
        reached = iter(torch.autograd.grad(
            loss, [p for name, p in leaves if name not in unreached]))
        grads = iter([torch.zeros_like(p) if name in unreached else next(reached)
                      for name, p in leaves])
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(grads), params))

    def compute_grads(params, batch):
        n = train_cfg.microbatches
        if n <= 1:
            return grads_of(params, batch)
        B = next(iter(batch.values())).shape[0]
        per = B // n
        loss_a = None
        for i in range(n):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, mb)
            if loss_a is None:
                loss_a, metrics_a = loss, metrics
                grads_a = tree_map(lambda g: g.float(), grads)
            else:
                loss_a = loss_a + loss
                metrics_a = {k: metrics_a[k] + metrics[k] for k in metrics_a}
                tree_map(lambda a, g: a.add_(g), grads_a, grads)
            del grads
        grads_a = tree_map(lambda g: g.div_(n), grads_a)
        metrics_a = {k: (v if k == "tokens" else v / n) for k, v in metrics_a.items()}
        return loss_a / n, metrics_a, grads_a

    def train_step(state, batch):
        loss, metrics, grads = compute_grads(state["params"], batch)
        new_state = dict(state)
        if train_cfg.grad_compression:
            grads, new_state["error_fb"] = compression.quantize_dequantize(
                grads, state["error_fb"])
        params, opt, opt_metrics = adamw_update(opt_cfg, state["params"], grads, state["opt"])
        new_state["params"] = params
        new_state["opt"] = opt
        return new_state, {"loss": loss, **opt_metrics, **metrics}

    return train_step
