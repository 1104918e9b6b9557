"""Train-step factory, the JAX package's ``training/train_loop.py`` in PyTorch.

``make_train_step`` closes over the model / optimizer configs and returns
``train_step(state, batch) -> (state, metrics)``: gradients of
:func:`repro_torch.models.transformer.loss_fn` (remat per period, as the
config says), optional microbatch accumulation in f32, optional int8
gradient compression with error feedback, then AdamW.  PyTorch runs
eagerly, so there is nothing to jit; the state is updated in place (see
:mod:`repro_torch.training.optimizer`).

With a mesh and axis rules the step is data-parallel over the mesh's
batch axes and tensor-parallel over its ``model`` axis, with the state
sharded as :func:`state_shardings` says (DTensors; the weights' ``embed``
dim over ``data``, ``heads`` / ``kv_heads`` / ``ffn`` / ``expert_ffn`` /
``vocab`` over ``model``, as in the JAX package).  Each step all-gathers
every parameter over the batch axes into a plain tensor (so the kernels
see plain tensors): the rank's slice over ``model`` where the model runs
split (:mod:`repro_torch.distributed.tensor_parallel`), the whole leaf
where the leaf is replicated or where a kv head must not be cut.  It runs
this rank's rows of the batch under the rules, reduce-scatters the
gradients onto the shards (all-reduces those of replicated leaves) and
updates the shards.  The arithmetic is the unsharded step's: the loss is
the mean over the global batch's tokens (each rank weights its
cross-entropy by its share of the global token count, and the shares'
gradients are summed), the clip's global norm is taken over every shard,
a compressed leaf's int8 scale is its whole gradient's, and microbatch
``i`` is the same rows of the global batch, split over the ranks.  Every
collective is a plain ``torch.distributed`` call
(:func:`~repro_torch.distributed.tensor_parallel.gather` and its
siblings): DTensor's functional collectives fault on CUDA tensors over
gloo.  xLSTM blocks on a ``model`` axis above 1 raise
``NotImplementedError`` (``ROADMAP.md`` Queue A).

The train state is ``{"params", "opt": {"mu", "nu", "step"}}`` plus
``"error_fb"`` under compression, the JAX package's tree; parameters are
leaf tensors with ``requires_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.distributed import compression, tensor_parallel
from repro_torch.distributed.api import AxisRules, axis_rules, mesh_axes, named_sharding
from repro_torch.distributed.tensor_parallel import TENSOR_AXIS, all_reduce, reduce_scatter
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import OptimizerConfig, adamw_update, init_opt_state
from repro_torch.tree import named_leaves, tree_leaves, tree_map

__all__ = ["TrainConfig", "init_train_state", "train_state_from_numpy", "make_train_step",
           "make_grads_fn", "state_axes", "state_shardings", "batch_shardings",
           "place_state"]


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


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and bool(x) and all(isinstance(e, (str, type(None))) for e in x)


def _map_axes(fn, axes):
    """``fn`` over the logical-axes leaves of an axes tree."""
    if _is_axes(axes):
        return fn(axes)
    if isinstance(axes, dict):
        return {k: _map_axes(fn, v) for k, v in axes.items()}
    return tuple(_map_axes(fn, v) for v in axes)


def state_axes(cfg: ModelConfig, train_cfg: TrainConfig = TrainConfig()):
    """Logical axes for the whole train state (mirrors init_train_state)."""
    p_axes = transformer.param_axes(cfg)
    axes = {"params": p_axes, "opt": {"mu": p_axes, "nu": p_axes, "step": ()}}
    if train_cfg.grad_compression:
        axes["error_fb"] = p_axes
    return axes


def state_shardings(cfg: ModelConfig, mesh, rules: AxisRules, train_cfg=TrainConfig()):
    """The train state's tree of :class:`~repro_torch.distributed.api.Sharding`."""
    ps = _map_axes(lambda ax: named_sharding(mesh, rules, ax), transformer.param_axes(cfg))
    shardings = {"params": ps, "opt": {"mu": ps, "nu": ps,
                                       "step": named_sharding(mesh, rules, ())}}
    if train_cfg.grad_compression:
        shardings["error_fb"] = ps
    return shardings


def batch_shardings(mesh, rules: AxisRules, batch_tree):
    """Every batch leaf sharded on its lead (global batch) dim."""
    return tree_map(lambda a: named_sharding(mesh, rules, ("batch",) + (None,) * (a.dim() - 1)),
                    batch_tree)


def place_state(tree, shardings):
    """Each full tensor of ``tree`` (the same values on every rank) as a
    DTensor on its sharding: each rank keeps its shard of its own copy (no
    collective), in the tensor's dtype and with its ``requires_grad``."""
    return tree_map(lambda t, s: distribute_tensor(t.detach(), s.mesh, s.placements,
                                                   src_data_rank=None)
                    .requires_grad_(t.requires_grad), tree, shardings)


def make_grads_fn(cfg: ModelConfig, train_cfg: TrainConfig = TrainConfig(), objective=None,
                  mesh=None, rules: Optional[AxisRules] = None):
    """``compute_grads(params, batch) -> (loss, metrics, grads)``: the train
    step's gradients, over ``train_cfg.microbatches`` slices of the batch's
    lead dim (f32 accumulation, means over the microbatches).  By default
    each microbatch differentiates its ``loss``; ``objective(loss, metrics)
    -> (target, loss, metrics)`` replaces what is differentiated and
    reported (the sharded step's token-weighted share).  With ``mesh`` and
    ``rules``: the sharded step's gradients of the placed parameters over
    the global batch, each a DTensor on its parameter's placements."""
    if mesh is not None and rules is not None:
        sharded = _sharded_grads(cfg, train_cfg, mesh, rules)

        def dtensors(params, batch):
            loss, metrics, grads = sharded(params, batch)
            return loss, metrics, tree_map(
                lambda g, p: DTensor.from_local(g, mesh, p.placements, run_check=False,
                                                shape=p.shape, stride=p.stride()),
                grads, params)

        return dtensors
    unreached = transformer.unreached_leaves(cfg)

    def grads_of(params, batch):
        loss, metrics = transformer.loss_fn(cfg, params, batch)
        target = loss
        if objective is not None:
            target, loss, metrics = objective(loss, metrics)
        # A leaf no input reaches gets a zero gradient, as jax.grad gives
        # it; any other leaf cut off from the loss makes autograd raise.
        leaves = list(named_leaves(params))
        reached = iter(torch.autograd.grad(
            target, [p for name, p in leaves if name not in unreached]))
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

    return compute_grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    train_cfg: TrainConfig = TrainConfig(), mesh=None,
                    rules: Optional[AxisRules] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``
    holds ``tokens`` and ``labels`` (B, S) on the state's device; the
    metrics are ``loss``, ``grad_norm``, ``lr``, ``xent``, ``aux`` and
    ``tokens`` (f32 scalars).  With ``mesh`` and ``rules``: the state
    placed by :func:`place_state` on :func:`state_shardings`, and the
    global batch, the same on every rank (see the module docstring)."""
    if mesh is not None and rules is not None:
        return _sharded_train_step(cfg, opt_cfg, train_cfg, mesh, rules)
    compute_grads = make_grads_fn(cfg, train_cfg)

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


def _reduce(values, mesh, dims, op="sum"):
    """``values`` (a tensor) summed (or ``op="max"``) over the mesh dims
    ``dims``, one group after the other."""
    for i in dims:
        if mesh.size(i) > 1:
            values = all_reduce(values, mesh.get_group(i), op)
    return values


def _sharded_grads(cfg, train_cfg, mesh, rules):
    """``grads(params, batch) -> (loss, metrics, grads)`` of the sharded
    step: the parameters DTensors on their storage placements, the batch
    global; each gradient this rank's local shard on its parameter's
    placements (see the module docstring)."""
    names, sizes = mesh_axes(mesh)
    size = dict(zip(names, sizes))
    tp = size.get(TENSOR_AXIS, 1)
    if tp > 1:
        tensor_parallel.check_config(cfg, tp)
    data_dims, R, rank = tensor_parallel.data_ranks(mesh, rules)
    local_cfg = cfg
    if "moe" in cfg.layer_kinds():  # MoE groups follow the batch sharding
        if cfg.moe_groups % R:
            raise ValueError(f"moe_groups={cfg.moe_groups} does not split over {R} data ranks")
        local_cfg = dataclasses.replace(cfg, moe_groups=cfg.moe_groups // R)
    n_mb = max(train_cfg.microbatches, 1)
    # Which leaves the model reads split over the tensor axis (the rest it
    # reads whole: a leaf replicated there, or kv heads fewer than ranks).
    whole = tensor_parallel.whole_axes(cfg, tp)
    split = _map_axes(lambda ax: not whole.intersection(ax), transformer.param_axes(cfg))
    model_dim = names.index(TENSOR_AXIS) if TENSOR_AXIS in names else None

    def objective(loss, metrics):
        c = metrics["tokens"]
        share = c / _reduce(c.detach(), mesh, data_dims)
        target = metrics["xent"] * share + 0.01 * metrics["aux"] / R
        tot = _reduce(torch.stack([target.detach(), (metrics["xent"] * share).detach(),
                                   (metrics["aux"] / R).detach(), c.detach()]), mesh, data_dims)
        return target, tot[0], {"xent": tot[1], "aux": tot[2], "tokens": tot[3]}

    compute_grads = make_grads_fn(local_cfg, train_cfg, objective)

    def local_rows(t):
        B = t.shape[0]
        if B % (R * n_mb):
            raise ValueError(f"batch {B} does not split into {n_mb} microbatches over {R} ranks")
        per, part = B // n_mb, B // (n_mb * R)
        return torch.cat([t[i * per + rank * part:i * per + (rank + 1) * part]
                          for i in range(n_mb)])

    def storage_layout(g, p, is_split):
        """A compute-layout gradient summed over the batch axes onto its
        parameter's shard (a whole leaf stored split over ``model``: this
        rank's chunk of it)."""
        for i in data_dims:
            pl = p.placements[i]
            if mesh.size(i) > 1:
                g = (reduce_scatter(g, mesh.get_group(i), pl.dim) if isinstance(pl, Shard)
                     else all_reduce(g, mesh.get_group(i)))
        pl = p.placements[model_dim] if model_dim is not None else None
        if not is_split and isinstance(pl, Shard) and tp > 1:
            g = g.chunk(tp, pl.dim)[mesh.get_local_rank(model_dim)]
        return g

    def grads(params, batch):
        local = tree_map(lambda t: t.detach().requires_grad_(True),
                         transformer.local_params(cfg, params, mesh))
        with axis_rules(rules):
            loss, metrics, g = compute_grads(local, {k: local_rows(v) for k, v in batch.items()})
        del local
        return loss, metrics, tree_map(storage_layout, g, params, split)

    return grads


def _sharded_train_step(cfg, opt_cfg, train_cfg, mesh, rules):
    grads_fn = _sharded_grads(cfg, train_cfg, mesh, rules)
    every_dim = range(mesh.ndim)

    def sharded_sum(values, placements):
        """Each leaf's local value summed over the mesh dims it is sharded
        on (once per group of leaves sharded alike)."""
        out = list(values)
        groups = {}
        for i, pl in enumerate(placements):
            groups.setdefault(tuple(j for j, x in enumerate(pl) if isinstance(x, Shard)),
                              []).append(i)
        for dims, idx in groups.items():
            if dims:
                tot = _reduce(torch.stack([values[i] for i in idx]), mesh, dims)
                for j, i in enumerate(idx):
                    out[i] = tot[j]
        return out

    def train_step(state, batch):
        params = state["params"]
        placements = [p.placements for p in tree_leaves(params)]
        loss, metrics, grads = grads_fn(params, batch)
        if train_cfg.grad_compression:
            with torch.no_grad():  # the feedback's shards, updated in place
                local_e = tree_map(lambda e: e.to_local(), state["error_fb"])
            grads, _ = compression.quantize_dequantize(
                grads, local_e,
                reduce_max=lambda m: _reduce(torch.stack(m), mesh, every_dim, "max"))
        sums = sharded_sum([g.float().square().sum() for g in tree_leaves(grads)], placements)
        gnorm = torch.stack(sums).sum().sqrt()
        opt = state["opt"]
        with torch.no_grad():  # the shards, updated in place
            local = {"params": params, "mu": opt["mu"], "nu": opt["nu"]}
            local = tree_map(lambda t: t.to_local(), local)
        _, new_opt, opt_metrics = adamw_update(
            opt_cfg, local["params"], grads,
            {"mu": local["mu"], "nu": local["nu"], "step": opt["step"].to_local()}, gnorm=gnorm)
        step = DTensor.from_local(new_opt["step"], mesh, opt["step"].placements, run_check=False)
        new_state = dict(state, opt={"mu": opt["mu"], "nu": opt["nu"], "step": step})
        return new_state, {"loss": loss, **opt_metrics, **metrics}

    return train_step
