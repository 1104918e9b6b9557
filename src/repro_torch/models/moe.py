"""Mixture-of-experts FFN with capacity-bounded dispatch (the JAX package's
``models/moe.py``).

Each group of tokens routes to its top-k experts; an expert takes at most
``capacity`` tokens, in token order, and the rest are dropped (their
combine weight is zero).  Tokens move into an (E, capacity, D) buffer, the
expert FFN runs dense over that buffer (``torch.bmm``, so a decode step
reads every expert's weights, as in the JAX package), and each token sums
its k expert outputs back.

Differences in form, not in result:

* The JAX package finds each assignment's slot in its expert's queue with
  a stable ``argsort`` by expert and a ``searchsorted``.  Here the slot is
  a running count per expert over the token-major assignments (a cumulative
  sum of one-hot rows), which is the same number: a stable sort keeps token
  order inside each expert's run.  So the same tokens overflow capacity.
* The combine sums each token's k rows in a fixed order (one reduction over
  the k axis of a gather), where the JAX package scatter-adds them.  No
  atomics, so the result, and the greedy tokens downstream, are the same
  from run to run on the card.
* ``constrain`` (a sharding annotation, the identity on one device) is
  dropped.  On a split tensor axis (``tp``) each rank runs its
  ``expert_ffn`` columns of every expert (``ffn`` of the shared ones) on
  the tokens that every rank routes alike (the router is whole), and the
  combined outputs are summed over the axis.  The gates enter the split
  region, so their gradient, the router's and the load-balancing loss's
  are whole on every rank and the loss is not summed over the axis.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers

__all__ = ["moe_init_spec", "moe_init_axes", "moe_apply", "capacity"]


def capacity(tokens_per_group: int, n_experts: int, top_k: int, cf: float) -> int:
    c = int(np.ceil(tokens_per_group * top_k * cf / n_experts))
    return max(c, top_k)


def moe_init_spec(cfg):
    """{name: shape} for one MoE block's FFN."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    spec = {"router": (d, e), "wi": (e, d, f), "wg": (e, d, f), "wo": (e, f, d)}
    if cfg.mlp_type == "gelu":
        del spec["wg"]
    if cfg.n_shared_experts:
        sf = cfg.expert_d_ff * cfg.n_shared_experts
        spec.update({"shared_wi": (d, sf), "shared_wg": (d, sf), "shared_wo": (sf, d)})
    return spec


def moe_init_axes(cfg):
    """The logical axes of :func:`moe_init_spec`'s leaves: experts
    unsharded, tensor parallelism inside each expert (``expert_ffn``)."""
    axes = {"router": ("embed", "experts"), "wi": ("experts", "embed", "expert_ffn"),
            "wg": ("experts", "embed", "expert_ffn"), "wo": ("experts", "expert_ffn", "embed")}
    if cfg.mlp_type == "gelu":
        del axes["wg"]
    if cfg.n_shared_experts:
        axes.update({"shared_wi": ("embed", "ffn"), "shared_wg": ("embed", "ffn"),
                     "shared_wo": ("ffn", "embed")})
    return axes


def _one_hot(idx, n: int):
    """``F.one_hot(idx, n)``'s int64 values from one comparison: no host
    read of the indices' range, and the same aten ops on every device (the
    CPU and CUDA ``one_hot`` check the range first, meta tensors do not)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _route(cfg, router_w, x):
    """Router in f32: top-k expert ids (T, k), gate values (T, k) and the
    Switch load-balancing loss.  x: (T, D)."""
    logits = x.float() @ router_w.float()  # (T, E)
    if cfg.router_type == "sigmoid":
        # Llama-4 style: pick top-k by logit, gate with sigmoid.
        _, top_idx = torch.topk(logits, cfg.top_k, dim=-1)
        top_gate = torch.sigmoid(logits).gather(-1, top_idx)
    else:
        top_gate, top_idx = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k, dim=-1)
        top_gate = top_gate / torch.clamp_min(top_gate.sum(-1, keepdim=True), 1e-9)
    e = cfg.n_experts
    me = _one_hot(top_idx[:, 0], e).float().mean(0)
    pe = torch.softmax(logits, dim=-1).mean(0)
    return top_idx, top_gate, e * torch.sum(me * pe)


def _dispatch_group(cfg, params, x, xe, cap, tp=None):
    """One group: x (T, D) -> ((T, D), aux); ``xe``: x as the experts read it
    (entered into the split region under ``tp``, else x)."""
    T_, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    top_idx, top_gate, aux = _route(cfg, params["router"], x)

    flat_e = top_idx.reshape(-1)  # (T*k,) expert per assignment, token-major
    # Slot of each assignment in its expert's queue: how many earlier
    # assignments chose the same expert.
    onehot = _one_hot(flat_e, E)
    pos = (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]
    keep = pos < cap
    slot = flat_e * cap + torch.clamp_max(pos, cap - 1)

    # Into the (E, cap, D) buffer; dropped assignments land on a trash row.
    dst = torch.where(keep, slot, E * cap)
    buf = x.new_zeros((E * cap + 1, D)).index_copy_(0, dst, xe.repeat_interleave(k, dim=0))
    buf = buf[:-1].view(E, cap, D)

    # Expert FFN, dense over the buffer.
    h = torch.bmm(buf, params["wi"])
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else (lambda t: F.gelu(t, approximate="tanh"))
        h = act(h) * torch.bmm(buf, params["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    out_buf = torch.bmm(h, params["wo"]).view(E * cap, D)

    # Combine: each token's k weighted rows, summed in a fixed order.
    w = (top_gate.reshape(-1) * keep).to(out_buf.dtype)
    if tp is not None:
        w = tp.enter(w)
    back = out_buf[slot] * w[:, None]
    return back.view(T_, k, D).sum(1), aux


def moe_apply(cfg, params, x, tp=None):
    """x: (B, S, D) -> ((B, S, D), aux loss scalar f32); ``tp``: the split
    tensor axis (see the module docstring)."""
    B, S, D = x.shape
    g = cfg.moe_groups
    total = B * S
    if total % g:
        raise ValueError(f"tokens {total} not divisible by moe_groups {g}")
    tpg = total // g
    cap = capacity(tpg, cfg.n_experts, cfg.top_k, cfg.capacity_factor)

    xg = x.reshape(g, tpg, D)
    xe = xg if tp is None else tp.enter(xg)
    outs, auxes = zip(*(_dispatch_group(cfg, params, xi, ei, cap, tp)
                        for xi, ei in zip(xg, xe)))
    out = torch.stack(outs).reshape(B, S, D).to(x.dtype)
    if tp is not None:
        out = tp.leave(out)
    if cfg.n_shared_experts:
        shared = layers.mlp_apply(
            {"wi": params["shared_wi"], "wg": params["shared_wg"], "wo": params["shared_wo"]},
            x, "swiglu" if cfg.mlp_type != "gelu" else "gelu", tp=tp)
        out = out + shared
    return out, torch.stack(auxes).mean()
