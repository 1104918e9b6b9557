"""Seeded weights, made by the benchmark and handed to both sides.

The tree has the layout the port's models take (``embed`` / ``final_norm``
/ ``head`` / ``periods`` of stacked per-layer leaves), built here from the
configuration alone, so the reference reads the same tensors without
taking anything the program made.  Each leaf comes from its own device
generator seeded by the run's seed and the leaf's path, in one call, in
the dtype it is served in: matrices ~ N(0, 1 / fan_in) (fan-in is the
input width of the product), embeddings ~ N(0, 1), norm weights
1 + 0.1 N(0, 1) (0.1 N(0, 1) for block norms under gemma's ``(1 + w)``
offset) in float32, as the port keeps its norms.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch

NORMS = ("ln1", "ln2", "q_norm", "k_norm", "final_norm")


def leaf_shapes(cfg) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """``{path: shape}`` of every leaf; per-layer leaves lead with the
    layer count (the port stacks a one-kind pattern's layers)."""
    if len(cfg.pattern) != 1:
        raise ValueError("the benchmark builds single-kind stacks only")
    kind = cfg.pattern[0]
    d, hd, nq, nkv, L = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    out = {("embed", "tokens"): (cfg.vocab_size, d), ("final_norm",): (d,)}
    if not cfg.tie_embeddings:
        out[("head",)] = (d, cfg.vocab_size)
    blk = ("periods", "0")
    out[blk + ("ln1",)] = (L, d)
    out[blk + ("ln2",)] = (L, d)
    attn = {"wq": (d, nq * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd), "wo": (nq * hd, d)}
    if cfg.qk_norm:
        attn.update(q_norm=(hd,), k_norm=(hd,))
    for k, s in attn.items():
        out[blk + ("attn", k)] = (L, *s)
    if kind == "moe":
        e, f = cfg.n_experts, cfg.expert_d_ff
        ffn = {"router": (d, e), "wi": (e, d, f), "wg": (e, d, f), "wo": (e, f, d)}
        for k, s in ffn.items():
            out[blk + ("moe", k)] = (L, *s)
    elif kind == "attn":
        for k, s in {"wi": (d, cfg.d_ff), "wg": (d, cfg.d_ff), "wo": (cfg.d_ff, d)}.items():
            out[blk + ("mlp", k)] = (L, *s)
    else:
        raise ValueError(f"block kind {kind!r} is not served by the benchmark")
    return out


def _leaf_seed(seed, path) -> int:
    h = hashlib.sha256(f"{seed}/{'/'.join(path)}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (2**63)


def make_params(cfg, seed, device) -> dict:
    """The weight tree for ``cfg`` (a ``ModelConfig`` or anything with its
    fields) from ``seed`` (an int, or a string naming a seed and a tier),
    on ``device``."""
    dtype = getattr(torch, cfg.dtype)
    tree: dict = {}
    for path, shape in leaf_shapes(cfg).items():
        g = torch.Generator(device=device)
        g.manual_seed(_leaf_seed(seed, path))
        name = path[-1]
        if name in NORMS:
            t = torch.randn(shape, generator=g, device=device, dtype=torch.float32) * 0.1
            if not cfg.norm_offset or name in ("q_norm", "k_norm"):
                t += 1.0  # q / k norms never take gemma's offset
        else:
            t = torch.randn(shape, generator=g, device=device, dtype=dtype)
            if name != "tokens":
                t.mul_(shape[-2] ** -0.5)  # 1 / sqrt(fan-in)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[name] = t
    periods = tree.pop("periods")
    tree["periods"] = tuple(periods[str(i)] for i in range(len(periods)))
    tree["epilogue"] = ()
    return tree

