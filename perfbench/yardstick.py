"""The benchmark's own arithmetic: peaks, work formulas, quantiles.

Frozen here so that a change to the program cannot move the yardstick.
The work formulas are copies of the port's ``kernels/cost.py`` (flash
forward and ring decode, as the H100 roofline column of ``PERF.md``'s
kernel table counts them); the model FLOPs count 2 per active
non-embedding parameter per token, the head only where a token's logits
are read, and causal attention's two products.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Iterable

import numpy as np

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take at its published bf16 peaks."""
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def flash_fwd_work(B, NQ, NKV, S, D, itemsize, pairs, lse=False):
    """``(flops, bytes)`` of one flash forward: two S x S x D products over
    the visible pairs; q, k, v read and out (and the f32 LSE) written once."""
    nbytes = itemsize * (2 * B * NQ * S * D + 2 * B * NKV * S * D) + (4 * B * NQ * S if lse else 0)
    return 4 * NQ * D * pairs, nbytes


def decode_work(B, NQ, NKV, D, S_cache, itemsize, live, lse=False):
    """``(flops, bytes)`` of one ring decode step: q read, out written,
    each live key's k and v read once, int32 slot positions and positions."""
    nbytes = (itemsize * (2 * B * NQ * D + 2 * live * NKV * D) + 4 * B * S_cache + 4 * B
              + (4 * B * NQ if lse else 0))
    return 4 * NQ * D * live, nbytes


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def layer_params(cfg) -> int:
    """Active parameters of one block's products (norms left out)."""
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    attn = d * hd * (nq + 2 * nkv) + nq * hd * d
    if cfg.pattern[0] == "moe":
        ffn = cfg.top_k * 3 * d * cfg.expert_d_ff + d * cfg.n_experts
    else:
        ffn = 3 * d * cfg.d_ff
    return attn + ffn


def request_flops(cfg, prompt: int, answer: int) -> float:
    """Model FLOPs one request needs: its prompt and its answer's first
    ``answer - 1`` tokens through every layer, attention over their
    causal prefixes, and the head at the ``answer`` positions whose
    logits give its tokens."""
    fed = prompt + answer - 1
    dense = 2 * layer_params(cfg) * fed
    attn = 4 * cfg.n_heads * cfg.head_dim * causal_pairs(fed) * cfg.n_layers
    head = 2 * cfg.d_model * cfg.vocab_size * answer
    return float(dense + attn + head)


def quantile(values: Iterable[float], q: float) -> float:
    """The ``q``-th percentile (0-100), linear interpolation (NumPy's
    default, as the serving stack's ``observability/quantile.py``); NaN on
    an empty sample."""
    arr = np.asarray(list(values), dtype=float)
    return float(np.percentile(arr, q)) if arr.size else math.nan
