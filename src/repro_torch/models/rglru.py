"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The recurrence is
    r_t = sigmoid(W_a x_t + b_a)                    (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                    (input gate)
    log a_t = -c * softplus(Lambda) * r_t           (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill and training run the recurrence through ``ops.rglru_scan``: the
hand-written scan kernel on CUDA (differentiable through
``ops.RGLRUScan``), the plain sequential version on the CPU, where the JAX
package runs an associative scan.  Decode carries h and updates it
elementwise (O(1) state per token), as the JAX package does; it launches no
kernel.

Block layout (Griffin "recurrent block"): a gated-linear-unit style pair of
input projections; the recurrent branch passes through a short depthwise
conv1d (width 4) and the RG-LRU; branches merge multiplicatively and project
back to d_model.  Parameters and caches keep the JAX package's names,
shapes and dtypes; functions return new cache values (the model writes
them into its cache in place).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

__all__ = [
    "rglru_init_spec",
    "rglru_init_axes",
    "rglru_apply",
    "rglru_decode_step",
    "rglru_init_cache",
    "C_CONST",
]

C_CONST = 8.0


def rglru_init_spec(cfg):
    """Returns {name: shape} for one recurrent branch."""
    d, w = cfg.d_model, cfg.lru_width
    return {
        "wx": (d, w),  # recurrent-branch input proj
        "wy": (d, w),  # gate branch
        "wo": (w, d),
        "conv_w": (cfg.conv_width, w),
        "conv_b": (w,),
        "gate_a": (w, w),  # W_a (recurrence gate)
        "gate_x": (w, w),  # W_x (input gate)
        "gate_a_b": (w,),
        "gate_x_b": (w,),
        "lamb": (w,),  # Lambda (learned decay)
    }


def rglru_init_axes(cfg):
    """The logical axes of :func:`rglru_init_spec`'s leaves."""
    return {"wx": ("embed", "lru"), "wy": ("embed", "lru"), "wo": ("lru", "embed"),
            "conv_w": (None, "lru"), "conv_b": ("lru",), "gate_a": ("lru", None),
            "gate_x": ("lru", None), "gate_a_b": ("lru",), "gate_x_b": ("lru",),
            "lamb": ("lru",)}


def _depthwise_conv(x, conv_w, conv_b, tail=None):
    """Causal depthwise conv1d.  x: (B, S, W); conv_w: (K, W).  Taps are
    added in the JAX package's order (i = 0..K-1), so 16-bit sums round the
    same way."""
    k, S = conv_w.shape[0], x.shape[1]
    if tail is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = tail  # (B, K-1, W) from the previous step (decode)
    xp = torch.cat([pad, x], dim=1)
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + S] * conv_w[i]
    new_tail = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return out + conv_b, new_tail


def _gates(params, x):
    """Decay a and gated input for the RG-LRU, f32.  x: (..., W) f32; the
    gate weights are cast to f32, as JAX promotes ``f32 @ bf16``."""
    r = torch.sigmoid(x @ params["gate_a"].float() + params["gate_a_b"])
    i = torch.sigmoid(x @ params["gate_x"].float() + params["gate_x_b"])
    log_a = -C_CONST * F.softplus(params["lamb"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) normalizer keeps the state norm bounded.
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    return a, beta * (i * x)


def rglru_apply(cfg, params, x, h0=None, conv_tail=None):
    """Full-sequence recurrent block.  x: (B, S, D) -> (B, S, D).

    Returns (out, (h_last, conv_tail)) so prefill can seed decode.
    """
    dtype = x.dtype
    y = F.gelu((x @ params["wy"]).float(), approximate="tanh")
    u = x @ params["wx"]
    u, new_tail = _depthwise_conv(u, params["conv_w"], params["conv_b"], conv_tail)
    a, bx = _gates(params, u.float())
    if h0 is None:
        h0 = torch.zeros((x.shape[0], a.shape[-1]), dtype=torch.float32, device=x.device)
    h = ops.rglru_scan(a, bx, h0)
    out = (h * y).to(dtype) @ params["wo"]
    return out, (h[:, -1], new_tail)


def rglru_init_cache(cfg, batch, dtype=torch.float32, device="cuda", lead=()):
    """``h`` (*lead, B, W) f32 and ``conv_tail`` (*lead, B, K-1, W) in
    ``dtype``; ``lead`` stacks them over periods."""
    w = cfg.lru_width
    return {
        "h": torch.zeros((*lead, batch, w), dtype=torch.float32, device=device),
        "conv_tail": torch.zeros((*lead, batch, cfg.conv_width - 1, w), dtype=dtype,
                                 device=device),
    }


def rglru_decode_step(cfg, params, x, cache):
    """One token.  x: (B, 1, D) -> (B, 1, D); O(1) state update.  Returns
    (out, {"h", "conv_tail"}) as new tensors."""
    dtype = x.dtype
    y = F.gelu((x @ params["wy"]).float(), approximate="tanh")
    u = x @ params["wx"]
    u, new_tail = _depthwise_conv(u, params["conv_w"], params["conv_b"], cache["conv_tail"])
    a, bx = _gates(params, u.float())
    h = a[:, 0] * cache["h"] + bx[:, 0]  # (B, W)
    out = (h[:, None] * y).to(dtype) @ params["wo"]
    return out, {"h": h, "conv_tail": new_tail}
