"""Shared layers: RMSNorm, rotary embeddings, dense MLPs, init helpers."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

__all__ = [
    "rms_norm",
    "rope",
    "apply_rope",
    "mlp_init_spec",
    "mlp_init_axes",
    "mlp_apply",
    "truncated_normal_init",
]


def truncated_normal_init(generator, shape, dtype, scale: float, device="cuda"):
    """He-style truncated normal in [-2, 2] std, stddev = scale / sqrt(fan_in).

    ``fan_in`` is ``shape[0]`` as in the JAX package (for a stacked period
    leaf that is the period count).  A leaf of 3 or more dims is drawn one
    leading slice at a time, so no full-size f32 temporary exists."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale / np.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=dtype, device=device)
    for view in (out.unbind(0) if len(shape) >= 3 else (out,)):
        t = torch.empty(view.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
        view.copy_(t * std)
    return out


def rms_norm(x, weight, *, eps: float = 1e-6, offset: bool = False):
    """RMSNorm (the fused kernel on CUDA); ``offset=True`` is gemma's (1 + w).
    Differentiable in x and weight (``ops.RMSNorm``'s plain backward)."""
    return ops.rms_norm(x, weight, eps=eps, offset=offset)


def rope(positions, head_dim: int, theta: float, dtype=torch.float32):
    """Rotary tables: positions (..., S) -> (sin, cos) each (..., S, head_dim // 2)
    in ``dtype`` (f32; float64 for a float64 model)."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=dtype, device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=dtype, device=positions.device), exponent)
    angle = positions.to(dtype)[..., None] * freq
    return torch.sin(angle), torch.cos(angle)


def apply_rope(x, sin, cos):
    """Rotate pairs. x: (B, S, N, HD); sin/cos: (B, S, half) or (S, half)."""
    half = x.shape[-1] // 2
    if sin.dim() == x.dim() - 1:  # (B, S, half) -> broadcast over heads
        sin = sin[..., None, :]
        cos = cos[..., None, :]
    wide = torch.promote_types(x.dtype, torch.float32)
    x1f, x2f = x[..., :half].to(wide), x[..., half:].to(wide)
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init_spec(d_model: int, d_ff: int, mlp_type: str):
    """Returns {name: shape} for one MLP."""
    if mlp_type in ("swiglu", "geglu"):
        return {"wi": (d_model, d_ff), "wg": (d_model, d_ff), "wo": (d_ff, d_model)}
    if mlp_type == "gelu":
        return {"wi": (d_model, d_ff), "wo": (d_ff, d_model)}
    raise ValueError(f"unknown mlp_type {mlp_type!r}")


def mlp_init_axes(mlp_type: str):
    """The logical axes of :func:`mlp_init_spec`'s leaves (the JAX
    package's ``(shape, axes)`` spec, second half)."""
    axes = {"wi": ("embed", "ffn"), "wg": ("embed", "ffn"), "wo": ("ffn", "embed")}
    if mlp_type == "gelu":
        del axes["wg"]
    elif mlp_type not in ("swiglu", "geglu"):
        raise ValueError(f"unknown mlp_type {mlp_type!r}")
    return axes


def mlp_apply(params, x, mlp_type: str):
    if mlp_type == "swiglu":
        h = F.silu(x @ params["wi"]) * (x @ params["wg"])
    elif mlp_type == "geglu":
        h = F.gelu(x @ params["wi"], approximate="tanh") * (x @ params["wg"])
    elif mlp_type == "gelu":
        h = F.gelu(x @ params["wi"], approximate="tanh")
    else:
        raise ValueError(mlp_type)
    return h @ params["wo"]
