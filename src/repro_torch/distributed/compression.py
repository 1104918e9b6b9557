"""Gradient compression for slow links, the JAX package's
``distributed/compression.py`` in PyTorch.

int8 uniform quantization with per-tensor scales and *error feedback*
(Seide et al. / EF-SGD): the quantization residual is carried to the next
step so compression bias does not accumulate.  :func:`quantize_dequantize`
is the gradient transform ``TrainConfig.grad_compression`` enables (it
models the wire format; on one GPU there is no exchange).  The JAX
package's ``compressed_psum`` is a ``shard_map`` collective and is not
ported: it waits for the multi-GPU tooling.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["quantize_int8", "dequantize_int8", "quantize_dequantize",
           "init_error_feedback"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns ``(q, scale)`` (scale f32)."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def quantize_dequantize(grads, error_fb=None):
    """Quantization-aware gradient transform with error feedback.

    Returns ``(grads_hat, new_error_fb)``; with ``error_fb=None`` feedback
    is disabled (plain quantization) and the second item is None.
    """

    def qdq(gf):
        return dequantize_int8(*quantize_int8(gf))

    if error_fb is None:
        return tree_map(lambda g: qdq(g.float()).to(g.dtype), grads), None
    gsum = tree_map(lambda g, e: g.float() + e, grads, error_fb)
    ghat = tree_map(qdq, gsum)
    return tree_map(lambda h, g: h.to(g.dtype), ghat, grads), tree_map(torch.sub, gsum, ghat)


def init_error_feedback(params):
    """f32 zeros shaped like ``params``."""
    device = tree_leaves(params)[0].device
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device), params)
