"""Gradient compression for slow links, the JAX package's
``distributed/compression.py`` in PyTorch.

int8 uniform quantization with per-tensor scales and *error feedback*
(Seide et al. / EF-SGD): the quantization residual is carried to the next
step so compression bias does not accumulate.  :func:`quantize_dequantize`
is the gradient transform ``TrainConfig.grad_compression`` enables (it
models the wire format); under the sharded train step each leaf's scale is
the max over its shards, as the JAX package's is over the whole array.
:func:`compressed_psum` is the explicit collective: quantize, sum int32
partials over a process group, dequantize.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["quantize_int8", "dequantize_int8", "quantize_dequantize",
           "compressed_psum", "init_error_feedback"]


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return amax.clamp_min(1e-12) / 127.0


def _codes(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns ``(q, scale)`` (scale f32)."""
    xf = x.float()
    scale = _scale(xf.abs().max())
    return _codes(xf, scale).to(torch.int8), scale


def dequantize_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def _qdq(xf, scale):
    """``xf`` through int8 codes at ``scale`` and back, in f32."""
    return dequantize_int8(_codes(xf, scale).to(torch.int8), scale)


def quantize_dequantize(grads, error_fb=None, reduce_max=None):
    """Quantization-aware gradient transform with error feedback.

    Returns ``(grads_hat, error_fb)``: the gradients through int8 codes, and
    the feedback tree, its tensors updated in place to the new residuals (at
    full width a second f32 copy would not fit beside the train state);
    with ``error_fb=None`` feedback is disabled and the second item is
    None.  Leaves are done one at a time, so the f32 temporaries are one
    leaf's.  ``reduce_max``: when each leaf is a shard of a larger
    gradient, a function from the leaves' local max ``|g|`` (f32 scalars,
    in leaf order) to their maxima over every shard, so each leaf's scale
    is the whole gradient's (the sharded train step passes an
    ``all_reduce`` MAX); a max is exact, so a single shard gives the
    unsharded codes.
    """
    g_leaves = tree_leaves(grads)
    e_leaves = [None] * len(g_leaves) if error_fb is None else tree_leaves(error_fb)

    def gsum(g, e):
        return g.float() if e is None else g.float() + e

    amax = [gsum(g, e).abs().max() for g, e in zip(g_leaves, e_leaves)]
    if reduce_max is not None:
        amax = reduce_max(amax)
    out = []
    for g, e, m in zip(g_leaves, e_leaves, amax):
        gs = gsum(g, e)
        ghat = _qdq(gs, _scale(m))
        out.append(ghat.to(g.dtype))
        if e is not None:
            e.copy_(gs - ghat)
        del gs, ghat
    hats = iter(out)
    return tree_map(lambda _: next(hats), grads), error_fb


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-on-the-wire sum of ``x`` over the ranks of ``group`` (the
    default group when None), the JAX package's ``compressed_psum``: each
    rank's scale, the max of them (``all_reduce`` MAX), every rank's values
    requantized against it as int32, summed (``all_reduce`` SUM) and
    dequantized, in x's dtype."""
    xf = x.float()
    scale = _scale(xf.abs().max()).reshape(1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    total = _codes(xf, scale[0]).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return (total.float() * scale[0]).to(x.dtype)


def init_error_feedback(params):
    """f32 zeros shaped like ``params``."""
    device = tree_leaves(params)[0].device
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device), params)
