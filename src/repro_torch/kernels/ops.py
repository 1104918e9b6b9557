"""Dispatch: the hand-written kernel on a CUDA tensor, the plain version on
a CPU tensor.

The model calls these.  A CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`; any other tensor goes to the kernel, whose
wrapper launches it or raises.  There is no fallback: a kernel that fails
to build or launch raises.

Training differentiates :func:`rms_norm`, :func:`flash_attention` and
:func:`rglru_scan` through the autograd Functions :class:`RMSNorm`,
:class:`FlashAttention` (the port of the JAX model's ``custom_vjp``) and
:class:`RGLRUScan`.  They are used only when
autograd records: with grad disabled (serving runs under
``torch.inference_mode()``), or when no input requires grad, the call goes
straight to the kernel wrapper, so serving pays no autograd overhead.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import rmsnorm as _rmsnorm

__all__ = [
    "rms_norm",
    "flash_attention",
    "decode_attention",
    "decode_attention_paged",
    "rglru_scan",
    "RMSNorm",
    "FlashAttention",
    "RGLRUScan",
    "COUNTERS",
    "launch_counts",
    "reset_launch_counts",
]

COUNTERS = {
    "rms_norm_fwd": _rmsnorm.launches,
    "flash_attention_fwd": _flash.launches,
    "flash_attention_bwd": _flash_bwd.launches,
    "decode_attention_fwd": _decode.launches,
    "decode_attention_paged_fwd": _decode.paged_launches,
    "rglru_scan_fwd": _rglru.launches,
    "rglru_scan_bwd": _rglru.bwd_launches,
}


def _records(*tensors) -> bool:
    """Whether autograd records this call (grad on, some input needs it)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class RMSNorm(torch.autograd.Function):
    """RMSNorm with a gradient.  Forward: the Triton kernel on CUDA, the
    plain version on the CPU.  Backward: plain PyTorch on either device
    (:func:`ref.rms_norm_bwd_ref`, recomputing ``rsqrt`` in f32): the JAX
    package has no Pallas backward for RMSNorm either; its gradient is
    ``jax.grad`` of the ``jnp`` norm."""

    @staticmethod
    def forward(ctx, x, w, eps, offset):
        y = _rms_norm_fwd(x, w, eps=eps, offset=offset)
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.offset = eps, offset
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = ref.rms_norm_bwd_ref(x, w, dy, eps=ctx.eps, offset=ctx.offset)
        return dx, dw, None, None


class FlashAttention(torch.autograd.Function):
    """Prefill attention with a gradient (kernel layout).  Forward: the
    flash kernel with its f32 LSE on CUDA, the plain version on the CPU;
    saves q, k, v, out, the LSE and the prefix lengths (or None).
    Backward: the hand-written backward kernel on CUDA,
    :func:`ref.flash_attention_bwd_ref` on the CPU, both recomputing from
    the LSE under the same mask, as the JAX model's ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, prefix_len):
        out, lse = _flash_fwd(q, k, v, causal=causal, window=window, scale=scale,
                              return_lse=True, prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, out, lse, prefix_len)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, prefix_len = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        bwd = (ref.flash_attention_bwd_ref if q.device.type == "cpu"
               else _flash_bwd.flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, out, dout, lse, causal=ctx.causal, window=ctx.window,
                         scale=ctx.scale, prefix_len=prefix_len)
        return dq, dk, dv, None, None, None, None


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU recurrence with a gradient.  Forward: the scan kernel on
    CUDA, the plain version on the CPU; saves a, the output h and h0.
    Backward: the same kernel run in reverse on CUDA, one launch that
    writes da, db and dh0 (:func:`rglru_scan.rglru_scan_bwd`),
    :func:`ref.rglru_scan_bwd_ref` on the CPU.  The JAX package
    differentiates its associative scan with ``jax.grad``; it has no Pallas
    backward here."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _rglru_scan_fwd(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.b_dtype = b.dtype
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        bwd = ref.rglru_scan_bwd_ref if a.device.type == "cpu" else _rglru.rglru_scan_bwd
        da, db, dh0 = bwd(a, h, h0, dh)
        return da, db.to(ctx.b_dtype), dh0


def _rms_norm_fwd(x, w, *, eps, offset):
    if x.device.type == "cpu":
        return ref.rms_norm_ref(x, w, eps=eps, offset=offset)
    return _rmsnorm.rms_norm_fwd(x, w, eps=eps, offset=offset)


def _flash_fwd(q, k, v, *, causal, window, scale, return_lse, prefix_len=None):
    if q.device.type == "cpu":
        return ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, scale=scale, return_lse=return_lse,
            prefix_len=prefix_len,
        )
    return _flash.flash_attention_fwd(
        q, k, v, causal=causal, window=window, scale=scale, return_lse=return_lse,
        prefix_len=prefix_len,
    )


def rms_norm(x, w, *, eps: float = 1e-6, offset: bool = False):
    if _records(x, w):
        return RMSNorm.apply(x, w, eps, offset)
    return _rms_norm_fwd(x, w, eps=eps, offset=offset)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, return_lse: bool = False, prefix_len=None):
    """Kernel layout: q (B, NQ, S, D); k, v (B, NKV, S, D); ``prefix_len``
    (B,) int32 prefix-LM lengths on q's device, or None.  Differentiable
    (through :class:`FlashAttention`) unless ``return_lse``.  A CUDA call
    with a prefix goes to the kernels like any other."""
    if not return_lse and _records(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, scale, prefix_len)
    return _flash_fwd(q, k, v, causal=causal, window=window, scale=scale,
                      return_lse=return_lse, prefix_len=prefix_len)


def decode_attention(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                     scale=None):
    """Kernel layout: q (B, NKV, G, D); caches (B, NKV, S, D)."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(
            q, k_cache, v_cache, slot_pos, pos, window=window, scale=scale
        )
    return _decode.decode_attention_fwd(
        q, k_cache, v_cache, slot_pos, pos, window=window, scale=scale
    )


def decode_attention_paged(q, k_pool, v_pool, page_tables, pos, *, window: int = 0,
                           scale=None):
    """Kernel layout: q (B, NKV, G, D); pools (P, NKV, page, D)."""
    if q.device.type == "cpu":
        return ref.decode_attention_paged_ref(
            q, k_pool, v_pool, page_tables, pos, window=window, scale=scale
        )
    return _decode.decode_attention_paged_fwd(
        q, k_pool, v_pool, page_tables, pos, window=window, scale=scale
    )


def _rglru_scan_fwd(a, b, h0):
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0)
    return _rglru.rglru_scan_fwd(a, b, h0)


def rglru_scan(a, b, h0):
    """``h_t = a_t * h_{t-1} + b_t`` from ``h0``: a, b (B, S, W), h0 (B, W)
    -> h (B, S, W) in a's dtype, carried in f32.  Differentiable (through
    :class:`RGLRUScan`) in a, b and h0."""
    if _records(a, b, h0):
        return RGLRUScan.apply(a, b, h0)
    return _rglru_scan_fwd(a, b, h0)


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()
