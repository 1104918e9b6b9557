"""Dispatch: the hand-written kernel on a CUDA tensor, the plain version on
a CPU tensor, the outputs' shapes on a meta tensor.

The model calls these.  A CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`; a meta tensor (shapes without values,
which the dry-run traces) gets empty outputs in the kernel's memory
layout, with no computation; any other tensor goes to the kernel, whose
wrapper launches it or raises (a meta tensor there raises too).  There is
no fallback: a kernel that fails to build or launch raises.  A call with
nothing to compute (no q heads or no rows: a tensor-parallel rank that
holds no head) returns its empty outputs and launches nothing.

Under an active :class:`~repro_torch.kernels.cost.CostCounter` every call
reports its function-level work (the formulas of
:mod:`repro_torch.kernels.cost`) and the aten ops that carry it out are not
counted; the plain version's outputs are then given the kernel's memory
layout, so what follows a call runs the same ops on every route and a
step's count does not depend on the route.

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

from repro_torch.kernels import cost
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
        if q.shape[1] == 0:  # no q heads (a tensor-parallel rank with none): nothing to do
            return q.new_zeros(q.shape), k.new_zeros(k.shape), v.new_zeros(v.shape), \
                None, None, None, None
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        B, NQ, S, D = q.shape
        kw = dict(causal=ctx.causal, window=ctx.window, scale=ctx.scale, prefix_len=prefix_len)
        dq, dk, dv = _dispatch(
            "flash_attention_bwd", q,
            lambda: cost.flash_bwd_work(B, NQ, k.shape[1], S, D, q.element_size(),
                                        _pairs(B, S, ctx.causal, ctx.window, prefix_len)),
            lambda: _flash_bwd.flash_attention_bwd(q, k, v, out, dout, lse, **kw),
            lambda: ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw),
            lambda: (_bsnd_empty(q), _bsnd_empty(k), _bsnd_empty(v)))
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
        da, db, dh0 = _dispatch(
            "rglru_scan_bwd", a,
            lambda: cost.rglru_scan_bwd_work(a.numel(), a.element_size(), h0.numel(),
                                             h0.element_size()),
            lambda: _rglru.rglru_scan_bwd(a, h, h0, dh),
            lambda: ref.rglru_scan_bwd_ref(a, h, h0, dh),
            lambda: (_empty(a.shape, a), _empty(a.shape, a), _empty(h0.shape, h0)))
        return da, db.to(ctx.b_dtype), dh0


def _dispatch(name, t, work, kernel, plain, empty):
    """The call on ``t``'s route: ``kernel()`` on CUDA, ``plain()`` on the
    CPU, ``empty()`` (outputs in the kernel's layout, no values) on meta.
    Under an active counter it reports ``work()`` for the call, its aten
    ops uncounted, and the plain outputs take ``empty()``'s layout."""
    dev = t.device.type
    counter = cost.active_counter()
    if counter is None:
        return plain() if dev == "cpu" else (empty() if dev == "meta" else kernel())
    with counter.kernel(name, work):
        if dev == "cpu":
            out, like = plain(), empty()
            if isinstance(out, tuple):
                return tuple(_to_layout(o, l) for o, l in zip(out, like))
            return _to_layout(out, like)
        return empty() if dev == "meta" else kernel()


def _to_layout(t, like):
    """``t``'s values in ``like``'s strides and dtype (``t`` when they match)."""
    if t.stride() == like.stride() and t.dtype == like.dtype:
        return t
    return like.copy_(t)


def _empty(shape, like, dtype=None):
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


def _bsnd_empty(t, dtype=None):
    """(B, N, S, D) as a view of a contiguous (B, S, N, D): the layout the
    flash kernels write."""
    B, N, S, D = t.shape
    return _empty((B, S, N, D), t, dtype).transpose(1, 2)


def _pairs(B, S, causal, window, prefix_len) -> int:
    """The visible (query, key) pairs summed over the batch's rows; a meta
    ``prefix_len`` takes the active counter's ``prefix_len``."""
    if prefix_len is None:
        return B * cost.visible_pairs(S, causal=causal, window=window)
    if prefix_len.is_meta:
        P = cost.active_counter().prefix_len
        if P is None:
            raise ValueError("a meta prefix_len has no values: pass the prefix length as "
                             "CostCounter(prefix_len=...)")
        return B * cost.visible_pairs(S, causal=causal, window=window, prefix=P)
    return sum(cost.visible_pairs(S, causal=causal, window=window, prefix=int(p))
               for p in prefix_len.tolist())


def _rms_norm_fwd(x, w, *, eps, offset):
    if x.numel() == 0:  # no rows (a tensor-parallel rank with no head): no launch
        return torch.empty_like(x)
    return _dispatch(
        "rms_norm_fwd", x,
        lambda: cost.rms_norm_work(x.numel(), x.element_size(), w.numel(), w.element_size()),
        lambda: _rmsnorm.rms_norm_fwd(x, w, eps=eps, offset=offset),
        lambda: ref.rms_norm_ref(x, w, eps=eps, offset=offset),
        lambda: torch.empty_like(x))


def _flash_fwd(q, k, v, *, causal, window, scale, return_lse, prefix_len=None):
    B, NQ, S, D = q.shape
    if NQ == 0:  # no q heads (a tensor-parallel rank with none): no launch
        out = _bsnd_empty(q)
        return (out, _empty((B, 0, S), q, torch.float32)) if return_lse else out
    kw = dict(causal=causal, window=window, scale=scale, return_lse=return_lse,
              prefix_len=prefix_len)
    return _dispatch(
        "flash_attention_fwd", q,
        lambda: cost.flash_fwd_work(B, NQ, k.shape[1], S, D, q.element_size(),
                                    _pairs(B, S, causal, window, prefix_len), lse=return_lse),
        lambda: _flash.flash_attention_fwd(q, k, v, **kw),
        lambda: ref.flash_attention_ref(q, k, v, **kw),
        lambda: ((_bsnd_empty(q), _empty((B, NQ, S), q, torch.float32)) if return_lse
                 else _bsnd_empty(q)))


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
                     scale=None, return_lse: bool = False):
    """Kernel layout: q (B, NKV, G, D); caches (B, NKV, S, D).  With
    ``return_lse``: ``(out, lse)``, the rows' log-sum-exp (B, NKV, G), f32
    (float64 on the plain route for a float64 q)."""
    B, NKV, G, D = q.shape
    S = k_cache.shape[2]

    def work():
        if slot_pos.is_meta:  # no values: a full ring
            live = B * S
        else:
            ok = (slot_pos >= 0) & (slot_pos <= pos[:, None])
            if window:
                ok &= slot_pos > (pos[:, None] - window)
            live = int(ok.sum())
        return cost.decode_work(B, NKV * G, NKV, D, S, q.element_size(), live, lse=return_lse)

    args = (q, k_cache, v_cache, slot_pos, pos)
    kw = dict(window=window, scale=scale, return_lse=return_lse)
    return _dispatch(
        "decode_attention_fwd", q, work,
        lambda: _decode.decode_attention_fwd(*args, **kw),
        lambda: ref.decode_attention_ref(*args, **kw),
        lambda: ((_empty(q.shape, q), _empty((B, NKV, G), q, torch.float32)) if return_lse
                 else _empty(q.shape, q)))


def decode_attention_paged(q, k_pool, v_pool, page_tables, pos, *, window: int = 0,
                           scale=None):
    """Kernel layout: q (B, NKV, G, D); pools (P, NKV, page, D)."""
    B, NKV, G, D = q.shape
    NB, span = page_tables.shape[1], page_tables.shape[1] * k_pool.shape[2]
    cap = min(span, window) if window else span

    def work():
        # Each row's live keys are its positions 0..pos (the last
        # ``window`` of them); no values (meta): every page of the table.
        live = (B * cap if pos.is_meta
                else int((pos.long() + 1).clamp(0, cap).sum()))
        return cost.paged_decode_work(B, NKV * G, NKV, D, NB, q.element_size(), live)

    args = (q, k_pool, v_pool, page_tables, pos)
    return _dispatch(
        "decode_attention_paged_fwd", q, work,
        lambda: _decode.decode_attention_paged_fwd(*args, window=window, scale=scale),
        lambda: ref.decode_attention_paged_ref(*args, window=window, scale=scale),
        lambda: _empty(q.shape, q))


def _rglru_scan_fwd(a, b, h0):
    return _dispatch(
        "rglru_scan_fwd", a,
        lambda: cost.rglru_scan_work(a.numel(), a.element_size(), h0.numel(), h0.element_size()),
        lambda: _rglru.rglru_scan_fwd(a, b, h0),
        lambda: ref.rglru_scan_ref(a, b, h0),
        lambda: _empty(a.shape, a))


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
