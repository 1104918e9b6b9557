"""Attention for the model, in the model's (B, S, N, HD) layout.

:func:`flash_attention` (prefill and training), :func:`decode_attention`
(one token against the ring cache) and :func:`paged_decode_attention` (one
token against the continuous tier's page pool) go through
:mod:`repro_torch.kernels.ops`: the hand-written kernels on CUDA, the plain
versions on the CPU.  The kernels read this layout through strides, so no
call copies q, k, v, the cache or the pool.  :func:`flash_attention` is
differentiable: when autograd records, it runs through
``ops.FlashAttention`` (forward kernel with its LSE, backward kernel
recomputing from it), the counterpart of the JAX model's ``custom_vjp``.
Its masks are the JAX model's: causal, sliding window, bidirectional
(hubert) and prefix-LM (paligemma: every query also sees its row's first
``prefix_len[b]`` keys), all inside the kernels.
:func:`attention_reference` is the plain naive attention (the oracle).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import ops, ref

__all__ = ["flash_attention", "attention_reference", "decode_attention",
           "paged_decode_attention"]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, prefix_len=None):
    """q: (B, S, NQ, HD); k, v: (B, S, NKV, HD) -> (B, S, NQ, HD) in q's dtype;
    ``prefix_len``: (B,) int32 prefix-LM lengths, or None.  Differentiable
    in q, k and v; the gradients come back in this layout."""
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=scale, prefix_len=prefix_len,
    )
    return out.transpose(1, 2)


def attention_reference(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, prefix_len=None):
    """Naive O(S^2) attention, same layout and masks as :func:`flash_attention`."""
    return ref.attention_bsnd(q, k, v, causal=causal, window=window, scale=scale,
                              prefix_len=prefix_len)


def decode_attention(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                     scale: Optional[float] = None, return_lse: bool = False):
    """Single-step attention over a ring cache.

    q: (B, 1, NQ, HD); caches: (B, S, NKV, HD); slot_pos: (B, S) absolute
    position per slot (-1 empty); pos: (B,) query positions.  With
    ``return_lse`` also each head's log-sum-exp over the slots (B, NQ), f32
    (about -1e30 where no slot is valid).
    """
    B, _, NQ, HD = q.shape
    NKV = k_cache.shape[2]
    out = ops.decode_attention(
        q.reshape(B, NKV, NQ // NKV, HD), k_cache.transpose(1, 2),
        v_cache.transpose(1, 2), slot_pos, pos, window=window, scale=scale,
        return_lse=return_lse,
    )
    if return_lse:
        return out[0].reshape(B, 1, NQ, HD), out[1].reshape(B, NQ)
    return out.reshape(B, 1, NQ, HD)


def paged_decode_attention(q, k_pool, v_pool, page_tables, pos, *, window: int = 0,
                           scale: Optional[float] = None):
    """Single-step attention over a block-paged KV pool.

    q: (B, 1, NQ, HD); pools: (P, page, NKV, HD) shared by every row;
    page_tables: (B, NB) int32 page ids per row; pos: (B,) query positions.
    Pages are append-only (a row's dense index ``i`` holds absolute
    position ``i``), so validity is ``i <= pos``; table entries past a
    row's reservation point at the trash page 0 and are always masked.
    """
    B, _, NQ, HD = q.shape
    NKV = k_pool.shape[2]
    out = ops.decode_attention_paged(
        q.reshape(B, NKV, NQ // NKV, HD), k_pool.transpose(1, 2),
        v_pool.transpose(1, 2), page_tables, pos, window=window, scale=scale,
    )
    return out.reshape(B, 1, NQ, HD)
