"""Dispatch: the hand-written kernel on a CUDA tensor, the plain version on
a CPU tensor.

The model calls these.  A CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`; any other tensor goes to the kernel, whose
wrapper launches it or raises.  There is no fallback: a kernel that fails
to build or launch raises.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm

__all__ = [
    "rms_norm",
    "flash_attention",
    "decode_attention",
    "decode_attention_paged",
    "COUNTERS",
    "launch_counts",
    "reset_launch_counts",
]

COUNTERS = {
    "rms_norm_fwd": _rmsnorm.launches,
    "flash_attention_fwd": _flash.launches,
    "decode_attention_fwd": _decode.launches,
    "decode_attention_paged_fwd": _decode.paged_launches,
}


def rms_norm(x, w, *, eps: float = 1e-6, offset: bool = False):
    if x.device.type == "cpu":
        return ref.rms_norm_ref(x, w, eps=eps, offset=offset)
    return _rmsnorm.rms_norm_fwd(x, w, eps=eps, offset=offset)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, return_lse: bool = False):
    """Kernel layout: q (B, NQ, S, D); k, v (B, NKV, S, D)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, scale=scale, return_lse=return_lse
        )
    return _flash.flash_attention_fwd(
        q, k, v, causal=causal, window=window, scale=scale, return_lse=return_lse
    )


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


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()
