"""Ring-cache decode-attention kernel (CUDA C++, ``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention_fwd``, ``pallas_call`` at :88, ``_kernel`` at :26).
The source file's header states what bounds it on the H100 and what its
design does about that.  This wrapper keeps the JAX kernel's layout and
signature; caches are read through strides, so the model passes
(B, NKV, S, D) transposed views of its (B, S, NKV, HD) ring cache and no
step copies the cache.  The paged kernel (``decode_attention_paged_fwd``)
belongs to the continuous tier and is not ported yet.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.cuda_build import check_launch, library
from repro_torch.kernels.flash_attention import DTYPE_CODES, HEAD_DIMS

__all__ = ["decode_attention_fwd", "launches"]

launches = LaunchCounter("decode_attention_fwd")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("decode_attention")
    lib.decode_attention_fwd.argtypes = [_P] * 6 + [_I] * 6 + [_L] * 13 + [_I, _F, _P]
    lib.decode_attention_fwd.restype = ctypes.c_int
    return lib


def decode_attention_fwd(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                         scale=None):
    """q: (B, NKV, G, D); caches: (B, NKV, S, D); slot_pos: (B, S) int32
    (-1 = empty slot); pos: (B,) int32.  Returns (B, NKV, G, D) in q's
    dtype.  Feature dims (and slot_pos's slot dim) must be contiguous."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("slot_pos", slot_pos), ("pos", pos)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"decode_attention_fwd: {name} must be on {q.device} (CUDA)")
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention_fwd: {name} needs a contiguous last dim")
    if q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention_fwd: dtypes q={q.dtype} "
                        f"k={k_cache.dtype} v={v_cache.dtype} not supported")
    if slot_pos.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("decode_attention_fwd: slot_pos and pos must be int32")
    if q.dim() != 4:
        raise ValueError(f"decode_attention_fwd: q must be (B, NKV, G, D), got {tuple(q.shape)}")
    B, NKV, G, D = q.shape
    S = k_cache.shape[2]
    if k_cache.shape != (B, NKV, S, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention_fwd: cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if slot_pos.shape != (B, S) or pos.shape != (B,):
        raise ValueError(f"decode_attention_fwd: slot_pos {tuple(slot_pos.shape)} / "
                         f"pos {tuple(pos.shape)} do not match B={B}, S={S}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention_fwd: head dim {D} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError("decode_attention_fwd: window must be >= 0")
    if scale is None:
        scale = D**-0.5
    out = torch.empty((B, NKV, G, D), dtype=q.dtype, device=q.device)
    if B * NKV * G * S:
        lib = _lib()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.decode_attention_fwd(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
                DTYPE_CODES[q.dtype], B, NKV, G, S, D,
                *(q.stride(i) for i in range(3)),
                *(k_cache.stride(i) for i in range(3)),
                *(v_cache.stride(i) for i in range(3)),
                slot_pos.stride(0),
                *(out.stride(i) for i in range(3)),
                int(window), float(scale), stream,
            )
        check_launch(lib, err, "decode_attention_fwd")
        launches.add()
    return out
