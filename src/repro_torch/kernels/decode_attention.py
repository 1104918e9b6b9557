"""Decode-attention kernels (CUDA C++, ``csrc/decode_attention.cu``).

Replace the Pallas TPU kernels of ``repro/kernels/decode_attention.py``:

* :func:`decode_attention_fwd` (``pallas_call`` at :88, ``_kernel`` at
  :26): one token against a ring cache.  The model passes (B, NKV, S, D)
  transposed views of its (B, S, NKV, HD) ring cache.
* :func:`decode_attention_paged_fwd` (``pallas_call`` at :207,
  ``_paged_kernel`` at :111): one token against a shared page pool through
  per-row page tables (the continuous tier).  The model passes
  (P, NKV, page, D) transposed views of its (P, page, NKV, HD) pool.

The source file's header states what bounds them on the H100 and what
their design does about that.  The wrappers keep the JAX kernels' layouts
and signatures; caches and pools are read through strides, so no step
copies them.  Each wrapper has its own launch counter.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.cuda_build import check_launch, library
from repro_torch.kernels.flash_attention import DTYPE_CODES, HEAD_DIMS

__all__ = ["decode_attention_fwd", "decode_attention_paged_fwd", "launches",
           "paged_launches"]

launches = LaunchCounter("decode_attention_fwd")
paged_launches = LaunchCounter("decode_attention_paged_fwd")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("decode_attention")
    lib.decode_attention_fwd.argtypes = [_P] * 6 + [_I] * 6 + [_L] * 13 + [_I, _F, _P]
    lib.decode_attention_fwd.restype = ctypes.c_int
    lib.decode_attention_paged_fwd.argtypes = [_P] * 6 + [_I] * 7 + [_L] * 13 + [_I, _F, _P]
    lib.decode_attention_paged_fwd.restype = ctypes.c_int
    return lib


def _check_operands(what, q, k, v, index, pos, names):
    for name, t in zip(names, (q, k, v, index, pos)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} must be on {q.device} (CUDA)")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last dim")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes q={q.dtype} k={k.dtype} v={v.dtype} not supported")
    if index.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{what}: {names[3]} and pos must be int32")
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be (B, NKV, G, D), got {tuple(q.shape)}")


def _check_head(D, window, scale, what):
    """Checks the head dim and window; returns the softmax scale."""
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"{what}: window must be >= 0")
    return D**-0.5 if scale is None else scale


def decode_attention_fwd(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                         scale=None):
    """q: (B, NKV, G, D); caches: (B, NKV, S, D); slot_pos: (B, S) int32
    (-1 = empty slot); pos: (B,) int32.  Returns (B, NKV, G, D) in q's
    dtype.  Feature dims (and slot_pos's slot dim) must be contiguous."""
    _check_operands("decode_attention_fwd", q, k_cache, v_cache, slot_pos, pos,
                    ("q", "k_cache", "v_cache", "slot_pos", "pos"))
    B, NKV, G, D = q.shape
    S = k_cache.shape[2]
    if k_cache.shape != (B, NKV, S, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention_fwd: cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if slot_pos.shape != (B, S) or pos.shape != (B,):
        raise ValueError(f"decode_attention_fwd: slot_pos {tuple(slot_pos.shape)} / "
                         f"pos {tuple(pos.shape)} do not match B={B}, S={S}")
    scale = _check_head(D, window, scale, "decode_attention_fwd")
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


def decode_attention_paged_fwd(q, k_pool, v_pool, page_tables, pos, *, window: int = 0,
                               scale=None):
    """q: (B, NKV, G, D); pools: (P, NKV, page, D); page_tables: (B, NB) int32
    page ids in [0, P); pos: (B,) int32.  Returns (B, NKV, G, D) in q's
    dtype.  Dense index ``i`` of row ``b`` is ``pool[page_tables[b, i //
    page], :, i % page]`` and is valid iff ``i <= pos[b]`` (and ``i >
    pos[b] - window``).  Feature dims (and the tables' entry dim) must be
    contiguous."""
    _check_operands("decode_attention_paged_fwd", q, k_pool, v_pool, page_tables, pos,
                    ("q", "k_pool", "v_pool", "page_tables", "pos"))
    B, NKV, G, D = q.shape
    P, page = (k_pool.shape[0], k_pool.shape[2]) if k_pool.dim() == 4 else (0, 0)
    if k_pool.shape != (P, NKV, page, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"decode_attention_paged_fwd: pool shapes {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if page_tables.dim() != 2 or page_tables.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"decode_attention_paged_fwd: page_tables "
                         f"{tuple(page_tables.shape)} / pos {tuple(pos.shape)} do not "
                         f"match B={B}")
    NB = page_tables.shape[1]
    scale = _check_head(D, window, scale, "decode_attention_paged_fwd")
    out = torch.empty((B, NKV, G, D), dtype=q.dtype, device=q.device)
    if B * NKV * G * NB * page:
        lib = _lib()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.decode_attention_paged_fwd(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                DTYPE_CODES[q.dtype], B, NKV, G, NB, page, D,
                *(q.stride(i) for i in range(3)),
                *(k_pool.stride(i) for i in range(3)),
                *(v_pool.stride(i) for i in range(3)),
                page_tables.stride(0),
                *(out.stride(i) for i in range(3)),
                int(window), float(scale), stream,
            )
        check_launch(lib, err, "decode_attention_paged_fwd")
        paged_launches.add()
    return out
