"""Flash-attention forward kernel (CUDA C++, ``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_fwd``, ``pallas_call`` at :119, ``_kernel`` at :30).
The source file's header states what bounds it on the H100 and what its
design does about that.  This wrapper keeps the JAX kernel's layout and
signature; the kernel reads its operands through strides, so callers may
pass transposed views of the model's (B, S, N, HD) activations without a
copy, and the output is allocated in that (B, S, NQ, D) memory order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.cuda_build import check_launch, library

__all__ = ["flash_attention_fwd", "launches", "HEAD_DIMS"]

launches = LaunchCounter("flash_attention_fwd")
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("flash_attention")
    lib.flash_attention_fwd.argtypes = [_P] * 5 + [_I] * 6 + [_L] * 12 + [_I, _I, _F, _P]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale=None, return_lse: bool = False):
    """q: (B, NQ, S, D); k, v: (B, NKV, S, D) -> (B, NQ, S, D) in q's dtype
    (+ f32 LSE (B, NQ, S) when ``return_lse``).  Any S; D in
    :data:`HEAD_DIMS`; GQA kv head ``q_head // (NQ // NKV)``.  Each operand
    needs a contiguous last dim; other strides are free."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} must be on {q.device} (CUDA)")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_fwd: {name} must be 4-D with a contiguous last dim")
        if t.dtype != q.dtype:
            raise TypeError("flash_attention_fwd: q, k, v dtypes differ")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention_fwd: unsupported dtype {q.dtype}")
    B, NQ, S, D = q.shape
    NKV = k.shape[1]
    if k.shape != (B, NKV, S, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {D} not in {HEAD_DIMS}")
    if NKV < 1 or NQ % NKV:
        raise ValueError(f"flash_attention_fwd: NQ={NQ} not a multiple of NKV={NKV}")
    if window < 0:
        raise ValueError("flash_attention_fwd: window must be >= 0")
    if scale is None:
        scale = D**-0.5
    out = torch.empty((B, S, NQ, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((B, NQ, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B * S:
        lib = _lib()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                DTYPE_CODES[q.dtype], B, NQ, NKV, S, D,
                *(q.stride(i) for i in range(3)),
                *(k.stride(i) for i in range(3)),
                *(v.stride(i) for i in range(3)),
                *(out.stride(i) for i in range(3)),
                int(bool(causal)), int(window), float(scale), stream,
            )
        check_launch(lib, err, "flash_attention_fwd")
        launches.add()
    return (out, lse) if return_lse else out
