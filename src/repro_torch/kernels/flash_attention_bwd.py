"""Flash-attention backward kernel (CUDA C++, ``csrc/flash_attention_bwd.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/flash_attention_bwd.py``
(``flash_attention_bwd``: ``_dq_kernel``, ``pallas_call`` at :161, and
``_dkv_kernel``, ``pallas_call`` at :181).  The source file's header states
what bounds it on the H100 and what its design does about that.  One call
of :func:`flash_attention_bwd` launches the source's two entry points on
the current stream: the dq kernel (which also writes ``delta = rowsum(dout
* out)`` to a scratch array) and then the dk/dv kernel (which reads it and
sums dk, dv over each kv head's GQA group in f32).  f32 operands run on the
CUDA cores; bf16 and f16 on the tensor cores, where the dk/dv launch works
per q head into f32 scratch that a third kernel sums per kv head.  The layout and
signature are the JAX function's; operands are read through strides, so
the model's transposed (B, S, N, HD) views need no copy, and the gradients
are allocated in that (B, S, N, D) memory order.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.cuda_build import check_launch, library
from repro_torch.kernels.flash_attention import DTYPE_CODES, HEAD_DIMS

__all__ = ["flash_attention_bwd", "launches"]

launches = LaunchCounter("flash_attention_bwd")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("flash_attention_bwd")
    for fn, n_ptrs in ((lib.flash_attention_bwd_dq, 8), (lib.flash_attention_bwd_dkv, 10)):
        fn.argtypes = [_P] * n_ptrs + [_I] * 6 + [_L] * 18 + [_I, _I, _F, _P]
        fn.restype = ctypes.c_int
    return lib


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True, window: int = 0,
                        scale=None):
    """q, out, dout: (B, NQ, S, D); k, v: (B, NKV, S, D); lse: (B, NQ, S) f32
    from the forward kernel.  Returns ``(dq, dk, dv)`` in the dtypes and
    shapes of q, k, v.  Any S; D in :data:`HEAD_DIMS`; GQA kv head
    ``q_head // (NQ // NKV)``.  Each operand needs a contiguous last dim;
    other strides are free."""
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be on {q.device} (CUDA)")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name} must be 4-D with a contiguous last dim")
        if t.dtype != q.dtype:
            raise TypeError("flash_attention_bwd: q, k, v, out, dout dtypes differ")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd: unsupported dtype {q.dtype}")
    B, NQ, S, D = q.shape
    NKV = k.shape[1]
    if k.shape != (B, NKV, S, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention_bwd: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError("flash_attention_bwd: out and dout must have q's shape")
    if (lse.device != q.device or lse.dtype != torch.float32 or lse.shape != (B, NQ, S)
            or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd: lse must be a contiguous (B, NQ, S) "
                         f"float32 tensor on {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {D} not in {HEAD_DIMS}")
    if NKV < 1 or NQ % NKV:
        raise ValueError(f"flash_attention_bwd: NQ={NQ} not a multiple of NKV={NKV}")
    if window < 0:
        raise ValueError("flash_attention_bwd: window must be >= 0")
    if scale is None:
        scale = D**-0.5
    dev = q.device
    dq = torch.empty((B, S, NQ, D), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((B, S, NKV, D), dtype=k.dtype, device=dev).transpose(1, 2)
    dv = torch.empty((B, S, NKV, D), dtype=v.dtype, device=dev).transpose(1, 2)
    if B * S:
        delta = torch.empty((B, NQ, S), dtype=torch.float32, device=dev)
        # bf16 / f16 with GQA: each q head's dk, dv in f32, summed per kv head.
        part = (None, None)
        if q.dtype != torch.float32 and NQ > NKV:
            part = tuple(torch.empty((B, NQ, S, D), dtype=torch.float32, device=dev)
                         for _ in range(2))
        lib = _lib()
        dims = (DTYPE_CODES[q.dtype], B, NQ, NKV, S, D)
        tail = (int(bool(causal)), int(window), float(scale))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.flash_attention_bwd_dq(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims,
                *_strides(q, k, v, out, dout, dq), *tail, stream,
            )
            check_launch(lib, err, "flash_attention_bwd (dq)")
            err = lib.flash_attention_bwd_dkv(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *(None if t is None else t.data_ptr() for t in part), *dims,
                *_strides(q, k, v, dout, dk, dv), *tail, stream,
            )
            check_launch(lib, err, "flash_attention_bwd (dk/dv)")
        launches.add()
    return dq, dk, dv
