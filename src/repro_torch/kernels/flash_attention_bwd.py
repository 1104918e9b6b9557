"""Flash-attention backward kernel (CUDA C++, ``csrc/flash_attention_bwd.cu``).

Replaces the Pallas TPU kernels ``repro/kernels/flash_attention_bwd.py``
(``flash_attention_bwd``: ``_dq_kernel``, ``pallas_call`` at :161, and
``_dkv_kernel``, ``pallas_call`` at :181).  The source file's header states
what bounds it on the H100 and what its design does about that.

:func:`bwd_route` picks one of three implementations from the dtype and
head dim alone:

* ``"wgmma"`` (bf16 / f16 at D = 64, 80, 96, 128, 256): TMA loads and
  ``wgmma`` on the tensor cores; one call launches an LSE / delta pass, one grid of
  the dk/dv blocks (key tile, head group; planned by :func:`bwd_plan`)
  and the dq blocks, and, when there is more than one group, a merge of
  the groups' f32 partials in group order.  TMA needs 16-byte-aligned
  operands with strides in 16-byte units: the wrapper raises otherwise
  (nothing falls back).
* ``"wmma"`` (bf16 / f16 at D = 16, 32) and ``"cuda_core"`` (f32):
  a dq launch (which also writes ``delta = rowsum(dout * out)``) and a
  dk/dv launch; the WMMA one works per q head into f32 scratch that a
  third kernel sums per kv head.

The layout and signature are the JAX function's; operands are read through
strides, so the model's transposed (B, S, N, HD) views need no copy, and
the gradients are allocated in that (B, S, N, D) memory order.  One call
counts one launch, whatever the route.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.cuda_build import check_launch, library
from repro_torch.kernels.decode_attention import _sm_count
from repro_torch.kernels.flash_attention import (DTYPE_CODES, HEAD_DIMS,
                                                  TENSOR_CORE_HEAD_DIMS, check_16b,
                                                  check_prefix)

__all__ = ["flash_attention_bwd", "bwd_route", "bwd_plan", "wgmma_rows", "launches"]

launches = LaunchCounter("flash_attention_bwd")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


def bwd_route(dtype, D: int) -> str:
    """Which implementation a CUDA call of ``dtype`` and head dim ``D``
    launches: ``"wgmma"`` for bf16 / f16 at D in
    :data:`~repro_torch.kernels.flash_attention.TENSOR_CORE_HEAD_DIMS` (D =
    80 / 96 in 16 / 32-wide feature boxes, as the forward), ``"wmma"`` for
    bf16 / f16 at D = 16 / 32 (on no full-width path), ``"cuda_core"`` for
    f32 (full precision)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma" if D in TENSOR_CORE_HEAD_DIMS else "wmma"
    return "cuda_core"


def wgmma_rows(D: int) -> int:
    """Fixed rows of a wgmma block at head dim ``D``: 64 at D = 128 / 256
    (the two consumer warpgroups share them and split the columns), 128 at
    D = 64 / 80 / 96 (each owns 64 with all D columns: half of 80 or 96
    would cut through a feature box).  The kernel refuses a launch planned
    with other rows (``csrc`` ``tcb::Layout<D>::kRows``), and it states its
    shared memory as a compile-time bound."""
    if D not in TENSOR_CORE_HEAD_DIMS:
        raise ValueError(f"wgmma_rows: head dim {D} not in {TENSOR_CORE_HEAD_DIMS}")
    return 64 if D >= 128 else 128


def bwd_plan(B: int, NQ: int, NKV: int, S: int, D: int, sm_count: int):
    """``(rows, heads_per_group, n_groups)`` of the wgmma dk/dv pass: a block
    per (key tile of ``rows`` keys, group of ``heads_per_group`` consecutive
    q heads of one kv head, batch); the last group of a kv head may be
    shorter.  The fewest groups whose ``B * NKV * ceil(S / rows) *
    n_groups`` blocks reach ``sm_count`` (one wave), at most one group per q
    head.  One group writes dk / dv directly; more sum f32 partials in group
    order."""
    if D not in TENSOR_CORE_HEAD_DIMS:
        raise ValueError(f"bwd_plan: head dim {D} not in {TENSOR_CORE_HEAD_DIMS}")
    if min(B, NQ, NKV, S, sm_count) < 1 or NQ % NKV:
        raise ValueError(f"bwd_plan: B={B} NQ={NQ} NKV={NKV} S={S} sm_count={sm_count}")
    G = NQ // NKV
    rows = wgmma_rows(D)
    blocks = B * NKV * -(-S // rows)
    want = min(G, -(-sm_count // blocks))
    hpg = -(-G // want)
    return rows, hpg, -(-G // hpg)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("flash_attention_bwd")
    for fn, n_ptrs in ((lib.flash_attention_bwd_dq, 9), (lib.flash_attention_bwd_dkv, 11)):
        fn.argtypes = [_P] * n_ptrs + [_I] * 6 + [_L] * 18 + [_I, _I, _F, _P]
        fn.restype = ctypes.c_int
    lib.flash_attention_bwd_tc.argtypes = [_P] * 14 + [_I] * 9 + [_L] * 24 + [_I, _I, _F, _P]
    lib.flash_attention_bwd_tc.restype = ctypes.c_int
    return lib


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True, window: int = 0,
                        scale=None, prefix_len=None):
    """q, out, dout: (B, NQ, S, D); k, v: (B, NKV, S, D); lse: (B, NQ, S) f32
    from the forward kernel.  Returns ``(dq, dk, dv)`` in the dtypes and
    shapes of q, k, v.  Any S; D in :data:`HEAD_DIMS`; GQA kv head
    ``q_head // (NQ // NKV)``.  Each operand needs a contiguous last dim;
    other strides are free.  ``prefix_len``: the forward's (B,) int32
    prefix-LM lengths, or None."""
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
    check_prefix("flash_attention_bwd", prefix_len, q)
    if scale is None:
        scale = D**-0.5
    route = bwd_route(q.dtype, D)
    if route == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
            check_16b("flash_attention_bwd (TMA)", name, t)
    dev = q.device
    dq = torch.empty((B, S, NQ, D), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((B, S, NKV, D), dtype=k.dtype, device=dev).transpose(1, 2)
    dv = torch.empty((B, S, NKV, D), dtype=v.dtype, device=dev).transpose(1, 2)
    if B * S:
        lib = _lib()
        tail = (int(bool(causal)), int(window), float(scale))
        pre = prefix_len.data_ptr() if prefix_len is not None else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if route == "wgmma":
                rows, hpg, n_groups = bwd_plan(B, NQ, NKV, S, D, _sm_count(dev.index))
                S_pad = -(-S // 128) * 128
                vec = torch.empty((2, B, NQ, S_pad), dtype=torch.float32, device=dev)
                part = (torch.empty((2, n_groups, B, NKV, S, D), dtype=torch.float32, device=dev)
                        if n_groups > 1 else None)
                err = lib.flash_attention_bwd_tc(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), vec[0].data_ptr(), vec[1].data_ptr(),
                    *((part[0].data_ptr(), part[1].data_ptr()) if part is not None
                      else (None, None)),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), pre,
                    DTYPE_CODES[q.dtype], B, NQ, NKV, S, D, S_pad, rows, hpg,
                    *_strides(q, k, v, out, dout, dq, dk, dv), *tail, stream,
                )
                check_launch(lib, err, "flash_attention_bwd (wgmma)")
            else:
                _launch_two_pass(lib, q, k, v, out, dout, lse, dq, dk, dv, pre, tail, stream)
        launches.add()
    return dq, dk, dv


def _launch_two_pass(lib, q, k, v, out, dout, lse, dq, dk, dv, pre, tail, stream):
    """The "wmma" and "cuda_core" routes: the dq launch, then the dk/dv one."""
    B, NQ, S, D = q.shape
    NKV = k.shape[1]
    dev = q.device
    delta = torch.empty((B, NQ, S), dtype=torch.float32, device=dev)
    # bf16 / f16 with GQA: each q head's dk, dv in f32, summed per kv head.
    part = (None, None)
    if q.dtype != torch.float32 and NQ > NKV:
        part = tuple(torch.empty((B, NQ, S, D), dtype=torch.float32, device=dev)
                     for _ in range(2))
    dims = (DTYPE_CODES[q.dtype], B, NQ, NKV, S, D)
    err = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), pre, *dims,
        *_strides(q, k, v, out, dout, dq), *tail, stream,
    )
    check_launch(lib, err, "flash_attention_bwd (dq)")
    err = lib.flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(None if t is None else t.data_ptr() for t in part), pre, *dims,
        *_strides(q, k, v, dout, dk, dv), *tail, stream,
    )
    check_launch(lib, err, "flash_attention_bwd (dk/dv)")
