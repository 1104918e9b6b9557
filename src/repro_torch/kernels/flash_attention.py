"""Flash-attention forward kernel (CUDA C++, ``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_fwd``, ``pallas_call`` at :119, ``_kernel`` at :30).
The source file's header states what bounds it on the H100 and what its
design does about that.  This wrapper keeps the JAX kernel's layout and
signature; the kernel reads its operands through strides, so callers may
pass transposed views of the model's (B, S, N, HD) activations without a
copy, and the output is allocated in that (B, S, NQ, D) memory order.

Two kernels sit behind the one entry point, chosen by :func:`flash_route`
from the dtype and head dim alone: bf16 / f16 at D = 64, 80, 96, 128, 256
go to the tensor-core kernel (``wgmma`` fed by TMA), everything else (f32,
and D = 16, 32) to the CUDA-core kernel.  TMA needs 16-byte-aligned
operands and byte strides that are multiples of 16; the wrapper raises for
a tensor-core call that breaks that rule (nothing falls back to the other
kernel).  An optional (B,) int32 ``prefix_len`` adds the prefix-LM term of
the JAX model's mask (paligemma's image prefix) on both kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.cuda_build import check_launch, library

__all__ = ["flash_attention_fwd", "flash_route", "check_prefix", "launches", "HEAD_DIMS"]

launches = LaunchCounter("flash_attention_fwd")
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)  # every attention kernel has these
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TENSOR_CORE_HEAD_DIMS = (64, 80, 96, 128, 256)


def flash_route(dtype, D: int) -> str:
    """Which kernel a CUDA call of ``dtype`` and head dim ``D`` launches:
    ``"wgmma"`` (tensor cores, TMA loads) for bf16 / f16 at D in
    :data:`TENSOR_CORE_HEAD_DIMS`, ``"cuda_core"`` otherwise.  f32 keeps
    full precision (TF32 would break its 1e-4 checks); D <= 32 is on no
    full-width path.  D = 80 / 96 (hubert-xlarge, phi3-mini) are no whole
    64-wide box, so their tiles take 16 / 32-wide boxes with 32 / 64-byte
    swizzle (``csrc/hopper.cuh`` ``FeatureBoxes``)."""
    if dtype in (torch.bfloat16, torch.float16) and D in TENSOR_CORE_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


def check_16b(what: str, name: str, t) -> None:
    """Raise unless ``t`` has a 16-byte-aligned base and every stride but the
    last is a whole number of 16-byte units (a size-1 dim's stride is never
    used): what TMA and 16-byte vector loads need."""
    es = t.element_size()
    if t.data_ptr() % 16 or any(t.shape[i] > 1 and (t.stride(i) * es) % 16
                                for i in range(t.dim() - 1)):
        raise ValueError(f"{what}: {name} strides {tuple(t.stride())} / base "
                         f"{t.data_ptr():#x} are not in 16-byte units")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("flash_attention")
    lib.flash_attention_fwd.argtypes = [_P] * 6 + [_I] * 6 + [_L] * 12 + [_I, _I, _F, _P]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def check_prefix(what: str, prefix_len, q) -> None:
    """Raise unless ``prefix_len`` is a (B,) int32 tensor on q's device (or
    None): the kernels read it as a device array of C ints."""
    if prefix_len is None:
        return
    if (prefix_len.device != q.device or prefix_len.dtype != torch.int32
            or tuple(prefix_len.shape) != (q.shape[0],) or not prefix_len.is_contiguous()):
        raise ValueError(f"{what}: prefix_len must be a contiguous ({q.shape[0]},) int32 "
                         f"tensor on {q.device}")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale=None, return_lse: bool = False, prefix_len=None):
    """q: (B, NQ, S, D); k, v: (B, NKV, S, D) -> (B, NQ, S, D) in q's dtype
    (+ f32 LSE (B, NQ, S) when ``return_lse``).  Any S; D in
    :data:`HEAD_DIMS`; GQA kv head ``q_head // (NQ // NKV)``.  Each operand
    needs a contiguous last dim; other strides are free.  ``prefix_len``:
    (B,) int32 prefix-LM lengths on the same device, or None; every query
    of row b also sees keys ``< prefix_len[b]``."""
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
    check_prefix("flash_attention_fwd", prefix_len, q)
    if scale is None:
        scale = D**-0.5
    if flash_route(q.dtype, D) == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_16b("flash_attention_fwd (TMA)", name, t)
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
                prefix_len.data_ptr() if prefix_len is not None else None,
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
