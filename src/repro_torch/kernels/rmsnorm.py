"""Fused RMSNorm kernel in Triton.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py``
(``rms_norm_fwd``, ``pallas_call`` at :43, ``_kernel`` at :18).

Bound on the H100: memory.  One row reduction plus an elementwise scale,
a few FLOPs per element against the bytes of x read once and y written
once; nothing for the tensor cores to do, so Triton serves as well as CUDA
would.  Design: one program per row with the whole row in one masked block
(``BLOCK_D = next_pow2(D)``, any D from 16 to 8192), f32 mean-square and
scale in registers, one read of x and w and one write of y in x's dtype —
no intermediate touches device memory.  ``offset`` uses the gemma
``(1 + w)`` scale.  ``triton`` is imported, and the kernel defined, on the
first launch only.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.counters import LaunchCounter

__all__ = ["rms_norm_fwd", "launches", "MAX_D"]

launches = LaunchCounter("rms_norm_fwd")
MAX_D = 8192
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
tl = None  # triton.language, bound on first launch (the kernel reads it as a global)


@functools.lru_cache(maxsize=None)
def _kernel():
    global tl
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def rms_norm_kernel(X, W, Y, D, eps, OFFSET: tl.constexpr, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < D
        x = tl.load(X + row * D + cols, mask=mask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / D
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(W + cols, mask=mask, other=0.0)
        if OFFSET:
            w = 1.0 + w
        y = x * rstd * w
        tl.store(Y + row * D + cols, y.to(Y.dtype.element_ty), mask=mask)

    return triton, rms_norm_kernel


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                 offset: bool = False) -> torch.Tensor:
    """x: (..., D) contiguous CUDA tensor; w: (D,) f32.  Returns RMSNorm(x)
    scaled by ``w`` (or ``1 + w``) in x's dtype.  Raises on anything the
    kernel does not take."""
    if not x.is_cuda:
        raise ValueError(f"rms_norm_fwd needs a CUDA tensor, got {x.device}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rms_norm_fwd: unsupported dtype {x.dtype}")
    if w.dtype != torch.float32 or w.dim() != 1 or not w.is_contiguous():
        raise TypeError("rms_norm_fwd: w must be a contiguous 1-D float32 tensor")
    D = x.shape[-1]
    if w.shape[0] != D or not 1 <= D <= MAX_D:
        raise ValueError(f"rms_norm_fwd: bad feature dim {D} (w {tuple(w.shape)})")
    if not x.is_contiguous():
        raise ValueError("rms_norm_fwd: x must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return y
    triton, kernel = _kernel()
    block_d = triton.next_power_of_2(D)
    num_warps = 4 if block_d <= 1024 else (8 if block_d <= 4096 else 16)
    with torch.cuda.device(x.device):
        kernel[(rows,)](x, w, y, D, float(eps), OFFSET=bool(offset),
                        BLOCK_D=block_d, num_warps=num_warps)
    launches.add()
    return y
