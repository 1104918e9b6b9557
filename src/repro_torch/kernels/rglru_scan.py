"""RG-LRU scan kernel (CUDA C++, ``csrc/rglru_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``rglru_scan_fwd``, ``pallas_call`` at :59, ``_kernel`` at :27): the
linear recurrence ``h_t = a_t * h_{t-1} + b_t`` from ``h0`` with an f32
carry.  The source file's header states what bounds it on the H100 and
what its design does about that.  This wrapper keeps the JAX kernel's
layout and signature (a, b (B, S, W); h0 (B, W)); operands are read
through (batch, seq) strides with a contiguous channel dim.

:func:`rglru_scan_bwd` is the gradient on the card.  The adjoint of the
recurrence is the same linear recurrence run backwards in time,
``g_t = dh_t + a_{t+1} * g_{t+1}``, so it launches this kernel once over
the reversed sequence and finishes ``da``, ``db``, ``dh0`` elementwise.
The JAX package has no Pallas backward here (its gradient is ``jax.grad``
of the associative scan).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.counters import LaunchCounter
from repro_torch.kernels.cuda_build import check_launch, library
from repro_torch.kernels.flash_attention import DTYPE_CODES

__all__ = ["rglru_scan_fwd", "rglru_scan_bwd", "launches"]

launches = LaunchCounter("rglru_scan_fwd")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.lru_cache(maxsize=None)
def _lib():
    lib = library("rglru_scan")
    lib.rglru_scan_fwd.argtypes = [_P] * 4 + [_I] * 5 + [_L] * 7 + [_P]
    lib.rglru_scan_fwd.restype = ctypes.c_int
    return lib


def rglru_scan_fwd(a, b, h0):
    """a, b: (B, S, W) of one dtype (f32, bf16 or f16); h0: (B, W) of any of
    the three.  Returns h (B, S, W) in a's dtype with ``h_t = a_t * h_{t-1}
    + b_t`` (``h_{-1} = h0``), carried in f32.  Any S and W; each operand
    needs a contiguous last dim, other strides are free."""
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"rglru_scan_fwd: {name} must be on {a.device} (CUDA)")
        if t.stride(-1) != 1:
            raise ValueError(f"rglru_scan_fwd: {name} needs a contiguous last dim")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype or h0.dtype not in DTYPE_CODES:
        raise TypeError(f"rglru_scan_fwd: dtypes a={a.dtype} b={b.dtype} h0={h0.dtype} "
                        "not supported (a and b alike; f32, bf16 or f16)")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"rglru_scan_fwd: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)}; need (B, S, W), (B, S, W), (B, W)")
    B, S, W = a.shape
    if B > 65535:
        raise ValueError(f"rglru_scan_fwd: batch {B} > 65535")
    out = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    if B * S * W:
        lib = _lib()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.rglru_scan_fwd(
                a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(),
                DTYPE_CODES[a.dtype], DTYPE_CODES[h0.dtype], B, S, W,
                a.stride(0), a.stride(1), b.stride(0), b.stride(1), h0.stride(0),
                out.stride(0), out.stride(1), stream,
            )
        check_launch(lib, err, "rglru_scan_fwd")
        launches.add()
    return out


def rglru_scan_bwd(a, h, h0, dh):
    """Gradients ``(da, db, dh0)`` of :func:`rglru_scan_fwd` for the
    cotangent ``dh``, from the saved ``a``, output ``h`` and ``h0``.

    ``g = db`` solves ``g_t = dh_t + a_{t+1} g_{t+1}`` (``g_{S-1} =
    dh_{S-1}``): one launch of the scan kernel over the reversed sequence
    with coefficients ``[0, a_{S-1}, ..., a_1]``, inputs ``flip(dh)`` and a
    zero initial state.  Then ``da_t = g_t h_{t-1}`` (``h_{-1} = h0``) and
    ``dh0 = a_0 g_0``, in f32, returned in the dtypes of a, a and h0."""
    B, S, W = a.shape
    coef = torch.zeros_like(a)
    coef[:, 1:] = a.flip(1)[:, :-1]
    g = rglru_scan_fwd(coef, dh.to(a.dtype).flip(1),
                       torch.zeros((B, W), dtype=torch.float32, device=a.device)).flip(1)
    gf = g.float()
    h_prev = torch.cat([h0.float()[:, None], h[:, :-1].float()], dim=1)
    da = (gf * h_prev).to(a.dtype)
    dh0 = (a[:, 0].float() * gf[:, 0]).to(h0.dtype)
    return da, g, dh0
