"""Plain PyTorch versions of every ported kernel (CPU path and oracles).

Each function computes what its kernel computes, written the way the JAX
package's ``models/`` code writes it (``repro.kernels.ref`` wraps the same
functions), so the CPU path of the port matches the JAX model.  The
kernels follow the Pallas kernels where the two differ: the attention
kernels keep the softmax weights in f32 for P.V, while these versions
cast them to the value dtype first (``models/attention.py``).  In f32 the
two agree to summation order; in bf16 within 2e-2.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "rms_norm_ref",
    "attention_bsnd",
    "decode_bsnd",
    "flash_attention_ref",
    "decode_attention_ref",
    "paged_decode_bsnd",
    "decode_attention_paged_ref",
    "flash_attention_bwd_ref",
    "rms_norm_bwd_ref",
    "rglru_scan_ref",
    "rglru_scan_bwd_ref",
]

_NEG_INF = -1e30  # finite masked-score sentinel (a fully masked row -> mean of v)


def rms_norm_ref(x, w, *, eps: float = 1e-6, offset: bool = False):
    """RMSNorm over the last dim in f32; ``offset`` scales by ``(1 + w)``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    wf = w.float()
    return (y * ((1.0 + wf) if offset else wf)).to(x.dtype)


def rms_norm_bwd_ref(x, w, dy, *, eps: float = 1e-6, offset: bool = False):
    """Gradients ``(dx, dw)`` of :func:`rms_norm_ref` for the cotangent ``dy``.

    Recomputes ``r = rsqrt(mean(x^2) + eps)`` in f32 and returns
    ``dx = r * (g - x * r^2 * mean(g * x))`` with ``g = dy * w'`` (``w' = w``
    or ``1 + w``) in x's dtype, and ``dw = sum(dy * x * r)`` over every
    leading dim in w's dtype.  This is what ``jax.grad`` of the JAX
    package's ``jnp`` norm computes; the JAX package has no Pallas backward
    for RMSNorm.
    """
    xf, gy = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    wf = w.float()
    g = gy * ((1.0 + wf) if offset else wf)
    dx = r * (g - xf * r.square() * (g * xf).mean(dim=-1, keepdim=True))
    dw = (gy * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _scores_mask(sq: int, skv: int, *, causal: bool, window: int, device):
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        ok &= qpos >= kpos
    if window:
        ok &= (qpos - kpos) < window
    return ok


def attention_bsnd(q, k, v, *, causal: bool = True, window: int = 0,
                   scale: Optional[float] = None, return_lse: bool = False):
    """Naive attention in the model layout.

    q: (B, Sq, NQ, HD); k, v: (B, Skv, NKV, HD), NQ % NKV == 0 (GQA kv head
    ``q_head // G``).  Returns (B, Sq, NQ, HD) in q's dtype, plus the f32
    log-sum-exp (B, NQ, Sq) when ``return_lse``.
    """
    B, Sq, NQ, HD = q.shape
    Skv, NKV = k.shape[1], k.shape[2]
    G = NQ // NKV
    if scale is None:
        scale = HD**-0.5
    qg = q.reshape(B, Sq, NKV, G, HD)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    ok = _scores_mask(Sq, Skv, causal=causal, window=window, device=q.device)
    s = torch.where(ok, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    out = out.reshape(B, Sq, NQ, HD).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, NQ, Sq)
    return out


def decode_bsnd(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                scale: Optional[float] = None):
    """One query token per row against a ring cache, in the model layout.

    q: (B, 1, NQ, HD); caches: (B, S, NKV, HD); slot_pos: (B, S) absolute
    position per slot (-1 empty); pos: (B,).  Valid slots satisfy
    ``0 <= slot_pos <= pos`` (and ``slot_pos > pos - window``).
    """
    B, _, NQ, HD = q.shape
    NKV = k_cache.shape[2]
    G = NQ // NKV
    if scale is None:
        scale = HD**-0.5
    qg = q.reshape(B, 1, NKV, G, HD)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) * scale
    pos = pos.to(slot_pos.dtype)[:, None]
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        ok &= slot_pos > (pos - window)
    s = torch.where(ok[:, None, None, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, NQ, HD).to(q.dtype)


def paged_decode_bsnd(q, k_pool, v_pool, page_tables, pos, *, window: int = 0,
                      scale: Optional[float] = None):
    """One query token per row against a block-paged pool, in the model layout.

    q: (B, 1, NQ, HD); pools: (P, page, NKV, HD); page_tables: (B, NB) page
    ids per row; pos: (B,).  Pages are append-only, so the entry at a row's
    dense index ``i`` (page ``i // page``, offset ``i % page``) holds
    absolute position ``i``: gather the dense (B, NB * page) view and mask
    it with ``slot_pos = arange``, as ``models/attention.py`` of the JAX
    package does.
    """
    P, page, NKV, HD = k_pool.shape
    B, NB = page_tables.shape
    S = NB * page
    offs = torch.arange(page, device=page_tables.device)
    flat = (page_tables.long()[:, :, None] * page + offs).reshape(B, S)
    k_dense = k_pool.reshape(P * page, NKV, HD)[flat]  # (B, S, NKV, HD)
    v_dense = v_pool.reshape(P * page, NKV, HD)[flat]
    slot_pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    return decode_bsnd(q, k_dense, v_dense, slot_pos, pos, window=window, scale=scale)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, return_lse: bool = False):
    """Kernel layout: q (B, NQ, S, D); k, v (B, NKV, S, D) -> (B, NQ, S, D)."""
    res = attention_bsnd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=scale, return_lse=return_lse,
    )
    if return_lse:
        return res[0].transpose(1, 2), res[1]
    return res.transpose(1, 2)


def decode_attention_ref(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                         scale: Optional[float] = None):
    """Kernel layout: q (B, NKV, G, D); caches (B, NKV, S, D) -> (B, NKV, G, D)."""
    B, NKV, G, D = q.shape
    out = decode_bsnd(
        q.reshape(B, 1, NKV * G, D), k_cache.transpose(1, 2),
        v_cache.transpose(1, 2), slot_pos, pos, window=window, scale=scale,
    )
    return out.reshape(B, NKV, G, D)


def decode_attention_paged_ref(q, k_pool, v_pool, page_tables, pos, *, window: int = 0,
                               scale: Optional[float] = None):
    """Kernel layout: q (B, NKV, G, D); pools (P, NKV, page, D) -> (B, NKV, G, D)."""
    B, NKV, G, D = q.shape
    out = paged_decode_bsnd(
        q.reshape(B, 1, NKV * G, D), k_pool.transpose(1, 2),
        v_pool.transpose(1, 2), page_tables, pos, window=window, scale=scale,
    )
    return out.reshape(B, NKV, G, D)


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, causal: bool = True,
                            window: int = 0, scale: Optional[float] = None):
    """Backward of :func:`flash_attention_ref`, recomputed from the LSE.

    Kernel layout: q, out, dout (B, NQ, S, D); k, v (B, NKV, S, D); lse
    (B, NQ, S) f32 from the forward.  The math of the Pallas backward
    (``repro/kernels/flash_attention_bwd.py``), all in f32:
    ``delta = rowsum(dout * out)``, ``p = exp(s - lse)`` with masked
    scores at the finite sentinel -1e30, ``ds = p * (dp - delta) * scale``;
    dk and dv are summed over each kv head's GQA group.  Returns
    ``(dq, dk, dv)`` in the dtypes of q, k and v.
    """
    B, NQ, S, D = q.shape
    NKV = k.shape[1]
    G = NQ // NKV
    if scale is None:
        scale = D**-0.5
    qf = q.float().reshape(B, NKV, G, S, D)
    dof = dout.float().reshape(B, NKV, G, S, D)
    kf, vf = k.float(), v.float()
    delta = (dout.float() * out.float()).sum(-1).reshape(B, NKV, G, S, 1)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    ok = _scores_mask(S, S, causal=causal, window=window, device=q.device)
    s = torch.where(ok, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse.float().reshape(B, NKV, G, S, 1))
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf).reshape(B, NQ, S, D)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rglru_scan_ref(a, b, h0):
    """``h_t = a_t * h_{t-1} + b_t`` (``h_{-1} = h0``).  a, b: (B, S, W); h0:
    (B, W).  Accumulates in f32 (a rounded multiply, then a rounded add, step
    by step) and returns h in a's dtype, as ``repro.kernels.ref``'s
    associative-scan version does up to summation order."""
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def rglru_scan_bwd_ref(a, h, h0, dh):
    """Gradients ``(da, db, dh0)`` of :func:`rglru_scan_ref` for the
    cotangent ``dh``, from ``a``, the output ``h`` and ``h0``: the adjoint
    recurrence ``g_{S-1} = dh_{S-1}``, ``g_t = dh_t + a_{t+1} g_{t+1}``,
    then ``db = g``, ``da_t = g_t h_{t-1}`` (``h_{-1} = h0``) and ``dh0 =
    a_0 g_0``, all in f32, returned in the dtypes of a, a and h0."""
    af, dhf = a.float(), dh.float()
    S = a.shape[1]
    g = torch.empty_like(dhf)
    carry = torch.zeros_like(dhf[:, 0])
    for t in range(S - 1, -1, -1):
        carry = (af[:, t + 1] * carry + dhf[:, t]) if t + 1 < S else dhf[:, t]
        g[:, t] = carry
    h_prev = torch.cat([h0.float()[:, None], h[:, :-1].float()], dim=1)
    da = g * h_prev
    dh0 = af[:, 0] * g[:, 0]
    return da.to(a.dtype), g.to(a.dtype), dh0.to(h0.dtype)
