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

from repro_torch.kernels.decode_attention import MAX_CHUNK, paged_chunks

__all__ = [
    "rms_norm_ref",
    "attention_bsnd",
    "decode_bsnd",
    "flash_attention_ref",
    "decode_attention_ref",
    "decode_attention_split_ref",
    "paged_decode_bsnd",
    "decode_attention_paged_ref",
    "decode_attention_paged_split_ref",
    "flash_attention_bwd_ref",
    "flash_attention_bwd_tiled_ref",
    "rms_norm_bwd_ref",
    "rglru_scan_ref",
    "rglru_scan_bwd_ref",
    "rglru_scan_chunked_ref",
]

_NEG_INF = -1e30  # finite masked-score sentinel (a fully masked row -> mean of v)


def _f32_at_least(t):
    """``t`` in f32, or in float64 if it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rms_norm_ref(x, w, *, eps: float = 1e-6, offset: bool = False):
    """RMSNorm over the last dim in f32 (float64 for a float64 ``x``);
    ``offset`` scales by ``(1 + w)``."""
    xf = _f32_at_least(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    wf = _f32_at_least(w)
    return (y * ((1.0 + wf) if offset else wf)).to(x.dtype)


def rms_norm_bwd_ref(x, w, dy, *, eps: float = 1e-6, offset: bool = False):
    """Gradients ``(dx, dw)`` of :func:`rms_norm_ref` for the cotangent ``dy``.

    Recomputes ``r = rsqrt(mean(x^2) + eps)`` in f32 (float64 for float64
    operands) and returns
    ``dx = r * (g - x * r^2 * mean(g * x))`` with ``g = dy * w'`` (``w' = w``
    or ``1 + w``) in x's dtype, and ``dw = sum(dy * x * r)`` over every
    leading dim in w's dtype.  This is what ``jax.grad`` of the JAX
    package's ``jnp`` norm computes; the JAX package has no Pallas backward
    for RMSNorm.
    """
    xf, gy = _f32_at_least(x), _f32_at_least(dy)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    wf = _f32_at_least(w)
    g = gy * ((1.0 + wf) if offset else wf)
    dx = r * (g - xf * r.square() * (g * xf).mean(dim=-1, keepdim=True))
    dw = (gy * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _scores_mask(sq: int, skv: int, *, causal: bool, window: int, device, prefix_len=None):
    """The visible (query, key) pairs: (sq, skv), or (B, 1, 1, sq, skv) with
    ``prefix_len`` (B,), the JAX model's rule ``(causal & window) | (kpos <
    prefix_len[b])``: every query sees its row's prefix keys."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        ok &= qpos >= kpos
    if window:
        ok &= (qpos - kpos) < window
    if prefix_len is not None:
        pre = kpos < prefix_len.to(device=device, dtype=torch.long)[:, None, None]
        ok = (ok | pre)[:, None, None]
    return ok


def attention_bsnd(q, k, v, *, causal: bool = True, window: int = 0,
                   scale: Optional[float] = None, return_lse: bool = False, prefix_len=None):
    """Naive attention in the model layout.

    q: (B, Sq, NQ, HD); k, v: (B, Skv, NKV, HD), NQ % NKV == 0 (GQA kv head
    ``q_head // G``); ``prefix_len``: (B,) int or None, the prefix-LM
    boundary (see :func:`_scores_mask`).  Returns (B, Sq, NQ, HD) in q's
    dtype, plus the f32 log-sum-exp (B, NQ, Sq) when ``return_lse``.
    """
    B, Sq, NQ, HD = q.shape
    Skv, NKV = k.shape[1], k.shape[2]
    G = NQ // NKV
    if scale is None:
        scale = HD**-0.5
    qg = q.reshape(B, Sq, NKV, G, HD)
    s = torch.einsum("bqkgd,bskd->bkgqs", _f32_at_least(qg), _f32_at_least(k)) * scale
    ok = _scores_mask(Sq, Skv, causal=causal, window=window, device=q.device,
                      prefix_len=prefix_len)
    s = torch.where(ok, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    out = out.reshape(B, Sq, NQ, HD).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, NQ, Sq)
    return out


def decode_bsnd(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                scale: Optional[float] = None, return_lse: bool = False):
    """One query token per row against a ring cache, in the model layout.

    q: (B, 1, NQ, HD); caches: (B, S, NKV, HD); slot_pos: (B, S) absolute
    position per slot (-1 empty); pos: (B,).  Valid slots satisfy
    ``0 <= slot_pos <= pos`` (and ``slot_pos > pos - window``).  With
    ``return_lse`` also the log-sum-exp (B, NQ) of each row's scaled
    scores, masked ones at the -1e30 sentinel (so about -1e30 for a row
    with no valid slot), f32 at least.
    """
    B, _, NQ, HD = q.shape
    NKV = k_cache.shape[2]
    G = NQ // NKV
    if scale is None:
        scale = HD**-0.5
    qg = q.reshape(B, 1, NKV, G, HD)
    s = torch.einsum("bqkgd,bskd->bkgqs", _f32_at_least(qg),
                     _f32_at_least(k_cache)) * scale
    pos = pos.to(slot_pos.dtype)[:, None]
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        ok &= slot_pos > (pos - window)
    s = torch.where(ok[:, None, None, None, :], s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype), v_cache)
    out = out.reshape(B, 1, NQ, HD).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, NQ)
    return out


def paged_decode_bsnd(q, k_pool, v_pool, page_tables, pos, *, window: int = 0,
                      scale: Optional[float] = None):
    """One query token per row against a block-paged pool, in the model layout.

    q: (B, 1, NQ, HD); pools: (P, page, NKV, HD); page_tables: (B, NB) page
    ids per row; pos: (B,).  Pages are append-only, so the entry at a row's
    dense index ``i`` (page ``i // page``, offset ``i % page``) holds
    absolute position ``i``: gather the dense (B, NB * page) view and mask
    it with ``slot_pos = arange``, as ``models/attention.py`` of the JAX
    package does.

    Each row is its own batch-1 call: a batched ``einsum`` may sum a row's
    scores in another order at another batch size (measured on an AVX-512
    CPU: 1.9e-6 apart at B = 8 against B = 1), and a padded ladder batch
    must give its real rows bitwise what they get alone.
    """
    P, page, NKV, HD = k_pool.shape
    B, NB = page_tables.shape
    S = NB * page
    offs = torch.arange(page, device=page_tables.device)
    flat = (page_tables.long()[:, :, None] * page + offs).reshape(B, S)
    k_dense = k_pool.reshape(P * page, NKV, HD)[flat]  # (B, S, NKV, HD)
    v_dense = v_pool.reshape(P * page, NKV, HD)[flat]
    slot_pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(1, S)
    return torch.cat([
        decode_bsnd(q[b:b + 1], k_dense[b:b + 1], v_dense[b:b + 1], slot_pos, pos[b:b + 1],
                    window=window, scale=scale)
        for b in range(B)
    ])


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, return_lse: bool = False,
                        prefix_len=None):
    """Kernel layout: q (B, NQ, S, D); k, v (B, NKV, S, D) -> (B, NQ, S, D)."""
    res = attention_bsnd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, scale=scale, return_lse=return_lse,
        prefix_len=prefix_len,
    )
    if return_lse:
        return res[0].transpose(1, 2), res[1]
    return res.transpose(1, 2)


def decode_attention_ref(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0,
                         scale: Optional[float] = None, return_lse: bool = False):
    """Kernel layout: q (B, NKV, G, D); caches (B, NKV, S, D) -> (B, NKV, G, D);
    with ``return_lse`` also the rows' log-sum-exp (B, NKV, G) (see
    :func:`decode_bsnd`)."""
    B, NKV, G, D = q.shape
    out = decode_bsnd(
        q.reshape(B, 1, NKV * G, D), k_cache.transpose(1, 2),
        v_cache.transpose(1, 2), slot_pos, pos, window=window, scale=scale,
        return_lse=return_lse,
    )
    if return_lse:
        return out[0].reshape(B, NKV, G, D), out[1].reshape(B, NKV, G)
    return out.reshape(B, NKV, G, D)


def decode_attention_split_ref(q, k_cache, v_cache, slot_pos, pos, *, chunk: int,
                               window: int = 0, scale: Optional[float] = None):
    """Test-only model of the ring kernel's split plan, all in f32: the
    slots cut into chunks of ``chunk``; each chunk's partials ``m`` (its
    max score, the sentinel -1e30 if it has no valid key), ``l`` (the sum
    of ``exp(s - m)``: its key count if it has no valid key) and ``acc``
    (``exp(s - m) . v``); then the chunks merged in order with the factors
    ``exp(m_c - M)``.  Kernel layout, as :func:`decode_attention_ref`."""
    B, NKV, G, D = q.shape
    S = k_cache.shape[2]
    if scale is None:
        scale = D**-0.5
    p = pos.to(slot_pos.dtype)[:, None]
    ok = (slot_pos >= 0) & (slot_pos <= p)
    if window:
        ok &= slot_pos > (p - window)
    s = torch.einsum("bhgd,bhsd->bhgs", q.float(), k_cache.float()) * scale
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    parts = []
    for c0 in range(0, S, chunk):
        sc = s[..., c0:c0 + chunk]
        m = sc.amax(dim=-1)
        e = torch.exp(sc - m[..., None])
        acc = torch.einsum("bhgs,bhsd->bhgd", e, v_cache[:, :, c0:c0 + chunk].float())
        parts.append((m, e.sum(dim=-1), acc))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp(m - M)
        L = L + l * f
        O = O + acc * f[..., None]
    return (O / L.clamp_min(1e-30)[..., None]).to(q.dtype)


def decode_attention_paged_ref(q, k_pool, v_pool, page_tables, pos, *, window: int = 0,
                               scale: Optional[float] = None):
    """Kernel layout: q (B, NKV, G, D); pools (P, NKV, page, D) -> (B, NKV, G, D)."""
    B, NKV, G, D = q.shape
    out = paged_decode_bsnd(
        q.reshape(B, 1, NKV * G, D), k_pool.transpose(1, 2),
        v_pool.transpose(1, 2), page_tables, pos, window=window, scale=scale,
    )
    return out.reshape(B, NKV, G, D)


def decode_attention_paged_split_ref(q, k_pool, v_pool, page_tables, pos, *, n_split: int,
                                     window: int = 0, scale: Optional[float] = None,
                                     step: int = MAX_CHUNK):
    """Test-only model of the paged kernel's split, all in f32: each row's
    live span cut into ``n_split`` chunks as the kernel cuts it
    (:func:`~repro_torch.kernels.decode_attention.paged_chunks`; every key
    of the span valid, or, for an empty span, every entry masked); each
    chunk walked ``step`` keys at a time with its partials ``m`` (the max
    score so far), ``l`` and ``acc`` rescaled by ``exp(m_old - m_new)``
    from step to step; chunks past the span skipped; then the chunks merged
    in order with the factors ``exp(m_c - M)``.  Kernel layout, as
    :func:`decode_attention_paged_ref`."""
    B, NKV, G, D = q.shape
    page = k_pool.shape[2]
    S = page_tables.shape[1] * page
    if scale is None:
        scale = D**-0.5
    out = torch.empty((B, NKV, G, D), dtype=torch.float32)
    for b in range(B):
        ids = page_tables[b].long()
        kd = k_pool[ids].float().transpose(0, 1).reshape(NKV, S, D)  # dense index order
        vd = v_pool[ids].float().transpose(0, 1).reshape(NKV, S, D)
        s = torch.einsum("hgd,hsd->hgs", q[b].float(), kd) * scale
        chunks, masked = paged_chunks(int(pos[b]), window, S, n_split)
        if masked:
            s = torch.full_like(s, _NEG_INF)
        parts = []
        for c0, n in chunks:
            if n <= 0:  # past the span: no partials
                continue
            m = l = acc = None
            for s0 in range(c0, c0 + n, step):
                s1 = min(c0 + n, s0 + step)
                sc = s[..., s0:s1]
                m_new = sc.amax(dim=-1) if m is None else torch.maximum(m, sc.amax(dim=-1))
                e = torch.exp(sc - m_new[..., None])
                pv = torch.einsum("hgs,hsd->hgd", e, vd[:, s0:s1])
                if m is None:
                    l, acc = e.sum(dim=-1), pv
                else:
                    corr = torch.exp(m - m_new)
                    l, acc = l * corr + e.sum(dim=-1), acc * corr[..., None] + pv
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        L = torch.zeros_like(M)
        O = torch.zeros_like(parts[0][2])
        for m, l, acc in parts:
            f = torch.exp(m - M)
            L = L + l * f
            O = O + acc * f[..., None]
        out[b] = O / L.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, causal: bool = True,
                            window: int = 0, scale: Optional[float] = None, prefix_len=None):
    """Backward of :func:`flash_attention_ref`, recomputed from the LSE.

    Kernel layout: q, out, dout (B, NQ, S, D); k, v (B, NKV, S, D); lse
    (B, NQ, S) f32 from the forward.  The math of the Pallas backward
    (``repro/kernels/flash_attention_bwd.py``), all in f32 (in float64 for
    float64 inputs, as the forward keeps them):
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
    qf = _f32_at_least(q).reshape(B, NKV, G, S, D)
    dof = _f32_at_least(dout).reshape(B, NKV, G, S, D)
    kf, vf = _f32_at_least(k), _f32_at_least(v)
    delta = (_f32_at_least(dout) * _f32_at_least(out)).sum(-1).reshape(B, NKV, G, S, 1)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    ok = _scores_mask(S, S, causal=causal, window=window, device=q.device,
                      prefix_len=prefix_len)
    s = torch.where(ok, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - _f32_at_least(lse).reshape(B, NKV, G, S, 1))
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf).reshape(B, NQ, S, D)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_tiled_ref(q, k, v, out, dout, lse, *, causal: bool = True,
                                  window: int = 0, scale: Optional[float] = None,
                                  block_q: int = 64, block_k: int = 64,
                                  heads_per_group: Optional[int] = None, prefix_len=None):
    """Test-only model of the wgmma backward's arithmetic
    (``csrc/flash_attention_bwd.cu``, namespace ``tcb``), in f32.

    dq: each ``block_q``-row q tile walks the ``block_k``-key tiles of its
    band in order (whole tiles with no visible pair skipped) and adds
    ``ds . k`` tile by tile.  dk / dv: each key tile walks its kv head's
    group of ``heads_per_group`` consecutive q heads (the last group may be
    shorter; default one group of all G), head by head, and each head's q
    tiles of the band in order, adding ``ds^T . q`` and ``p^T . dout``; the
    groups' f32 partials are then summed in group order.  As in the kernel,
    ``p = exp(s - lse)`` with masked scores at the sentinel -1e30 and ``ds
    = p * (dp - delta) * scale`` are f32; ds is rounded to q's dtype before
    its products, and p enters ``p^T . dout`` as two products, of p rounded
    to q's dtype and of its remainder ``p - rnd(p)`` rounded (no-ops in
    f32).  With ``prefix_len`` the bands reach every row's prefix: a q
    tile's keys run to ``ceil(prefix / block_k)`` at least, and a key tile
    that starts inside a prefix is seen from q tile 0 on, as in the
    kernel; the largest prefix of the batch sets them, and a tile some rows
    do not see adds exact zeros there.  Kernel layout, as
    :func:`flash_attention_bwd_ref`; returns ``(dq, dk, dv)`` in the dtypes
    of q, k and v.
    """
    B, NQ, S, D = q.shape
    NKV = k.shape[1]
    G = NQ // NKV
    hpg = G if heads_per_group is None else heads_per_group
    if scale is None:
        scale = D**-0.5

    def rnd(x):
        return x.to(q.dtype).float()

    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = (dout.float() * out.float()).sum(-1)
    lsef = lse.float()
    ok = _scores_mask(S, S, causal=causal, window=window, device=q.device,
                      prefix_len=prefix_len)
    if prefix_len is not None:
        ok = ok[:, 0]  # (B, 1, S, S): one mask per row, shared by its heads
    pmax = 0 if prefix_len is None else int(prefix_len.max().clamp(0, S))

    def scores(h, q0, q1, k0, k1):
        """p, ds of q heads ``h`` (a tensor of indices), rows q0:q1, keys k0:k1."""
        kvh = h // G
        qt, dot = qf[:, h, q0:q1], dof[:, h, q0:q1]
        kt, vt = kf[:, kvh, k0:k1], vf[:, kvh, k0:k1]
        s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
        s = torch.where(ok[..., q0:q1, k0:k1], s, torch.full_like(s, _NEG_INF))
        p = torch.exp(s - lsef[:, h, q0:q1, None])
        dp = torch.einsum("bhqd,bhkd->bhqk", dot, vt)
        return p, p * (dp - delta[:, h, q0:q1, None]) * scale

    dq = torch.zeros_like(qf)
    heads = torch.arange(NQ, device=q.device)
    n_kt = -(-S // block_k)
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        begin, end = 0, n_kt
        if causal:
            end = min(end, max((q1 - 1) // block_k + 1, -(-pmax // block_k)))
        if window and q0 - window + 1 > 0 and not pmax:
            begin = (q0 - window + 1) // block_k
        for kt in range(begin, end):
            k0, k1 = kt * block_k, min(kt * block_k + block_k, S)
            if not ok[..., q0:q1, k0:k1].any():
                continue
            _, ds = scores(heads, q0, q1, k0, k1)
            dq[:, :, q0:q1] += torch.einsum("bhqk,bhkd->bhqd", rnd(ds), kf[:, heads // G, k0:k1])

    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    n_qt = -(-S // block_q)
    for k0 in range(0, S, block_k):
        k1 = min(k0 + block_k, S)
        in_prefix = k0 < pmax  # seen by every query of some row
        begin = k0 // block_q if causal and not in_prefix else 0
        end = n_qt
        if window and not in_prefix:
            end = min(end, (k1 - 1 + window - 1) // block_q + 1)
        parts = []
        for g0 in range(0, G, hpg):
            pk = torch.zeros_like(dk[:, :, k0:k1])
            pv = torch.zeros_like(pk)
            for j in range(g0, min(G, g0 + hpg)):
                h = torch.arange(NKV, device=q.device) * G + j
                for qt in range(begin, end):
                    q0, q1 = qt * block_q, min(qt * block_q + block_q, S)
                    if not ok[..., q0:q1, k0:k1].any():
                        continue
                    p, ds = scores(h, q0, q1, k0, k1)
                    pv += torch.einsum("bhqk,bhqd->bhkd", rnd(p), dof[:, h, q0:q1])
                    pv += torch.einsum("bhqk,bhqd->bhkd", rnd(p - rnd(p)), dof[:, h, q0:q1])
                    pk += torch.einsum("bhqk,bhqd->bhkd", rnd(ds), qf[:, h, q0:q1])
            parts.append((pk, pv))
        for pk, pv in parts:  # the merge, in group order
            dk[:, :, k0:k1] += pk
            dv[:, :, k0:k1] += pv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rglru_scan_ref(a, b, h0):
    """``h_t = a_t * h_{t-1} + b_t`` (``h_{-1} = h0``).  a, b: (B, S, W); h0:
    (B, W).  Accumulates in f32 (float64 for float64 operands; a rounded
    multiply, then a rounded add, step by step) and returns h in a's dtype,
    as ``repro.kernels.ref``'s associative-scan version does up to summation
    order."""
    af, bf = _f32_at_least(a), _f32_at_least(b)
    h = _f32_at_least(h0)
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
    a_0 g_0``, all in f32 (float64 for float64 operands), returned in the
    dtypes of a, a and h0."""
    af, dhf = _f32_at_least(a), _f32_at_least(dh)
    S = a.shape[1]
    g = torch.empty_like(dhf)
    carry = torch.zeros_like(dhf[:, 0])
    for t in range(S - 1, -1, -1):
        carry = (af[:, t + 1] * carry + dhf[:, t]) if t + 1 < S else dhf[:, t]
        g[:, t] = carry
    h_prev = torch.cat([_f32_at_least(h0)[:, None], _f32_at_least(h[:, :-1])], dim=1)
    da = g * h_prev
    dh0 = af[:, 0] * g[:, 0]
    return da.to(a.dtype), g.to(a.dtype), dh0.to(h0.dtype)


def rglru_scan_chunked_ref(a, b, h0, *, chunk: int, cluster: int, reverse: bool = False,
                           h=None):
    """The scan kernel's arithmetic (``csrc/rglru_scan.cu``) in plain PyTorch.

    S is cut into chunks of ``chunk`` steps, taken ``cluster`` at a time.
    Each chunk folds into its summary ``(A, H)``: ``A = A * a_t`` from 1 and
    ``H = a_t * H + b_t`` from 0, in time order.  The carry into chunk r of
    a group is the group's incoming carry with summaries 0..r-1 folded on
    in chunk order (``carry = A * carry + H``); folding all of them gives
    the next group's carry.  Each chunk is then re-walked from its carry
    (``h = a_t * h + b_t``).  Every step is a rounded f32 multiply, then a
    rounded add.  With S <= ``chunk`` this is :func:`rglru_scan_ref` bit for
    bit.  Forward: returns h in a's dtype.

    ``reverse``: ``b`` is the cotangent ``dh`` and ``h`` the forward's
    output; the walk runs from S-1 down with coefficient ``a_{t+1}`` (0 past
    the end) and no initial carry, giving ``g_t = dh_t + a_{t+1} g_{t+1}``;
    returns ``(da, db, dh0) = (g_t h_{t-1}, g, a_0 g_0)`` (``h_{-1} = h0``)
    from the f32 g, in the dtypes of a, a and h0, as
    :func:`rglru_scan_bwd_ref` does.
    """
    af, xf = a.float(), b.float()
    B, S, W = a.shape
    if reverse:
        coef = torch.cat([af[:, 1:], torch.zeros_like(af[:, :1])], dim=1).flip(1)
        xf = xf.flip(1)
        carry = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    else:
        coef, carry = af, h0.float()
    out = torch.empty_like(xf)
    n_chunks = -(-S // chunk)
    for g0 in range(0, n_chunks, cluster):
        spans = [(c * chunk, min(S, (c + 1) * chunk))
                 for c in range(g0, min(g0 + cluster, n_chunks))]
        summaries = []
        for lo, hi in spans:
            A = torch.ones_like(carry)
            H = torch.zeros_like(carry)
            for t in range(lo, hi):
                A = A * coef[:, t]
                H = coef[:, t] * H + xf[:, t]
            summaries.append((A, H))
        for (lo, hi), (A, H) in zip(spans, summaries):
            x = carry
            for t in range(lo, hi):
                x = coef[:, t] * x + xf[:, t]
                out[:, t] = x
            carry = A * carry + H
    if not reverse:
        return out.to(a.dtype)
    g = out.flip(1)
    h_prev = torch.cat([h0.float()[:, None], h[:, :-1].float()], dim=1)
    return (g * h_prev).to(a.dtype), g.to(a.dtype), (af[:, 0] * g[:, 0]).to(h0.dtype)
