"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory), the JAX package's ``models/xlstm.py``.

* mLSTM runs chunkwise-parallel: quadratic inside a chunk (a decay-masked
  product), the (C, n) state carried across chunks in a Python loop.
  Decode is the O(1) recurrent update.  Sigmoid input and forget gates
  (log-gates <= 0) keep the decay matrix stable without a running max.
  The decay matrix is masked *before* its ``exp``: the JAX package takes
  the ``exp`` of the whole (L, L) difference and masks after, where the
  upper triangle can overflow to ``inf``; the kept entries are the same.
* sLSTM is sequential (recurrent connections through h_{t-1}): a Python
  loop over time with the exponential-gate formulation and the m_t
  running-max stabilizer.  Its input projections do not depend on the
  recurrence, so they run once over the whole sequence before the loop.
  Products of f32 activations with 16-bit weights cast the weight to f32,
  as JAX promotes ``f32 @ bf16``.

Training runs through autograd; no state is detached (the JAX package has
no ``stop_gradient``: the sLSTM stabiliser ``m`` keeps its gradient).  The
floors are ``torch.maximum``, whose gradient splits a tie evenly as
``jnp.maximum``'s does (``clamp_min`` gives all of it to the input), and
the mLSTM's decay matrix is masked before its ``exp``, so the masked
entries' gradient is 0 where the reference's ``0 * inf`` can be NaN.

Gates and states compute in f32 (:func:`_wide`: f32, or f64 for a float64
model, which the card-vs-CPU checks use as their reference).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "mlstm_init_spec",
    "mlstm_apply",
    "mlstm_decode_step",
    "mlstm_init_cache",
    "slstm_init_spec",
    "slstm_apply",
    "slstm_decode_step",
    "slstm_init_cache",
]

_GATES = ("i", "f", "z", "o")


def _wide(t):
    """``t`` in at least f32 (bf16 and f32 -> f32, f64 stays)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _floor(t, lo: float):
    """``max(t, lo)``; under autograd through ``torch.maximum``, whose
    gradient splits a tie evenly, as ``jnp.maximum``'s does.  Both forms
    give the same value; without autograd ``clamp_min`` is kept because it
    needs no device tensor for ``lo``, so serving launches no fill kernel
    per sLSTM step."""
    if not torch.is_grad_enabled():
        return torch.clamp_min(t, lo)
    return torch.maximum(t, torch.full((), lo, dtype=t.dtype, device=t.device))


# ---------------------------------------------------------------------------
# mLSTM.
# ---------------------------------------------------------------------------
def _dims(cfg):
    di = int(cfg.d_model * cfg.xlstm_proj_factor)
    nh = cfg.xlstm_heads
    return di, nh, di // nh


def mlstm_init_spec(cfg):
    d = cfg.d_model
    di, nh, _ = _dims(cfg)
    return {
        "wq": (d, di),
        "wk": (d, di),
        "wv": (d, di),
        "wz": (d, di),  # output-gate branch
        "wi": (d, nh),  # input gate (per head)
        "wf": (d, nh),  # forget gate (per head)
        "bi": (nh,),
        "bf": (nh,),
        "wo": (di, d),
    }


def _mlstm_qkvg(cfg, params, x):
    B, S, _ = x.shape
    di, nh, dh = _dims(cfg)
    q = (x @ params["wq"]).reshape(B, S, nh, dh)
    k = (x @ params["wk"]).reshape(B, S, nh, dh) * (dh**-0.5)
    v = (x @ params["wv"]).reshape(B, S, nh, dh)
    z = F.silu(x @ params["wz"])
    xf = _wide(x)
    log_f = F.logsigmoid(xf @ params["wf"].to(xf.dtype) + params["bf"])
    gate_i = torch.sigmoid(xf @ params["wi"].to(xf.dtype) + params["bi"])
    return q, k, v, z, log_f, gate_i  # gates: (B, S, NH) f32


def _mlstm_chunk(q, k, v, log_f, gate_i, carry):
    """One chunk.  q, k, v: (B, L, NH, dh); gates (B, L, NH); carry (C, n)."""
    C_prev, n_prev = carry  # (B, NH, dh, dh), (B, NH, dh)
    L = q.shape[1]
    lf = torch.cumsum(log_f, dim=1)  # inclusive cumulative log-decay
    # Intra-chunk decay matrix D_ij = exp(lf_i - lf_j) * i_j for j <= i.
    diff = lf[:, :, None, :] - lf[:, None, :, :]  # (B, L, L, NH)
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    D = torch.exp(torch.where(mask, diff, float("-inf"))) * gate_i[:, None, :, :]
    qf, kf, vf = _wide(q), _wide(k), _wide(v)

    scores = torch.einsum("blhd,bmhd->blmh", qf, kf) * D  # (B, L, L, NH)
    h_intra = torch.einsum("blmh,bmhd->blhd", scores, vf)
    n_intra = torch.einsum("blmh,bmhd->blhd", D, kf)

    decay_q = torch.exp(lf)  # (B, L, NH)
    h_inter = torch.einsum("blhd,bhde->blhe", qf * decay_q[..., None], C_prev)
    n_inter = decay_q[..., None] * n_prev[:, None]  # (B, L, NH, dh)

    h = h_intra + h_inter
    n = n_intra + n_inter
    denom = _floor(torch.abs(torch.einsum("blhd,blhd->blh", qf, n)), 1.0)
    out = h / denom[..., None]

    # State update to the end of the chunk.
    decay_to_end = torch.exp(lf[:, -1:, :] - lf)  # (B, L, NH)
    kv = torch.einsum("blhd,blhe->bhde", kf * (decay_to_end * gate_i)[..., None], vf)
    C_new = torch.exp(lf[:, -1])[:, :, None, None] * C_prev + kv
    k_sum = torch.einsum("blh,blhd->bhd", decay_to_end * gate_i, kf)
    n_new = torch.exp(lf[:, -1])[:, :, None] * n_prev + k_sum
    return out, (C_new, n_new)


def mlstm_apply(cfg, params, x, carry=None):
    """Chunkwise-parallel mLSTM.  x: (B, S, D) -> ((B, S, D), (C, n))."""
    B, S, _ = x.shape
    di, nh, dh = _dims(cfg)
    L = min(cfg.xlstm_chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by xlstm_chunk {L}")
    q, k, v, z, log_f, gate_i = _mlstm_qkvg(cfg, params, x)
    if carry is None:
        cache = mlstm_init_cache(cfg, B, x.device, dtype=log_f.dtype)
        carry = (cache["C"], cache["n"])
    outs = []
    for c in range(S // L):
        sl = slice(c * L, (c + 1) * L)
        out, carry = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], log_f[:, sl], gate_i[:, sl],
                                  carry)
        outs.append(out)
    h = torch.cat(outs, dim=1).reshape(B, S, di)
    return (h.to(x.dtype) * z) @ params["wo"], carry


def mlstm_init_cache(cfg, batch, device="cuda", lead=(), dtype=torch.float32):
    """``C`` (*lead, B, NH, dh, dh) and ``n`` (*lead, B, NH, dh), f32;
    ``lead`` stacks them over periods."""
    _, nh, dh = _dims(cfg)
    return {
        "C": torch.zeros((*lead, batch, nh, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((*lead, batch, nh, dh), dtype=dtype, device=device),
    }


def mlstm_decode_step(cfg, params, x, cache):
    """One token, O(1) state.  x: (B, 1, D).  Returns (out, {"C", "n"}) as
    new tensors."""
    B = x.shape[0]
    di, nh, dh = _dims(cfg)
    q, k, v, z, log_f, gate_i = _mlstm_qkvg(cfg, params, x)
    qf, kf, vf = (_wide(t[:, 0]) for t in (q, k, v))  # (B, NH, dh)
    f = torch.exp(log_f[:, 0])[..., None]  # (B, NH, 1)
    i = gate_i[:, 0][..., None]
    C = f[..., None] * cache["C"] + i[..., None] * torch.einsum("bhd,bhe->bhde", kf, vf)
    n = f * cache["n"] + i * kf
    h = torch.einsum("bhd,bhde->bhe", qf, C)
    denom = _floor(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)), 1.0)
    h = (h / denom[..., None]).reshape(B, 1, di)
    return (h.to(x.dtype) * z) @ params["wo"], {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM.
# ---------------------------------------------------------------------------
def slstm_init_spec(cfg):
    d = cfg.d_model
    nh = cfg.xlstm_heads
    dh = d // nh
    spec = {}
    for g in _GATES:
        spec[f"w{g}"] = (d, d)
        spec[f"r{g}"] = (nh, dh, dh)  # block-diagonal recurrence
        spec[f"b{g}"] = (d,)
    spec["wo_proj"] = (d, d)
    return spec


def slstm_init_cache(cfg, batch, device="cuda", lead=(), dtype=torch.float32):
    """``c``, ``n``, ``h``, ``m`` each (*lead, B, D) f32."""
    return {s: torch.zeros((*lead, batch, cfg.d_model), dtype=dtype, device=device)
            for s in ("c", "n", "h", "m")}


def _slstm_scan(params, nh, xf, state):
    """The recurrence over xf (B, S, D) f32 from ``state``: returns the
    hidden states (B, S, D) f32 and the final state."""
    B, S, d = xf.shape
    dh = d // nh
    # Per gate, the input projection of every step plus the bias.
    pre = [xf @ params[f"w{g}"].to(xf.dtype) for g in _GATES]
    bias = [params[f"b{g}"].to(xf.dtype) for g in _GATES]
    r = torch.cat([params[f"r{g}"].to(xf.dtype) for g in _GATES], dim=-1)  # (NH, dh, 4 dh)
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(B, nh, dh), r).reshape(B, nh, 4, dh)
        it, ft, zt, ot = (pre[j][:, t] + rec[:, :, j].reshape(B, d) + bias[j] for j in range(4))
        zt, ot = torch.tanh(zt), torch.sigmoid(ot)
        # Stabilized exponential gating (xLSTM eq. 15-17).
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        h = ot * c / _floor(n, 1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), {"c": c, "n": n, "h": h, "m": m}


def slstm_apply(cfg, params, x, state=None):
    """Sequential sLSTM over the sequence.  x: (B, S, D) -> ((B, S, D), state)."""
    xf = _wide(x)
    if state is None:
        state = slstm_init_cache(cfg, x.shape[0], device=x.device, dtype=xf.dtype)
    hs, state = _slstm_scan(params, cfg.xlstm_heads, xf, state)
    return hs.to(x.dtype) @ params["wo_proj"], state


def slstm_decode_step(cfg, params, x, state):
    """One token.  x: (B, 1, D).  Returns (out, state) as new tensors."""
    return slstm_apply(cfg, params, x, state)
