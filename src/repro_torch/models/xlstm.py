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

Gates and states compute in f32 (:func:`layers.wide`: f32, or f64 for a
float64 model, which the card-vs-CPU checks use as their reference).

On a split tensor axis (``tp``, :mod:`~repro_torch.distributed.tensor_parallel`)
a rank runs its whole heads of either cell, the JAX package's ``lru``
layout.  mLSTM: its columns of ``wq`` / ``wk`` / ``wv`` / ``wz`` and rows of
``wo``; the per-head gates are whole (shared into the region), so every
rank computes every head's gates; the key scale stays the global
``dh ** -0.5``.  Training and prefill carry the rank's heads' ``(C, n)``;
a decode step gathers the token's k / v over the heads and advances the
whole state on every rank (the cache keeps it whole, as the JAX package's
``cache_axes`` say), computing the output of the rank's heads only.
sLSTM: its channels of ``w{g}`` / ``b{g}`` / the state and rows of
``wo_proj``, and its heads of the block-diagonal recurrence ``r{g}``, which
the rank reads whole and slices, so the time loop runs no collective.
Either cell's output leaves the region summed over the axis.

Heads that do not split over the axis (or are fewer than its ranks): a rank
runs its contiguous heads (:meth:`TensorParallel.heads`, maybe none), their
columns and rows cut from the cell's ``lru`` leaves read whole and shared
(:meth:`TensorParallel.head_slices`).  The mLSTM's state is whole on every
rank as before; its gathers over the heads pad to the largest count
(:meth:`TensorParallel.gather_heads`).  The sLSTM's ``c, n, h, m`` stay
stored as even channel chunks (``cache_axes``), which are not the rank's
heads: a prefill or decode step all-gathers the four chunks (one call),
the rank advances its heads' channels, and their new state is gathered over
the heads (one call) before the rank keeps its chunk; two all-gathers of
``4 * B * d_model`` entries a step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel
from repro_torch.models import layers

__all__ = [
    "mlstm_init_spec",
    "mlstm_init_axes",
    "mlstm_apply",
    "mlstm_decode_step",
    "mlstm_init_cache",
    "slstm_init_spec",
    "slstm_init_axes",
    "slstm_apply",
    "slstm_decode_step",
    "slstm_init_cache",
]

_GATES = ("i", "f", "z", "o")


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


def mlstm_init_axes(cfg):
    """The logical axes of :func:`mlstm_init_spec`'s leaves."""
    return {"wq": ("embed", "lru"), "wk": ("embed", "lru"), "wv": ("embed", "lru"),
            "wz": ("embed", "lru"), "wi": ("embed", None), "wf": ("embed", None),
            "bi": (None,), "bf": (None,), "wo": ("lru", "embed")}


def _mlstm_qkvg(cfg, params, x):
    """q, k, v (B, S, heads, dh) of the heads ``wq`` / ``wk`` / ``wv`` hold
    (every head, or a rank's), z, and every head's gates."""
    B, S, _ = x.shape
    _, _, dh = _dims(cfg)
    nh = params["wq"].shape[-1] // dh  # none on a tensor-parallel rank with no head
    q = (x @ params["wq"]).reshape(B, S, nh, dh)
    k = (x @ params["wk"]).reshape(B, S, nh, dh) * (dh**-0.5)
    v = (x @ params["wv"]).reshape(B, S, nh, dh)
    z = F.silu(x @ params["wz"])
    xf = layers.wide(x)
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
    qf, kf, vf = layers.wide(q), layers.wide(k), layers.wide(v)

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


_MLSTM_COLS, _MLSTM_ROWS = ("wq", "wk", "wv", "wz"), ("wo",)


def mlstm_apply(cfg, params, x, carry=None, tp=None):
    """Chunkwise-parallel mLSTM.  x: (B, S, D) -> ((B, S, D), (C, n)).
    With ``tp``: this rank's heads (``carry`` and the carry returned are
    theirs)."""
    _, nh, dh = _dims(cfg)
    if tp is not None:
        x = tp.enter(x)
        params = dict(params, **{k: tp.share(params[k]) for k in ("wi", "wf", "bi", "bf")})
        params = tp.head_slices(params, nh, dh, _MLSTM_COLS, _MLSTM_ROWS)
    B, S, _ = x.shape
    L = min(cfg.xlstm_chunk, S)
    if S % L:
        raise ValueError(f"seq {S} not divisible by xlstm_chunk {L}")
    q, k, v, z, log_f, gate_i = _mlstm_qkvg(cfg, params, x)
    if tp is not None:
        log_f, gate_i = log_f[..., tp.heads(nh)], gate_i[..., tp.heads(nh)]
    if carry is None:
        carry = (torch.zeros((B, q.shape[2], dh, dh), dtype=log_f.dtype, device=x.device),
                 torch.zeros((B, q.shape[2], dh), dtype=log_f.dtype, device=x.device))
    outs = []
    for c in range(S // L):
        sl = slice(c * L, (c + 1) * L)
        out, carry = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], log_f[:, sl], gate_i[:, sl],
                                  carry)
        outs.append(out)
    h = torch.cat(outs, dim=1).reshape(B, S, -1)
    out = (h.to(x.dtype) * z) @ params["wo"]
    return (out if tp is None else tp.leave(out)), carry


def mlstm_init_cache(cfg, batch, device="cuda", lead=(), dtype=torch.float32):
    """``C`` (*lead, B, NH, dh, dh) and ``n`` (*lead, B, NH, dh), f32;
    ``lead`` stacks them over periods."""
    _, nh, dh = _dims(cfg)
    return {
        "C": torch.zeros((*lead, batch, nh, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((*lead, batch, nh, dh), dtype=dtype, device=device),
    }


def mlstm_decode_step(cfg, params, x, cache, tp=None):
    """One token, O(1) state.  x: (B, 1, D).  Returns (out, {"C", "n"}) as
    new tensors.  With ``tp``: the cache and the new state hold every head
    (the token's k / v gathered over the heads); the output is this rank's
    heads', summed over the axis."""
    B = x.shape[0]
    _, nh, dh = _dims(cfg)
    if tp is not None:
        params = tp.head_slices(params, nh, dh, _MLSTM_COLS, _MLSTM_ROWS)
    q, k, v, z, log_f, gate_i = _mlstm_qkvg(cfg, params, x)
    qf, kf, vf = (layers.wide(t[:, 0]) for t in (q, k, v))  # (B, NH, dh)
    if tp is not None:
        kf, vf = (tp.gather_heads(t, nh, 1) for t in (kf, vf))
    f = torch.exp(log_f[:, 0])[..., None]  # (B, NH, 1)
    i = gate_i[:, 0][..., None]
    C = f[..., None] * cache["C"] + i[..., None] * torch.einsum("bhd,bhe->bhde", kf, vf)
    n = f * cache["n"] + i * kf
    Cq, nq = (C, n) if tp is None else (C[:, tp.heads(nh)], n[:, tp.heads(nh)])
    h = torch.einsum("bhd,bhde->bhe", qf, Cq)
    denom = _floor(torch.abs(torch.einsum("bhd,bhd->bh", qf, nq)), 1.0)
    h = (h / denom[..., None]).reshape(B, 1, -1)
    out = (h.to(x.dtype) * z) @ params["wo"]
    return (out if tp is None else tp.leave(out)), {"C": C, "n": n}


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


def slstm_init_axes(cfg):
    """The logical axes of :func:`slstm_init_spec`'s leaves (the recurrence
    block-diagonal over heads)."""
    axes = {}
    for g in _GATES:
        axes[f"w{g}"] = ("embed", "lru")
        axes[f"r{g}"] = (None, "lru", None)
        axes[f"b{g}"] = ("lru",)
    axes["wo_proj"] = ("lru", "embed")
    return axes


def slstm_init_cache(cfg, batch, device="cuda", lead=(), dtype=torch.float32):
    """``c``, ``n``, ``h``, ``m`` each (*lead, B, D) f32."""
    return {s: torch.zeros((*lead, batch, cfg.d_model), dtype=dtype, device=device)
            for s in ("c", "n", "h", "m")}


def _slstm_scan(params, dh, xf, state):
    """The recurrence of the heads ``params`` hold (every one, or a rank's,
    ``dh`` channels each) over xf (B, S, D) f32 from ``state``: returns
    their hidden states (B, S, heads * dh) f32 and the final state."""
    B, S = xf.shape[:2]
    # Per gate, the input projection of every step plus the bias.
    pre = [xf @ params[f"w{g}"].to(xf.dtype) for g in _GATES]
    d = pre[0].shape[-1]
    nh = d // dh
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


_STATE = ("c", "n", "h", "m")


def slstm_apply(cfg, params, x, state=None, tp=None):
    """Sequential sLSTM over the sequence.  x: (B, S, D) -> ((B, S, D), state).
    With ``tp``: this rank's heads; ``state`` and the state returned are
    its channels as ``cache_axes`` store them (its heads' channels where
    the heads split; else its even chunk, see the module docstring)."""
    nh = cfg.xlstm_heads
    dh = cfg.d_model // nh
    chunked = tp is not None and nh % tp.size != 0 and state is not None
    if tp is not None:
        x = tp.enter(x)
        params = dict(params, **{f"r{g}": tp.share(params[f"r{g}"])[tp.heads(nh)]
                                 for g in _GATES})
        params = tp.head_slices(params, nh, dh, [f"{w}{g}" for g in _GATES for w in "wb"],
                                ("wo_proj",))
        if chunked:  # every chunk, then the rank's heads' channels
            whole = tensor_parallel.all_gather(torch.stack([state[s] for s in _STATE]),
                                               tp.group, -1)
            cut = tp.heads(nh)
            state = dict(zip(_STATE, whole[..., cut.start * dh:cut.stop * dh]))
    xf = layers.wide(x)
    if state is None:
        state = {s: torch.zeros((x.shape[0], params["wi"].shape[1]), dtype=xf.dtype,
                                device=x.device) for s in _STATE}
    hs, state = _slstm_scan(params, dh, xf, state)
    out = hs.to(x.dtype) @ params["wo_proj"]
    if chunked:  # the ranks' heads' new channels, then this rank's chunk
        whole = tp.gather_heads(torch.stack([state[s] for s in _STATE]), nh, -1, dh)
        state = dict(zip(_STATE, whole.chunk(tp.size, -1)[tp.rank]))
    return (out if tp is None else tp.leave(out)), state


def slstm_decode_step(cfg, params, x, state, tp=None):
    """One token.  x: (B, 1, D).  Returns (out, state) as new tensors."""
    return slstm_apply(cfg, params, x, state, tp)
