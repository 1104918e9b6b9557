"""Plain PyTorch reference of the served decoder stacks.

Follows the published descriptions of the configurations the benchmark
serves: pre-norm RMSNorm blocks (gemma's ``(1 + w)`` scale where the
configuration says ``norm_offset``), grouped-query attention with rotary
embeddings on the two halves of each head and RMSNorm on q and k where it
says ``qk_norm``, causal softmax attention, a SwiGLU (GeGLU with tanh gelu)
MLP, or a softmax top-k router with renormalised gates over experts that
each take at most ``capacity`` assignments in token order (GShard's
capacity factor; the rest are dropped), a final RMSNorm and the head (the
embedding's transpose where tied).

Everything is computed in float32 with TF32 off, from the benchmark's
weights, one layer at a time.  ``precision`` selects a control: ``"fp8"``
runs every product with bfloat16 weights as an fp8 GEMM would, both
operands rounded to float8 e4m3 (one scale per output column of the
weight, per row of the activations; the embedding table per row) and the
sums in float32, while the router and attention's own products stay in
float32; ``"tf32"`` lets float32 products run in TF32.  Nothing here
imports the program.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

PRECISIONS = ("fp32", "fp8", "tf32")


@dataclasses.dataclass(frozen=True)
class Spec:
    """The sizes and choices of a configuration file's ``model`` block that
    the reference and the weights read (other keys are the program's)."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple = ("attn",)
    mlp_type: str = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    tie_embeddings: bool = True
    emb_scale: bool = False
    norm_offset: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @classmethod
    def from_dict(cls, d: dict) -> "Spec":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in d.items() if k in names})


_FP8_MAX = 448.0


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 off for the reference, on for the ``tf32`` control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(t: torch.Tensor, reduce_dim: int) -> torch.Tensor:
    tf = t.float()
    scale = tf.abs().amax(dim=reduce_dim, keepdim=True).clamp_min(1e-12) / _FP8_MAX
    return (tf / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """One served model: ``cfg`` (a :class:`Spec`), ``params`` (the
    benchmark's weight tree)."""

    def __init__(self, cfg, params: dict, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.cfg, self.p, self.precision = cfg, params, precision
        self.kind = cfg.pattern[0]
        self._layers: Dict[int, dict] = {}

    # -- weights --------------------------------------------------------------
    def _w(self, t: torch.Tensor, reduce_dim: int = -2) -> torch.Tensor:
        if self.precision == "fp8" and t.dtype in (torch.bfloat16, torch.float16):
            return _fp8(t, reduce_dim)
        return t.float()

    def layer(self, i: int, keep: bool = False) -> dict:
        """Layer ``i``'s weights in the working precision (kept when
        ``keep``, for step-by-step decoding)."""
        if i in self._layers:
            return self._layers[i]
        blk = self.p["periods"][0]
        out = {"ln1": blk["ln1"][i].float(), "ln2": blk["ln2"][i].float()}
        out.update({k: (v[i].float() if k.endswith("_norm") else self._w(v[i]))
                    for k, v in blk["attn"].items()})
        ffn = blk["moe"] if self.kind == "moe" else blk["mlp"]
        out["ffn"] = {k: (v[i].float() if k == "router" else self._w(v[i]))
                      for k, v in ffn.items()}
        if keep:
            self._layers[i] = out
        return out

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        table = self.p["embed"]["tokens"]
        x = table[tokens]
        x = _fp8(x, -1) if self.precision == "fp8" and x.dtype == torch.bfloat16 else x.float()
        if self.cfg.emb_scale:
            x = x * math.sqrt(self.cfg.d_model)
        return x

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of hidden states ``x`` (..., D), final norm included."""
        x = self.norm(x, self.p["final_norm"].float())
        if self.cfg.tie_embeddings:
            w = self.p["embed"]["tokens"]
            w = (_fp8(w, -1) if self.precision == "fp8" and w.dtype == torch.bfloat16
                 else w.float()).T
        else:
            w = self._w(self.p["head"])
        return self.mm(x, w)

    def mm(self, x, w):
        """``x @ w``; the fp8 control rounds the activations too."""
        if self.precision == "fp8" and self.cfg.dtype in ("bfloat16", "float16"):
            x = _fp8(x, -1)
        return x @ w

    # -- layers -----------------------------------------------------------------
    def norm(self, x, w):
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.cfg.norm_eps)
        return y * ((1.0 + w) if self.cfg.norm_offset else w)

    def rope(self, x, pos):
        """x (B, S, H, D); pos (S,) absolute positions."""
        half = x.shape[-1] // 2
        freq = self.cfg.rope_theta ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos.float()[:, None] * freq  # (S, half)
        sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, W, h, pos, cache: Optional[dict]):
        """h (B, S, D) normed; pos (S,); ``cache`` {"k", "v"} (B, T, NKV, HD)
        of earlier positions, extended in place."""
        c = self.cfg
        B, S, _ = h.shape
        hd, nq, nkv = c.head_dim, c.n_heads, c.n_kv_heads
        q = self.mm(h, W["wq"]).view(B, S, nq, hd)
        k = self.mm(h, W["wk"]).view(B, S, nkv, hd)
        v = self.mm(h, W["wv"]).view(B, S, nkv, hd)
        if c.qk_norm:
            q = self.norm_plain(q, W["q_norm"])
            k = self.norm_plain(k, W["k_norm"])
        q, k = self.rope(q, pos), self.rope(k, pos)
        if cache is not None:
            if "k" in cache:
                k = torch.cat([cache["k"], k], dim=1)
                v = torch.cat([cache["v"], v], dim=1)
            cache["k"], cache["v"] = k, v
        T = k.shape[1]
        kpos = torch.arange(T, device=h.device) + (int(pos[0]) - (T - S))
        mask = kpos[None, :] <= pos[:, None]  # (S, T)
        g = nq // nkv
        out = torch.empty(B, S, nq, hd, device=h.device)
        for b in range(B):  # one row at a time bounds the score tensor
            kb = k[b].repeat_interleave(g, dim=1).transpose(0, 1)  # (nq, T, hd)
            vb = v[b].repeat_interleave(g, dim=1).transpose(0, 1)
            s = (q[b].transpose(0, 1) @ kb.transpose(1, 2)) / math.sqrt(hd)  # (nq, S, T)
            s = s.masked_fill(~mask, float("-inf"))
            out[b] = (torch.softmax(s, dim=-1) @ vb).transpose(0, 1)
        return self.mm(out.reshape(B, S, nq * hd), W["wo"])

    def norm_plain(self, x, w):  # q / k norm: never gemma's offset
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.cfg.norm_eps) * w

    def mlp(self, W, h):
        a = self.mm(h, W["wi"])
        act = (torch.nn.functional.silu(a) if self.cfg.mlp_type == "swiglu"
               else torch.nn.functional.gelu(a, approximate="tanh"))
        return self.mm(act * self.mm(h, W["wg"]), W["wo"])

    def moe(self, W, h):
        """h (T, D): every token's top-k experts, capacity in token order."""
        c = self.cfg
        T, D = h.shape
        E, k = c.n_experts, c.top_k
        probs = torch.softmax(h @ W["router"], dim=-1)
        gate, idx = probs.topk(k, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        cap = max(int(math.ceil(T * k * c.capacity_factor / E)), k)
        flat = idx.reshape(-1)  # assignments, token-major
        order = torch.sort(flat, stable=True).indices
        ranked = flat[order]
        first = torch.searchsorted(ranked, ranked, side="left")
        slot = torch.empty_like(flat)
        slot[order] = torch.arange(flat.numel(), device=h.device) - first
        keep = slot < cap
        out = torch.zeros(T, D, device=h.device)
        gflat = gate.reshape(-1)
        for e in range(E):
            a = torch.nonzero((flat == e) & keep).flatten()
            if a.numel() == 0:
                continue
            t = a // k
            x = h[t]
            y = self.mlp({"wi": W["wi"][e], "wg": W["wg"][e], "wo": W["wo"][e]}, x)
            out.index_add_(0, t, y * gflat[a][:, None])
        return out

    def block(self, W, x, pos, cache=None):
        x = x + self.attention(W, self.norm(x, W["ln1"]), pos, cache)
        h = self.norm(x, W["ln2"])
        if self.kind == "moe":
            B, S, D = h.shape
            return x + self.moe(W["ffn"], h.reshape(B * S, D)).view(B, S, D)
        return x + self.mlp(W["ffn"], h)

    # -- the two ways of reading logits ----------------------------------------
    @torch.no_grad()
    def teacher_forced(self, rows: Sequence[torch.Tensor],
                       judged: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """Rows that do not share a batch (a stack without experts): each
        row's full causal pass; logits (b - a, V) at positions a .. b - 1 of
        each row.  One layer's weights at a time."""
        if self.kind == "moe":
            raise ValueError("experts share capacity across a batch: use batch_decode")
        with matmul_precision(self.precision):
            xs = [self.embed(r)[None] for r in rows]
            poss = [torch.arange(r.numel(), device=r.device) for r in rows]
            for i in range(self.cfg.n_layers):
                W = self.layer(i)
                xs = [self.block(W, x, p) for x, p in zip(xs, poss)]
                del W
            return [self.head(x[0, a:b]) for x, (a, b) in zip(xs, judged)]

    @torch.no_grad()
    def batch_decode(self, prompt: torch.Tensor, forced: torch.Tensor) -> torch.Tensor:
        """A batch as served: the (B, W) prompt in one pass, then one token
        per row per step; step j feeds ``forced[:, j - 1]``, or the row's own
        best token where that is -1.  Returns logits (B, n, V) of the n
        tokens (n = ``forced.shape[1]``)."""
        B, Wd = prompt.shape
        n = forced.shape[1]
        with matmul_precision(self.precision):
            caches = [dict() for _ in range(self.cfg.n_layers)]
            x = self.embed(prompt)
            pos = torch.arange(Wd, device=prompt.device)
            for i in range(self.cfg.n_layers):
                x = self.block(self.layer(i, keep=True), x, pos, caches[i])
            out = [self.head(x[:, -1])]
            for j in range(1, n):
                own = out[-1].argmax(-1)
                tok = torch.where(forced[:, j - 1] >= 0, forced[:, j - 1], own)
                x = self.embed(tok[:, None])
                pos = torch.tensor([Wd + j - 1], device=prompt.device)
                for i in range(self.cfg.n_layers):
                    x = self.block(self.layer(i, keep=True), x, pos, caches[i])
                out.append(self.head(x[:, -1]))
            return torch.stack(out, dim=1)

    def release(self) -> None:
        self._layers.clear()
