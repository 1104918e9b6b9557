"""Architecture configuration for the LM zoo.

One :class:`ModelConfig` describes any of the 10 assigned architectures;
``pattern`` expresses heterogeneous block stacks (RecurrentGemma's 2:1
recurrent:attention pattern, xLSTM's mLSTM/sLSTM mix) as one *period* that
repeats ``n_layers // len(pattern)`` times (plus an explicit epilogue for
non-divisible depths).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "BLOCK_KINDS"]

# Block kinds usable in ``pattern``:
#   "attn"      global attention + dense MLP
#   "local"     sliding-window attention + dense MLP
#   "moe"       global attention + mixture-of-experts MLP
#   "recurrent" conv1d + RG-LRU gated linear recurrence + dense MLP
#   "mlstm"     xLSTM matrix-memory block (self-contained, no separate MLP)
#   "slstm"     xLSTM scalar-memory block (sequential recurrence)
BLOCK_KINDS = ("attn", "local", "moe", "recurrent", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    pattern: Tuple[str, ...] = ("attn",)
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    window: int = 0  # sliding-window size for "local" blocks
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True  # False => bidirectional encoder (HuBERT)
    prefix_lm: bool = False  # PaliGemma: bidirectional over the image prefix

    # Mixture of experts ("moe" blocks).
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0  # Llama-4 shared expert
    capacity_factor: float = 1.25
    router_type: str = "softmax"  # softmax | sigmoid (llama4 top-1)

    # Recurrent ("recurrent" = RG-LRU) blocks.
    lru_width: int = 0
    conv_width: int = 4

    # xLSTM blocks.
    xlstm_proj_factor: float = 2.0
    xlstm_heads: int = 4
    xlstm_chunk: int = 64

    # Frontend stubs ([audio]/[vlm] backbones take precomputed embeddings).
    frontend: str = "none"  # none | audio | vision
    frontend_dim: int = 0  # raw embedding dim fed by the stub
    num_prefix_tokens: int = 0  # vision patches prepended to the text

    tie_embeddings: bool = True
    emb_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    norm_offset: bool = False  # gemma: RMSNorm scale is (1 + w)
    norm_eps: float = 1e-6

    # Execution knobs (not architecture).
    dtype: str = "bfloat16"
    attn_chunk: int = 1024  # flash-attention chunk length
    scan_layers: bool = True
    remat: bool = True  # checkpoint each period during training
    use_pallas: bool = False  # TPU kernels; pure-JAX path otherwise
    unroll_scans: bool = False  # unroll inner scans (cost-analysis compiles)
    moe_groups: int = 1  # token groups for MoE dispatch (launcher overrides)
    kv_cache_quant: bool = False  # int8 KV cache (per-entry scales)
    loss_chunk: int = 512  # sequence chunking of the softmax-xent loss

    # ---------------------------------------------------------------
    def __post_init__(self):
        for k in self.pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if "moe" in self.pattern and not (self.n_experts and self.top_k):
            raise ValueError("moe blocks need n_experts and top_k")

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def epilogue(self) -> Tuple[str, ...]:
        """Layer kinds beyond the last full period (e.g. RecurrentGemma 26L)."""
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def encoder_only(self) -> bool:
        return not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state is O(1)/O(window) — long_500k eligible."""
        return all(k in ("recurrent", "mlstm", "slstm", "local") for k in self.pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        return self.pattern * self.n_periods + self.epilogue

    # Rough parameter count (for roofline MODEL_FLOPS = 6*N*D).
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        total = 0
        for kind in self.layer_kinds():
            if kind in ("attn", "local", "moe"):
                attn = d * hd * (nq + 2 * nkv) + nq * hd * d
                if kind == "moe":
                    n_e = self.top_k if active_only else self.n_experts
                    gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                    mlp = n_e * gates * d * self.expert_d_ff
                    mlp += self.n_shared_experts * gates * d * self.expert_d_ff
                    mlp += d * self.n_experts  # router
                else:
                    gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                    mlp = gates * d * self.d_ff
                total += attn + mlp
            elif kind == "recurrent":
                w = self.lru_width
                total += 2 * d * w + w * d + self.conv_width * w + 2 * w
                gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
                total += gates * d * self.d_ff
            elif kind == "mlstm":
                di = int(self.d_model * self.xlstm_proj_factor)
                total += d * di * 5 + 2 * di * self.xlstm_heads + di * d
            elif kind == "slstm":
                di = d
                total += 4 * (d * di + di * di // self.xlstm_heads) + di * d
        total += self.vocab_size * d  # embeddings (tied head)
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return total
