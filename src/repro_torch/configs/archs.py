"""The 10 assigned architectures as exact :class:`ModelConfig` instances.

Dims follow the assignment block verbatim; block-internal choices (rope
theta, norm styles, patterns) follow the cited sources.  ``reduced()``
shrinks any config to a CPU-smoke-test size of the same family.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "reduced", "ARCH_IDS"]


def _llama4_scout():
    # [moe] 48L d=5120 40H (kv=8) d_ff=8192 vocab=202048, 16 experts top-1,
    # shared expert (Llama-4 style), sigmoid router.
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        pattern=("moe",),
        n_experts=16,
        top_k=1,
        expert_d_ff=8192,
        n_shared_experts=1,
        router_type="sigmoid",
        rope_theta=500_000.0,
        tie_embeddings=False,
    )


def _olmoe():
    # [moe] 16L d=2048 16H d_ff=1024(expert) 64 experts top-8, qk-norm.
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab_size=50304,
        pattern=("moe",),
        n_experts=64,
        top_k=8,
        expert_d_ff=1024,
        qk_norm=True,
        rope_theta=10_000.0,
        tie_embeddings=False,
    )


def _recurrentgemma():
    # [hybrid] 26L d=2560 10H (kv=1, MQA) d_ff=7680 GeGLU, RG-LRU + local
    # attention (window 2048), 2 recurrent : 1 attention; 26 = 8*(r,r,a)+(r,r).
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        pattern=("recurrent", "recurrent", "local"),
        window=2048,
        lru_width=2560,
        mlp_type="geglu",
        emb_scale=True,
        norm_offset=True,
        tie_embeddings=True,
    )


def _xlstm():
    # [ssm] 24L d=1024 4H d_ff=0 — mLSTM blocks with 1 sLSTM per 8.
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        head_dim=256,
        d_ff=0,
        vocab_size=50304,
        pattern=("mlstm",) * 7 + ("slstm",),
        xlstm_heads=4,
        xlstm_proj_factor=2.0,
        xlstm_chunk=64,
        tie_embeddings=True,
    )


def _gemma_2b():
    # [dense] 18L d=2048 8H (kv=1, MQA) d_ff=16384 GeGLU head_dim=256.
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256_000,
        pattern=("attn",),
        mlp_type="geglu",
        emb_scale=True,
        norm_offset=True,
        tie_embeddings=True,
    )


def _phi3_mini():
    # [dense] 32L d=3072 32H (kv=32, MHA) d_ff=8192 SwiGLU.
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        pattern=("attn",),
        rope_theta=10_000.0,
        tie_embeddings=False,
    )


def _qwen3_14b():
    # [dense] 40L d=5120 40H (kv=8) d_ff=17408, qk_norm.
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        pattern=("attn",),
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def _llama3_8b():
    # [dense] 32L d=4096 32H (kv=8) d_ff=14336 vocab=128256.
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        pattern=("attn",),
        rope_theta=500_000.0,
        tie_embeddings=False,
    )


def _hubert_xlarge():
    # [audio] 48L d=1280 16H d_ff=5120 encoder-only; conv feature extractor
    # is the modality stub (input_specs feeds 512-dim frame embeddings).
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        pattern=("attn",),
        mlp_type="gelu",
        causal=False,  # bidirectional encoder
        frontend="audio",
        frontend_dim=512,
        tie_embeddings=False,
    )


def _paligemma():
    # [vlm] gemma-2b text decoder + SigLIP patch stub (1152-d embeddings,
    # 256 patches) with prefix-LM masking over the image prefix.
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        pattern=("attn",),
        mlp_type="geglu",
        emb_scale=True,
        norm_offset=True,
        prefix_lm=True,
        frontend="vision",
        frontend_dim=1152,
        num_prefix_tokens=256,
        tie_embeddings=True,
    )


ARCHS = {
    c.name: c
    for c in (
        _llama4_scout(),
        _olmoe(),
        _recurrentgemma(),
        _xlstm(),
        _gemma_2b(),
        _phi3_mini(),
        _qwen3_14b(),
        _llama3_8b(),
        _hubert_xlarge(),
        _paligemma(),
    )
}
ARCH_IDS = tuple(ARCHS)


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    cfg = ARCHS[arch]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def reduced(arch: str, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    cfg = ARCHS[arch]
    pat_len = len(cfg.pattern)
    small = dict(
        n_layers=pat_len if pat_len > 1 else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        window=min(cfg.window, 32) if cfg.window else 0,
        lru_width=64 if cfg.lru_width else 0,
        expert_d_ff=64 if cfg.expert_d_ff else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        frontend_dim=32 if cfg.frontend_dim else 0,
        num_prefix_tokens=8 if cfg.num_prefix_tokens else 0,
        xlstm_chunk=8,
        attn_chunk=32,
        loss_chunk=32,
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
