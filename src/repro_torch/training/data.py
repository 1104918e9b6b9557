"""Deterministic, resumable data pipeline.

Counter-based RNG (numpy Philox keyed on (seed, step)) gives O(1) random
access to any batch: restart-from-checkpoint reproduces the exact stream
without replaying, and elastic re-sharding just re-slices the same global
batch.  A file-backed mode memory-maps a token file for real corpora.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["DataConfig", "SyntheticTokens", "FileTokens", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    seed: int = 0
    path: Optional[str] = None  # file-backed when set


class SyntheticTokens:
    """Zipf-ish synthetic token stream (harder than uniform for training)."""

    def __init__(self, cfg: DataConfig, model: ModelConfig):
        self.cfg = cfg
        self.model = model

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c, m = self.cfg, self.model
        rng = np.random.Generator(np.random.Philox(key=(c.seed, step)))
        shape = (c.batch_size, c.seq_len + 1)
        # Zipf over the vocab, clipped; plus a little local structure
        # (repeat-previous-token) so models can actually learn something.
        z = rng.zipf(1.3, size=shape)
        toks = np.minimum(z - 1, m.vocab_size - 1).astype(np.int32)
        repeat = rng.random(shape) < 0.3
        toks[:, 1:] = np.where(repeat[:, 1:], toks[:, :-1], toks[:, 1:])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if m.frontend == "audio":
            frames = rng.normal(size=(c.batch_size, c.seq_len, m.frontend_dim))
            batch = {
                "frames": frames.astype(np.float32),
                "labels": toks[:, 1:],
            }
        elif m.frontend == "vision":
            patches = rng.normal(
                size=(c.batch_size, m.num_prefix_tokens, m.frontend_dim)
            )
            batch["patches"] = patches.astype(np.float32)
        return batch


class FileTokens:
    """Memory-mapped int32 token file; deterministic strided access."""

    def __init__(self, cfg: DataConfig, model: ModelConfig):
        self.cfg = cfg
        self.model = model
        self.data = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.Generator(np.random.Philox(key=(c.seed, step)))
        idx = rng.integers(0, self.n_windows, size=c.batch_size)
        rows = np.stack(
            [self.data[i * c.seq_len : i * c.seq_len + c.seq_len + 1] for i in idx]
        )
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }


def make_pipeline(cfg: DataConfig, model: ModelConfig):
    if cfg.path:
        return FileTokens(cfg, model)
    return SyntheticTokens(cfg, model)
