"""Assigned input shapes and their meta-tensor stand-ins for the dry-run,
the JAX package's ``configs/shapes.py`` in PyTorch.

Four shape cells per architecture:
  train_4k     seq 4096,   global batch 256  -> train step
  prefill_32k  seq 32768,  global batch 32   -> prefill
  decode_32k   KV 32768,   global batch 128  -> decode step
  long_500k    KV 524288,  global batch 1    -> decode step, sub-quadratic only

Encoder-only architectures have no decode step; ``long_500k`` needs
O(1) / O(window) decode state.  The stand-ins are tensors on the ``meta``
device (shapes and dtypes, no values and no allocation), the counterpart
of ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "ShapeCell", "applicable", "input_specs", "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}


def skip_reason(cfg: ModelConfig, shape: str) -> Optional[str]:
    cell = SHAPES[shape]
    if cell.kind == "decode" and cfg.encoder_only:
        return "encoder-only architecture has no decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return "full-attention KV state is quadratic-cost at 500k; skipped per assignment"
    return None


def applicable(cfg: ModelConfig, shape: str) -> bool:
    return skip_reason(cfg, shape) is None


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str, *, batch_override: int = None):
    """Meta-tensor inputs for (arch, shape), no allocation:

      train:   {"inputs": {tokens / frames / patches, labels}}
      prefill: {"inputs": {...}}
      decode:  {"cache": <init_cache tree>, "token": (B,), "pos": (B,)}
    """
    cell = SHAPES[shape]
    B = batch_override or cell.global_batch
    S = cell.seq_len
    i32, f32 = torch.int32, torch.float32

    if cell.kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            inputs = {"frames": _meta((B, S, cfg.frontend_dim), f32)}
            if cell.kind == "train":
                inputs["labels"] = _meta((B, S), i32)
        elif cfg.frontend == "vision":
            P = cfg.num_prefix_tokens
            inputs = {"patches": _meta((B, P, cfg.frontend_dim), f32),
                      "tokens": _meta((B, S - P), i32)}
            if cell.kind == "train":
                inputs["labels"] = _meta((B, S - P), i32)
        else:
            inputs = {"tokens": _meta((B, S), i32)}
            if cell.kind == "train":
                inputs["labels"] = _meta((B, S), i32)
        return {"inputs": inputs}

    return {
        "cache": transformer.init_cache(cfg, B, S, device="meta"),
        "token": _meta((B,), i32),
        "pos": _meta((B,), i32),
    }
