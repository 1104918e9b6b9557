"""Tiny cells for the CPU tests: the real cells' structure at toy sizes."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from perfbench import cells

HERE = Path(__file__).resolve().parent.parent

TINY_MODEL = {
    "qwen3-14b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                      vocab_size=8192),
    "olmoe-1b-7b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=64,
                        expert_d_ff=64, n_experts=4, top_k=2, vocab_size=8192),
}


def tiny_cell(config: str, traffic: str, dtype: str = "float32", rate: float = 20.0):
    """``config`` under ``traffic`` cut to toy sizes: short prompts, a high
    rate, two layers of width 64 (a vocabulary wide enough that the best
    logits lie close, as at full size)."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    conf = json.loads((HERE / "configs" / f"{config}.json").read_text())
    conf["model"].update(TINY_MODEL[config], dtype=dtype)
    hedge = json.loads((HERE / "tiers" / f"{conf['hedge']}.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{traffic}.json").read_text())
    mix = copy.deepcopy(mix)
    mix["arrivals"]["rate_rps"] = rate
    mix["prompt_tokens"].update(median=16, min=8, max=32)
    mix["max_len"] = 40
    return cells.Cell(f"{config}.tiny", conf, hedge, mix, bench["end_to_end"], bench["per_layer"])
