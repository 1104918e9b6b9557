"""Latency/quality profiles for the LM zoo: the H100 analogue of Table III
(the JAX package's ``serving/profiles.py``).

``A(m)`` is a quality proxy (published-benchmark-flavoured scores for the
text-generation tier of each arch; it parameterizes the selection
trade-off the way top-1 accuracy does in the paper).  ``mu(m)`` is a
roofline latency estimate: per request, prefill(P tokens) + T *
decode_step, each term ``max(compute, memory, collective)``.  When a
dry-run roofline JSON is available, profiles are refined from its compiled
numbers instead of the analytic ones.

The roofline constants are the H100 80GB HBM3 SXM's data-sheet peaks at
its 700 W limit, not measurements: the port's measured profiles come from
``ExecutionBackend.measure_profile`` on the card.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from repro_torch.configs.archs import get_config
from repro_torch.core.registry import ModelProfile, ModelRegistry

__all__ = ["H100", "QUALITY", "estimate_ms", "roofline_ms", "lm_zoo_registry", "ONDEVICE_TIER"]

# NVIDIA H100 80GB HBM3 (SXM) data sheet, per card.
H100 = {
    "peak_flops": 989e12,  # dense bf16 tensor-core FLOP/s
    "hbm_bw": 3.35e12,  # HBM3 bytes/s
    "link_bw": 450e9,  # NVLink bytes/s per direction
}

# Quality proxies for the text-generation task tier (open-benchmark
# flavoured; a stand-in for the paper's measured top-1 accuracy).
QUALITY = {
    "llama4-scout-17b-a16e": 79.0,
    "qwen3-14b": 77.0,
    "phi3-mini-3.8b": 69.0,
    "llama3-8b": 68.0,
    "olmoe-1b-7b": 54.0,
    "gemma-2b": 42.0,
    "recurrentgemma-2b": 42.0,
    "xlstm-350m": 28.0,
}


def estimate_ms(flops, bytes_, coll_bytes=0.0, chips=8):
    """Roofline step-time estimate (ms): max of the three terms."""
    t_c = flops / (chips * H100["peak_flops"])
    t_m = bytes_ / (chips * H100["hbm_bw"])
    t_x = coll_bytes / (chips * H100["link_bw"])
    return 1e3 * max(t_c, t_m, t_x)


def _arch_latency_ms(arch: str, *, prompt=512, gen_tokens=64, chips=8):
    return roofline_ms(get_config(arch), prompt=prompt, gen_tokens=gen_tokens, chips=chips)


def roofline_ms(cfg, *, prompt=512, gen_tokens=64, chips=8):
    """Roofline latency (ms) of one request on ``cfg``: the prefill of
    ``prompt`` tokens plus ``gen_tokens`` decode steps."""
    n_active = cfg.param_count(active_only=True)
    n_total = cfg.param_count()
    # Prefill: compute-bound, 2*N_active FLOPs/token; weights read once.
    pre = estimate_ms(2 * n_active * prompt, 2 * n_total, chips=chips)
    # Decode: memory-bound, streams weights + KV/state per token.
    kv_bytes = 0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "moe"):
            kv_bytes += 2 * prompt * cfg.n_kv_heads * cfg.head_dim * 2
        elif kind == "local":
            kv_bytes += 2 * min(cfg.window, prompt) * cfg.n_kv_heads * cfg.head_dim * 2
        elif kind in ("mlstm", "slstm", "recurrent"):
            kv_bytes += 4 * cfg.d_model * 4  # O(1) state, fp32
    dec = estimate_ms(2 * n_active, 2 * n_total + kv_bytes, chips=chips)
    return pre + gen_tokens * dec


def lm_zoo_registry(
    *,
    prompt: int = 512,
    gen_tokens: int = 64,
    chips: int = 8,
    sigma_frac: float = 0.04,
    roofline_json: Optional[str] = None,
) -> ModelRegistry:
    """The serving-tier zoo: every text-gen arch as a ModelProfile.

    ``sigma_frac`` models serving jitter (batching/queueing) as a fraction
    of mu.  ``roofline_json``: optional dry-run output (cells of
    ``decode_32k`` on ``single_pod`` with per-term seconds,
    ``repro_torch.launch.dryrun``'s) to refine mu.
    """
    refine = {}
    if roofline_json and Path(roofline_json).exists():
        data = json.loads(Path(roofline_json).read_text())
        for row in data.get("cells", []):
            # a skipped or failed row (hubert has no decode step) has no terms
            if (row.get("shape") == "decode_32k" and row.get("mesh") == "single_pod"
                    and "terms_s" in row):
                # compiled per-step seconds -> per-token ms at this batch
                terms = row["terms_s"]
                refine[row["arch"]] = 1e3 * max(terms.values()) / row.get("global_batch", 1)

    profiles = []
    for arch, quality in QUALITY.items():
        mu = _arch_latency_ms(arch, prompt=prompt, gen_tokens=gen_tokens, chips=chips)
        if arch in refine:
            mu = refine[arch] * gen_tokens + mu * 0.1  # compiled decode + est prefill
        profiles.append(
            ModelProfile(name=arch, accuracy=quality, mu_ms=mu, sigma_ms=sigma_frac * mu)
        )
    return ModelRegistry(sorted(profiles, key=lambda p: p.accuracy))


# The hedged duplicate tier: the smallest, always-fast variant, replicated
# on every serving slice (the datacenter analogue of the on-device model).
ONDEVICE_TIER = ModelProfile(
    name="xlstm-350m (hedge tier)",
    accuracy=QUALITY["xlstm-350m"],
    mu_ms=_arch_latency_ms("xlstm-350m", prompt=512, gen_tokens=64, chips=1),
    sigma_ms=0.5,
)
