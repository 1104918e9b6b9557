#!/usr/bin/env python3
"""Holds the flash kernels' D = 64 / 128 / 256 routes bitwise between two
trees, and times both kernels at hubert-xlarge's (D = 80) and phi3-mini's
(D = 96) train shapes, on one card.

    python3 scripts/flash_headdim_timing.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` runs (by default
this checkout's), so two trees can be compared on one card in one call
(A, B, B, A; one process each).  First, on five bf16 cases at D = 64, 128
and 256 (gemma-2b's and recurrentgemma-2b's heads, olmoe-1b-7b's one q head
per kv head, a bidirectional window cut mid-tile, GQA with a window and a
ragged S), the forward's out and LSE and the backward's dq, dk and dv from
fixed seeds, hashed together per case: two trees that leave those routes
alone print the same digests.  The same for two cases at D = 80 and 96,
printed apart (a tree that changes those routes changes them).  Then rows
of ``chip_smoke.py``'s kernels line with its own timers: the forward (with
the LSE) and the backward at hubert-xlarge's q (2, 16, 2048, 80),
bidirectional (rows 2g / 5d) and phi3-mini-3.8b's q (2, 32, 2048, 96),
causal (rows 2h / 5e).  One JSON line each, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (name, B, NQ, NKV, S, D, causal, window)
SAME_CASES = (("gemma-2b", 2, 8, 1, 2048, 256, True, 0),
              ("recurrentgemma-2b", 1, 10, 1, 2100, 256, True, 2048),
              ("olmoe-1b-7b", 2, 16, 16, 1024, 128, True, 0),
              ("d64-bidirectional-window", 2, 8, 2, 1000, 64, False, 65),
              ("d128-gqa-window", 1, 10, 2, 517, 128, True, 130))
NEW_CASES = (("hubert-xlarge", 1, 16, 16, 1000, 80, False, 0),
             ("phi3-mini", 1, 32, 32, 1000, 96, True, 0))
ROW_KEYS = ("shape", "ms", "eager_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")


def _digests(torch, fk, bk, cases):
    out = {}
    for name, B, NQ, NKV, S, D, causal, window in cases:
        gen = torch.Generator().manual_seed(11)
        q, k, v, dout = (torch.randn(B, S, n, D, generator=gen).to("cuda", torch.bfloat16)
                         .transpose(1, 2) for n in (NQ, NKV, NKV, NQ))
        o, lse = fk.flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
        grads = bk.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal, window=window)
        h = hashlib.sha256()
        for t in (o, lse) + tuple(grads):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out[name] = h.hexdigest()[:16]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("flash_headdim_timing: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as bk

    cuda_build.build(["flash_attention", "flash_attention_bwd"])  # both nvcc at once

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    routes = {D: (fk.flash_route(torch.bfloat16, D), bk.bwd_route(torch.bfloat16, D))
              for D in (64, 80, 96, 128, 256)}
    print(json.dumps(dict(label=args.label, src=args.src, card=card, routes=routes,
                          digests=_digests(torch, fk, bk, SAME_CASES),
                          digests_80_96=_digests(torch, fk, bk, NEW_CASES))), flush=True)
    gen = torch.Generator().manual_seed(0)
    hubert, phi3 = get_config(cs.HUBERT_ARCH), get_config(cs.PHI3_ARCH)
    B, S = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    rows = {
        "2g hubert forward": lambda: cs._flash_row(
            torch, gen, B, hubert.n_heads, hubert.n_kv_heads, S, hubert.head_dim, 0, True,
            "hubert training", causal=False),
        "5d hubert backward": lambda: cs._full_width_bwd(torch, gen, cs.HUBERT_ARCH),
        "2h phi3 forward": lambda: cs._flash_row(
            torch, gen, B, phi3.n_heads, phi3.n_kv_heads, S, phi3.head_dim, 0, True,
            "phi3-mini training"),
        "5e phi3 backward": lambda: cs._full_width_bwd(torch, gen, cs.PHI3_ARCH),
    }
    for name, row in rows.items():
        e = row()
        print(json.dumps(dict(label=args.label, card=card, row=name,
                              **{k: e[k] for k in ROW_KEYS})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
