#!/usr/bin/env python3
"""Times the port's prefix-LM flash attention on one card, and prints digests
of its results so two trees can be held bitwise to each other.

    python3 scripts/flash_prefix_timing.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` runs (by default
this checkout's), so two trees can be compared on one card in one call
(A, B, B, A; one process each).  First, on four causal bf16 cases with a
prefix per row (paligemma-3b's q (2, 8, 2304, 256) with prefixes (256, 100)
and (256, 256); q (2, 4, 1000, 128) window 300, prefixes (100, 1); q (2, 2,
384, 64), one query head per kv head, prefixes (65, 0)), the forward's out
and LSE and the backward's dq, dk and dv from fixed seeds, hashed together
per case.  Then the rows of ``chip_smoke.py``'s kernels line that carry a
prefix, with its own timers: the forward at paligemma-3b's prefill q (4, 8,
384, 256) and train q (2, 8, 2304, 256) shapes and the backward at the
latter, prefix 256.  One JSON line each, with the card's name and power
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
# (name, B, NQ, NKV, S, D, window, prefix per row)
CASES = (("paligemma", 2, 8, 1, 2304, 256, 0, (256, 100)),
         ("window", 2, 4, 1, 1000, 128, 300, (100, 1)),
         ("one-per-kv-head", 2, 2, 2, 384, 64, 0, (65, 0)),
         ("paligemma-256", 2, 8, 1, 2304, 256, 0, (256, 256)))
ROW_KEYS = ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("flash_prefix_timing: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as bk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    digests = {}
    for name, B, NQ, NKV, S, D, window, prefix in CASES:
        gen = torch.Generator().manual_seed(7)
        q, k, v, dout = (torch.randn(B, n, S, D, generator=gen).to("cuda", torch.bfloat16)
                         for n in (NQ, NKV, NKV, NQ))
        pre = torch.tensor(prefix, dtype=torch.int32, device="cuda")
        out, lse = fk.flash_attention_fwd(q, k, v, causal=True, window=window, return_lse=True,
                                          prefix_len=pre)
        grads = bk.flash_attention_bwd(q, k, v, out, dout, lse, causal=True, window=window,
                                       prefix_len=pre)
        h = hashlib.sha256()
        for t in (out, lse) + tuple(grads):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digests[name] = h.hexdigest()[:16]
    print(json.dumps(dict(label=args.label, src=args.src, card=card, digests=digests)), flush=True)
    gen = torch.Generator().manual_seed(0)
    rows = {
        "paligemma prefill": lambda: cs._flash_row(torch, gen, 4, 8, 1, 384, 256, 0, False,
                                                   "paligemma prefill", prefix=256),
        "paligemma training": lambda: cs._flash_row(torch, gen, 2, 8, 1, 2304, 256, 0, True,
                                                    "paligemma training", prefix=256),
        "paligemma backward": lambda: cs._full_width_bwd(torch, gen, cs.PALI_ARCH, S=2304,
                                                         prefix=256),
    }
    for name, row in rows.items():
        e = row()
        print(json.dumps(dict(label=args.label, card=card, row=name,
                              **{k: e[k] for k in ROW_KEYS})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
