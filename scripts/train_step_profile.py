#!/usr/bin/env python3
"""Times full-width train steps on one card and breaks one step down by
kernel family, so two trees can be compared step for step.

    python3 scripts/train_step_profile.py [--src DIR] [--label NAME]
        [--arch A ...] [--steps N]

Each arch (by default hubert-xlarge and phi3-mini-3.8b, the two full-width
train commands whose attention runs at head dims 80 and 96) trains as
``chip_smoke.py``'s train phase sets it up (``chip_smoke.train_setup``:
batch 2 x 2048 of the seed-0 pipeline, seeded state on the card): ``N``
steps, each timed on the host around work that ends in
``torch.cuda.synchronize()``, then one more under ``torch.profiler``
(device busy share, device ms by kernel family, the top kernels).
``--src`` names the ``src`` directory whose ``repro_torch`` runs (by
default this checkout's), so two trees can be compared on one card in one
call (A, B, B, A; one process each).  One JSON line per arch, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--arch", nargs="+", default=["hubert-xlarge", "phi3-mini-3.8b"])
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("train_step_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs.archs import get_config

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    for arch in args.arch:
        step_fn, pipe, state, _ = cs.train_setup(torch, get_config(arch))
        step_ms, losses = [], []
        for step in range(args.steps):
            batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(step).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(args.steps).items()}
        prof = cs._profile_step(torch, lambda: step_fn(state, batch), f"{arch} train step", card,
                                verbose=False)
        print(json.dumps(dict(
            label=args.label, card=card, arch=arch, step_ms=step_ms,
            median_step_ms=statistics.median(step_ms[1:]), losses=losses,
            profiled_wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
            families={k: round(v, 3) for k, v in sorted(prof["families"].items(),
                                                         key=lambda kv: -kv[1])},
            top=[(name[:80], round(ms, 3)) for name, ms in prof["top"]])), flush=True)
        del step_fn, pipe, state, batch
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
