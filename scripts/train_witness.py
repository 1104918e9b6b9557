#!/usr/bin/env python3
"""Trains a model as ``chip_smoke.py``'s train phase does, with the kernels
and with their plain versions, on one card.

    python3 scripts/train_witness.py [--src DIR] [--arch ARCH[:LAYERS] ...] [--no-plain]
                                     [--swap KERNEL ...]

For each ``--arch`` (default: gemma-2b, recurrentgemma-2b and olmoe-1b-7b
cut to 8 layers, at full width) it builds the train state with
``chip_smoke.train_setup`` (seed 0, batch 2 x 2048, the phase's optimizer),
scores a fixed held-out batch, runs the phase's 12 steps and scores it
again; then, unless ``--no-plain``, the same with every kernel of
``chip_smoke.plain_kernel_sites()`` (the norm, the flash forward and
backward, the ring decode, the RG-LRU scan and its backward) swapped for its
plain PyTorch version in ``kernels.ref``: the witness.  ``--swap`` swaps
only the kernels it names (``rms_norm_fwd``, ``flash_attention_fwd``,
``flash_attention_bwd``, ``decode_attention_fwd``, ``rglru_scan_fwd``,
``rglru_scan_bwd``); ``--swap flash_attention_bwd`` is the backward-only
witness of a flash-backward change.  One JSON line per run, with the card's name and power limit: the
train losses, the MoE load-balancing losses, the held-out loss before and
after, ``learned`` (the held-out fall) and ``wander`` (the standard
deviation of the train loss's step-to-step changes: each step draws its own
batch).  A model learns when the witness's ``learned`` is at least 5x its
``wander``; only then does ``chip_smoke.py`` check that its held-out loss
falls.

``--src`` names the ``src`` directory whose ``repro_torch`` runs, with the
``chip_smoke.py`` beside it, so two trees can be compared in one call: the
train losses of an unchanged model must be bitwise the same.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_ARCHS = ("gemma-2b", "recurrentgemma-2b", "olmoe-1b-7b:8")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", action="append", help="ARCH or ARCH:LAYERS (repeatable)")
    ap.add_argument("--no-plain", action="store_true", help="the kernels' run only")
    ap.add_argument("--swap", action="append", default=None,
                    help="swap only this kernel for its plain version (repeatable; "
                    "default: every kernel)")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(src.parent))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_witness: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs.archs import get_config

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    sites = cs.plain_kernel_sites()
    if args.swap:
        unknown = set(args.swap) - {attr for _, attr, _ in sites}
        if unknown:
            print(f"train_witness: no kernel named {sorted(unknown)}", file=sys.stderr)
            return 2
        sites = [site for site in sites if site[1] in args.swap]
    for spec in args.arch or DEFAULT_ARCHS:
        arch, _, layers = spec.partition(":")
        cfg = get_config(arch, n_layers=int(layers)) if layers else get_config(arch)
        for run in ("kernels",) + (() if args.no_plain else ("plain",)):
            with cs.plain_kernels(sites if run == "plain" else []):
                step_fn, pipe, state, held_out_loss = cs.train_setup(torch, cfg)
                before, losses, auxes = held_out_loss(state), [], []
                for step in range(cs.TRAIN_STEPS):
                    batch = {k: torch.from_numpy(v).to("cuda")
                             for k, v in pipe.batch_at(step).items()}
                    state, metrics = step_fn(state, batch)
                    losses.append(float(metrics["loss"]))
                    auxes.append(float(metrics["aux"]) if "aux" in metrics else 0.0)
                after = held_out_loss(state)
            print(json.dumps(dict(
                src=str(src), card=card, arch=arch, layers=cfg.n_layers,
                run=run, swapped=[attr for _, attr, _ in sites] if run == "plain" else [],
                train_losses=losses, aux=auxes, held_out=[before, after],
                learned=before - after, wander=float(np.std(np.diff(losses))))), flush=True)
            del state, step_fn
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
