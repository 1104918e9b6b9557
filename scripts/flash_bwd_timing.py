#!/usr/bin/env python3
"""Times the port's flash-attention backward on one card, at the train shapes.

    python3 scripts/flash_bwd_timing.py [--src DIR] [--label NAME] [--plans] [--witness]
                                        [--sensitivity]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so two trees can be compared on one card in one
call (A, B, B, A).  At gemma-2b's q (2, 8, 2048, 256) causal and
recurrentgemma-2b's q (2, 10, 2048, 256) window 2048, one kv head, bf16, it
times with CUDA events (``chip_smoke.time_ms``) the whole
``flash_attention_bwd`` call over CUDA-graph replays and eagerly, the
device ms of each kernel it launches (``torch.profiler``), the backward of
``F.scaled_dot_product_attention`` alone (eager).  ``--plans`` also times
the wgmma route under every heads-per-group split.  The inputs are drawn
from a fixed seed, so two trees see the same ones.  ``--witness`` then
trains both models as ``chip_smoke.py``'s train phase does
(``chip_smoke.train_setup``), once with the kernel and once with the plain
backward (``ref.flash_attention_bwd_ref``, f32) in its place, and prints
each run's train losses and held-out loss before and after.
``--sensitivity`` takes one ``loss_fn`` gradient of each model at its
train state and first batch with the kernels, then with each kernel's
plain version in its place alone (the norm, the flash forward, the flash
backward, the scan forward and backward) and with all of them plain, and
prints each gradient's relative distance from the kernels' (all leaves
together, and the largest leaf alone): how far the last bits of one op
move a full-width gradient.  One JSON line per shape or run, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("gemma-2b", 8, 0), ("recurrentgemma-2b", 10, 2048))  # (arch, NQ, window)
B, S, D = 2, 2048, 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--plans", action="store_true",
                    help="also time every heads-per-group split of the wgmma route")
    ap.add_argument("--witness", action="store_true",
                    help="also train both models with the kernel and with the plain backward")
    ap.add_argument("--sensitivity", action="store_true",
                    help="also each model's gradient with one op at a time plain")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_timing: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import _randn, _sdpa, time_ms
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as bk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16
    for arch, NQ, window in SHAPES:
        q = _randn(torch, (B, S, NQ, D), bf16, gen).transpose(1, 2)
        k = _randn(torch, (B, S, 1, D), bf16, gen).transpose(1, 2)
        v = _randn(torch, (B, S, 1, D), bf16, gen).transpose(1, 2)
        dout = _randn(torch, (B, S, NQ, D), bf16, gen).transpose(1, 2)
        out, lse = fk.flash_attention_fwd(q, k, v, window=window, return_lse=True)

        def call():
            return bk.flash_attention_bwd(q, k, v, out, dout, lse, window=window)

        row = dict(label=args.label, src=str(Path(args.src).resolve()), card=card, arch=arch,
                   shape=[B, NQ, 1, S, D], window=window,
                   route=bk.bwd_route(bf16, D) if hasattr(bk, "bwd_route") else "wmma",
                   ms=time_ms(torch, call, launches=5),
                   eager_ms=time_ms(torch, call, launches=5, graph=False),
                   kernels_ms=_kernel_ms(torch, call))
        if hasattr(bk, "bwd_plan"):
            row["plan"] = list(bk.bwd_plan(B, NQ, 1, S, D, torch.cuda.get_device_properties(0)
                                           .multi_processor_count))
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = _sdpa(torch, qq, kk, vv, is_causal=True)  # a window of S is causal
        row["sdpa_bwd_eager_ms"] = time_ms(
            torch, lambda: torch.autograd.grad(o, (qq, kk, vv), dout, retain_graph=True),
            launches=5, graph=False)
        if args.plans and hasattr(bk, "bwd_plan"):
            row["plans_ms"] = _plan_ms(torch, bk, time_ms, call, NQ)
        print(json.dumps(row), flush=True)
    if args.witness:
        _witness(torch, bk, card, args.label)
    if args.sensitivity:
        _sensitivity(torch, card, args.label)
    return 0


def _sensitivity(torch, card, label):
    """One gradient per op swapped for its plain version, against the kernels'."""
    import chip_smoke as cs
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import flash_attention_bwd as bk
    from repro_torch.kernels import ops, ref
    from repro_torch.models.transformer import loss_fn
    from repro_torch.tree import tree_leaves, tree_map

    sites = {  # (module, attribute, its plain version)
        "rms_norm_fwd": (ops._rmsnorm, "rms_norm_fwd", lambda x, w, eps, offset:
                         ref.rms_norm_ref(x, w, eps=eps, offset=offset)),
        "flash_attention_fwd": (ops._flash, "flash_attention_fwd", ref.flash_attention_ref),
        "flash_attention_bwd": (bk, "flash_attention_bwd", ref.flash_attention_bwd_ref),
        "rglru_scan_fwd": (ops._rglru, "rglru_scan_fwd", ref.rglru_scan_ref),
        "rglru_scan_bwd": (ops._rglru, "rglru_scan_bwd", ref.rglru_scan_bwd_ref),
    }
    kernels = {name: getattr(mod, attr) for name, (mod, attr, _) in sites.items()}
    for arch in cs.TRAIN_ARCHS:
        cfg = get_config(arch)
        _, pipe, state, _ = cs.train_setup(torch, cfg)
        params = state["params"]
        del state
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(0).items()}

        def grads(plain):
            for name, (mod, attr, fn) in sites.items():
                setattr(mod, attr, fn if name in plain else kernels[name])
            try:
                leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
                flat = tree_leaves(leaves)
                loss = loss_fn(cfg, leaves, batch)[0]
                return float(loss.detach()), torch.autograd.grad(loss, flat)
            finally:
                for name, (mod, attr, _) in sites.items():
                    setattr(mod, attr, kernels[name])

        def dist(got, want):
            sq = [(float((g.float() - w.float()).pow(2).sum()), float(w.float().pow(2).sum()))
                  for g, w in zip(got, want)]
            big = max(range(len(sq)), key=lambda i: sq[i][1])
            return ((sum(a for a, _ in sq) / sum(b for _, b in sq)) ** 0.5,
                    (sq[big][0] / sq[big][1]) ** 0.5)

        base_loss, base = grads(())
        norm = sum(float(g.float().pow(2).sum()) for g in base) ** 0.5
        row = dict(label=label, card=card, arch=arch, loss=base_loss, grad_norm=norm,
                   again=dist(grads(())[1], base))
        used = [n for n in sites if "recurrent" in cfg.layer_kinds() or not n.startswith("rglru")]
        for plain in [(name,) for name in used] + [tuple(used)]:
            loss, g = grads(plain)
            row["+".join(plain) if len(plain) == 1 else "all plain"] = dict(loss=loss,
                                                                          dist=dist(g, base))
            del g
        print(json.dumps(row), flush=True)
        del params, base
        torch.cuda.empty_cache()


def _witness(torch, bk, card, label):
    """chip_smoke's train runs with the kernel, then with the plain backward."""
    import chip_smoke as cs
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ref

    kernel = bk.flash_attention_bwd
    for arch in cs.TRAIN_ARCHS:
        cfg = get_config(arch)
        for name, bwd in (("kernel", kernel), ("plain", ref.flash_attention_bwd_ref)):
            bk.flash_attention_bwd = bwd
            try:
                step_fn, pipe, state, held_out_loss = cs.train_setup(torch, cfg)
                before, losses = held_out_loss(state), []
                for step in range(cs.TRAIN_STEPS):
                    batch = {k: torch.from_numpy(v).to("cuda")
                             for k, v in pipe.batch_at(step).items()}
                    state, metrics = step_fn(state, batch)
                    losses.append(float(metrics["loss"]))
                print(json.dumps(dict(label=label, card=card, arch=arch, backward=name,
                                      train_losses=losses, held_out=[before, held_out_loss(state)])),
                      flush=True)
            finally:
                bk.flash_attention_bwd = kernel
            del state
            torch.cuda.empty_cache()


def _kernel_ms(torch, call, n=3):
    """Device ms of each kernel of one call (the mean over ``n`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        ms = getattr(e, "device_time_total", 0) / 1e3 / n
        if ms > 0:
            name = e.key.split("<")[0].split("(")[0].split("::")[-1] or e.key[:60]
            out[name] = out.get(name, 0.0) + ms
    return out


def _plan_ms(torch, bk, time_ms, call, NQ):
    """The whole call's ms under each heads-per-group split 1..G."""
    chosen = bk.bwd_plan
    rows = {}
    try:
        for hpg in range(1, NQ + 1):
            bk.bwd_plan = lambda *a, hpg=hpg: (64, hpg, -(-NQ // hpg))
            rows[hpg] = time_ms(torch, call, launches=5)
    finally:
        bk.bwd_plan = chosen
    return rows


if __name__ == "__main__":
    sys.exit(main())
