#!/usr/bin/env python3
"""Times the port's RG-LRU scan kernel, forward and backward, on one card.

    python3 scripts/rglru_scan_timing.py [--src DIR] [--label NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so two trees can be compared in one session: run
the script on each in turn on the same card (A, B, B, A).  It times, with
CUDA events over CUDA-graph replays (``chip_smoke.time_ms``), the forward
``rglru_scan_fwd`` at the recurrentgemma-2b train shape (2, 2048, 2560) and
hybrid serve prefill shape (4, 128, 2560), and the whole backward call
``rglru_scan_bwd`` at the train shape, all f32 as the model feeds them, and
prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--plans", action="store_true",
                    help="also time the kernel under every plan it takes at each shape "
                    "(chunk length x channels a block; trees with a planner only)")
    ap.add_argument("--profiled", action="store_true",
                    help="also the host wall of 18 backward and 34 forward launches at the "
                    "train shape (one recurrentgemma-2b train step's), eager, without and "
                    "under torch.profiler")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("rglru_scan_timing: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import _rglru_case, _randn, time_ms
    from repro_torch.kernels import rglru_scan as rk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(0)
    out = dict(label=args.label, src=str(Path(args.src).resolve()), card=card)
    for name, (B, S, W) in (("fwd_train", (2, 2048, 2560)), ("fwd_serve", (4, 128, 2560))):
        a, b, h0 = _rglru_case(torch, gen, B, S, W, torch.float32)
        out[name + "_ms"] = time_ms(torch, lambda: rk.rglru_scan_fwd(a, b, h0))
        out[name + "_eager_ms"] = time_ms(torch, lambda: rk.rglru_scan_fwd(a, b, h0),
                                          graph=False)
    a, b, h0 = _rglru_case(torch, gen, 2, 2048, 2560, torch.float32)
    h = rk.rglru_scan_fwd(a, b, h0)
    dh = _randn(torch, (2, 2048, 2560), torch.float32, gen)
    out["bwd_train_ms"] = time_ms(torch, lambda: rk.rglru_scan_bwd(a, h, h0, dh))
    out["bwd_train_eager_ms"] = time_ms(torch, lambda: rk.rglru_scan_bwd(a, h, h0, dh),
                                        graph=False)
    plan = getattr(rk, "launch_plan", None)
    if plan is not None:
        out["plan_fwd_train"] = str(plan(a, False))
        out["plan_bwd_train"] = str(plan(a, True))
    if args.profiled:
        out.update(_profiled_walls(torch, rk, a, b, h0, h, dh))
    print(json.dumps(out), flush=True)
    if args.plans:
        for name, (B, S, W), reverse in (("fwd_serve", (4, 128, 2560), False),
                                         ("fwd_train", (2, 2048, 2560), False),
                                         ("bwd_train", (2, 2048, 2560), True)):
            for row in _plan_times(torch, rk, time_ms, gen, B, S, W, reverse):
                print(json.dumps(dict(label=args.label, case=name, **row)), flush=True)
    return 0


def _profiled_walls(torch, rk, a, b, h0, h, dh):
    """Host wall (ms) of one train step's scan launches, eager, three times
    without and three times under ``torch.profiler`` (CPU and CUDA
    activities), each ending in a synchronize."""
    import time

    from torch.profiler import ProfilerActivity, profile

    def step():
        for _ in range(34):
            rk.rglru_scan_fwd(a, b, h0)
        for _ in range(18):
            rk.rglru_scan_bwd(a, h, h0, dh)
        torch.cuda.synchronize()

    def wall():
        t0 = time.perf_counter()
        step()
        return (time.perf_counter() - t0) * 1e3

    step()
    plain = [wall() for _ in range(3)]
    profiled = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            profiled.append(wall())
    return dict(step_scans_wall_ms=plain, step_scans_profiled_wall_ms=profiled)


def _plan_times(torch, rk, time_ms, gen, B, S, W, reverse):
    """Device ms of one launch under each plan that fits (f32), the
    planner's own marked."""
    from chip_smoke import _randn, _rglru_case

    a, b, h0 = _rglru_case(torch, gen, B, S, W, torch.float32)
    h = rk.rglru_scan_fwd(a, b, h0)
    dh = _randn(torch, (B, S, W), torch.float32, gen)
    chosen = rk.launch_plan(a, reverse)
    rows = []
    for chunk in rk.CHUNKS:
        for tile_w in (32, 64, 128):
            plan = rk.make_plan(B, S, W, 4, reverse, chunk, tile_w)
            if plan.smem > rk.SMEM_LIMIT:
                continue
            if reverse:
                def fn():
                    rk.rglru_scan_bwd(a, h, h0, dh, plan=plan)
            else:
                def fn():
                    rk.rglru_scan_fwd(a, b, h0, plan=plan)
            rows.append(dict(chunk=chunk, tile_w=tile_w, cluster=plan.cluster,
                             groups=plan.groups, blocks=plan.blocks, planner=plan == chosen,
                             ms=time_ms(torch, fn)))
    return rows


if __name__ == "__main__":
    sys.exit(main())
