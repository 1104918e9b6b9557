"""Readings that set a configuration's limits: the program's and the controls'.

    python3 perfbench/control.py --workload qwen3-14b.classify --seeds 1,2,3 \
        --seconds 51 [--json-out results/control.json]

Per seed, in one process: the cell's deployment built from that seed, one
short window of the cell's own traffic (as a run serves it), then the
check's readings of what the program served, and the control's at the
same prompts and tokens: the reference computed as an fp8 GEMM would
compute it in place of the remote tier, and the float32 hedge model's
reference with TF32 on in place of the hedge tier (the gap of the token
each control puts first).  Both sets of readings then go through the
check's own verdict at the configuration's limits: the program's has to
come out correct, the control's not.
The benchmark's runs do not run this; the limits in ``configs/`` are set
from its readings (``PERF.md`` gives them).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

from perfbench import run as bench  # noqa: E402  (sets the cache paths)
from perfbench import cells, loadgen, window  # noqa: E402
from perfbench.reference import check  # noqa: E402
from perfbench.reference.model import Reference, Spec  # noqa: E402

import torch  # noqa: E402


def readings(cell, seed: int, seconds: float) -> dict:
    dev = torch.device("cuda")
    remote = window.make_tier({"name": cell.config["name"], "model": cell.config["model"],
                               "quality": cell.config["quality"]}, seed, dev)
    hedge = window.make_tier(cell.hedge, seed, dev)
    mix = cell.mix
    eng = window.Engine(remote, hedge, mix, seed, dev)
    res = window.run_window(eng, loadgen.make_stream(mix, seconds, seed), seconds)
    del eng
    torch.cuda.empty_cache()
    rspec, hspec = Spec.from_dict(cell.config["model"]), Spec.from_dict(cell.hedge["model"])
    limits = cell.config["correct"]
    tokens, far = int(limits["sample_tokens"]), float(limits.get("far_gap", 0.1))
    pg, cg = {}, {}
    prog = check.judge(res.served, Reference(rspec, remote.params),
                       Reference(hspec, hedge.params), seed, tokens, dev, gaps_out=pg, far_gap=far)
    ctl = check.judge(res.served, Reference(rspec, remote.params), Reference(hspec, hedge.params),
                      seed, tokens, dev,
                      control={"remote": Reference(rspec, remote.params, "fp8"),
                               "hedge": Reference(hspec, hedge.params, "tf32")},
                      gaps_out=cg, far_gap=far)
    return {"seed": seed, "sent": len(res.records),
            "program": prog, "control": ctl,
            "program_gaps": pg["remote"].tolist(), "control_gaps": cg["remote"].tolist(),
            "program_correct": check.verdict(prog, limits)[0],
            "control_correct": check.verdict(ctl, limits)[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(bench.ROOT, args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        row = readings(cell, seed, args.seconds)
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=1))
    held = all(r["program_correct"] and not r["control_correct"] for r in rows)
    print(f"program correct and control not correct on every seed: {held}", file=sys.stderr)
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
