"""Knee sweep of one configuration: short windows at a ladder of Poisson rates.

    python3 perfbench/sweep.py --config qwen3-14b --traffic classify-qwen3-14b \
        --rates 0.5,1,2,4 --seconds 20 --seed 7 [--json-out results/sweep.json]

One set-up, then one window per rate on the same deployment, each served
as a benchmark run serves it.  Per rate it prints the requests sent, the
share the remote tier answered within the SLA, the drain after the
window's close (a backlog that grows through the window shows as a drain
that grows with the rate), the remote tier's p50 / p95 and the accuracy.
The knee is the highest rate at which 90 % of the requests sent are
answered by the remote tier within the SLA and the backlog does not grow.
Used once, when a cell's rate is fixed; the benchmark's runs do not use it.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

from perfbench import run as bench  # noqa: E402  (sets the cache paths)
from perfbench import cells, loadgen, window  # noqa: E402
from perfbench.yardstick import quantile  # noqa: E402

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    conf = json.loads((cells.HERE / "configs" / f"{args.config}.json").read_text())
    hedge = json.loads((cells.HERE / "tiers" / f"{conf['hedge']}.json").read_text())
    mix = json.loads((cells.HERE / "traffic" / f"{args.traffic}.json").read_text())
    dev = torch.device("cuda")
    remote = window.make_tier({"name": conf["name"], "model": conf["model"],
                               "quality": conf["quality"]}, args.seed, dev)
    spans = window.Spans()
    eng = window.Engine(remote, window.make_tier(hedge, args.seed, dev), mix, args.seed, dev,
                        spans)
    print(f"setup {time.perf_counter() - T_START:.1f} s; profiles "
          + ", ".join(f"{p.name} mu={p.mu_ms:.1f} ms" for p in eng.registry)
          + f"; hedge mu={eng.ondevice.mu_ms:.1f} ms", flush=True)
    rows = []
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        m = copy.deepcopy(mix)
        m["arrivals"]["rate_rps"] = rate
        stream = loadgen.make_stream(m, args.seconds, args.seed + k)
        spans.items.clear()
        res = window.run_window(eng, stream, args.seconds, spans)
        recs = res.records
        calls = {}
        for name, a, b in res.spans:
            if name.startswith("generate"):
                calls.setdefault(name, []).append((b - a) / 1e6)
        lat = [r.remote_ms if r.remote_ms is not None else float("inf") for r in recs]
        remote_ok = sum(bool(r.used_remote) and r.answer_ms is not None
                        and r.answer_ms <= stream.sla_ms for r in recs)
        q = {m_: float(conf["quality"]) if r.used_remote else float(hedge["quality"])
             for m_, r in enumerate(recs) if r.answered}
        row = {
            "rate_rps": rate, "sent": len(recs),
            "remote_in_sla_pct": 100.0 * remote_ok / max(len(recs), 1),
            "drain_s": res.window_s - args.seconds,
            "remote_p50_ms": quantile(lat, 50), "remote_p95_ms": quantile(lat, 95),
            "accuracy_pct": sum(q.values()) / max(len(recs), 1),
            "rows_per_batch": (sum(t.n_requests for t in res.ticks) / max(len(res.ticks), 1)),
            "unanswered": sum(not r.answered for r in recs),
            "calls": {k: {"n": len(v), "p50_ms": quantile(v, 50), "max_ms": max(v),
                          "sum_s": sum(v) / 1e3} for k, v in calls.items()},
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
