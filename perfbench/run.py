"""The benchmark of the port's serving stack: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's deployment from the seed, serves the cell's traffic
open-loop for ``--seconds`` on the wall clock, checks the answers against
the plain reference, and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end ones, or with ``--trace 1`` the
per-layer ones), ``device`` (and with ``--trace 1`` a ``breakdown``), then
``compared``: each number the check compared beside its limit.  Needs a
CUDA device; exits non-zero without one, or when JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SERVING_KERNELS = ("flash_attention", "decode_attention")


def _paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # Triton's kernel cache at a fixed place inside the checkout, so only a
    # checkout's first run compiles.
    cache = ROOT / "build" / "perfbench-triton"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(cache)


_paths()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import cells, devtrace, loadgen, window  # noqa: E402
from perfbench.reference import check  # noqa: E402
from perfbench.reference.model import Reference, Spec  # noqa: E402


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: cells.Cell
    remote_cfg: object
    records: List[window.Record]
    ticks: list
    sla_ms: float
    max_len: int
    setup_s: float
    window_s: float
    trace: Optional[devtrace.DeviceTrace]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_kernels() -> None:
    """Build the serving path's CUDA kernels now, and say how long that
    took: a checkout's first run compiles them (counted in ``setup_s``,
    as every set-up is), later runs load them."""
    from repro_torch.kernels import cuda_build

    t = time.perf_counter()
    built = cuda_build.build(SERVING_KERNELS)
    print(f"kernels: {', '.join(built) or 'none'} built in {time.perf_counter() - t:.3f} s "
          f"(of {', '.join(SERVING_KERNELS)})", file=sys.stderr)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, limits: Optional[dict] = None) -> dict:
    """One run; returns the result object (without ``compared`` last).
    ``limits`` overrides the configuration's (the tests' tiny cells)."""
    dev = torch.device(device)
    spans = window.Spans() if trace else None
    if dev.type == "cuda":
        build_kernels()
    remote = window.make_tier({"name": cell.config["name"], "model": cell.config["model"],
                               "quality": cell.config["quality"]}, seed, dev)
    hedge = window.make_tier(cell.hedge, seed, dev)
    eng = window.Engine(remote, hedge, cell.mix, seed, dev, spans)
    stream = loadgen.make_stream(cell.mix, seconds, seed)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    with devtrace.maybe_trace(trace) as tr:
        res = window.run_window(eng, stream, seconds, spans)
        _sync(dev)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded during the run: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    dtrace = tr.reduce(res.spans) if tr is not None else None
    run = Run(cell=cell, remote_cfg=remote.cfg, records=res.records, ticks=res.ticks,
              sla_ms=stream.sla_ms, max_len=stream.max_len, setup_s=setup_s,
              window_s=res.window_s, trace=dtrace)
    metrics = cells.read_all(cell.per_layer if trace else cell.end_to_end, run)
    late = res.lateness_ms
    print(f"generator lateness: p50 {np.median(late):.3f} ms, max {late.max(initial=0):.3f} ms "
          f"over {len(late)} requests; window + drain {res.window_s:.3f} s; "
          f"setup {setup_s:.3f} s", file=sys.stderr)

    # The check runs once the program's state is gone; only the weights stay.
    del eng, tr
    res.ticks.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lim = dict(cell.config["correct"], **(limits or {}))
    readings = check.judge(res.served,
                           Reference(Spec.from_dict(cell.config["model"]), remote.params),
                           Reference(Spec.from_dict(cell.hedge["model"]), hedge.params), seed,
                           int(lim["sample_tokens"]), dev,
                           far_gap=float(lim.get("far_gap", 0.1)))
    correct, compared = check.verdict(readings, lim)
    print("check readings: " + json.dumps(readings), file=sys.stderr)
    out = {
        "correct": bool(correct),
        "attempted": len(res.records),
        "failed": int(sum(not r.answered for r in res.records)),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if dtrace is not None:
        out["device"]["busy_s"] = dtrace.busy_s()
        out["device"]["window_s"] = dtrace.window_s
        out["breakdown"] = {"device_ops": dtrace.top_ops(10), "idle_gaps": dtrace.idle_gaps(10)}
    out["compared"] = [{"name": n, "value": v, "limit": lim_} for n, v, lim_ in compared]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    cell = cells.load(ROOT, args.workload)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded during the run: {', '.join(found)}", file=sys.stderr)
        return 3
    for c in out["compared"]:
        print(f"compared {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
