"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix and
lists the metrics; everything else lives in files of its own, found here by
name:

* ``configs/<config>.json``: the model as it is run, its quality, its
  hedge tier (``tiers/<hedge>.json``) and the limits ``correct`` is held to;
* ``traffic/<traffic>.json``: the mix's parameters, read by ``loadgen``;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns a number or None when it finds nothing to read.

A model, a mix or a metric is added by adding its file and its entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    hedge: dict
    mix: dict
    end_to_end: List[dict]  # the cell's end-to-end metric entries
    per_layer: List[dict]  # the cell's per-layer metric entries


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark(root: Path) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, workload: str) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = _json(HERE / "configs" / f"{entry['config']}.json")
    hedge = _json(HERE / "tiers" / f"{config['hedge']}.json")
    mix = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in moves and _reports(m, workload)]
    return Cell(workload, config, hedge, mix, e2e, layer)


def reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(metrics: List[dict], run) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
