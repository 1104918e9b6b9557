"""Every cell's files load, and BENCHMARK.json keeps to its rules."""
import json
import re
from pathlib import Path

import pytest

from perfbench import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    c = cells.load(ROOT, cell)
    assert c.config["model"]["n_layers"] >= 1 and c.mix["arrivals"]["rate_rps"] > 0
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.reader(m["name"]))


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs)) and all(w["chips"] == 1 for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200


def test_rooflines_and_mfu_names():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"
    assert any("mfu" in m["name"].split("_") for m in BENCH["per_layer"])
