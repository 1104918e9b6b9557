"""Render the dry-run's JSON (``results/roofline_torch.json``) as a markdown
table, the JAX package's ``launch/report.py``."""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def fmt_table(cells, variant=""):
    rows = []
    header = (
        "| arch | shape | mesh | compile | mem/dev | compute | memory | "
        "collective | dominant | useful |"
    )
    rows.append(header)
    rows.append("|" + "---|" * 10)
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    sel = [c for c in cells if c.get("variant", "") == variant]
    sel.sort(key=lambda c: (c["arch"], order.get(c["shape"], 9), c["mesh"]))
    for c in sel:
        if c["status"] == "skipped":
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | — | — | — | — | — "
                f"| N/A | {c['note'][:42]} |"
            )
            continue
        if c["status"] == "error":
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | ERR | — | — | — | — "
                f"| — | {c['note'][:42]} |"
            )
            continue
        mem = c["memory"]["per_device_total"] / 2**30
        if "terms_s" in c:
            t = c["terms_s"]
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | {c['compile_s']:.0f}s "
                f"| {mem:.1f}G | {t['compute_s']*1e3:.0f}ms | {t['memory_s']*1e3:.0f}ms "
                f"| {t['collective_s']*1e3:.0f}ms | {c['dominant'].split('_')[0]} "
                f"| {c['model_flops_over_hlo']*100:.0f}% |"
            )
        else:
            census = ",".join(f"{k.split('-')[-1]}:{v}" for k, v in
                              sorted(c["collective_census"].items()))
            rows.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | {c['compile_s']:.0f}s "
                f"| {mem:.1f}G | — | — | — | compiled | {census[:40]} |"
            )
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="results/roofline_torch.json")
    ap.add_argument("--variant", default="")
    args = ap.parse_args()
    cells = json.loads(Path(args.json).read_text())["cells"]
    print(fmt_table(cells, args.variant))


if __name__ == "__main__":
    main()
