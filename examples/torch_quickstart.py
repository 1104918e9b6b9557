"""Quickstart on the PyTorch port: the MDInference algorithm in 40 lines.

The selection runs on the device (``--device``, ``cuda`` by default; the
CPU only when asked for), the rest on the host, as ``examples/quickstart.py``
does with the JAX package.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.mdinference_zoo import paper_zoo
from repro_torch.core.duplication import DEFAULT_ON_DEVICE
from repro_torch.core.network import FixedCVNetwork
from repro_torch.core.selection import compute_budget, select_ref
from repro_torch.core.simulator import SimConfig, run_simulation


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # --- one request through the three-stage selection ---------------------
    zoo = paper_zoo()  # Table III: 11 functionally-equivalent image classifiers
    t_sla, t_nw = 250.0, 100.0  # SLA and estimated network time (ms)
    budget = compute_budget(t_sla, t_nw)
    sel = select_ref(zoo, budget, np.random.default_rng(0))
    print(f"budget {budget:.0f}ms -> base={zoo[sel.base_index].name!r} "
          f"selected={zoo[sel.index].name!r} (M_E size {len(sel.exploration_set)})")

    # --- 10,000 simulated requests, with and without duplication -----------
    net = FixedCVNetwork(mean_ms=100.0, cv=0.5)  # the paper's 100 +- 50 ms network
    for dup in (False, True):
        m = run_simulation(SimConfig(registry=zoo, algorithm="mdinference", t_sla_ms=t_sla,
                                     n_requests=10_000, network=net, duplication=dup,
                                     ondevice=DEFAULT_ON_DEVICE, seed=0),
                           device=args.device).metrics
        print(f"duplication={dup!s:5s}  {m.row()}")

    # Against the static baselines of the paper's Table IV.
    for alg in ("static_latency", "static_accuracy", "static_greedy"):
        m = run_simulation(SimConfig(registry=zoo, algorithm=alg, t_sla_ms=t_sla,
                                     n_requests=10_000, network=net, duplication=True, seed=0),
                           device=args.device).metrics
        print(f"{alg:16s}  {m.row()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
