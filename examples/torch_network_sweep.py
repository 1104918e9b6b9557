"""Network-adaptiveness demo on the PyTorch port (paper Fig 4/5): sweep CV,
watch MDInference trade model diversity for SLA attainment; then the
measured traces through the batched online scheduler.  The simulator's
selection runs on ``--device`` (``cuda`` by default).

Run:  PYTHONPATH=src python examples/torch_network_sweep.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.mdinference_zoo import paper_zoo
from repro_torch.core.duplication import DEFAULT_ON_DEVICE
from repro_torch.core.network import NAMED_TRACES, FixedCVNetwork
from repro_torch.core.simulator import SimConfig, run_simulation
from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    zoo = paper_zoo()
    print(f"{'CV':>4s}  {'SLA=100ms':^34s}  {'SLA=250ms':^34s}")
    print(f"{'':4s}  {'acc':>7s} {'attain':>7s} {'models':>7s}     "
          f"{'acc':>7s} {'attain':>7s} {'models':>7s}")
    for cv in (0.0, 0.2, 0.4, 0.6, 0.74, 1.0):
        cols = []
        for sla in (100.0, 250.0):
            m = run_simulation(SimConfig(registry=zoo, algorithm="mdinference", t_sla_ms=sla,
                                         n_requests=10_000, network=FixedCVNetwork(100.0, cv),
                                         seed=1), device=args.device).metrics
            diverse = sum(1 for v in m.model_usage.values() if v > 0.01)
            cols.append(f"{m.aggregate_accuracy:7.2f} {m.sla_attainment*100:6.1f}% {diverse:7d}")
        print(f"{cv:4.2f}  {cols[0]}     {cols[1]}")

    # Measured-trace sweep through the batched online scheduler, hedged
    # with the paper's on-device vision model.
    print(f"\n{'trace':>12s}  {'acc':>7s} {'attain':>7s} {'ondev':>7s}")
    for name, factory in NAMED_TRACES.items():
        t_nw = factory().sample(np.random.default_rng(7), 10_000)
        sched = MDInferenceScheduler(zoo, DEFAULT_ON_DEVICE,
                                     SchedulerConfig(t_sla_ms=250.0, seed=7, chunk_size=1024))
        m = sched.run_trace(t_nw)
        print(f"{name:>12s}  {m.aggregate_accuracy:7.2f} "
              f"{m.sla_attainment*100:6.1f}% {m.ondevice_reliance*100:6.2f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
