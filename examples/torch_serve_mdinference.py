"""End-to-end serving on the PyTorch port: the async request-lifecycle API,
for real, on ``--device`` (``cuda`` by default).

Part 1 drives the client surface by hand: an ``InferenceClient`` over a
``ServingLoop`` wired to two real execution tiers (remote ``JitBackend``
variants and the ``OnDeviceBackend`` duplicate).  ``submit`` returns an
``InferenceFuture`` at once (QUEUED); a scheduling tick dispatches the
remote batch and the hedged duplicate concurrently, and ``result()``
returns the resolved ``CompletedRequest`` with the tier that won the race.

Part 2 serves an open-loop Poisson trace through the same tick path
(``repro_torch.launch.serve``) over a 2-replica ``ClusterBackend`` pool
with least-in-flight routing.

Run:  PYTHONPATH=src python examples/torch_serve_mdinference.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.launch.serve import build_engine, main
from repro_torch.serving.client import InferenceClient
from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig

PROMPT, GEN = 16, 4


def client_demo(device):
    print("=== part 1: InferenceClient futures over a two-tier ServingLoop ===")
    engine = build_engine(max_len=PROMPT + GEN + 8, measured_hedge=True, device=device)
    registry = engine.measure_profiles(prompt_len=PROMPT, gen_tokens=GEN, trials=2)
    ondevice = engine.hedge_backend.measure_profile(prompt_len=PROMPT, gen_tokens=GEN, trials=2)
    loop = engine.make_loop(MDInferenceScheduler(registry, ondevice,
                                                 SchedulerConfig(t_sla_ms=2_000.0)))
    client = InferenceClient(loop)

    rng = np.random.default_rng(0)
    # Three requests: generous network, a tight per-request SLA, a cancel.
    f_ok = client.submit(rng.integers(0, 256, PROMPT), GEN, t_nw_est_ms=80.0)
    f_tight = client.submit(rng.integers(0, 256, PROMPT), GEN, sla=10.0, t_nw_est_ms=80.0)
    f_cancel = client.submit(rng.integers(0, 256, PROMPT), GEN, t_nw_est_ms=80.0)
    print(f"submitted: {f_ok.state.value}, {f_tight.state.value}, {f_cancel.state.value}")
    f_cancel.cancel()  # still QUEUED: freed before it occupies a batch slot

    done = f_ok.result()  # drives the loop: one tick serves the chunk
    print(f"f_ok     -> {done.model_name:10s} race={done.race_resolution:12s} "
          f"latency={done.latency_ms:7.1f}ms tokens={done.tokens.tolist()}")
    tight = f_tight.result()  # 10 ms SLA < network: the duplicate answered
    print(f"f_tight  -> {tight.model_name:10s} race={tight.race_resolution:12s} "
          f"latency={tight.latency_ms:7.1f}ms (10ms SLA)")
    print(f"f_cancel -> cancelled={f_cancel.cancelled()}")
    print(f"lifecycle of f_ok: submitted@{f_ok.submitted_ms:.0f}ms "
          f"scheduled@{f_ok.scheduled_ms:.0f}ms "
          f"tiers dispatched {sorted(f_ok.tier_dispatch_wall_ms)} "
          f"resolved@{f_ok.resolved_ms:.0f}ms\n")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = ap.parse_args().device
    client_demo(device)
    print("=== part 2: open-loop trace through a 2-replica cluster ===")
    raise SystemExit(main(["--requests", "30", "--sla", "2500", "--gen", "8", "--rate", "20",
                           "--hedge", "measured", "--dispatch", "async", "--replicas", "2",
                           "--router", "least_inflight", "--device", device]))
