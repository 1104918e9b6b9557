"""End-to-end serving driver: MDInference over real model variants.

The port of ``repro.launch.serve``'s default path.  Builds N
functionally-equivalent LM tiers (reduced configs at different
widths/depths), measures their real latency profiles (Table III
methodology), then serves an open-loop request stream: arrivals come from
a Poisson (or bursty, or overload) load generator over a network model,
each scheduling window is decided in one batched scheduler call, requests
that picked the same tier execute as one real ``generate`` batch, and the
hedge tier bounds every response at the SLA.

Two-tier execution: the remote tiers run on a ``JitBackend``; the hedge
duplicate runs *for real* on an ``OnDeviceBackend`` (the zoo's tiny
hedge-xs variant), so duplication resolves on measured wall time.
``--hedge sampled`` falls back to the profile-sampled simulation of the
duplicate.  ``--dispatch async`` (the default) runs the remote batch and
the duplicate concurrently; ``--dispatch sync`` serializes them.

``--continuous`` serves the remote tiers on a ``ContinuousBatchingBackend``:
fixed-shape prefill/graft/decode entry points (``--bs-ladder`` prefill
batch sizes) over a block-paged KV pool; requests join the persistent
decode batch at step boundaries, and ``--dispatch`` becomes ``stepped``
(the tier's decode clock) unless ``sync`` is asked for.  ``--stream``
(with ``--continuous``) first streams one request token by token through
``InferenceClient``.

Everything runs on the CUDA device (``--device cuda``, the default) through
the port's hand-written kernels; ``--device cpu`` runs the plain PyTorch
versions.  The JAX driver's cluster, transport, tenancy, controller and
tracing flags are not ported yet (ROADMAP.md).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 50 --sla 2000
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous --stream
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.archs import reduced
from repro_torch.configs.mdinference_zoo import ServingGeometry
from repro_torch.core.network import NAMED_TRACES, LognormalNetwork
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.observability.quantile import quantile
from repro_torch.serving.admission import OVERLOAD_POLICIES, AdmissionConfig
from repro_torch.serving.backend import OnDeviceBackend
from repro_torch.serving.engine import ServingEngine, Variant
from repro_torch.serving.loadgen import (
    BurstyArrivals,
    OverloadArrivals,
    PoissonArrivals,
    make_trace,
)
from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig

TIERS = (
    # (name, arch family, width, layers, quality-proxy)
    ("tier-s", "gemma-2b", 64, 2, 42.0),
    ("tier-m", "llama3-8b", 128, 4, 68.0),
    ("tier-l", "qwen3-14b", 256, 6, 77.0),
)


def tier_configs() -> Tuple[Tuple[str, ModelConfig, float], ...]:
    """``(name, config, quality)`` of each remote tier, reduced as served."""
    return tuple(
        (
            name,
            reduced(arch, d_model=width, n_layers=n_layers, n_heads=4,
                    n_kv_heads=2, head_dim=width // 4),
            quality,
        )
        for name, arch, width, n_layers, quality in TIERS
    )


def build_engine(
    max_len: int, seed: int = 0, measured_hedge: bool = True,
    dispatch: str = "async", device="cuda",
    configs: Optional[Sequence[Tuple[str, ModelConfig, float]]] = None,
    geometry: Optional[ServingGeometry] = None,
) -> ServingEngine:
    """The serving engine: the remote tiers (``configs``, default
    :func:`tier_configs`) with seeded weights, plus the zoo's hedge tier
    unless ``measured_hedge`` is off.  The remote tier is a ``JitBackend``,
    or with ``geometry`` a ``ContinuousBatchingBackend`` sized by it."""
    dev = resolve_device(device)
    hedge = (
        OnDeviceBackend.from_zoo(max_len=max_len, seed=seed, device=dev)
        if measured_hedge
        else None
    )
    engine = ServingEngine(
        max_len=max_len, hedge_backend=hedge, dispatch=dispatch, device=dev,
        continuous=geometry is not None, geometry=geometry,
    )
    for name, cfg, quality in (tier_configs() if configs is None else configs):
        params = T.init_params(cfg, torch.Generator().manual_seed(seed), dev)
        engine.register(Variant(name, cfg, params, quality))
    return engine


def prewarm_hedge(engine: ServingEngine, prompt: int, gen: int, n_slots: int) -> None:
    """Run the hedge tier once at every power-of-two tick shape up to
    ``n_slots``: its first run at a shape otherwise burns real SLA budget
    mid-race and spuriously releases hedged slots."""
    hb = engine.hedge_backend
    N = 1
    while N <= n_slots:
        hb.run_batch(hb.hedge_name, np.zeros((N, prompt), np.int32), gen)
        N *= 2


def stream_demo(engine: ServingEngine, sched, prompt: np.ndarray, gen: int, sla: float):
    """One request through its own loop (its completion stays out of the
    trace's metrics), printed chunk by chunk as the decode steps emit
    tokens.  Returns ``(chunks, resolved-at-yield flags, completed request)``."""
    from repro_torch.serving.client import InferenceClient

    fut = InferenceClient(engine.make_loop(sched)).submit(prompt, gen, sla=sla)
    print("streaming demo: tokens as the decode steps emit them")
    chunks, done_at_yield = [], []
    for chunk in fut.stream():
        chunks.append(chunk)
        done_at_yield.append(fut.done())
        print(f"  chunk[{chunk.index}] token={chunk.token:5d} "
              f"+{chunk.wall_ms - chunks[0].wall_ms:7.2f}ms")
    c = fut.result()
    ttft = "n/a" if c.ttft_ms is None else f"{c.ttft_ms:.2f}ms"
    print(f"  resolved on {c.model_name}: {len(chunks)} chunks ttft={ttft} "
          f"exec={c.exec_ms:.1f}ms")
    return chunks, done_at_yield, c


def continuous_summary(backend, completions, compiles_after_warmup: int) -> str:
    """The ``continuous tier`` summary line; checks slot/page conservation."""
    growth = backend.compile_count - compiles_after_warmup
    ttfts = np.asarray([c.ttft_ms for c in completions if c.ttft_ms is not None])
    ttft_note = (
        f"ttft p50/p99={quantile(ttfts, 50):.1f}/{quantile(ttfts, 99):.1f}ms "
        if ttfts.size else ""
    )
    backend.check_conservation()
    return (f"continuous tier   : joined={backend.joined_total} "
            f"recycled={backend.recycled_total} {ttft_note}"
            f"post-warmup recompiles={growth} (conservation ok)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--sla", type=float, default=2000.0, help="ms")
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument(
        "--network", default="lognormal",
        choices=["lognormal", *NAMED_TRACES],
        help="network-time model for the trace",
    )
    ap.add_argument("--net-mean", type=float, default=300.0)
    ap.add_argument("--net-cv", type=float, default=0.6)
    ap.add_argument("--rate", type=float, default=20.0, help="arrival rate rps")
    ap.add_argument("--bursty", action="store_true", help="MMPP bursts")
    ap.add_argument("--overload", type=float, default=0.0, metavar="FACTOR",
                    help="sustained overload phase at FACTOR x the base "
                    "rate over the middle half of the stream")
    ap.add_argument("--window", type=float, default=200.0,
                    help="scheduling-tick window (ms)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="bounded admission queue capacity (default: "
                    "unbounded)")
    ap.add_argument("--max-chunk", type=int, default=None,
                    help="per-tick scheduling cap; leftovers stay queued "
                    "across ticks")
    ap.add_argument("--overload-policy", default="unbounded",
                    choices=list(OVERLOAD_POLICIES),
                    help="what happens at max-pending capacity: block "
                    "(client backpressure), shed (deadline-aware REJECTED), "
                    "degrade (on-device tier alone); requires --max-pending")
    ap.add_argument("--service-ms", type=float, default=0.0,
                    help="per-request service-time model coupled into the "
                    "loop clock (0: uncoupled windows-only clock)")
    ap.add_argument(
        "--hedge", default="measured", choices=["measured", "sampled"],
        help="resolve duplicates on real hedge-tier wall time (measured) "
        "or on-device profile samples (sampled)",
    )
    ap.add_argument(
        "--dispatch", default="async", choices=["async", "sync", "stepped"],
        help="dispatch the tiers' batches concurrently (async), "
        "serialized (sync, the deterministic fallback), or stepped "
        "(continuous-batching decode clock; implied by --continuous)",
    )
    ap.add_argument("--continuous", action="store_true",
                    help="serve the remote tier with cross-tick continuous "
                    "batching: fixed-shape prefill/decode entry points (no "
                    "new shapes after warmup) over a block-paged slot "
                    "cache; requests join the persistent decode batch at "
                    "step boundaries and slots recycle on early resolution")
    ap.add_argument("--bs-ladder", default="1,2,4,8", metavar="N,N,...",
                    help="prefill batch-size ladder for --continuous: "
                    "sorted powers of two; submissions decompose onto "
                    "these fixed shapes (default 1,2,4,8)")
    ap.add_argument("--stream", action="store_true",
                    help="demonstrate token streaming before the trace: "
                    "submit one request and print each StreamChunk as the "
                    "continuous tier's decode steps emit it (requires "
                    "--continuous)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the tiers run: cuda (the hand-written "
                    "kernels, the default) or cpu (the plain PyTorch "
                    "versions, only when asked for)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.overload_policy != "unbounded" and args.max_pending is None:
        ap.error(
            f"--overload-policy {args.overload_policy} requires "
            "--max-pending (the capacity whose overflow it governs)"
        )
    if args.stream and not args.continuous:
        ap.error("--stream requires --continuous (the streaming decode tier)")
    geometry = None
    dispatch = args.dispatch
    if args.continuous:
        try:
            ladder = tuple(int(x) for x in args.bs_ladder.split(","))
        except ValueError:
            ap.error(f"--bs-ladder must be comma-separated ints, got {args.bs_ladder!r}")
        page = 8
        try:
            geometry = ServingGeometry(
                max_len=args.prompt + args.gen + 8,
                prompt_width=-(-args.prompt // page) * page,  # whole pages
                bs_ladder=ladder,
                n_slots=max(ladder),
                page_size=page,
                max_steps=args.gen,
            )
        except ValueError as e:
            ap.error(f"--bs-ladder: {e}")
        if dispatch == "async":
            dispatch = "stepped"  # the continuous tier's native clock
    device = resolve_device(args.device)

    measured = args.hedge == "measured"
    print(f"building + profiling tiers on {device} (real execution)...")
    engine = build_engine(
        max_len=args.prompt + args.gen + 8, seed=args.seed,
        measured_hedge=measured, dispatch=dispatch, device=device,
        geometry=geometry,
    )
    registry = engine.measure_profiles(
        prompt_len=args.prompt, gen_tokens=args.gen, trials=3, seed=args.seed
    )
    for p in registry:
        print(f"  {p.name:8s} quality={p.accuracy:5.1f} "
              f"mu={p.mu_ms:8.1f}ms sigma={p.sigma_ms:6.1f}ms")
    if measured:
        ondevice = engine.hedge_backend.measure_profile(
            prompt_len=args.prompt, gen_tokens=args.gen, trials=3,
            seed=args.seed,
        )
        print(f"  hedge tier (on-device, real): {ondevice.name} "
              f"quality={ondevice.accuracy:5.1f} mu={ondevice.mu_ms:8.1f}ms")
    else:
        ondevice = registry[int(np.argmin(registry.mu))]
        print(f"  hedge tier (sampled profile): {ondevice.name}")

    compiles_after_warmup = 0
    if args.continuous:
        engine.backend.warmup()
        compiles_after_warmup = engine.backend.compile_count
        print(f"continuous tier: ladder={geometry.bs_ladder} "
              f"n_slots={geometry.n_slots} page_size={geometry.page_size} "
              f"entry-point shapes={compiles_after_warmup} (fixed from here)")
        if measured:
            prewarm_hedge(engine, args.prompt, args.gen, geometry.n_slots)

    sched = MDInferenceScheduler(
        registry, ondevice, SchedulerConfig(t_sla_ms=args.sla, seed=args.seed)
    )
    if args.network == "lognormal":
        network = LognormalNetwork(args.net_mean, args.net_cv)
    else:
        network = NAMED_TRACES[args.network]()
    if args.overload > 0:
        arrivals = OverloadArrivals(args.rate, overload_factor=args.overload)
    elif args.bursty:
        arrivals = BurstyArrivals(args.rate)
    else:
        arrivals = PoissonArrivals(args.rate)
    trace = make_trace(args.requests, arrivals, network, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, 256, (args.requests, args.prompt))

    policy = args.overload_policy
    if policy == "unbounded" and args.max_pending is not None:
        policy = "block"  # a bound without a policy means backpressure
    admission = AdmissionConfig(
        max_pending=args.max_pending, max_chunk=args.max_chunk, policy=policy,
    )
    if args.stream:
        stream_demo(engine, sched, prompts[0], args.gen, args.sla)
    loop = engine.make_loop(sched, admission=admission)
    service_model = (
        (lambda res: args.service_ms * res.stats.max_replica_rows)
        if args.service_ms > 0
        else None
    )

    def on_tick(tick_ms, res):
        if not res.completions:
            print(f"tick t={tick_ms:7.0f}ms batch=  0 "
                  f"shed={res.stats.n_shed} (all rejected)")
            return
        c = res.completions[0]
        overlap = ""
        if res.stats.hedge_wall_ms is not None:
            saved = 1.0 - res.stats.span_wall_ms / res.stats.serialized_wall_ms
            overlap = f" overlap={saved*100:4.0f}%"
        overload = ""
        if res.stats.n_shed or res.stats.n_degraded:
            overload = f" shed={res.stats.n_shed} degraded={res.stats.n_degraded}"
        print(
            f"tick t={tick_ms:7.0f}ms batch={len(res.completions):3d} "
            f"models={{{', '.join(sorted({d.model_name for d in res.completions}))}}} "
            f"first: wait+nw={c.remote_ms - c.exec_ms:5.0f}ms -> {c.model_name:8s} "
            f"exec={c.exec_ms:7.1f}ms "
            f"{'remote' if c.used_remote else 'HEDGED'}{overlap}{overload}"
        )

    t_start = time.time()
    completions, metrics = loop.drain_trace(
        trace, args.window,
        tokens_for=lambda i: prompts[i], n_steps=args.gen, on_tick=on_tick,
        service_model=service_model,
    )
    if not completions:
        print(
            f"\nserved 0 of {args.requests} requests (policy={policy}, "
            f"shed_rate={metrics.shed_rate*100:.1f}%) — every request was "
            "rejected by admission; loosen --sla or --max-pending"
        )
        return 0
    lats = np.asarray([c.latency_ms for c in completions])
    waits = np.asarray([c.queue_wait_ms for c in completions])
    hedge_note = (
        f"measured on-device wall (live profile mu={sched.ondevice_mu:.1f}ms)"
        if measured
        else "profile-sampled simulation"
    )
    races = " ".join(
        f"{k}={v*100:.0f}%" for k, v in metrics.race_resolution.items()
    )
    admission_note = ""
    if metrics.n_rejected or policy != "unbounded":
        admission_note = (
            f"admission         : policy={policy} "
            f"max_pending={args.max_pending} shed_rate={metrics.shed_rate*100:.1f}% "
            f"goodput={metrics.goodput*100:.1f}%\n"
        )
    device_note = (
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    )
    print(
        f"\nserved {len(completions)} requests in {time.time()-t_start:.1f}s wall "
        f"(offered {trace.offered_rps:.1f} rps, dispatch={engine.dispatch}, "
        f"device={device_note})\n"
        f"aggregate quality : {metrics.aggregate_accuracy:.2f}\n"
        f"SLA attainment    : {np.mean(lats <= args.sla)*100:.1f}%  "
        f"(duplication bounds post-dispatch latency at the SLA; only queue "
        f"wait can breach it)\n"
        f"hedge reliance    : {metrics.ondevice_reliance*100:.1f}%  "
        f"[{hedge_note}]\n"
        f"race resolution   : {races}\n"
        f"{admission_note}"
        f"queue wait        : mean {waits.mean():.0f}ms  max {waits.max():.0f}ms  "
        f"(time-to-schedule mean {metrics.mean_time_to_schedule_ms:.0f}ms)\n"
        f"p50/p99 latency   : {quantile(lats, 50):.0f}/{quantile(lats, 99):.0f} ms"
    )
    if args.continuous:
        print(continuous_summary(engine.backend, completions, compiles_after_warmup))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
