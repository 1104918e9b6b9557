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

Overload hardening: ``--max-pending``/``--max-chunk`` put a bounded
admission queue in front of the loop and ``--overload-policy`` picks what
happens at capacity (``block``, ``shed``, ``degrade``).  ``--tenants
'interactive:4,batch:1:batch:32'`` splits admission into per-tenant lanes
and drives a tagged two-lane traffic mix; ``--controller`` retunes
``--max-pending`` and the shed margin each tick (clamped AIMD with
hysteresis).

Replicas: ``--replicas N`` serves the remote tiers through a
``ClusterBackend`` pool (``--router``, ``--replica-spec`` for a
heterogeneous pool, ``--shard-zoo`` for disjoint zoo slices) with circuit
breakers; ``--transport inline`` gives each replica the transport's fault
surface in this process (the replicas share the same weight tensors), and
``--transport process`` puts each replica's ``JitBackend`` in a spawned
worker on its own CUDA context — a real failure domain.  In that mode this
process runs no remote tier: the tiers' weights are built on the host
(seeded there, so they differ from weights built on the card) and each
worker places its copy on its card.  ``--kill-replica-at`` /
``--rejoin-replica-at`` schedule a kill and a rejoin on the loop clock.
``--trace-out`` / ``--metrics-out`` turn tracing on and write the Chrome
trace, the JSONL spans and the Prometheus text.

Everything runs on the CUDA device (``--device cuda``, the default) through
the port's hand-written kernels; ``--device cpu`` runs the plain PyTorch
versions.  The flags are the JAX driver's, plus ``--device``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 50 --sla 2000
  PYTHONPATH=src python -m repro_torch.launch.serve --continuous --stream
  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 --transport process
"""
from __future__ import annotations

import argparse
import functools
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
from repro_torch.serving.backend import JitBackend, OnDeviceBackend
from repro_torch.serving.cluster import (
    ROUTERS,
    ClusterBackend,
    parse_replica_specs,
    shard_slices,
)
from repro_torch.serving.controller import AdmissionController, ControllerConfig
from repro_torch.serving.engine import ServingEngine, Variant
from repro_torch.serving.loadgen import (
    BurstyArrivals,
    MixedTenantArrivals,
    OverloadArrivals,
    PoissonArrivals,
    make_trace,
)
from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig
from repro_torch.serving.tenancy import parse_tenant_spec
from repro_torch.serving.transport import ProcessTransportBackend

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


def _jit_backend_factory(max_len: int, device="cuda") -> JitBackend:
    """Top-level (picklable) backend factory for the process transport: the
    worker builds its ``JitBackend`` on ``device``, resolved in the worker
    (``cuda`` on a machine without a GPU fails the worker's construction)."""
    return JitBackend(max_len, device=device)


def _export_observability(obs, trace_out, metrics_out) -> None:
    """Write the run's trace/metrics exports (no-op with tracing off): the
    Chrome trace at ``trace_out`` with ``.spans.jsonl`` and
    ``.metrics.json`` (the registry's snapshot) beside it, and the
    Prometheus text at ``metrics_out``.  With ``metrics_out`` =
    ``trace_out + ".prom"`` the four files are what
    ``benchmarks/validate_obs.py trace_out`` checks."""
    if obs is None:
        return
    from repro_torch.observability import (
        request_conservation,
        write_chrome_trace,
        write_jsonl_spans,
        write_metrics_snapshot,
        write_prometheus,
    )

    if trace_out is not None:
        write_chrome_trace(trace_out, obs.tracer)
        write_jsonl_spans(trace_out + ".spans.jsonl", obs.tracer)
        write_metrics_snapshot(trace_out + ".metrics.json", obs.metrics)
        audit = request_conservation(obs.tracer)
        balanced = (
            audit["open"] == 0
            and audit["extra_terminals"] == 0
            and audit["submitted"]
            == audit["resolved"] + audit["rejected"] + audit["cancelled"]
        )
        print(
            f"trace             : {len(obs.tracer)} spans -> {trace_out} "
            f"(conservation {'ok' if balanced else f'VIOLATED {audit}'})"
        )
    if metrics_out is not None:
        write_prometheus(metrics_out, obs.metrics)
        print(f"metrics           : prometheus text -> {metrics_out}")


def build_engine(
    max_len: int, seed: int = 0, measured_hedge: bool = True,
    dispatch: str = "async", device="cuda",
    configs: Optional[Sequence[Tuple[str, ModelConfig, float]]] = None,
    geometry: Optional[ServingGeometry] = None,
    replicas: int = 1, router: str = "round_robin", shard_zoo: bool = False,
    transport: str = "none", specs=None,
) -> ServingEngine:
    """The serving engine: the remote tiers (``configs``, default
    :func:`tier_configs`) with seeded weights, plus the zoo's hedge tier
    unless ``measured_hedge`` is off.  The remote tier is a ``JitBackend``,
    with ``geometry`` a ``ContinuousBatchingBackend`` sized by it, and with
    ``replicas > 1`` (or ``shard_zoo`` / a ``transport``) a
    ``ClusterBackend`` pool of ``JitBackend`` replicas.  In-process
    replicas share the same ``Variant`` objects (one copy of the weights);
    with ``transport="process"`` the weights are built on the host and each
    worker places its copy on its own device."""
    dev = resolve_device(device)
    hedge = (
        OnDeviceBackend.from_zoo(max_len=max_len, seed=seed, device=dev)
        if measured_hedge
        else None
    )
    tiers = tier_configs() if configs is None else configs
    # With --replicas > 1 (or --shard-zoo / --transport) the remote tier
    # becomes a replicated cluster behind the same execution protocol; the
    # hedge tier stays the device-side singleton outside the pool.
    backend = None
    if geometry is None and (replicas > 1 or shard_zoo or transport != "none"):
        slices = shard_slices([t[0] for t in tiers], replicas) if shard_zoo else None

        def make_replica():
            if transport == "none":
                return JitBackend(max_len, device=dev)
            # inline: same process, but with the transport's fault surface
            # (kill/inject); process: a real spawned worker per replica.
            return ProcessTransportBackend(
                functools.partial(_jit_backend_factory, max_len, str(dev)),
                mode=transport, max_len=max_len,
            )

        backend = ClusterBackend(
            [make_replica() for _ in range(replicas)],
            router=router, slices=slices, seed=seed, specs=specs,
        )
    engine = ServingEngine(
        max_len=max_len, backend=backend, hedge_backend=hedge, dispatch=dispatch,
        device=dev, continuous=geometry is not None, geometry=geometry,
    )
    # This process runs no remote tier behind a process transport: the
    # weights stay on the host, and each worker places its own copy.
    weights_on = torch.device("cpu") if transport == "process" else dev
    for name, cfg, quality in tiers:
        params = T.init_params(cfg, torch.Generator().manual_seed(seed), weights_on)
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
                    "loop clock (0: uncoupled windows-only clock); makes "
                    "overload build real queue wait")
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="remote-tier replica count: >1 serves through a "
                    "ClusterBackend pool with load-aware routing")
    ap.add_argument("--router", default="round_robin",
                    choices=list(ROUTERS),
                    help="cluster routing policy (with --replicas > 1): "
                    "round_robin, least_inflight (join-shortest-queue), "
                    "power_of_two (2 random replicas, pick by live "
                    "latency EWMA)")
    ap.add_argument("--replica-spec", default=None, metavar="SPEC",
                    help="heterogeneous replica pool (with --replicas > 1): "
                    "'weight[:max_concurrency[:service_scale]],...' — one "
                    "entry per replica, empty fields keep the default, e.g. "
                    "'2:8:0.5,1' (a double-weight box capped at 8 inflight "
                    "rows that runs 2x fast, next to a stock one).  Routers "
                    "normalize queue depth by weight and treat "
                    "max_concurrency as a soft routing cap")
    ap.add_argument("--controller", action="store_true",
                    help="close the loop on admission: an "
                    "AdmissionController reads each tick's queue-wait / "
                    "shed / service signals and retunes --max-pending and "
                    "the shed margin via a clamped AIMD law with "
                    "hysteresis (requires --max-pending; without this "
                    "flag the static config is served unchanged)")
    ap.add_argument("--controller-target-frac", type=float, default=0.2,
                    metavar="FRAC",
                    help="controller setpoint: target queue wait as a "
                    "fraction of --sla (default 0.2)")
    ap.add_argument("--shard-zoo", action="store_true",
                    help="shard the model zoo across replicas (disjoint "
                    "slices, one backend per slice) instead of full "
                    "replication; selection is constrained to hosted "
                    "variants and routing respects placement")
    ap.add_argument("--transport", default="none",
                    choices=["none", "inline", "process"],
                    help="replica transport: none (in-process backends, "
                    "the default), inline (in-process with the transport's "
                    "kill/fault surface), process (each replica's backend "
                    "in a spawned worker with its own CUDA context — a "
                    "real failure domain; weights cross as host bytes)")
    ap.add_argument("--kill-replica-at", type=float, default=None,
                    metavar="MS",
                    help="fault injection: kill one replica at this "
                    "loop-clock time; its breaker trips permanently, "
                    "in-flight rows requeue/fail over, routing continues "
                    "on the survivors (requires --replicas > 1 unless you "
                    "want the whole chunk degraded on-device)")
    ap.add_argument("--kill-replica", type=int, default=0, metavar="ID",
                    help="which replica --kill-replica-at kills")
    ap.add_argument("--rejoin-replica-at", type=float, default=None,
                    metavar="MS",
                    help="bring the killed replica back at this loop-clock "
                    "time (transport restart + breaker reset)")
    ap.add_argument("--tenants", default=None, metavar="SPEC",
                    help="multi-tenant QoS lanes: "
                    "'name[:weight[:class[:max_pending]]],...' (class is "
                    "interactive|batch), e.g. "
                    "'interactive:4,batch:1:batch:32'.  Admission drains "
                    "the lanes deficit-weighted-fair with strict "
                    "interactive-over-batch priority; the trace becomes a "
                    "tagged two-lane mix (interactive at --rate, a batch "
                    "flood at 4x --rate, or --overload x when higher)")
    ap.add_argument("--stream", action="store_true",
                    help="demonstrate token streaming before the trace: "
                    "submit one request and print each StreamChunk as the "
                    "continuous tier's decode steps emit it (requires "
                    "--continuous)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable tracing and write a Chrome trace_event "
                    "JSON timeline (chrome://tracing / Perfetto) of the "
                    "whole run to PATH; PATH.spans.jsonl gets the raw span "
                    "sink and PATH.metrics.json the metrics snapshot "
                    "(without this flag — and --metrics-out — the stack "
                    "runs untraced)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable metrics and write a Prometheus-style text "
                    "exposition of every counter/gauge/histogram to PATH")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the tiers run: cuda (the hand-written "
                    "kernels, the default) or cpu (the plain PyTorch "
                    "versions, only when asked for)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tenants = None
    if args.tenants:
        try:
            tenants = parse_tenant_spec(args.tenants)
        except ValueError as e:
            ap.error(f"--tenants: {e}")
    tenant_bounded = any(t.max_pending is not None for t in tenants or ())
    if (
        args.overload_policy != "unbounded"
        and args.max_pending is None
        and not tenant_bounded
    ):
        ap.error(
            f"--overload-policy {args.overload_policy} requires "
            "--max-pending (the capacity whose overflow it governs) or a "
            "--tenants spec with a per-lane max_pending"
        )
    if args.stream and not args.continuous:
        ap.error("--stream requires --continuous (the streaming decode tier)")

    if args.replicas < 1:
        ap.error("--replicas must be >= 1")

    specs = None
    if args.replica_spec is not None:
        if args.replicas <= 1:
            ap.error("--replica-spec needs a pool (--replicas > 1)")
        try:
            specs = parse_replica_specs(args.replica_spec, args.replicas)
        except ValueError as e:
            ap.error(f"--replica-spec: {e}")

    controller = None
    if args.controller:
        if args.max_pending is None and not tenant_bounded:
            ap.error(
                "--controller retunes a bounded queue; give it "
                "--max-pending (the knob it drives)"
            )
        try:
            controller = AdmissionController(
                ControllerConfig(target_wait_frac=args.controller_target_frac)
            )
        except ValueError as e:
            ap.error(f"--controller-target-frac: {e}")

    geometry = None
    dispatch = args.dispatch
    if args.continuous:
        if args.replicas > 1 or args.shard_zoo or args.transport != "none":
            ap.error(
                "--continuous replaces the remote tier with the "
                "continuous-batching backend; it cannot combine with "
                "--replicas/--shard-zoo/--transport"
            )
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
    clustered = args.replicas > 1 or args.shard_zoo or args.transport != "none"
    if args.kill_replica_at is not None and not clustered:
        ap.error("--kill-replica-at needs a cluster (--replicas/--transport)")
    device = resolve_device(args.device)

    measured = args.hedge == "measured"
    print(f"building + profiling tiers on {device} (real execution)...")
    engine = build_engine(
        max_len=args.prompt + args.gen + 8, seed=args.seed,
        measured_hedge=measured, dispatch=dispatch, device=device,
        geometry=geometry, replicas=args.replicas, router=args.router,
        shard_zoo=args.shard_zoo, transport=args.transport, specs=specs,
    )
    cluster = engine.backend if isinstance(engine.backend, ClusterBackend) else None
    if cluster is not None:
        print(
            f"cluster: {cluster.n_replicas} replicas, router={args.router}, "
            f"transport={args.transport}"
        )
        for snap in cluster.snapshot():
            hw = ""
            if specs is not None:
                cap = (
                    "inf" if snap.max_concurrency is None
                    else snap.max_concurrency
                )
                hw = (
                    f" weight={snap.weight:g} cap={cap} "
                    f"scale={snap.service_scale:g}"
                )
            print(f"  replica {snap.replica_id}: hosts {list(snap.hosts)}{hw}")
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
    if tenants is not None:
        # Tagged two-lane mix: the first interactive-class tenant gets a
        # Poisson lane at the base rate; the first batch-class tenant (or
        # the last tenant) floods at 4x (or the --overload factor).
        interactive = next(
            (t.name for t in tenants if t.priority == "interactive"),
            tenants[0].name,
        )
        batch = next(
            (t.name for t in tenants if t.priority == "batch"),
            tenants[-1].name,
        )
        arrivals = MixedTenantArrivals(
            interactive_rps=args.rate,
            batch_rps=args.rate * max(args.overload, 4.0),
            interactive_tenant=interactive,
            batch_tenant=batch,
        )
    elif args.overload > 0:
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
        tenants=tenants,
    )
    if args.stream:
        stream_demo(engine, sched, prompts[0], args.gen, args.sla)

    observability = None
    if args.trace_out is not None or args.metrics_out is not None:
        from repro_torch.observability import Observability

        observability = Observability()

    loop = engine.make_loop(
        sched, admission=admission, controller=controller,
        observability=observability,
    )
    # Server service time covers the remote-scheduled rows only; replicas
    # serve in parallel, so a tick's makespan is the busiest replica's rows.
    service_model = (
        (lambda res: args.service_ms * res.stats.max_replica_rows)
        if args.service_ms > 0
        else None
    )

    fault = {"killed": False, "rejoined": False}

    def drive_faults(tick_ms):
        # Loop-clock fault schedule: kill (and optionally rejoin) between
        # ticks, exactly where an operator action would land.
        if (
            args.kill_replica_at is not None
            and not fault["killed"]
            and tick_ms >= args.kill_replica_at
        ):
            cluster.kill_replica(args.kill_replica, reason="operator kill")
            fault["killed"] = True
            print(f"tick t={tick_ms:7.0f}ms !! killed replica {args.kill_replica}")
        if (
            args.rejoin_replica_at is not None
            and fault["killed"]
            and not fault["rejoined"]
            and tick_ms >= args.rejoin_replica_at
        ):
            cluster.rejoin(args.kill_replica)
            fault["rejoined"] = True
            print(f"tick t={tick_ms:7.0f}ms !! rejoined replica {args.kill_replica}")

    def on_tick(tick_ms, res):
        if cluster is not None:
            drive_faults(tick_ms)
        if res.stats.n_lost:
            print(
                f"tick t={tick_ms:7.0f}ms !! lost {res.stats.n_lost} rows "
                f"to a failed replica ({res.stats.n_requeued} requeued, "
                f"{res.stats.n_lost - res.stats.n_requeued} hedge-failover)"
            )
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
    try:
        completions, metrics = loop.drain_trace(
            trace, args.window,
            tokens_for=lambda i: prompts[i], n_steps=args.gen, on_tick=on_tick,
            service_model=service_model,
        )
    finally:
        if cluster is not None:  # stop process workers (a no-op otherwise)
            for r in cluster.replicas:
                close = getattr(r.backend, "close", None)
                if close is not None:
                    close()
    if not completions:
        print(
            f"\nserved 0 of {args.requests} requests (policy={policy}, "
            f"shed_rate={metrics.shed_rate*100:.1f}%, "
            f"goodput={metrics.goodput*100:.1f}%) — every request was "
            "rejected by admission; loosen --sla or --max-pending"
        )
        _export_observability(observability, args.trace_out, args.metrics_out)
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
    controller_note = ""
    if controller is not None:
        cfg_now = loop.admission.cfg
        controller_note = (
            f"controller        : retunes={controller.n_retunes} "
            f"final max_pending={cfg_now.max_pending} "
            f"shed_headroom={cfg_now.shed_headroom_ms:.0f}ms "
            f"(setpoint {args.controller_target_frac:.2f}x sla)\n"
        )
    tenancy_note = ""
    if metrics.tenant_rows:
        lanes = "\n".join(
            f"  lane {name:12s} [{row.priority:11s}] "
            f"share={row.share*100:5.1f}% shed={row.shed_rate*100:5.1f}% "
            f"goodput={row.goodput*100:5.1f}% p99={row.p99_latency_ms:7.1f}ms"
            for name, row in sorted(metrics.tenant_rows.items())
        )
        p99s = " ".join(
            f"{cls}={v:.0f}ms" for cls, v in sorted(metrics.priority_p99.items())
        )
        tenancy_note = f"tenancy           : class p99 {p99s}\n{lanes}\n"
    cluster_note = ""
    if metrics.replica_rows:
        shares = " ".join(
            f"r{rid}={row.share*100:.0f}%(util={row.utilization:.2f})"
            for rid, row in sorted(metrics.replica_rows.items())
        )
        cluster_note = (
            f"cluster           : {args.replicas} replicas "
            f"router={args.router} served {shares}\n"
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
        f"{controller_note}"
        f"{tenancy_note}"
        f"{cluster_note}"
        f"queue wait        : mean {waits.mean():.0f}ms  max {waits.max():.0f}ms  "
        f"(time-to-schedule mean {metrics.mean_time_to_schedule_ms:.0f}ms)\n"
        f"p50/p99 latency   : {quantile(lats, 50):.0f}/{quantile(lats, 99):.0f} ms"
    )
    if args.continuous:
        print(continuous_summary(engine.backend, completions, compiles_after_warmup))
    _export_observability(observability, args.trace_out, args.metrics_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
