"""The port's replica pool, breakers and transport against the JAX package, on the CPU.

Every scenario runs through both packages (``repro`` and ``repro_torch``)
and the outcomes are compared:

* router picks over a seeded sequence of EWMA / inflight / dispatched
  states and eligible sets; breaker state after each event of a seeded
  event stream; ``shard_slices`` placement, ``parse_replica_specs`` and
  ``hosted_mask`` / ``fan_out`` under trips and drains;
* a sync ``drain_trace`` over a pool of inline transports with fixed-wall
  stub backends (no sleep) with a kill, a rejoin and injected faults:
  replica ids, requeue counts, per-replica conservation;
* process workers (``tests/transport_stubs.py`` and
  ``torch_transport_stubs.py`` factories, so the children import neither
  torch nor jax): a kill mid-batch that surfaces
  ``ReplicaDied`` and a restart that re-registers, and the batch timeout
  that kills a hung worker;
* greedy tokens of a 2-replica pool of reduced CPU tiers against the JAX
  pool's (same weights through ``params_from_numpy``), and a real
  ``JitBackend`` worker whose weights cross the pipe piece by piece.
"""
import functools
import importlib
import os
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from transport_stubs import (  # noqa: E402
    HangingWorkerBackend,
    SlowWorkerBackend,
    StubVariant,
)
from torch_transport_stubs import HoldingWorkerBackend  # noqa: E402

PKGS = ("repro", "repro_torch")
ROUTER_NAMES = ("round_robin", "least_inflight", "power_of_two")
STUB_NAMES = ("stub-a", "stub-b")
WALLS = {"stub-a": 30.0, "stub-b": 60.0, "stub-hedge": 20.0}


def _ns(pkg):
    """One package's modules under common names."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        backend=m("serving.backend"), cluster=m("serving.cluster"),
        health=m("serving.health"), transport=m("serving.transport"),
        loop=m("serving.loop"), lifecycle=m("serving.lifecycle"),
        scheduler=m("serving.scheduler"), registry=m("core.registry"),
        loadgen=m("serving.loadgen"), network=m("core.network"),
    )


def _stub_tiers(ns):
    """Fixed-wall stub tiers over ``ns``'s ``ExecutionBackend`` (no sleep):
    row i's tokens are its first prompt token + 0..n_steps-1."""

    class Remote(ns.backend.ExecutionBackend):
        def __init__(self, scale=1.0):
            super().__init__()
            self.scale = scale
            self.batch_rows = []
            self.batch_names = []

        def register(self, v):
            self.variants[v.name] = v

        def generate(self, name, tokens, n_steps):
            tokens = np.asarray(tokens)
            self.batch_rows.append(int(tokens.shape[0]))
            self.batch_names.append(name)
            out = tokens[:, :1].astype(np.int32) + np.arange(n_steps, dtype=np.int32)
            return out, WALLS[name] * self.scale

        def run_batch(self, name, batch, n_steps):
            return self.generate(name, batch, n_steps)

    class Hedge(Remote):
        hedge_name = "stub-hedge"

        def hedge(self, batch, n_steps):
            return self.run_batch(self.hedge_name, batch, n_steps)

        def submit_hedge(self, batch, n_steps, *, sync=False):
            return self.submit_batch(self.hedge_name, batch, n_steps, sync=sync)

    return Remote, Hedge


def _scheduler(ns, t_sla_ms=1_000.0, seed=0):
    P = ns.registry.ModelProfile
    reg = ns.registry.ModelRegistry([P("stub-a", 40.0, 30.0, 2.0), P("stub-b", 80.0, 60.0, 4.0)])
    return ns.scheduler.MDInferenceScheduler(
        reg, P("stub-hedge", 35.0, 20.0, 2.0),
        ns.scheduler.SchedulerConfig(t_sla_ms=t_sla_ms, seed=seed))


def _fault_cluster(ns, n, router="round_robin", breaker=None, slices=None, seed=0,
                   scales=None):
    """A pool of inline transports over fixed-wall stubs, with breakers."""
    Remote, _ = _stub_tiers(ns)
    scales = scales or [1.0] * n
    cluster = ns.cluster.ClusterBackend(
        [ns.transport.ProcessTransportBackend(functools.partial(Remote, s), mode="inline")
         for s in scales],
        router=router, seed=seed, slices=slices,
        breaker=breaker if breaker is not None else ns.health.BreakerConfig(),
    )
    for name, quality in zip(STUB_NAMES, (40.0, 80.0)):
        if slices is None or any(name in s for s in slices):
            cluster.register(ns.backend.Variant(name, None, None, quality))
    return cluster


def _request(ns, rid, arrival_ms=0.0, nw=10.0):
    return ns.lifecycle.QueuedRequest(
        rid=rid, tokens=np.full(4, rid, np.int32), n_steps=2,
        t_nw_est_ms=nw, t_nw_actual_ms=nw, arrival_ms=arrival_ms)


def _outcome_of(exc_or_value):
    if isinstance(exc_or_value, BaseException):
        return (type(exc_or_value).__name__, str(exc_or_value))
    return exc_or_value


def _twin(fn, *args):
    """``fn(ns, *args)`` through both packages; returns (jax, port)."""
    out = []
    for pkg in PKGS:
        try:
            out.append(fn(_ns(pkg), *args))
        except Exception as e:  # compared by type name and message
            out.append(_outcome_of(e))
    return out


# ---------------------------------------------------------------------------
# Routers.
# ---------------------------------------------------------------------------
class _Fake:
    """Load-accounting carrier for driving routers directly."""

    def __init__(self):
        self.variants = {}
        self.inflight_rows = 0
        self.dispatched_rows = 0
        self.ewma_wall_ms = None


def _router_picks(ns, router, seed, weights):
    rng = np.random.default_rng(seed)
    replicas = [ns.cluster.Replica(i, _Fake(), spec=ns.cluster.ReplicaSpec(weight=w))
                for i, w in enumerate(weights)]
    r = ns.cluster.make_router(router, seed=seed)
    picks = []
    for _ in range(300):
        for rep in replicas:
            rep.backend.inflight_rows = int(rng.integers(0, 6))
            rep.backend.dispatched_rows += int(rng.integers(0, 3))
            rep.backend.ewma_wall_ms = None if rng.random() < 0.1 else float(rng.integers(10, 60))
        mask = rng.random(len(replicas)) < 0.75
        eligible = [rep for rep, m in zip(replicas, mask) if m]
        try:
            pick = r.pick(eligible).replica_id
        except ns.cluster.NoHealthyReplica:
            pick = None
        picks.append(pick)
    return picks


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (2.0, 1.0, 0.5, 1.0)],
                         ids=["homogeneous", "weighted"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("router", ROUTER_NAMES)
def test_router_picks_twin(router, seed, weights):
    jpicks, picks = _twin(_router_picks, router, seed, weights)
    assert picks == jpicks
    assert set(picks) - {None} == {0, 1, 2, 3}


@pytest.mark.parametrize("router", ROUTER_NAMES)
def test_router_empty_set_raises_typed_error_twin(router):
    def run(ns):
        with pytest.raises(ns.cluster.NoHealthyReplica) as e:
            ns.cluster.make_router(router).pick([])
        return str(e.value)

    j, t = _twin(run)
    assert t == j


def test_make_router_rejects_unknown_twin():
    j, t = _twin(lambda ns: ns.cluster.make_router("random"))
    assert t == j and t[0] == "ValueError"
    assert set(_ns("repro_torch").cluster.ROUTERS) == set(_ns("repro").cluster.ROUTERS)


# ---------------------------------------------------------------------------
# Breakers.
# ---------------------------------------------------------------------------
EVENTS = ("routable", "dispatch", "success", "failure", "fatal", "trip", "permanent",
          "reset", "drain", "undrain")


def _breaker_trace(ns, seed, cfg_kw):
    rng = np.random.default_rng(seed)
    health = ns.health.ReplicaHealth(ns.health.CircuitBreaker(ns.health.BreakerConfig(**cfg_kw)))
    b = health.breaker
    now, states = 0.0, []
    p = np.array([6, 3, 2, 4, 1, 1, 0.3, 0.5, 0.5, 0.5])
    for _ in range(250):
        now += float(rng.uniform(0.0, 60.0))
        ev = EVENTS[int(rng.choice(len(EVENTS), p=p / p.sum()))]
        out = None
        if ev == "routable":
            out = health.routable(now)
        elif ev == "dispatch":
            b.on_dispatch(now)
        elif ev == "success":
            b.on_success(now)
        elif ev in ("failure", "fatal"):
            b.on_failure(now, f"{ev}@{now:.3f}", fatal=ev == "fatal")
        elif ev in ("trip", "permanent"):
            b.trip(now, ev, permanent=ev == "permanent")
        elif ev == "reset":
            b.reset()
        else:
            health.draining = ev == "drain"
        states.append((ev, out, b.state, b.reason, b.open_until_ms, b.consecutive_failures,
                       b.trips, b.healthy, b.permanently_open, health.draining))
    return states


@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(failure_threshold=1, cooldown_ms=50.0, backoff=3.0, max_cooldown_ms=200.0),
    dict(failure_threshold=2, cooldown_ms=100.0, backoff=1.0),
], ids=["default", "tight", "no-backoff"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_breaker_state_after_each_event_twin(seed, cfg_kw):
    j, t = _twin(_breaker_trace, seed, cfg_kw)
    assert t == j
    assert {s[2] for s in t} >= {"closed", "open"}


@pytest.mark.parametrize("kw", [
    dict(failure_threshold=0), dict(cooldown_ms=0.0), dict(cooldown_ms=-1.0), dict(backoff=0.5),
])
def test_breaker_config_rejects_bad_values_twin(kw):
    j, t = _twin(lambda ns: ns.health.BreakerConfig(**kw))
    assert t == j and t[0] == "ValueError"


# ---------------------------------------------------------------------------
# Placement, specs, membership-aware masks.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_names,n_replicas,overlap", [
    (3, 1, 1), (3, 2, 1), (3, 2, 2), (5, 3, 2), (7, 4, 3), (2, 4, 1), (3, 0, 1), (3, 2, 3),
])
def test_shard_slices_twin(n_names, n_replicas, overlap):
    names = [f"m{i}" for i in range(n_names)]
    j, t = _twin(lambda ns: ns.cluster.shard_slices(names, n_replicas, overlap))
    assert t == j


@pytest.mark.parametrize("text,n", [
    ("2:8:0.5,1", 2), ("1,1,1::2", 3), (",", 2), ("2:8:0.5:1,1", 2), ("1,2", 3),
    ("0,1", 2), ("1:0,1", 2), ("1::0,1", 2),
])
def test_parse_replica_specs_twin(text, n):
    def run(ns):
        return [(s.weight, s.max_concurrency, s.service_scale)
                for s in ns.cluster.parse_replica_specs(text, n)]

    j, t = _twin(run)
    assert t == j


def _membership(ns):
    names = ["stub-a", "stub-b"]
    cluster = _fault_cluster(
        ns, 3, slices=ns.cluster.shard_slices(names, 3, overlap=1),
        breaker=ns.health.BreakerConfig(failure_threshold=1, cooldown_ms=100.0))
    out = []

    def snap(tag):
        out.append((tag, cluster.hosted_mask(names).tolist(), cluster.hosted_mask(
            names + ["outsider"]).tolist(), [cluster.fan_out(n) for n in names],
            [(s.health, s.reason, s.open_until_ms, s.draining, s.hosts) for s in cluster.snapshot()]))

    cluster.advance_clock(10.0)
    snap("start")
    cluster.note_failure(0, "exploded", fatal=True)
    snap("replica 0 open")
    cluster.drain(1)
    snap("replica 1 draining")
    cluster.advance_clock(50.0)
    snap("inside the cooldown")
    cluster.advance_clock(120.0)
    snap("cooldown over: half-open")
    cluster.kill_replica(0, reason="operator kill")
    snap("replica 0 killed")
    cluster.advance_clock(1e9)
    snap("far future")
    cluster.rejoin(0)
    cluster.rejoin(1)
    snap("rejoined")
    for name in names:
        try:
            out.append(("route", name, cluster.route(name).replica_id))
        except Exception as e:
            out.append(("route", name, _outcome_of(e)))
    out.append(("outsider", _outcome_of(_raises(cluster.route, "outsider"))))
    return out


def _raises(fn, *a):
    try:
        return fn(*a)
    except Exception as e:
        return e


def test_hosted_mask_and_fan_out_under_trips_and_drains_twin():
    j, t = _twin(_membership)
    assert t == j
    assert t[0][1] == [True, True]


def test_nested_cluster_and_hedge_are_not_replicas_twin():
    def run(ns):
        Remote, _ = _stub_tiers(ns)
        inner = ns.cluster.ClusterBackend([Remote()])
        hedge = ns.backend.OnDeviceBackend.__new__(ns.backend.OnDeviceBackend)
        return [_outcome_of(_raises(ns.cluster.ClusterBackend, [b])) for b in (inner, hedge)]

    j, t = _twin(run)
    assert [x[0] for x in t] == ["ValueError", "ValueError"]
    assert t == j


# ---------------------------------------------------------------------------
# The loop over a pool: kill, rejoin, injected faults, conservation.
# ---------------------------------------------------------------------------
def _drain_with_faults(ns, router, n_replicas, with_hedge):
    cluster = _fault_cluster(ns, n_replicas, router=router,
                             breaker=ns.health.BreakerConfig(failure_threshold=2, cooldown_ms=150.0))
    _, Hedge = _stub_tiers(ns)
    loop = ns.loop.ServingLoop(_scheduler(ns, seed=3), cluster, Hedge() if with_hedge else None,
                               dispatch="sync")
    trace = ns.loadgen.make_trace(60, ns.loadgen.PoissonArrivals(120.0),
                                  ns.network.LognormalNetwork(60.0, 0.5), seed=4)
    events, served = [], []
    kill_at, rejoin_at = 150.0, 350.0

    def on_tick(t_ms, res):
        served.append((t_ms, sorted({c.replica for c in res.completions if c.used_remote})))
        events.append((t_ms, res.stats.n_lost, res.stats.n_requeued, dict(res.stats.replica_rows)))
        if t_ms >= kill_at and cluster.replicas[0].backend.alive and not events_flag:
            cluster.kill_replica(0, reason="operator kill")
            cluster.replicas[1].backend.inject_failures(2)
            events_flag.append(t_ms)
        if t_ms >= rejoin_at and events_flag and not cluster.replicas[0].backend.alive:
            cluster.rejoin(0)
            events_flag.append(t_ms)

    events_flag = []
    done, metrics = loop.drain_trace(
        trace, 50.0, tokens_for=lambda i: np.full(4, i, np.int32), n_steps=2,
        on_tick=on_tick, service_model=lambda res: 4.0 * res.stats.max_replica_rows)
    completions = [(c.rid, c.model_name, c.replica, c.used_remote, c.race_resolution,
                    tuple(int(x) for x in c.tokens)) for c in done]
    snaps = [(s.dispatched_rows, s.inflight_rows, s.completed_batches, s.health, s.reason)
             for s in cluster.snapshot()]
    return dict(completions=completions, events=events, served=served, flags=events_flag,
                snaps=snaps, rejected=metrics.n_rejected,
                dispatched=[r.dispatched_rows for r in cluster.replicas],
                executed=[sum(r.backend._inner.batch_rows) for r in cluster.replicas])


@pytest.mark.parametrize("with_hedge", [False, True], ids=["no-hedge", "hedge"])
@pytest.mark.parametrize("router", ROUTER_NAMES)
def test_drain_trace_with_kill_rejoin_and_faults_twin(router, with_hedge):
    j, t = _twin(_drain_with_faults, router, 3, with_hedge)
    assert t == j
    # Conservation, aggregate and per replica.
    rids = [c[0] for c in t["completions"]]
    assert sorted(rids) == list(range(60)) and t["rejected"] == 0
    per_replica = {0: 0, 1: 0, 2: 0}
    for c in t["completions"]:
        if c[3]:
            per_replica[c[2]] += 1
    assert sum(per_replica.values()) == sum(c[3] for c in t["completions"])
    assert all(s[1] == 0 for s in t["snaps"])  # nothing left in flight
    # The killed replica served nothing between its kill and its rejoin.
    kill_t, rejoin_t = t["flags"]
    for t_ms, replicas in t["served"]:
        if kill_t < t_ms < rejoin_t:
            assert 0 not in replicas
    # The injected faults lost rows, and they were requeued or failed over.
    assert sum(e[1] for e in t["events"]) > 0
    # Each completion's tokens are its prompt's first token + 0, 1.
    assert all(c[5] == (c[0], c[0] + 1) for c in t["completions"] if c[3])


def _lost_batch_requeue(ns):
    cluster = _fault_cluster(ns, 2, router="least_inflight",
                             breaker=ns.health.BreakerConfig(failure_threshold=1, cooldown_ms=1e6))
    cluster.replicas[0].backend.inject_failures(50)
    loop = ns.loop.ServingLoop(_scheduler(ns), cluster, dispatch="sync")
    futures = [loop.submit(_request(ns, i)) for i in range(8)]
    r1 = loop.tick(now_ms=0.0)
    pending = loop.pending
    r2 = loop.tick(now_ms=100.0)
    return dict(lost=(r1.stats.n_lost, r2.stats.n_lost), requeued=r1.stats.n_requeued,
                pending=pending, first=[(c.rid, c.replica) for c in r1.completions],
                second=[(c.rid, c.replica) for c in r2.completions],
                requeues=[f.requeues for f in futures],
                states=[f.state.name for f in futures],
                health=[s.health for s in cluster.snapshot()])


def test_lost_batch_requeues_and_resolves_on_the_survivor_twin():
    j, t = _twin(_lost_batch_requeue)
    assert t == j
    assert t["lost"][0] > 0 and t["lost"][1] == 0 and t["requeued"] == t["lost"][0]
    assert {r for _, r in t["second"]} == {1}
    assert set(t["states"]) == {"RESOLVED"}


def _whole_pool_outage(ns):
    cluster = _fault_cluster(ns, 2)
    _, Hedge = _stub_tiers(ns)
    hedge = Hedge()
    loop = ns.loop.ServingLoop(_scheduler(ns), cluster, hedge, dispatch="sync")
    cluster.kill_replica(0, reason="rack down")
    cluster.kill_replica(1, reason="rack down")
    for i in range(5):
        loop.submit(_request(ns, i))
    res = loop.tick(now_ms=0.0)
    cluster.rejoin(0)
    loop.submit(_request(ns, 99, arrival_ms=10.0))
    res2 = loop.tick(now_ms=10.0)
    return [(c.rid, c.race_resolution, c.model_name, c.replica) for c in res.completions + res2.completions], \
        res.stats.n_degraded, res2.stats.n_degraded


def test_whole_pool_outage_degrades_then_rejoin_serves_twin():
    j, t = _twin(_whole_pool_outage)
    assert t == j
    assert t[1] == 5 and t[2] == 0


# ---------------------------------------------------------------------------
# Process workers (stub factories: the children import neither torch nor jax).
# ---------------------------------------------------------------------------
def _process_kill_restart(ns):
    # The worker holds the [[1, 0], ...] batch far past the kill, whenever
    # it reads it, answers the others at once, and ignores the SIGTERM of
    # kill(), which fails the held batch with its own reason; the SIGKILL
    # after it is the worker's death.
    t = ns.transport.ProcessTransportBackend(HoldingWorkerBackend, timeout_s=30.0)
    try:
        t.register(StubVariant("m"))
        out = [t.run_batch("m", np.array([[0, 0]]), 1)[0].tolist()]
        h = t.submit_batch("m", np.array([[1, 0], [2, 0]]), 2, sync=False)
        t.kill("fault injection")
        out.append(_outcome_of(_raises(h.wait, 10.0)))
        t._proc.kill()
        # The pump thread sees the pipe close before the scenario goes on:
        # the JAX transport's pump marks the replica dead when it does, and
        # would mark the restarted worker dead if that came later.
        t._pump_thread.join(10.0)
        out.append((t.alive, t.inflight_rows))
        out.append(_outcome_of(_raises(t.run_batch, "m", np.array([[1, 0]]), 2)))
        t.restart()  # respawns and replays the registration
        out.append(t.alive)
        out.append(t.run_batch("m", np.array([[6, 0]]), 2)[0].tolist())
        out.append(t.inflight_rows)
        return out
    finally:
        t.close()


def test_process_kill_mid_batch_then_restart_reregisters_twin():
    j, t = _twin(_process_kill_restart)
    assert t == j
    assert t[1] == ("ReplicaDied", "fault injection")
    assert t[4] is True and t[5] == [[6, 7]]


def test_process_worker_death_and_batch_timeout():
    tr = importlib.import_module("repro_torch.serving.transport")
    t = tr.ProcessTransportBackend(SlowWorkerBackend, timeout_s=30.0)
    try:
        t.register(StubVariant("m"))
        info = t.stats()
        assert not info["torch_loaded"] and not info["jax_loaded"]  # stub child
        errors = []

        def submit():
            try:
                t.run_batch("m", np.array([[1, 0]]), 2)
            except tr.TransportError as e:
                errors.append(e)

        th = threading.Thread(target=submit)
        th.start()
        time.sleep(0.05)
        os.kill(t.pid, 9)  # the worker dies out from under the batch
        th.join(timeout=10.0)
        assert len(errors) == 1 and isinstance(errors[0], tr.ReplicaDied)
        assert not t.alive
        t.restart()
        assert t.reap_s is not None and t.ready_s > 0 and t.alive
        np.testing.assert_array_equal(t.run_batch("m", np.array([[3, 0]]), 2)[0], [[3, 4]])
    finally:
        t.close()
    # A hung worker: the per-batch timeout (counted after registration was
    # acknowledged) converts it into a death.
    t = tr.ProcessTransportBackend(HangingWorkerBackend, timeout_s=0.5)
    try:
        t.register(StubVariant("m"))
        with pytest.raises(tr.ReplicaDied, match="batch timeout after 0.5s"):
            t.run_batch("m", np.array([[1, 0]]), 2)
        assert not t.alive
    finally:
        t.close()
    assert not t._proc.is_alive()


def test_worker_asked_for_cuda_without_a_gpu_fails_construction():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    from repro_torch.launch.serve import _jit_backend_factory
    from repro_torch.serving.transport import ProcessTransportBackend, ReplicaDied

    t = ProcessTransportBackend(functools.partial(_jit_backend_factory, 16, "cuda"))
    try:
        with pytest.raises(ReplicaDied, match="worker backend construction.*cuda"):
            t.register(StubVariant("m"))
        assert not t.alive
    finally:
        t.close()


# ---------------------------------------------------------------------------
# Real tiers: tokens of the port's pool equal the JAX pool's.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def twin_tier():
    """One reduced tier with the same weights in both packages."""
    from repro.configs import reduced as j_reduced
    from repro.models import transformer as JT
    from repro_torch.configs.archs import reduced
    from repro_torch.models import transformer as T

    kw = dict(d_model=64, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=32)
    jcfg, cfg = j_reduced("llama3-8b", **kw), reduced("llama3-8b", **kw)
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(2))
    params = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return (jcfg, jparams), (cfg, params)


BATCHES = [np.random.default_rng(i).integers(0, 256, (2, 8)) for i in range(5)]


def test_pool_greedy_tokens_equal_the_jax_pool(twin_tier):
    (jcfg, jparams), (cfg, params) = twin_tier
    outs = {}
    for pkg, c, p in (("repro", jcfg, jparams), ("repro_torch", cfg, params)):
        ns = _ns(pkg)
        kw = {} if pkg == "repro" else {"device": "cpu"}
        cluster = ns.cluster.ClusterBackend(
            [ns.transport.ProcessTransportBackend(
                functools.partial(ns.backend.JitBackend, 24, **kw), mode="inline")
             for _ in range(2)], router="least_inflight")
        cluster.register(ns.backend.Variant("tier", c, p, 70.0))
        res = []
        for b in BATCHES:
            h = cluster.submit_batch("tier", b, 4, sync=True)
            res.append((h.replica, np.asarray(h.wait()[0]).tolist()))
        outs[pkg] = res
    assert outs["repro_torch"] == outs["repro"]
    assert {r for r, _ in outs["repro_torch"]} == {0, 1}


def test_process_worker_places_weights_in_pieces_and_matches_jax(twin_tier, monkeypatch):
    """A real ``JitBackend`` worker on the CPU: the tier's weights cross the
    pipe as 4 KiB pieces, the worker's checksums equal the parent's, its
    tokens equal the JAX backend's, and a restart re-registers them."""
    from repro.serving.backend import JitBackend as JJit
    from repro.serving.backend import Variant as JVariant
    from repro_torch.launch.serve import _jit_backend_factory
    from repro_torch.serving import transport
    from repro_torch.serving.backend import Variant

    monkeypatch.setattr(transport, "PIECE_BYTES", 4096)  # several pieces a leaf
    (jcfg, jparams), (cfg, params) = twin_tier
    jb = JJit(24)
    jb.register(JVariant("tier", jcfg, jparams, 70.0))
    want = [np.asarray(jb.run_batch("tier", b, 4)[0]) for b in BATCHES[:2]]
    t = transport.ProcessTransportBackend(functools.partial(_jit_backend_factory, 24, "cpu"),
                                          max_len=24)
    try:
        t.register(Variant("tier", cfg, params, 70.0))
        info = t.registrations["tier"]
        leaves = importlib.import_module("repro_torch.tree").tree_leaves(params)
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        assert max(x.numel() * x.element_size() for x in leaves) > 4096
        assert info["bytes"] == nbytes and len(info["checksums"]) > 0
        assert set(info["rss"]) == {"entry_mib", "before_pieces_mib", "pieces_peak_mib",
                                    "after_pieces_mib"}
        assert info["torch_loaded"] and not info["jax_loaded"]
        for b, w in zip(BATCHES, want):
            np.testing.assert_array_equal(t.run_batch("tier", b, 4)[0], w)
        first = info["checksums"]
        t.kill("fault injection")
        t.restart()
        assert t.registrations["tier"]["checksums"] == first
        np.testing.assert_array_equal(t.run_batch("tier", BATCHES[0], 4)[0], want[0])
    finally:
        t.close()


def test_process_registration_refuses_leaves_off_the_host():
    """A process worker is sent host bytes only: a variant whose leaves lie
    on another device is refused before it is mirrored or sent."""
    from repro_torch.serving.backend import Variant
    from repro_torch.serving.transport import ProcessTransportBackend

    t = ProcessTransportBackend(SlowWorkerBackend, timeout_s=30.0)
    try:
        v = Variant("tier", None, {"w": torch.empty(4, 4, device="meta")}, 70.0)
        with pytest.raises(TypeError, match="leaves on meta"):
            t.register(v)
        assert "tier" not in t.variants and t.alive
        t.register(StubVariant("m"))  # the worker is untouched
        np.testing.assert_array_equal(t.run_batch("m", np.array([[3, 0]]), 2)[0], [[3, 4]])
    finally:
        t.close()


def test_in_process_replicas_share_the_weight_tensors(twin_tier):
    from repro_torch.launch.serve import build_engine, tier_configs

    _, (cfg, params) = twin_tier
    engine = build_engine(max_len=24, measured_hedge=False, device="cpu",
                          configs=[("tier", cfg, 70.0)], replicas=2, transport="inline")
    a, b = (r.backend._inner.variants["tier"] for r in engine.backend.replicas)
    assert a is b  # one Variant, one set of tensors, on both replicas
    assert len(tier_configs()) == 3


# ---------------------------------------------------------------------------
# The pins: a one-replica pool is the single backend; default specs are no specs.
# ---------------------------------------------------------------------------
def test_one_replica_round_robin_is_identical_to_single_backend(twin_tier):
    """A 1-replica round_robin pool serves a seeded trace exactly like the
    plain single-backend loop — same decisions, tokens and loop-clock
    timings (real reduced tiers on the CPU; the profiles are fixed, so
    measured walls cannot steer the two runs apart)."""
    from repro_torch.core.network import LognormalNetwork
    from repro_torch.core.registry import ModelProfile, ModelRegistry
    from repro_torch.serving.backend import JitBackend, Variant
    from repro_torch.serving.cluster import ClusterBackend
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.loadgen import PoissonArrivals, make_trace
    from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig

    _, (cfg, params) = twin_tier
    variants = [Variant("small", cfg, params, 40.0), Variant("large", cfg, params, 80.0)]
    registry = ModelRegistry([ModelProfile("small", 40.0, 30.0, 2.0),
                              ModelProfile("large", 80.0, 60.0, 4.0)])
    trace = make_trace(24, PoissonArrivals(120.0), LognormalNetwork(40.0, 0.5), seed=21)
    prompts = np.random.default_rng(21).integers(0, 64, (24, 8))
    outcomes = []
    for clustered in (False, True):
        backend = (ClusterBackend([JitBackend(24, device="cpu")], router="round_robin")
                   if clustered else JitBackend(24, device="cpu"))
        engine = ServingEngine(max_len=24, backend=backend)
        for v in variants:
            engine.register(v)
        sched = MDInferenceScheduler(registry, registry[0], SchedulerConfig(
            t_sla_ms=5_000.0, seed=4, profile_ewma=0.0))
        outcomes.append(engine.make_loop(sched, dispatch="sync").drain_trace(
            trace, 50.0, tokens_for=lambda i: prompts[i], n_steps=2))
    (done_a, metrics_a), (done_b, metrics_b) = outcomes
    assert [c.rid for c in done_a] == [c.rid for c in done_b]
    for a, b in zip(done_a, done_b):
        assert (a.model_index, a.hedged, a.used_remote, a.race_resolution, a.queue_wait_ms,
                a.time_to_schedule_ms) == (b.model_index, b.hedged, b.used_remote,
                                           b.race_resolution, b.queue_wait_ms,
                                           b.time_to_schedule_ms)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.replica is None and b.replica == 0
    assert metrics_a.model_usage == metrics_b.model_usage
    assert metrics_b.replica_rows[0].share == 1.0


def _route_sequence(ns, specs):
    Remote, _ = _stub_tiers(ns)
    cluster = ns.cluster.ClusterBackend([Remote() for _ in range(3)], router="least_inflight",
                                        specs=specs)
    for name, quality in zip(STUB_NAMES, (40.0, 80.0)):
        cluster.register(ns.backend.Variant(name, None, None, quality))
    picks = []
    for i in range(12):
        r = cluster.route(STUB_NAMES[i % 2])
        r.backend.inflight_rows += 3 + (i % 4)
        picks.append(r.replica_id)
    snaps = [(s.weight, s.max_concurrency, s.service_scale) for s in cluster.snapshot()]
    return picks, snaps


@pytest.mark.parametrize("specs", [None, "default", "2:8:0.5,1,1::2"])
def test_specs_route_and_snapshot_twin(specs):
    def run(ns):
        s = specs
        if s == "default":
            s = [ns.cluster.ReplicaSpec() for _ in range(3)]
        elif s is not None:
            s = ns.cluster.parse_replica_specs(s, 3)
        return _route_sequence(ns, s)

    j, t = _twin(run)
    assert t == j
    if specs == "default":
        assert t[0] == _route_sequence(_ns("repro_torch"), None)[0]


def test_serve_cli_with_process_workers_on_cpu(capsys):
    """``launch.serve --transport process`` on the CPU: two spawned
    ``JitBackend`` workers at the reduced tiers, a kill and a rejoin on the
    loop clock, every request served."""
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--requests", "12", "--prompt", "8", "--gen", "2",
                       "--rate", "10", "--replicas", "2", "--transport", "process",
                       "--kill-replica-at", "200", "--rejoin-replica-at", "600"]) == 0
    out = capsys.readouterr().out
    assert "cluster: 2 replicas, router=round_robin, transport=process" in out
    assert "!! killed replica 0" in out and "!! rejoined replica 0" in out
    assert "served 12 requests" in out and "cluster           : 2 replicas" in out
