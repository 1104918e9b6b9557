"""The port's tracing, metrics and exporters against the JAX package, on the CPU.

Each scenario of ``tests/test_observability.py`` runs through both
packages over fixed-wall stub tiers (no sleep) and the outcomes are
compared: span trees (ids, parents, names, tracks, argument keys), the
request-conservation audit and every metric's value, for a resolve, a
shed, a cancel, a lost batch that requeues, a hedge failover, transport
spans under their dispatch group and the controller's retune instants.
The units (quantile, histogram grid, registry, tracer, Chrome / Prometheus
formats) give identical outputs on identical inputs.  An attached run is
decision-identical to a detached one, and both to the JAX package's.  The
port's serve driver writes exports that pass ``benchmarks/validate_obs.py``.
"""
import importlib
import json
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transport_stubs import StubVariant, StubWorkerBackend  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("repro", "repro_torch")
STUB_NAMES = ("stub-a", "stub-b")
WALLS = {"stub-a": 30.0, "stub-b": 60.0, "stub-hedge": 20.0}


def _ns(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        obs=m("observability"), metrics=m("observability.metrics"),
        export=m("observability.export"), admission=m("serving.admission"),
        backend=m("serving.backend"), cluster=m("serving.cluster"),
        controller=m("serving.controller"), health=m("serving.health"),
        lifecycle=m("serving.lifecycle"), loop=m("serving.loop"),
        loadgen=m("serving.loadgen"), network=m("core.network"),
        registry=m("core.registry"), scheduler=m("serving.scheduler"),
        transport=m("serving.transport"),
    )


def _twin(fn, *args):
    return [fn(_ns(pkg), *args) for pkg in PKGS]


def _stub_tiers(ns):
    class Remote(ns.backend.ExecutionBackend):
        def register(self, v):
            self.variants[v.name] = v

        def generate(self, name, tokens, n_steps):
            tokens = np.asarray(tokens)
            return tokens[:, :1].astype(np.int32) + np.arange(n_steps, dtype=np.int32), WALLS[name]

        def run_batch(self, name, batch, n_steps):
            return self.generate(name, batch, n_steps)

    class Hedge(Remote):
        hedge_name = "stub-hedge"

        def submit_hedge(self, batch, n_steps, *, sync=False):
            return self.submit_batch(self.hedge_name, batch, n_steps, sync=sync)

    return Remote, Hedge


def _scheduler(ns, t_sla_ms=1_000.0, seed=0):
    P = ns.registry.ModelProfile
    reg = ns.registry.ModelRegistry([P("stub-a", 40.0, 30.0, 2.0), P("stub-b", 80.0, 60.0, 4.0)])
    return ns.scheduler.MDInferenceScheduler(
        reg, P("stub-hedge", 35.0, 20.0, 2.0),
        ns.scheduler.SchedulerConfig(t_sla_ms=t_sla_ms, seed=seed))


def _zoo(ns, backend):
    for name, quality in zip(STUB_NAMES, (40.0, 80.0)):
        backend.register(ns.backend.Variant(name, None, None, quality))
    return backend


def _fault_cluster(ns, n, router="round_robin", breaker=None):
    Remote, _ = _stub_tiers(ns)
    return _zoo(ns, ns.cluster.ClusterBackend(
        [ns.transport.ProcessTransportBackend(Remote, mode="inline") for _ in range(n)],
        router=router, breaker=breaker if breaker is not None else ns.health.BreakerConfig()))


def _request(ns, rid, arrival_ms=0.0, nw=10.0, tenant=None):
    return ns.lifecycle.QueuedRequest(
        rid=rid, tokens=np.full(4, rid, np.int32), n_steps=2, t_nw_est_ms=nw,
        t_nw_actual_ms=nw, arrival_ms=arrival_ms, tenant=tenant)


def _stub_loop(ns, obs=None, *, hedge=False, admission=None, **kw):
    Remote, Hedge = _stub_tiers(ns)
    return ns.loop.ServingLoop(_scheduler(ns), _zoo(ns, Remote()), Hedge() if hedge else None,
                               dispatch="sync", admission=admission, observability=obs, **kw)


def _tree(tracer):
    """A span tree without its host-clock stamps: ids, parents, names,
    categories, tracks, open/instant flags and the arguments (floats by key
    only, since some are host-clock durations)."""
    return [(s.span_id, s.parent_id, s.name, s.cat, s.track, s.is_instant, s.end_ms is None,
             tuple(sorted((k, "<float>" if isinstance(v, float) else repr(v))
                          for k, v in s.args.items())))
            for s in tracer.spans]


def _metric_values(registry):
    out = []
    for kind, name, labels, obj in registry.items():
        if kind == "histogram":
            out.append((kind, name, tuple(sorted(labels.items())), obj.count))
        else:
            out.append((kind, name, tuple(sorted(labels.items())), obj.value))
    return sorted(out, key=repr)


def _observed(ns, obs, extra=None):
    return dict(tree=_tree(obs.tracer), audit=ns.obs.request_conservation(obs.tracer),
                metrics=_metric_values(obs.metrics), **(extra or {}))


# ---------------------------------------------------------------------------
# Units: identical outputs on identical inputs.
# ---------------------------------------------------------------------------
def _units(ns):
    M = ns.metrics
    vals = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    out = {"quantile": [ns.obs.quantile(vals, q) for q in (0, 25, 50, 90, 99, 100)],
           "empty": (math.isnan(ns.obs.quantile([], 99)), ns.obs.quantile([], 99, default=0.0),
                     ns.obs.percentiles([], [50, 99], default=-1.0)),
           "grid": (M.N_BUCKETS, M.BUCKET_LO_MS, [M.bucket_upper_ms(i) for i in range(M.N_BUCKETS)],
                    [M.bucket_index(v) for v in (0.0, 0.02, 0.5, 1.0, 3.7, 42.0, 999.0, 1e5)])}
    h, a, b = M.Histogram(), M.Histogram(), M.Histogram()
    rng = np.random.default_rng(0)
    for i, s in enumerate(rng.lognormal(3.0, 1.0, 2_000)):
        h.record(float(s))
        (a if i % 2 else b).record(float(s))
    merged = a.snapshot().merge(b.snapshot())
    out["histogram"] = (h.counts, h.count, h.sum, [h.percentile(q) for q in (50, 90, 99)],
                        merged.counts, merged.percentile(99))
    reg = M.MetricsRegistry()
    reg.counter("x", tenant="ui").inc()
    reg.counter("x", tenant="batch").inc(3)
    reg.gauge("loop_inflight_ticks", lane="x").set(2)
    for v in (0.5, 0.5, 50.0):
        reg.histogram("wait_ms").record(v)
    out["registry"] = (reg.snapshot(), ns.obs.prometheus_text(reg),
                       reg.get_value("counter", "x", tenant="nope"))
    tr = ns.obs.Tracer()
    root = tr.start("request", cat="request", track="tenant:ui", t0_ms=10.0, rid=1)
    child = tr.start("queued", parent=root, t0_ms=10.5)
    tr.instant("resolve", parent=root, track="tenant:ui", t_ms=14.0)
    tr.end(child, t1_ms=12.0)
    tr.end(child, t1_ms=99.0)  # idempotent
    tr.end(root, t1_ms=14.0)
    with tr.bind(root):
        tr.start("batch:stub", parent=tr.ambient_id(), track="loop", t0_ms=11.0)  # left open
    out["tracer"] = (_tree(tr), ns.obs.chrome_trace(tr), ns.export.request_conservation(tr))
    return out


def test_units_give_identical_outputs_twin():
    j, t = _twin(_units)
    assert json.dumps(t, sort_keys=True, default=repr) == json.dumps(j, sort_keys=True, default=repr)
    assert t["grid"][0] == 97


# ---------------------------------------------------------------------------
# Span trees and conservation through the loop.
# ---------------------------------------------------------------------------
def _resolve(ns):
    obs = ns.obs.Observability()
    loop = _stub_loop(ns, obs, hedge=True)
    futures = [loop.submit(_request(ns, i, tenant="ui")) for i in range(6)]
    loop.tick(now_ms=50.0)
    return _observed(ns, obs, {"states": [f.state.name for f in futures]})


def _shed(ns):
    obs = ns.obs.Observability()
    loop = _stub_loop(ns, obs, admission=ns.admission.AdmissionConfig(
        policy="shed", max_pending=2, max_chunk=2))
    futures = [loop.submit(_request(ns, i)) for i in range(6)]
    loop.tick(now_ms=0.0)
    return _observed(ns, obs, {"states": [f.state.name for f in futures]})


def _cancel(ns):
    obs = ns.obs.Observability()
    loop = _stub_loop(ns, obs)
    futures = [loop.submit(_request(ns, i)) for i in range(3)]
    futures[1].cancel()
    loop.tick(now_ms=0.0)
    return _observed(ns, obs, {"states": [f.state.name for f in futures]})


def _lost_batch(ns):
    obs = ns.obs.Observability()
    cluster = _fault_cluster(ns, 2, router="least_inflight",
                             breaker=ns.health.BreakerConfig(failure_threshold=1, cooldown_ms=1e6))
    cluster.replicas[0].backend.inject_failures(50)
    loop = ns.loop.ServingLoop(_scheduler(ns), cluster, dispatch="sync", observability=obs)
    futures = [loop.submit(_request(ns, i)) for i in range(8)]
    r1 = loop.tick(now_ms=0.0)
    r2 = loop.tick(now_ms=100.0)
    return _observed(ns, obs, {"lost": (r1.stats.n_lost, r2.stats.n_lost),
                               "requeued": r1.stats.n_requeued,
                               "requeues": [f.requeues for f in futures]})


def _failover(ns):
    obs = ns.obs.Observability()
    cluster = _fault_cluster(ns, 1, breaker=ns.health.BreakerConfig(failure_threshold=1,
                                                                    cooldown_ms=1e6))
    cluster.replicas[0].backend.inject_failures(10)
    _, Hedge = _stub_tiers(ns)
    loop = ns.loop.ServingLoop(_scheduler(ns), cluster, Hedge(), dispatch="sync",
                               observability=obs)
    for i in range(2):
        loop.submit(_request(ns, i))
    res = loop.tick(now_ms=0.0)
    return _observed(ns, obs, {"races": [c.race_resolution for c in res.completions],
                               "lost": res.stats.n_lost, "requeued": res.stats.n_requeued})


def _transport_nesting(ns):
    obs = ns.obs.Observability()
    loop = ns.loop.ServingLoop(_scheduler(ns), _fault_cluster(ns, 1), dispatch="sync",
                               observability=obs)
    loop.submit(_request(ns, 0))
    loop.tick(now_ms=0.0)
    rts = obs.tracer.find("transport.roundtrip")
    nest = []
    for rt in rts:
        ex = [s for s in obs.tracer.children_of(rt) if s.name == "worker.execute"]
        nest.append((len(ex), rt.start_ms <= ex[0].start_ms and ex[0].end_ms <= rt.end_ms + 1e-6))
    batch_ids = {s.span_id for s in obs.tracer.spans if s.name.startswith("batch:")}
    return _observed(ns, obs, {"nest": nest, "under_group": [rt.parent_id in batch_ids
                                                             for rt in rts]})


def _controller_retune(ns):
    obs = ns.obs.Observability()
    ctl = ns.controller.AdmissionController(ns.controller.ControllerConfig(
        target_wait_frac=0.1, hysteresis=1))
    ctl.observability = obs
    queue = ns.admission.AdmissionQueue(ns.admission.AdmissionConfig(
        policy="shed", max_pending=16, max_chunk=16))
    sched = types.SimpleNamespace(cfg=types.SimpleNamespace(t_sla_ms=100.0), mu=np.array([5.0]),
                                  join_ttft_mu=0.0)
    result = types.SimpleNamespace(completions=[types.SimpleNamespace(queue_wait_ms=90.0)],
                                   stats=types.SimpleNamespace(n_shed=1))
    applied = []
    for t in (123.0, 173.0, 223.0):
        ctl.observe(result, scheduler=sched, now_ms=t)
        applied.append(ctl.apply(queue))
    (first, *_) = obs.tracer.find("controller.retune")
    return _observed(ns, obs, {"applied": applied, "log": list(ctl.log),
                               "first_args": sorted(first.args.items())})


def _stream(ns):
    obs = ns.obs.Observability()
    loop = _stub_loop(ns, obs)
    f = loop.submit(_request(ns, 0))
    f._push_chunk(7, 100.0)
    f._push_chunk(9, 105.0)
    marks = [(m.start_ms, m.args["index"]) for m in obs.tracer.find("stream.token")]
    loop.tick(now_ms=0.0)
    return _observed(ns, obs, {"marks": marks, "tokens": [c.token for c in f.stream()]})


SCENARIOS = {"resolve": _resolve, "shed": _shed, "cancel": _cancel, "lost_batch": _lost_batch,
             "hedge_failover": _failover, "transport_nesting": _transport_nesting,
             "controller_retune": _controller_retune, "stream": _stream}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_span_trees_audit_and_metrics_twin(name):
    j, t = _twin(SCENARIOS[name])
    assert t == j
    audit = t["audit"]
    assert audit["open"] == 0 and audit["extra_terminals"] == 0
    assert audit["submitted"] == audit["resolved"] + audit["rejected"] + audit["cancelled"]


def test_scenario_outcomes_match_the_reference_expectations():
    ns = _ns("repro_torch")
    r = _resolve(ns)
    assert r["audit"]["resolved"] == 6 and set(r["states"]) == {"RESOLVED"}
    assert {n for _, _, n, *_ in r["tree"]} >= {"request", "queued", "scheduled", "remote",
                                                 "resolve", "tick", "batch:hedge"}
    s = _shed(ns)
    assert s["audit"]["rejected"] == 4 and s["audit"]["resolved"] == 2
    assert _cancel(ns)["audit"]["cancelled"] == 1
    lb = _lost_batch(ns)
    assert lb["lost"][0] > 0 and lb["lost"][1] == 0 and lb["requeued"] == lb["lost"][0]
    assert sum(1 for q in lb["requeues"] if q) == lb["requeued"]
    assert any(n == "breaker.trip" for _, _, n, *_ in lb["tree"])
    fo = _failover(ns)
    assert fo["races"] == ["remote_failed"] * 2 and fo["lost"] == 2 and fo["requeued"] == 0
    tn = _transport_nesting(ns)
    assert tn["nest"] == [(1, True)] and tn["under_group"] == [True]
    cr = _controller_retune(ns)
    assert cr["applied"][0] and dict(cr["first_args"])["direction"] == "tighten"
    st = _stream(ns)
    assert st["marks"] == [(100.0, 0), (105.0, 1)] and st["tokens"][:2] == [7, 9]


def test_process_transport_spans_nest_and_anchor_to_the_parent_clock():
    """A traced submit across a real worker: ``worker.execute`` is rebuilt
    from the worker's relative timings inside ``transport.roundtrip``."""
    ns = _ns("repro_torch")
    obs = ns.obs.Observability()
    t = ns.transport.ProcessTransportBackend(StubWorkerBackend, timeout_s=30.0)
    try:
        t.attach_observability(obs, track="replica:0")
        t.register(StubVariant("m"))
        with obs.tracer.bind(obs.tracer.start("batch:m", track="replica:0")):
            out, _ = t.run_batch("m", np.array([[4, 0]]), 2)
    finally:
        t.close()
    np.testing.assert_array_equal(out, [[4, 5]])
    (rt,) = obs.tracer.find("transport.roundtrip")
    (ex,) = [s for s in obs.tracer.children_of(rt) if s.name == "worker.execute"]
    assert rt.args["mode"] == "process" and rt.parent_id == 0
    assert rt.start_ms <= ex.start_ms <= ex.end_ms <= rt.end_ms + 1e-6
    assert obs.metrics.get_value("counter", "transport_batches_total", outcome="ok") == 1


# ---------------------------------------------------------------------------
# The regression pin: attached == detached == the JAX package's decisions.
# ---------------------------------------------------------------------------
def _decisions(ns, attached):
    obs = ns.obs.Observability() if attached else None
    cluster = _fault_cluster(ns, 2, router="least_inflight",
                             breaker=ns.health.BreakerConfig(failure_threshold=2, cooldown_ms=100.0))
    _, Hedge = _stub_tiers(ns)
    controller = ns.controller.AdmissionController(ns.controller.ControllerConfig(
        target_wait_frac=0.1, wait_alpha=0.7, max_pending=64))
    loop = ns.loop.ServingLoop(
        _scheduler(ns, seed=4), cluster, Hedge(), dispatch="sync",
        admission=ns.admission.AdmissionConfig(policy="shed", max_pending=16, max_chunk=8),
        controller=controller, observability=obs)
    trace = ns.loadgen.make_trace(200, ns.loadgen.OverloadArrivals(120.0, overload_factor=2.0),
                                  ns.network.LognormalNetwork(80.0, 0.6), seed=6)
    state = {"n": 0}

    def on_tick(t_ms, res):
        state["n"] += 1
        if state["n"] == 3:
            cluster.kill_replica(1, reason="operator kill")
            cluster.replicas[0].backend.inject_failures(2)
        if state["n"] == 8:
            cluster.rejoin(1)

    done, metrics = loop.drain_trace(
        trace, 50.0, tokens_for=lambda i: np.full(4, i, np.int32), n_steps=2, on_tick=on_tick,
        service_model=lambda res: 5.0 * res.stats.max_replica_rows)
    out = dict(completions=[(c.rid, c.model_index, c.model_name, c.replica, c.queue_wait_ms,
                             c.latency_ms, c.race_resolution) for c in done],
               rejected=metrics.n_rejected, log=list(controller.log))
    if obs is not None:
        audit = ns.obs.request_conservation(obs.tracer)
        out["audit_ok"] = (audit["submitted"] == 200 and audit["open"] == 0
                           and audit["resolved"] == len(done) and audit["rejected"] == metrics.n_rejected)
    return out


def test_attached_run_is_decision_identical_to_detached_and_to_jax():
    j_off, t_off = _twin(_decisions, False)
    t_on = _decisions(_ns("repro_torch"), True)
    assert t_on.pop("audit_ok") is True
    assert t_off == j_off
    assert t_on == t_off
    assert t_off["rejected"] > 0 and t_off["log"]


# ---------------------------------------------------------------------------
# The serve driver's exports pass benchmarks/validate_obs.py.
# ---------------------------------------------------------------------------
def test_serve_exports_pass_validate_obs(tmp_path, capsys):
    from repro_torch.launch import serve

    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        validate_obs = importlib.import_module("validate_obs")
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    trace = str(tmp_path / "trace.json")
    assert serve.main([
        "--device", "cpu", "--requests", "24", "--prompt", "8", "--gen", "2", "--rate", "10",
        "--replicas", "2", "--transport", "inline", "--kill-replica-at", "100",
        "--rejoin-replica-at", "300", "--tenants", "interactive:4,batch:1:batch:32",
        "--controller", "--max-pending", "8", "--overload", "2", "--overload-policy", "shed",
        "--trace-out", trace, "--metrics-out", trace + ".prom"]) == 0
    out = capsys.readouterr().out
    assert "(conservation ok)" in out and "prometheus text ->" in out
    assert validate_obs.main([trace]) == 0
    report = capsys.readouterr().out
    assert report.count("ok   ") == 4
    doc = json.loads(Path(trace).read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"request", "tick", "transport.roundtrip", "worker.execute", "breaker.trip"} <= names
