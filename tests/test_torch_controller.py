"""The port's admission controller, drift gauntlet and serve flags against the JAX package.

* the controller law's unit cases (``tests/test_controller.py``) as
  cross-package twins: after every observe / apply, the queue's bound and
  shed margin, the retune log and the service estimate are identical;
* the drift gauntlet's four scenarios (``tests/test_drift_gauntlet.py``)
  over the no-sleep fixed-wall harness, controller on and off: every
  completion (model, latency, wait, race) and the controller's log are
  identical to the JAX run's;
* ``repro_torch.launch.serve``: the same flags as ``repro.launch.serve``
  plus ``--device``, the same argument errors (the ``--continuous``
  exclusion among them), and with ``--tenants``, ``--controller`` and
  ``--replicas 2 --transport inline --kill-replica-at/--rejoin-replica-at``
  the same summary lines as the JAX driver on the CPU.
"""
import argparse
import dataclasses
import importlib
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PKGS = ("repro", "repro_torch")
STUB_NAMES = ("stub-a", "stub-b")


def _ns(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        admission=m("serving.admission"), controller=m("serving.controller"),
        backend=m("serving.backend"), cluster=m("serving.cluster"),
        loop=m("serving.loop"), loadgen=m("serving.loadgen"), network=m("core.network"),
        registry=m("core.registry"), scheduler=m("serving.scheduler"),
    )


def _scheduler(ns, t_sla_ms=1_000.0, seed=0):
    P = ns.registry.ModelProfile
    reg = ns.registry.ModelRegistry([P("stub-a", 40.0, 30.0, 2.0), P("stub-b", 80.0, 60.0, 4.0)])
    return ns.scheduler.MDInferenceScheduler(
        reg, P("stub-hedge", 35.0, 20.0, 2.0),
        ns.scheduler.SchedulerConfig(t_sla_ms=t_sla_ms, seed=seed))


def _twin(fn, *args):
    out = []
    for pkg in PKGS:
        try:
            out.append(fn(_ns(pkg), *args))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    return out


# ---------------------------------------------------------------------------
# The law's unit cases.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [
    dict(target_wait_frac=0.0), dict(target_wait_frac=1.5),
    dict(low_water=0.9, high_water=0.5), dict(low_water=-0.1), dict(wait_alpha=0.0),
    dict(hysteresis=0), dict(increase_step=0), dict(decrease_factor=1.0),
    dict(decrease_factor=0.0), dict(min_pending=0), dict(min_pending=10, max_pending=5),
    dict(headroom_decay=1.0), dict(headroom_step_frac=-0.1),
], ids=lambda d: ",".join(d))
def test_controller_config_validation_twin(bad):
    j, t = _twin(lambda ns: ns.controller.ControllerConfig(**bad))
    assert t == j and t[0] == "ValueError"


@dataclasses.dataclass
class _Completion:
    queue_wait_ms: float


@dataclasses.dataclass
class _Stats:
    n_shed: int = 0


@dataclasses.dataclass
class _Tick:
    completions: list
    stats: _Stats


def _tick(waits=(), n_shed=0):
    return _Tick([_Completion(w) for w in waits], _Stats(n_shed))


class _SlowBackend:
    ewma_wall_ms = 250.0


# Each case: controller kwargs, queue kwargs, then steps — ("obs", waits,
# n_shed, backlog, now_ms[, backend]) or ("apply",).
LAW_CASES = {
    "single_overload_tick": (dict(hysteresis=2), dict(), [("obs", (), 3, 0, 0.0), ("apply",)]),
    "neutral_tick_resets_streak": (dict(hysteresis=2), dict(), [
        ("obs", (), 3, 0, 0.0), ("obs", (150.0,), 0, 0, 0.0), ("obs", (), 3, 0, 0.0),
        ("apply",)]),
    "overload_streak_halves": (dict(hysteresis=2), dict(max_pending=16, headroom=0.0),
                               [("obs", (), 3, 0, 0.0)] * 2 + [("apply",)]),
    "underload_streak_adds": (dict(hysteresis=2, increase_step=4, headroom_decay=0.5),
                              dict(max_pending=16, headroom=100.0),
                              [("obs", (1.0,), 0, 0, 0.0)] * 2 + [("apply",)]),
    "backlog_blocks_underload": (dict(hysteresis=2), dict(),
                                 [("obs", (1.0,), 0, 5, 0.0)] * 2 + [("apply",)]),
    "capacity_clamps": (dict(hysteresis=1, min_pending=4, max_pending=24), dict(max_pending=5),
                        [("obs", (), 1, 0, 0.0), ("apply",)]
                        + [("obs", (1.0,), 0, 0, 0.0), ("apply",)] * 40),
    "margin_clamps_to_sla_fraction": (dict(hysteresis=1, max_headroom_frac=0.8), dict(),
                                      [("obs", (5_000.0,), 2, 0, 0.0), ("apply",)] * 10),
    "persistent_overload_escalates": (dict(hysteresis=1, headroom_step_frac=0.5),
                                      dict(max_pending=64),
                                      [("obs", (), 1, 0, 0.0), ("apply",)] * 2),
    "retunes_logged_with_clock": (dict(hysteresis=1), dict(),
                                  [("obs", (), 1, 0, 1_234.0), ("apply",)]),
    "unbounded_queue_noop": (dict(hysteresis=1), None,
                             [("obs", (10_000.0,), 0, 0, 0.0), ("apply",)]),
    "no_evidence_no_touch": (dict(), dict(), [("apply",)]),
    "service_estimate_scheduler": (dict(), dict(), [("obs", (10.0,), 0, 0, 0.0)]),
    "service_estimate_backend": (dict(), dict(), [("obs", (10.0,), 0, 0, 0.0, "slow")]),
    "mixed_drift": (dict(hysteresis=2, wait_alpha=0.5), dict(max_pending=32, headroom=20.0),
                    [("obs", (w,), s, b, 50.0 * i) if i % 3 else ("apply",)
                     for i, (w, s, b) in enumerate(
                         zip(np.linspace(0.0, 900.0, 60).tolist() * 2, [0, 1, 0, 2] * 30,
                             [0, 0, 3] * 40))]),
}


def _run_law(ns, case):
    ctl_kw, q_kw, steps = LAW_CASES[case]
    sched = _scheduler(ns)
    c = ns.controller.AdmissionController(ns.controller.ControllerConfig(**ctl_kw))
    if q_kw is None:
        q = ns.admission.AdmissionQueue(ns.admission.AdmissionConfig())
    else:
        q = ns.admission.AdmissionQueue(ns.admission.AdmissionConfig(
            max_pending=q_kw.get("max_pending", 16), max_chunk=8, policy="shed",
            shed_headroom_ms=q_kw.get("headroom", 0.0)))
    before, trail = q.cfg, []
    for step in steps:
        if step[0] == "obs":
            _, waits, n_shed, backlog, now_ms, *rest = step
            kw = {"backend": _SlowBackend()} if rest else {}
            c.observe(_tick(waits, n_shed), scheduler=sched, now_ms=now_ms, backlog=backlog, **kw)
            trail.append(("obs", c.service_est_ms))
        else:
            trail.append(("apply", c.apply(q), q.cfg.max_pending, q.cfg.shed_headroom_ms,
                          q.cfg is before))
    return dict(trail=trail, n_retunes=c.n_retunes, log=list(c.log), n_ticks=c.n_ticks,
                final=(q.cfg.max_pending, q.cfg.shed_headroom_ms))


@pytest.mark.parametrize("case", sorted(LAW_CASES))
def test_controller_law_twin(case):
    j, t = _twin(_run_law, case)
    assert t == j


def test_controller_law_cases_reach_the_reference_outcomes():
    """The twins above compare packages; these are the reference's own
    expectations, read off the port's runs."""
    ns = _ns("repro_torch")
    assert _run_law(ns, "overload_streak_halves")["final"][0] == 8
    assert _run_law(ns, "underload_streak_adds")["final"] == (20, 50.0)
    assert _run_law(ns, "capacity_clamps")["final"] == (24, 0.0)
    assert _run_law(ns, "margin_clamps_to_sla_fraction")["final"][1] == pytest.approx(800.0)
    r = _run_law(ns, "retunes_logged_with_clock")
    assert r["log"][0][0] == 1_234.0
    assert _run_law(ns, "service_estimate_backend")["trail"][0][1] == 250.0
    assert _run_law(ns, "service_estimate_scheduler")["trail"][0][1] == pytest.approx(30.0)
    assert _run_law(ns, "no_evidence_no_touch")["trail"][0][-1] is True


# ---------------------------------------------------------------------------
# The drift gauntlet's seeded twins (fixed-wall harness, no sleep).
# ---------------------------------------------------------------------------
SLA_MS, WINDOW_MS, SERVICE_MS_PER_ROW = 1_000.0, 50.0, 6.0
WALLS = {"stub-a": 30.0, "stub-b": 60.0}


def _fixed_wall_backend(ns, scale=1.0):
    class FixedWallBackend(ns.backend.ExecutionBackend):
        def __init__(self, scale):
            super().__init__()
            self.scale = float(scale)

        def register(self, v):
            self.variants[v.name] = v

        def generate(self, name, tokens, n_steps):
            out = np.zeros((np.shape(tokens)[0], n_steps), dtype=np.int32)
            return out, float(WALLS[name]) * self.scale

        def run_batch(self, name, batch, n_steps):
            return self.generate(name, batch, n_steps)

    return FixedWallBackend(scale)


def _register_zoo(ns, backend):
    for name, quality in zip(STUB_NAMES, (40.0, 80.0)):
        backend.register(ns.backend.Variant(name, None, None, quality))


def _scenario(ns, name):
    """(trace, backend, service_model, on_tick) of one gauntlet scenario."""
    lg, net = ns.loadgen, ns.network
    state = {"factor": 1.0}
    service = lambda res: SERVICE_MS_PER_ROW * res.stats.max_replica_rows  # noqa: E731
    on_tick = None
    if name == "flap":
        backend = ns.cluster.ClusterBackend(
            [_fixed_wall_backend(ns, s) for s in (1.0, 2.0)], router="least_inflight",
            specs=[ns.cluster.ReplicaSpec(weight=2.0),
                   ns.cluster.ReplicaSpec(weight=1.0, service_scale=2.0)], seed=0)
    else:
        backend = _fixed_wall_backend(ns)
    _register_zoo(ns, backend)
    if name == "diurnal":
        trace = lg.make_trace(1_200, lg.DiurnalArrivals(trough_rps=20.0, peak_rps=600.0),
                              net.university_trace(), seed=5)
    elif name == "spike":
        spike = lg.SpikeArrivals(rate_rps=100.0, spike_factor=30.0, spike_start=0.4,
                                 spike_stop=0.6)
        trace = lg.make_trace(800, spike, net.university_trace(), seed=7)
        horizon = float(trace.arrival_ms[-1])

        def on_tick(t_ms, result):
            state["factor"] = spike.service_factor(t_ms, horizon)
            backend.scale = state["factor"]

        service = lambda res: (  # noqa: E731
            SERVICE_MS_PER_ROW * state["factor"] * res.stats.max_replica_rows)
    elif name == "flap":
        trace = lg.make_trace(800, lg.PoissonArrivals(140.0), net.university_trace(), seed=11)
        horizon = float(trace.arrival_ms[-1])

        def on_tick(t_ms, result):
            frac = t_ms / horizon
            drained = backend.pool.replicas[0].health.draining
            if 0.3 <= frac < 0.6:
                if not drained:
                    backend.drain(0)
            elif drained:
                backend.rejoin(0)

        def service(res):
            rows = res.stats.replica_rows
            if not rows:
                return SERVICE_MS_PER_ROW * res.stats.n_requests
            return max(SERVICE_MS_PER_ROW * r * (1.0, 2.0)[rid] for rid, r in rows.items())
    else:  # network_swap
        trace = lg.make_trace(800, lg.PoissonArrivals(180.0),
                              net.SwitchedNetwork(net.university_trace(), net.lte_trace(), 0.5),
                              seed=13)
    return trace, backend, service, on_tick


def _gauntlet_run(ns, name, adaptive):
    trace, backend, service, on_tick = _scenario(ns, name)
    A = ns.admission.AdmissionConfig
    controller = (ns.controller.AdmissionController(ns.controller.ControllerConfig(
        target_wait_frac=0.1, wait_alpha=0.7, max_pending=64)) if adaptive else None)
    loop = ns.loop.ServingLoop(
        _scheduler(ns, t_sla_ms=SLA_MS), backend, None, dispatch="sync",
        admission=A(max_pending=64 if adaptive else 16, max_chunk=16, policy="shed"),
        controller=controller)
    done, metrics = loop.drain_trace(trace, WINDOW_MS, tokens_for=lambda i: np.zeros(4, np.int32),
                                     n_steps=2, service_model=service, on_tick=on_tick)
    return dict(
        completions=[(c.rid, c.model_name, c.latency_ms, c.queue_wait_ms, c.race_resolution,
                      c.replica) for c in done],
        p99=metrics.p99_latency_ms, goodput=metrics.goodput, rejected=metrics.n_rejected,
        log=None if controller is None else list(controller.log),
        retunes=None if controller is None else controller.n_retunes)


@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
@pytest.mark.parametrize("scenario", ["diurnal", "spike", "flap", "network_swap"])
def test_drift_gauntlet_seeded_twins(scenario, adaptive):
    j, t = _twin(_gauntlet_run, scenario, adaptive)
    assert t == j
    assert t["completions"] and t["rejected"] >= 0
    if adaptive and scenario != "network_swap":
        assert t["retunes"] > 0  # the drift made the law act


# ---------------------------------------------------------------------------
# The serve driver's flags, errors and summary lines.
# ---------------------------------------------------------------------------
class _Parsed(Exception):
    pass


def _parser(pkg, monkeypatch):
    serve = importlib.import_module(f"{pkg}.launch.serve")
    grabbed = {}

    def grab(self, *a, **k):
        grabbed["ap"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            serve.main([])
    return {a.dest: a for a in grabbed["ap"]._actions if a.dest != "help"}


def test_serve_flags_equal_the_jax_drivers_plus_device(monkeypatch):
    jact, act = _parser("repro", monkeypatch), _parser("repro_torch", monkeypatch)
    assert set(act) - set(jact) == {"device"} and set(jact) <= set(act)
    for dest, ja in jact.items():
        a = act[dest]
        assert (a.option_strings, a.default, a.choices, a.type, a.nargs, a.const) == \
            (ja.option_strings, ja.default, ja.choices, ja.type, ja.nargs, ja.const), dest
    assert act["device"].default == "cuda"


@pytest.mark.parametrize("argv", [
    ["--continuous", "--replicas", "2"],
    ["--continuous", "--shard-zoo"],
    ["--continuous", "--transport", "inline"],
    ["--controller"],
    ["--controller", "--max-pending", "8", "--controller-target-frac", "0"],
    ["--replicas", "0"],
    ["--replica-spec", "2:8:0.5,1"],
    ["--replicas", "2", "--replica-spec", "2:8:0.5"],
    ["--tenants", "a:0"],
    ["--overload-policy", "shed"],
    ["--stream"],
    ["--kill-replica-at", "100"],
    ["--router", "random"],
    ["--transport", "tcp"],
], ids=lambda a: " ".join(a))
def test_serve_argument_errors_match_the_jax_driver(argv, capsys):
    msgs = []
    for pkg in PKGS:
        serve = importlib.import_module(f"{pkg}.launch.serve")
        extra = ["--device", "cpu"] if pkg == "repro_torch" else []
        with pytest.raises(SystemExit) as e:
            serve.main(argv + extra + ["--requests", "2", "--prompt", "4", "--gen", "1"])
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msgs[1] == msgs[0]


CLI = ["--requests", "30", "--prompt", "8", "--gen", "2", "--dispatch", "sync", "--rate", "10",
       "--tenants", "interactive:4,batch:1:batch:32", "--controller", "--max-pending", "8",
       "--overload", "2", "--overload-policy", "shed", "--replicas", "2", "--transport",
       "inline", "--kill-replica-at", "100", "--rejoin-replica-at", "300"]
LABELS = ("admission", "controller", "tenancy", "cluster", "queue wait", "p50/p99 latency",
          "aggregate quality", "SLA attainment", "hedge reliance", "race resolution")


@pytest.fixture(scope="module")
def serve_runs():
    import contextlib
    import io

    out = {}
    for pkg in PKGS:
        serve = importlib.import_module(f"{pkg}.launch.serve")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert serve.main(CLI + (["--device", "cpu"] if pkg == "repro_torch" else [])) == 0
        out[pkg] = buf.getvalue()
    return out


def _summary(text):
    lines = {}
    for line in text.splitlines():
        m = re.match(r"^([a-zA-Z0-9/ ]+?)\s*: (.*)$", line)
        if m and m.group(1) in LABELS:
            lines[m.group(1)] = m.group(2)
    return lines


def test_serve_cli_prints_the_jax_drivers_summary_lines(serve_runs):
    j, t = _summary(serve_runs["repro"]), _summary(serve_runs["repro_torch"])
    assert set(t) == set(j) == set(LABELS)
    # The numbers follow the tiers' measured walls (selection, shedding and
    # the controller's service estimate read them), so the lines are held
    # to the same form with every number masked.
    mask = lambda line: re.sub(r"\d+(\.\d+)?", "#", line)  # noqa: E731
    for label in LABELS:
        assert mask(t[label]) == mask(j[label]), label
    assert re.search(r"r0=\d+%.* r1=\d+%", t["cluster"])
    for text in (serve_runs["repro"], serve_runs["repro_torch"]):
        assert "!! killed replica 0" in text and "!! rejoined replica 0" in text
    lanes = [line for line in serve_runs["repro_torch"].splitlines() if line.startswith("  lane ")]
    assert {line.split()[1] for line in lanes} == {"interactive", "batch"}
    assert "device=cpu" in serve_runs["repro_torch"]
