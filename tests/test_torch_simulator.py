"""The port's LM-zoo profiles and the paper's simulator against the JAX
package, on the CPU.

* ``serving.profiles``: the quality table, ``estimate_ms``,
  ``lm_zoo_registry`` (the ``roofline_json`` refinement included) and
  ``ONDEVICE_TIER`` equal to the JAX package's (rtol 1e-12) once the H100
  table is replaced by the JAX package's TPU v5e constants; the H100 table
  itself holds the data sheet's.
* ``core.simulator`` with ``device="cpu"``: the deterministic algorithms'
  ``model_index``, every latency array and the metrics exactly equal to
  the JAX package's; the sampled ones (``mdinference``, ``pure_random``,
  ``related_random``) draw from the same probability rows (rtol 1e-6),
  every draw outside selection is the same, and aggregate accuracy and SLA
  attainment agree within 4 standard errors at 10 000 requests (the two
  packages draw their selection uniforms from different generators).
* the paper-figure assertions of tests/test_simulator.py, on the port.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.serving.profiles as jprofiles  # noqa: E402
from repro.configs import mdinference_zoo as jzoo  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import network as jnetwork  # noqa: E402
from repro.core import simulator as jsimulator  # noqa: E402
from repro_torch.configs.mdinference_zoo import ablation_zoo, paper_zoo  # noqa: E402
from repro_torch.core import baselines, selection  # noqa: E402
from repro_torch.core.network import (  # noqa: E402
    FixedCVNetwork,
    NoisyEstimator,
    residential_trace,
    university_trace,
)
from repro_torch.core.simulator import SimConfig, run_simulation  # noqa: E402
import repro_torch.serving.profiles as profiles  # noqa: E402

N = 10_000


# ---------------------------------------------------------------------------
# Profiles.
# ---------------------------------------------------------------------------
@pytest.fixture
def v5e(monkeypatch):
    """The port's roofline table set to the JAX package's constants."""
    monkeypatch.setattr(profiles, "H100", {"peak_flops": jprofiles.V5E["peak_flops"],
                                           "hbm_bw": jprofiles.V5E["hbm_bw"],
                                           "link_bw": jprofiles.V5E["ici_bw"]})


def test_h100_table_is_the_data_sheet():
    assert profiles.H100 == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9}
    assert profiles.QUALITY == jprofiles.QUALITY


@pytest.mark.parametrize("args", [(1e15, 1e12, 0.0, 8), (1e12, 1e13, 5e11, 1), (1e9, 1e6, 1e12, 4)])
def test_estimate_ms_matches_jax(v5e, args):
    np.testing.assert_allclose(profiles.estimate_ms(*args), jprofiles.estimate_ms(*args),
                               rtol=1e-12, atol=0)


def _registries_equal(reg, jreg):
    assert reg.names == jreg.names
    np.testing.assert_array_equal(reg.accuracy, jreg.accuracy)
    np.testing.assert_allclose(reg.mu, jreg.mu, rtol=1e-12, atol=0)
    np.testing.assert_allclose(reg.sigma, jreg.sigma, rtol=1e-12, atol=0)


@pytest.mark.parametrize("kwargs", [
    {}, {"chips": 1}, {"prompt": 128, "gen_tokens": 16, "chips": 1}, {"sigma_frac": 0.1},
], ids=["default", "one-chip", "serve-shape", "sigma"])
def test_lm_zoo_registry_matches_jax(v5e, kwargs):
    _registries_equal(profiles.lm_zoo_registry(**kwargs), jprofiles.lm_zoo_registry(**kwargs))


def test_lm_zoo_registry_roofline_refinement_matches_jax(v5e, tmp_path):
    cells = [
        {"arch": "olmoe-1b-7b", "shape": "decode_32k", "mesh": "single_pod",
         "terms_s": {"compute": 0.002, "memory": 0.005}, "global_batch": 4},
        {"arch": "xlstm-350m", "shape": "decode_32k", "mesh": "single_pod",
         "terms_s": {"compute": 0.001, "memory": 0.0004}},
        {"arch": "qwen3-14b", "shape": "prefill_8k", "mesh": "single_pod",
         "terms_s": {"compute": 9.0}},
    ]
    path = tmp_path / "roofline.json"
    path.write_text(json.dumps({"cells": cells}))
    reg = profiles.lm_zoo_registry(roofline_json=str(path))
    _registries_equal(reg, jprofiles.lm_zoo_registry(roofline_json=str(path)))
    assert reg.names != profiles.lm_zoo_registry().names or not np.array_equal(
        reg.mu, profiles.lm_zoo_registry().mu)  # the refinement took effect
    _registries_equal(profiles.lm_zoo_registry(roofline_json=str(tmp_path / "absent.json")),
                      jprofiles.lm_zoo_registry(roofline_json=str(tmp_path / "absent.json")))


def test_ondevice_tier_matches_jax(v5e):
    got = profiles._arch_latency_ms("xlstm-350m", prompt=512, gen_tokens=64, chips=1)
    np.testing.assert_allclose(got, jprofiles.ONDEVICE_TIER.mu_ms, rtol=1e-12, atol=0)
    tier = profiles.ONDEVICE_TIER  # built at import, from the H100 table
    assert (tier.name, tier.accuracy, tier.sigma_ms) == (
        jprofiles.ONDEVICE_TIER.name, jprofiles.ONDEVICE_TIER.accuracy,
        jprofiles.ONDEVICE_TIER.sigma_ms)


def test_h100_profiles_are_the_roofline_of_the_data_sheet():
    """Without the patch: xlstm-350m's request on one card is its weights
    streamed 65 times (prefill and 64 decode steps) at 3.35 TB/s, the
    prefill's compute at 989 TFLOP/s being smaller."""
    from repro_torch.configs.archs import get_config

    cfg = get_config("xlstm-350m")
    n = cfg.param_count()
    state = 4 * cfg.d_model * 4 * len(cfg.layer_kinds())
    want = 1e3 * (max(2 * n * 512 / 989e12, 2 * n / 3.35e12)
                  + 64 * max(2 * n / 989e12, (2 * n + state) / 3.35e12))
    np.testing.assert_allclose(profiles.ONDEVICE_TIER.mu_ms, want, rtol=1e-12)
    reg = profiles.lm_zoo_registry(chips=1)
    assert reg.names[-1] == "llama4-scout-17b-a16e" and len(reg.names) == 8
    # The roofline of a configuration as served: a depth cut streams fewer weights.
    scout = get_config("llama4-scout-17b-a16e")
    full = profiles.roofline_ms(scout, prompt=128, gen_tokens=16, chips=1)
    assert full == profiles._arch_latency_ms(scout.name, prompt=128, gen_tokens=16, chips=1)
    cut = profiles.roofline_ms(get_config(scout.name, n_layers=4), prompt=128, gen_tokens=16,
                               chips=1)
    assert 0 < cut < full / 5


# ---------------------------------------------------------------------------
# Selection.
# ---------------------------------------------------------------------------
def test_sample_rows_is_the_scheduler_inverse_cdf():
    """The count of float32 running sums ``<= u * total`` compared in float64,
    capped at N - 1: the serving scheduler's numpy draw, exactly."""
    rng = np.random.default_rng(0)
    probs = rng.random((4000, 7)).astype(np.float32)
    probs[rng.random(probs.shape) < 0.4] = 0.0
    probs[:10] = 0.0
    probs[:10, 3] = 1.0  # one-hot rows
    u = rng.random(4000)
    u[:5] = 0.0
    cum = np.cumsum(probs, axis=1)
    want = np.minimum((cum <= u[:, None] * cum[:, -1:]).sum(axis=1), probs.shape[1] - 1)
    got = selection.sample_rows(u, torch.from_numpy(probs))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[:10] == 3).all()


def test_select_batch_matches_jax_probabilities_and_fallback():
    from repro.core.selection import select_batch as jselect
    import jax

    reg = ablation_zoo()
    budgets = np.linspace(-20.0, 400.0, 512).astype(np.float32)
    u = np.random.default_rng(1).random(512)
    sel = selection.select_batch(u, reg.accuracy, reg.mu, reg.sigma, budgets)
    jsel = jselect(jax.random.key(0), jnp.asarray(reg.accuracy), jnp.asarray(reg.mu),
                   jnp.asarray(reg.sigma), jnp.asarray(budgets))
    np.testing.assert_allclose(sel.probabilities.numpy(), np.asarray(jsel.probabilities),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(sel.base_index.numpy(), np.asarray(jsel.base_index))
    np.testing.assert_array_equal(sel.fallback.numpy(), np.asarray(jsel.fallback))
    assert sel.fallback.numpy()[:3].all()
    fastest = int(np.argmin(reg.mu))
    assert (sel.index.numpy()[sel.fallback.numpy()] == fastest).all()
    probs = sel.probabilities.numpy()
    assert (probs[np.arange(512), sel.index.numpy()] > 0).all()  # draws land on support


def test_get_algorithm_matches_jax():
    assert sorted(baselines.ALGORITHMS) == sorted(jbaselines.ALGORITHMS)
    with pytest.raises(KeyError) as jerr:
        jbaselines.get_algorithm("nope")
    with pytest.raises(KeyError) as terr:
        baselines.get_algorithm("nope")
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# The simulator against the JAX package.
# ---------------------------------------------------------------------------
SCENARIOS = {
    "paper-cv0.5-sla250": dict(zoo="paper", net=("FixedCVNetwork", (100.0, 0.5)), sla=250.0),
    "residential-noisy-queue-sla150": dict(
        zoo="ablation", net=("residential_trace", ()), sla=150.0, noisy=0.3,
        queue_delay_mean_ms=40.0, queue_spike_prob=0.1),
}


def _configs(scenario, alg, dup, seed=0):
    sc = SCENARIOS[scenario]
    kind, args = sc["net"]
    extra = {k: sc[k] for k in ("queue_delay_mean_ms", "queue_spike_prob") if k in sc}
    out = []
    for zoo_mod, net_mod, cls in ((jzoo, jnetwork, jsimulator.SimConfig),
                                  (None, None, SimConfig)):
        if zoo_mod is None:
            zoo = paper_zoo() if sc["zoo"] == "paper" else ablation_zoo()
            net = {"FixedCVNetwork": FixedCVNetwork,
                   "residential_trace": residential_trace}[kind](*args)
            est = NoisyEstimator(sc["noisy"]) if "noisy" in sc else None
        else:
            zoo = zoo_mod.paper_zoo() if sc["zoo"] == "paper" else zoo_mod.ablation_zoo()
            net = getattr(net_mod, kind)(*args)
            est = net_mod.NoisyEstimator(sc["noisy"]) if "noisy" in sc else None
        kw = dict(registry=zoo, algorithm=alg, t_sla_ms=sc["sla"], n_requests=N, network=net,
                  duplication=dup, seed=seed, **extra)
        if est is not None:
            kw["estimator"] = est
        out.append(cls(**kw))
    return out


DETERMINISTIC = ["static_greedy", "budget_greedy", "static_accuracy", "static_latency",
                 "related_accurate", "oracle"]


@pytest.mark.parametrize("dup", [False, True], ids=["plain", "dup"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("alg", DETERMINISTIC)
def test_deterministic_algorithms_equal_jax(alg, scenario, dup):
    jcfg, cfg = _configs(scenario, alg, dup)
    j, r = jsimulator.run_simulation(jcfg), run_simulation(cfg, device="cpu")
    np.testing.assert_array_equal(r.model_index, j.model_index)
    np.testing.assert_array_equal(r.fallback, j.fallback)
    for key in ("t_nw_ms", "exec_ms", "remote_latency_ms"):
        np.testing.assert_array_equal(getattr(r, key), getattr(j, key), err_msg=key)
    if dup:
        np.testing.assert_array_equal(r.used_remote, j.used_remote)
    else:
        assert r.used_remote is None and j.used_remote is None
    assert dataclasses.asdict(r.metrics) == dataclasses.asdict(j.metrics)


def _per_request_accuracy(res, reg, ondevice):
    acc = reg.accuracy[res.model_index]
    return acc if res.used_remote is None else np.where(res.used_remote, acc, ondevice.accuracy)


SAMPLED = ["mdinference", "pure_random", "related_random"]
SAMPLED_SETTINGS = {
    "ablation-sla250": ("paper-cv0.5-sla250", 250.0, "ablation"),
    "ablation-sla120": ("paper-cv0.5-sla250", 120.0, "ablation"),
    "residential-sla150": ("residential-noisy-queue-sla150", 150.0, "ablation"),
}


@pytest.mark.parametrize("dup", [False, True], ids=["plain", "dup"])
@pytest.mark.parametrize("setting", sorted(SAMPLED_SETTINGS))
@pytest.mark.parametrize("alg", SAMPLED)
def test_sampled_algorithms_agree_with_jax(alg, setting, dup):
    scenario, sla, zoo = SAMPLED_SETTINGS[setting]
    jcfg, cfg = _configs(scenario, alg, dup)
    jcfg = dataclasses.replace(jcfg, t_sla_ms=sla, registry=jzoo.ablation_zoo())
    cfg = dataclasses.replace(cfg, t_sla_ms=sla, registry=ablation_zoo())
    j, r = jsimulator.run_simulation(jcfg), run_simulation(cfg, device="cpu")
    # Every draw outside selection is the reference's.
    np.testing.assert_array_equal(r.t_nw_ms, j.t_nw_ms)
    same = r.model_index == j.model_index
    np.testing.assert_array_equal(r.exec_ms[same], j.exec_ms[same])
    np.testing.assert_array_equal(r.fallback, j.fallback)
    # Both draw from the same probability rows.
    reg = cfg.registry
    jfn = jbaselines.POLICY_PROBABILITIES[alg]
    tfn = baselines.POLICY_PROBABILITIES[alg]
    budgets = np.float32(sla) - r.t_nw_ms[:512].astype(np.float32)
    args = (reg.accuracy, reg.mu, reg.sigma, np.float32(sla), budgets)
    np.testing.assert_allclose(
        tfn(*(torch.as_tensor(np.asarray(a, np.float32)) for a in args))[0].numpy(),
        np.asarray(jfn(*(jnp.asarray(np.asarray(a, np.float32)) for a in args))[0]),
        rtol=1e-6, atol=1e-7)
    # Aggregates within 4 standard errors.
    acc = _per_request_accuracy(r, reg, cfg.ondevice)
    jacc = _per_request_accuracy(j, reg, jcfg.ondevice)
    np.testing.assert_allclose(acc.mean(), r.metrics.aggregate_accuracy, rtol=1e-6)
    se = np.sqrt(acc.var() / N + jacc.var() / N)
    assert abs(r.metrics.aggregate_accuracy - j.metrics.aggregate_accuracy) <= 4 * se + 1e-9
    p, q = r.metrics.sla_attainment, j.metrics.sla_attainment
    se = np.sqrt(p * (1 - p) / N + q * (1 - q) / N)
    assert abs(p - q) <= 4 * se + 1e-9


def test_run_simulation_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(registry=paper_zoo(), n_requests=10, network=FixedCVNetwork(100.0, 0.5))
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        run_simulation(cfg)
    assert run_simulation(cfg, device="cpu").model_index.shape == (10,)
    with pytest.raises(ValueError, match="network is required"):
        run_simulation(SimConfig(registry=paper_zoo()), device="cpu")


def test_custom_algorithm_and_seed_stream():
    """A callable algorithm gets the request uniforms and float32 tensors on
    the device; the uniforms are a stream of their own, fixed by the seed."""
    seen = {}

    def first(uniforms, accuracy, mu, sigma, t_sla, t_budget):
        seen.update(u=np.asarray(uniforms), dtype=accuracy.dtype, device=accuracy.device)
        return (torch.zeros(t_budget.shape, dtype=torch.int32),
                torch.zeros(t_budget.shape, dtype=torch.bool))

    cfg = SimConfig(registry=paper_zoo(), algorithm=first, n_requests=100,
                    network=FixedCVNetwork(100.0, 0.5), seed=3)
    res = run_simulation(cfg, device="cpu")
    assert (res.model_index == 0).all()
    assert seen["dtype"] == torch.float32 and seen["device"].type == "cpu"
    assert seen["u"].shape == (100,) and 0 <= seen["u"].min() and seen["u"].max() < 1
    u3 = seen["u"]
    run_simulation(cfg, device="cpu")
    np.testing.assert_array_equal(seen["u"], u3)
    run_simulation(dataclasses.replace(cfg, seed=4), device="cpu")
    assert not np.array_equal(seen["u"], u3)


@pytest.mark.cuda
def test_card_and_cpu_choose_the_same_models():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for alg in sorted(baselines.ALGORITHMS):
        for dup in (False, True):
            cfg = SimConfig(registry=ablation_zoo(), algorithm=alg, t_sla_ms=150.0,
                            n_requests=N, network=FixedCVNetwork(100.0, 0.5), duplication=dup)
            a, b = run_simulation(cfg, device="cuda"), run_simulation(cfg, device="cpu")
            np.testing.assert_array_equal(a.model_index, b.model_index)
            assert a.metrics == b.metrics


# ---------------------------------------------------------------------------
# tests/test_simulator.py's paper-figure assertions, on the port.
# ---------------------------------------------------------------------------
ZOO = paper_zoo()
NET = FixedCVNetwork(100.0, 0.5)  # the paper's 100ms +- 50ms default


def run(alg, sla, *, net=NET, dup=False, seed=0, zoo=ZOO, n=8000, **kw):
    return run_simulation(
        SimConfig(registry=zoo, algorithm=alg, t_sla_ms=sla, n_requests=n, network=net,
                  duplication=dup, seed=seed, **kw),
        device="cpu")


def test_fig3_greedy_violates_at_low_sla():
    g = run("static_greedy", 150)
    m = run("mdinference", 150)
    assert g.metrics.sla_attainment < 0.3
    assert m.metrics.sla_attainment > 0.75


def test_fig3_latency_reduction_vs_greedy():
    g = run("static_greedy", 115)
    m = run("mdinference", 115)
    reduction = 1.0 - m.metrics.mean_latency_ms / g.metrics.mean_latency_ms
    assert reduction > 0.30  # paper: up to 42-43 %


def test_fig3_accuracy_converges_at_250():
    g = run("static_greedy", 250)
    m = run("mdinference", 250)
    assert m.metrics.aggregate_accuracy > 80.0
    assert abs(g.metrics.aggregate_accuracy - m.metrics.aggregate_accuracy) < 3.0


def test_fig3b_low_sla_uses_fastest_model():
    m = run("mdinference", 25)
    assert m.metrics.model_usage.get("MobileNetV1 0.25", 0.0) > 0.90


def test_fig3b_high_sla_uses_nasnet_large():
    m = run("mdinference", 300)
    assert m.metrics.model_usage.get("NasNet Large", 0.0) > 0.5


def test_inceptionresnet_never_selected():
    m = run("mdinference", 300)
    assert m.metrics.model_usage.get("InceptionResNetV2", 0.0) < 0.01


def test_fig4_sla100_low_attainment_on_stable_network():
    m = run("mdinference", 100, net=FixedCVNetwork(100.0, 0.0))
    assert m.metrics.sla_attainment < 0.5


def test_fig4_sla100_attainment_grows_with_cv():
    lo = run("mdinference", 100, net=FixedCVNetwork(100.0, 0.2))
    hi = run("mdinference", 100, net=FixedCVNetwork(100.0, 1.0))
    assert hi.metrics.sla_attainment > lo.metrics.sla_attainment


@pytest.mark.parametrize("cv", [0.0, 0.5, 1.0])
def test_fig4_sla250_high_accuracy_across_cv(cv):
    m = run("mdinference", 250, net=FixedCVNetwork(100.0, cv))
    assert m.metrics.aggregate_accuracy > 75.0, cv


def test_fig6_ordering():
    zoo = ablation_zoo()
    res = {alg: run(alg, 250, zoo=zoo).metrics.aggregate_accuracy
           for alg in ["pure_random", "related_random", "related_accurate", "mdinference"]}
    assert res["related_accurate"] >= res["related_random"]
    assert res["mdinference"] >= res["related_random"]
    assert res["related_random"] > res["pure_random"] - 2.0


def test_fig6_pure_random_flat_latency():
    a = run("pure_random", 100)
    b = run("pure_random", 300)
    assert abs(a.metrics.mean_latency_ms - b.metrics.mean_latency_ms) < 5.0


@pytest.mark.parametrize(
    "trace,md_acc,md_rel,sa_acc,sa_rel",
    [
        (university_trace(), 82.39, 0.0026, 81.09, 0.0367),
        (residential_trace(), 80.43, 0.0316, 73.11, 0.2303),
    ],
    ids=["university", "residential"],
)
def test_table4(trace, md_acc, md_rel, sa_acc, sa_rel):
    md = run("mdinference", 250, net=trace, dup=True)
    sa = run("static_accuracy", 250, net=trace, dup=True)
    assert md.metrics.sla_attainment == 1.0  # duplication bounds latency
    assert sa.metrics.sla_attainment == 1.0
    assert abs(md.metrics.aggregate_accuracy - md_acc) < 1.5
    assert abs(md.metrics.ondevice_reliance - md_rel) < 0.01
    assert abs(sa.metrics.aggregate_accuracy - sa_acc) < 1.5
    assert abs(sa.metrics.ondevice_reliance - sa_rel) < 0.03
    assert md.metrics.aggregate_accuracy > sa.metrics.aggregate_accuracy


@pytest.mark.parametrize("sla", [100.0, 150.0, 250.0])
def test_duplication_never_violates_sla(sla):
    m = run("mdinference", sla, net=residential_trace(), dup=True)
    assert m.metrics.sla_attainment == 1.0, sla


def test_aggregate_accuracy_gain_over_ondevice_only():
    md = run("mdinference", 250, net=university_trace(), dup=True)
    assert md.metrics.aggregate_accuracy - 41.4 > 39.0


def test_noisy_estimator_degrades_gracefully():
    exact = run("mdinference", 250)
    noisy = run("mdinference", 250, estimator=NoisyEstimator(0.3))
    assert noisy.metrics.sla_attainment > 0.9 * exact.metrics.sla_attainment


def test_seed_determinism():
    a = run("mdinference", 250, seed=7)
    b = run("mdinference", 250, seed=7)
    assert np.array_equal(a.model_index, b.model_index)
    assert a.metrics == b.metrics
