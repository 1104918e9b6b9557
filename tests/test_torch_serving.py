"""The port's policy core and serving path against the JAX package, on the CPU.

* every probability-form policy: allclose (1e-6) with the JAX one;
* ``decide_batch`` as seeded twins: identical model choices and hedge
  flags, except a row whose uniform lies within 1e-6 of a CDF boundary
  (the policies compute probabilities in float32);
* ``JitBackend.generate``: token-equal to the JAX ``JitBackend`` on bridged
  weights, batch 1 to 4;
* a seeded sync ``drain_trace`` over fixed-wall stub tiers: the same
  decisions, race outcomes and conservation on both sides;
* the port's ``serve.main`` completes on the CPU when asked for it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.backend as jbackend  # noqa: E402
from repro.configs.mdinference_zoo import paper_zoo as j_paper_zoo  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import selection as jselection  # noqa: E402
from repro.core.network import LognormalNetwork as JLognormal  # noqa: E402
from repro.core.registry import ModelProfile as JProfile  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.loadgen import PoissonArrivals as JPoisson  # noqa: E402
from repro.serving.loadgen import make_trace as j_make_trace  # noqa: E402
from repro.serving.loop import ServingLoop as JLoop  # noqa: E402
from repro.serving.scheduler import MDInferenceScheduler as JScheduler  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
import repro_torch.serving.backend as backend  # noqa: E402
from repro_torch.configs.mdinference_zoo import paper_zoo  # noqa: E402
from repro_torch.core import baselines, selection  # noqa: E402
from repro_torch.core.network import LognormalNetwork  # noqa: E402
from repro_torch.core.registry import ModelProfile  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import tier_configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.loadgen import PoissonArrivals, make_trace  # noqa: E402
from repro_torch.serving.loop import ServingLoop  # noqa: E402
from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig  # noqa: E402


def _profile_arrays():
    zoo = paper_zoo()
    return (zoo.accuracy.astype(np.float32), zoo.mu.astype(np.float32),
            zoo.sigma.astype(np.float32))


# ---------------------------------------------------------------------------
# Policies.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", sorted(jbaselines.POLICY_PROBABILITIES))
def test_policy_probabilities_match_jax(policy):
    acc, mu, sigma = _profile_arrays()
    budgets = np.random.default_rng(7).uniform(-20.0, 160.0, 512).astype(np.float32)
    jfn = jax.jit(jbaselines.POLICY_PROBABILITIES[policy])  # as the JAX scheduler runs it
    fn = baselines.POLICY_PROBABILITIES[policy]
    jp, jb, jf = jfn(jnp.asarray(acc), jnp.asarray(mu), jnp.asarray(sigma),
                     jnp.float32(250.0), jnp.asarray(budgets))
    p, b, f = fn(torch.as_tensor(acc), torch.as_tensor(mu), torch.as_tensor(sigma),
                 torch.tensor(250.0), torch.as_tensor(budgets))
    assert p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


@pytest.mark.parametrize("utility_power", [1.0, 2.5])
def test_selection_probabilities_and_select_ref_match_jax(utility_power):
    acc, mu, sigma = _profile_arrays()
    budgets = np.random.default_rng(8).uniform(0.0, 130.0, 256).astype(np.float32)
    jfn = jax.jit(jselection.selection_probabilities, static_argnames=("utility_power",))
    jp, jb, jf = jfn(jnp.asarray(acc), jnp.asarray(mu), jnp.asarray(sigma),
                     jnp.asarray(budgets), utility_power=utility_power)
    p, b, f = selection.selection_probabilities(acc, mu, sigma, budgets,
                                                utility_power=utility_power)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    jreg, reg = j_paper_zoo(), paper_zoo()
    jrng, rng = np.random.default_rng(0), np.random.default_rng(0)
    for t in budgets[:32]:
        assert dataclasses.asdict(selection.select_ref(reg, float(t), rng)) == \
            dataclasses.asdict(jselection.select_ref(jreg, float(t), jrng))


@pytest.mark.parametrize("algorithm", ["mdinference", "related_random", "static_greedy"])
def test_decide_batch_seeded_twins(algorithm):
    jsched = JScheduler(j_paper_zoo(), JProfile("dev", 41.4, 10.0, 1.0),
                        JSchedulerConfig(t_sla_ms=150.0, seed=3, algorithm=algorithm))
    sched = MDInferenceScheduler(paper_zoo(), ModelProfile("dev", 41.4, 10.0, 1.0),
                                 SchedulerConfig(t_sla_ms=150.0, seed=3, algorithm=algorithm))
    rng = np.random.default_rng(11)
    near_boundary = 0
    for _ in range(8):
        t_nw = rng.uniform(0.0, 170.0, 256)
        u = rng.random(256)
        jd = jsched.decide_batch(t_nw, uniforms=u)
        d = sched.decide_batch(t_nw, uniforms=u)
        np.testing.assert_array_equal(d.hedged, jd.hedged)
        np.testing.assert_array_equal(d.base_index, jd.base_index)
        np.testing.assert_array_equal(d.fallback, jd.fallback)
        differ = d.model_index != jd.model_index
        if differ.any():
            # The only allowed difference: u within 1e-6 of a CDF boundary.
            probs = selection.selection_probabilities(
                sched.accuracy, sched.mu, sched.sigma, sched.cfg.t_sla_ms - t_nw)[0].numpy()
            cum = np.cumsum(probs.astype(np.float64), axis=1)
            gap = np.abs(cum - u[:, None] * cum[:, -1:]).min(axis=1)
            assert (gap[differ] < 1e-6).all(), np.flatnonzero(differ)
            near_boundary += int(differ.sum())
        exec_ms = np.maximum(jsched.mu[jd.model_index] + rng.standard_normal(256), 0.1)
        jsched.observe_batch(jd.model_index, exec_ms)
        sched.observe_batch(jd.model_index, exec_ms)
        np.testing.assert_array_equal(sched.mu, jsched.mu)
    assert near_boundary <= 2


# ---------------------------------------------------------------------------
# Execution tier.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def twin_backends():
    name, cfg, quality = tier_configs()[0]
    jcfg = JT.ModelConfig(**dataclasses.asdict(cfg))
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(4))
    params = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    jb = jbackend.JitBackend(max_len=32)
    jb.register(jbackend.Variant(name, jcfg, jparams, quality))
    tb = backend.JitBackend(max_len=32, device="cpu")
    tb.register(backend.Variant(name, cfg, params, quality))
    return name, cfg, jb, tb


@pytest.mark.parametrize("batch", [1, 2, 3, 4])
def test_generate_token_equal_to_jax(twin_backends, batch):
    name, cfg, jb, tb = twin_backends
    tokens = np.random.default_rng(batch).integers(0, cfg.vocab_size, (batch, 10))
    jout, _ = jb.generate(name, tokens, 6)
    out, wall_ms = tb.generate(name, tokens, 6)
    assert out.dtype == np.int32 and out.shape == (batch, 6)
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert wall_ms > 0


def test_generate_zero_steps(twin_backends):
    name, _, _, tb = twin_backends
    out, wall_ms = tb.generate(name, np.zeros((2, 4), np.int64), 0)
    assert out.shape == (2, 0) and wall_ms == 0.0


WALLS = {"stub-a": 30.0, "stub-b": 60.0, "stub-hedge": 45.0}


def _fixed_wall_tiers(base):
    """Remote and hedge stub tiers that report fixed wall times (no sleep)."""

    class Remote(base):
        def register(self, v):
            self.variants[v.name] = v

        def generate(self, name, tokens, n_steps):
            out = np.full((np.shape(tokens)[0], n_steps), len(name), dtype=np.int32)
            return out, WALLS[name]

        def run_batch(self, name, batch, n_steps):
            return self.generate(name, batch, n_steps)

    class Hedge(Remote):
        hedge_name = "stub-hedge"

        def submit_hedge(self, batch, n_steps, *, sync=False):
            return self.submit_batch(self.hedge_name, batch, n_steps, sync=sync)

    return Remote(), Hedge()


def _drain(pkg):
    """One seeded sync drain_trace over stub tiers; pkg is 'jax' or 'torch'."""
    if pkg == "jax":
        remote, hedge = _fixed_wall_tiers(jbackend.ExecutionBackend)
        Variant, Profile, Sched, Cfg, Loop = (jbackend.Variant, JProfile, JScheduler,
                                              JSchedulerConfig, JLoop)
        trace = j_make_trace(40, JPoisson(60.0), JLognormal(120.0, 0.8), seed=5)
    else:
        remote, hedge = _fixed_wall_tiers(backend.ExecutionBackend)
        Variant, Profile, Sched, Cfg, Loop = (backend.Variant, ModelProfile,
                                              MDInferenceScheduler, SchedulerConfig,
                                              ServingLoop)
        trace = make_trace(40, PoissonArrivals(60.0), LognormalNetwork(120.0, 0.8), seed=5)
    registry = [Profile("stub-a", 40.0, 30.0, 2.0), Profile("stub-b", 80.0, 60.0, 4.0)]
    for p in registry:
        remote.register(Variant(p.name, None, None, p.accuracy))
    from repro_torch.core.registry import ModelRegistry
    from repro.core.registry import ModelRegistry as JModelRegistry

    reg = (JModelRegistry if pkg == "jax" else ModelRegistry)(registry)
    sched = Sched(reg, Profile("stub-hedge", 35.0, 45.0, 2.0), Cfg(t_sla_ms=400.0, seed=2))
    loop = Loop(sched, remote, hedge, dispatch="sync")
    completions, metrics = loop.drain_trace(
        trace, 50.0, tokens_for=lambda i: np.full(4, i), n_steps=3)
    return completions, metrics


def test_sync_drain_trace_twins():
    jc, jm = _drain("jax")
    tc, tm = _drain("torch")
    key = lambda c: (c.rid, c.model_name, c.hedged, c.used_remote, c.race_resolution,  # noqa: E731
                     tuple(c.tokens), round(c.latency_ms, 9), round(c.queue_wait_ms, 9))
    assert [key(c) for c in tc] == [key(c) for c in jc]
    assert tm.race_resolution == jm.race_resolution
    assert len(tc) + tm.n_rejected == 40
    assert {c.race_resolution for c in tc} >= {"remote_won", "ondevice_won"}


def test_serve_main_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--requests", "6", "--prompt", "8",
                       "--gen", "2", "--dispatch", "sync"]) == 0
    out = capsys.readouterr().out
    assert "served 6 requests" in out and "device=cpu" in out
