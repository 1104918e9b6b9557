"""The port's continuous-batching tier against the JAX package, on the CPU.

* the block-paged slot ledger conserves slots and pages;
* ``prefill_ragged``, ``graft_prefill``/``graft_prefill_batch`` and 8
  ``paged_decode_step``s match their JAX twins on bridged weights: greedy
  tokens exactly in f32; the values through a float64 run of each package
  from the same weights (fed the JAX f32 run's tokens), see
  :func:`_assert_f64_twins`;
* ``ContinuousBatchingBackend.generate`` is token-equal to the JAX
  continuous backend and to the port's own ``JitBackend`` (ladder sizes and
  padded partials), mid-flight joins are token-exact, early releases
  recycle slots, and ``compile_count`` does not grow after warmup;
* a seeded stepped ``drain_trace`` over fixed-wall tiers makes the same
  decisions and race outcomes as the JAX loop over its continuous backend;
* every decode token reaches the future before it resolves (streaming),
  and ``serve.main --continuous --stream`` prints the tier's summary line.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax_f64 import Jnp64  # noqa: E402

import repro.serving.backend as jbackend  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.configs.mdinference_zoo import ServingGeometry as JGeometry  # noqa: E402
from repro.core.network import LognormalNetwork as JLognormal  # noqa: E402
from repro.core.registry import ModelProfile as JProfile  # noqa: E402
from repro.core.registry import ModelRegistry as JRegistry  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.loadgen import PoissonArrivals as JPoisson  # noqa: E402
from repro.serving.loadgen import make_trace as j_make_trace  # noqa: E402
from repro.serving.loop import ServingLoop as JLoop  # noqa: E402
from repro.serving.scheduler import MDInferenceScheduler as JScheduler  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig  # noqa: E402
import repro_torch.serving.backend as backend  # noqa: E402
from repro_torch.configs.archs import reduced  # noqa: E402
from repro_torch.configs.mdinference_zoo import ServingGeometry  # noqa: E402
from repro_torch.core.duplication import HedgePolicy  # noqa: E402
from repro_torch.core.network import LognormalNetwork  # noqa: E402
from repro_torch.core.registry import ModelProfile, ModelRegistry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.block_cache import BlockPagedSlotCache, NoFreeSlot  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.loadgen import PoissonArrivals, make_trace  # noqa: E402
from repro_torch.serving.loop import ServingLoop  # noqa: E402
from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

PROMPT, GEN = 8, 4
GEO_ARGS = dict(max_len=32, prompt_width=PROMPT, bs_ladder=(1, 2, 4), n_slots=8,
                page_size=8, max_steps=8)
GEO, JGEO = ServingGeometry(**GEO_ARGS), JGeometry(**GEO_ARGS)
# Bounds of the f32 runs against float64, each a share of the float64
# array's largest entry (see _assert_f64_twins): measured worst 9.8e-6 for
# logits (gemma's decode step 6, both packages) and 3.4e-6 for K/V (gemma's
# prefill keys, |k| up to 18), on an AVX-512 CPU.
F32_LOGITS, F32_KV, F64_TWINS = 2e-5, 1e-5, 1e-12


def _twin_variant(name, width=64, n_layers=2, seed=0, quality=80.0, arch="gemma-2b",
                  n_heads=2, n_kv_heads=1):
    """The same seeded weights as a JAX and a port ``Variant``."""
    kw = dict(d_model=width, n_layers=n_layers, n_heads=n_heads, n_kv_heads=n_kv_heads,
              head_dim=width // n_heads)
    jcfg, cfg = j_reduced(arch, **kw), reduced(arch, **kw)
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(seed))
    params = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return (jbackend.Variant(name, jcfg, jparams, quality),
            backend.Variant(name, cfg, params, quality))


def _prompts(n, seed=3, width=PROMPT):
    return np.random.default_rng(seed).integers(0, 64, (n, width)).astype(np.int32)


# ---------------------------------------------------------------------------
# Block-paged slot cache (the port's copy).
# ---------------------------------------------------------------------------
def test_block_cache_lifecycle_and_conservation():
    cache = BlockPagedSlotCache(n_slots=2, n_pages=5, page_size=4, pages_per_slot=2)
    a = cache.begin_prefill(prompt_len=4, n_steps=4)
    b = cache.begin_prefill(prompt_len=4, n_steps=4)
    with pytest.raises(NoFreeSlot):
        cache.begin_prefill(prompt_len=4, n_steps=4)
    cache.commit_graft(a.index)
    cache.commit_graft(b.index)
    table = cache.page_table(a.index)
    assert table.dtype == np.int32 and table.shape == (2,)
    assert (table > 0).sum() == cache.pages_needed(4, 4)
    cache.release(a.index, "resolved")
    cache.release(b.index, "hedge_win")
    c = cache.begin_prefill(prompt_len=4, n_steps=4)  # slot recycles
    cache.commit_graft(c.index)
    cache.release(c.index, "cancel")
    assert cache.stats() == dict(grafted=3, freed=3, freed_resolved=1, freed_hedge_win=1,
                                 freed_cancel=1, free_pages=4, free_slots=2)
    cache.check_conservation()


def test_block_cache_never_hands_out_trash_page():
    cache = BlockPagedSlotCache(n_slots=4, n_pages=9, page_size=4, pages_per_slot=2)
    seen = set()
    for _ in range(4):
        s = cache.begin_prefill(prompt_len=4, n_steps=4)
        pages = {int(p) for p in cache.page_table(s.index) if p != 0}
        assert 0 not in pages and not (pages & seen)
        seen |= pages


# ---------------------------------------------------------------------------
# Model functions against their JAX twins.
# ---------------------------------------------------------------------------
MODEL_ARCHS = {
    "gemma": dict(arch="gemma-2b"),  # MQA, GeGLU, (1+w) norms, tied embeddings
    "qwen3": dict(arch="qwen3-14b", n_heads=4, n_kv_heads=2),  # GQA, qk-norm
}
W, PAGE, NB, N_ROWS = 16, 8, 4, 4  # prefill width, page size, pages per row, decode rows
LENGTHS = np.array([16, 9, 5], np.int32)  # S < W for two of the rows
TABLES = np.array([[3, 7, 1, 12], [9, 2, 14, 0], [5, 11, 0, 0]], np.int32)  # scattered
N_PAGES = 16


def _paged_pair(jcfg, jparams, cfg, params, tokens, forced=None):
    """prefill_ragged -> graft -> 8 paged decode steps on both packages.
    Each side decodes its own greedy tokens, or ``forced[i]`` at step i."""
    jpre = jax.jit(lambda p, t, lens: JT.prefill_ragged(jcfg, p, {"tokens": t}, lens, W))
    jgraft = jax.jit(lambda pool, pc, tbl: JT.graft_prefill_batch(jcfg, pool, pc, tbl, PAGE))
    jgraft1 = jax.jit(lambda pool, pc, tbl: JT.graft_prefill(jcfg, pool, pc, 1, tbl, PAGE))
    jdec = jax.jit(lambda p, pool, tbl, tok, pos: JT.paged_decode_step(
        jcfg, p, pool, tbl, tok, pos, PAGE))
    out = {}
    jcache, jlogits = jpre(jparams, jnp.asarray(tokens), jnp.asarray(LENGTHS))
    with torch.inference_mode():
        cache, logits = T.prefill_ragged(cfg, params, {"tokens": torch.as_tensor(tokens)},
                                         torch.as_tensor(LENGTHS), W)
        out["prefill"] = (logits.numpy().copy(), np.asarray(jlogits),
                          jax.tree.map(lambda t: t.numpy().copy(), cache),
                          jax.tree.map(np.asarray, jcache))
        jpool = JT.init_paged_cache(jcfg, N_PAGES, PAGE)
        pool = T.init_paged_cache(cfg, N_PAGES, PAGE, device="cpu")
        out["graft1"] = (
            jax.tree.map(lambda t: t.numpy().copy(), T.graft_prefill(
                cfg, T.init_paged_cache(cfg, N_PAGES, PAGE, device="cpu"), cache, 1,
                torch.as_tensor(TABLES[1]), PAGE)),
            jax.tree.map(np.asarray, jgraft1(jpool, jcache, jnp.asarray(TABLES[1]))))
        jpool = jgraft(jpool, jcache, jnp.asarray(TABLES))
        T.graft_prefill_batch(cfg, pool, cache, torch.as_tensor(TABLES), PAGE)
        out["graft"] = (jax.tree.map(lambda t: t.numpy().copy(), pool),
                        jax.tree.map(np.asarray, jpool))
        # Decode: rows 0-2 at their own positions (their tables hold room
        # for 8 more tokens), row 3 inactive (pos 0, all-trash table).
        tables = np.zeros((N_ROWS, NB), np.int32)
        tables[:3] = TABLES
        pos = np.zeros(N_ROWS, np.int32)
        pos[:3] = LENGTHS
        tok = np.zeros(N_ROWS, np.int32)
        tok[:3] = np.argmax(np.asarray(jlogits), -1)
        jtok, ttok = jnp.asarray(tok), torch.as_tensor(tok)
        steps = []
        for i in range(8):
            if forced is not None:
                jtok, ttok = jnp.asarray(forced[i]), torch.tensor(forced[i])
            jl, jpool = jdec(jparams, jpool, jnp.asarray(tables), jtok, jnp.asarray(pos))
            tl, pool = T.paged_decode_step(cfg, params, pool, torch.as_tensor(tables),
                                           ttok, torch.as_tensor(pos), PAGE)
            steps.append((tl.numpy().copy(), np.asarray(jl), ttok.numpy().copy(),
                          np.asarray(jtok)))
            active = pos > 0
            jtok = jnp.where(jnp.asarray(active), jnp.argmax(jl, -1), 0).astype(jnp.int32)
            ttok = torch.where(torch.as_tensor(active), tl.argmax(-1), 0).to(torch.int32)
            pos = np.where(active, pos + 1, 0).astype(np.int32)
        out["decode"] = steps
    return out


@pytest.fixture(scope="module", params=sorted(MODEL_ARCHS))
def paged_runs(request):
    """The f32 runs of both packages, and (under ``"f64"``) both again in
    float64 from the same weights, fed the JAX f32 run's tokens."""
    jv, tv = _twin_variant("m", seed=5, **MODEL_ARCHS[request.param])
    tokens = _prompts(3, seed=7, width=W)
    out = _paged_pair(jv.cfg, jv.params, tv.cfg, tv.params, tokens)
    forced = [jtok for _, _, _, jtok in out["decode"]]
    c64 = dataclasses.replace(tv.cfg, dtype="float64")
    p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t, tv.params)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in (jattention, jlayers, JT):
            mp.setattr(mod, "jnp", Jnp64())
        jc64 = dataclasses.replace(jv.cfg, dtype="float64")
        jp64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), jv.params)
        out["f64"] = _paged_pair(jc64, jp64, c64, p64, tokens, forced)
    return out


def _pool_leaves(tree):
    for group in ("periods", "epilogue"):
        for layer in tree[group]:
            yield layer["kp"], layer["vp"]


def _assert_f64_twins(got, want, got64, want64, share, what):
    """The two packages' float64 runs agree to ``F64_TWINS`` of the
    largest entry (measured <= 1.3e-14: the same arithmetic), and each f32
    run lies within ``share`` of it from the float64 result.

    The f32 runs differ from each other only in summation order (the JAX
    prefill sums attention in key chunks, the port in one product; BLAS
    blocks differ by host), each by up to its own f32 rounding of the
    float64 result, so a direct f32-to-f32 check pins one host's orders:
    on an AVX-512 CPU gemma's prefill keys part by 3.7e-5 and its decode
    logits by 2.5e-5.  The bounds are about 2-3x the worst f32 error
    measured there (see ``F32_LOGITS``, ``F32_KV``)."""
    scale = float(np.abs(want64).max())
    np.testing.assert_allclose(got64, want64, rtol=0, atol=F64_TWINS * scale,
                               err_msg=f"{what}: float64 runs")
    for side, arr in (("port", got), ("jax", want)):
        np.testing.assert_allclose(np.asarray(arr, np.float64), want64, rtol=0,
                                   atol=share * scale, err_msg=f"{what}: {side} f32")


def test_prefill_ragged_matches_jax(paged_runs):
    logits, jlogits, cache, jcache = paged_runs["prefill"]
    logits64, jlogits64, cache64, jcache64 = paged_runs["f64"]["prefill"]
    _assert_f64_twins(logits, jlogits, logits64, jlogits64, F32_LOGITS, "logits")
    for group in ("periods", "epilogue"):
        for layers in zip(cache[group], jcache[group], cache64[group], jcache64[group]):
            for key in ("k", "v"):
                for row, n in enumerate(LENGTHS):  # real positions only
                    _assert_f64_twins(*(t[key][..., row, :n, :, :] for t in layers),
                                      F32_KV, f"{group} {key} row {row}")


@pytest.mark.parametrize("which", ["graft1", "graft"])
def test_graft_matches_jax(paged_runs, which):
    """Every prefill position lands in its row's page slot as an exact copy
    of the port's prefill cache and, at real positions, matches the JAX
    pool; pages no table names stay zero on both sides.  (Pad positions
    hold pad-token k/v that the mask never exposes.)"""
    pool, jpool = paged_runs[which]
    pool64, jpool64 = paged_runs["f64"][which]
    cache = paged_runs["prefill"][2]
    rows = [1] if which == "graft1" else [0, 1, 2]
    written = {int(TABLES[r][i // PAGE]) for r in rows for i in range(W)} - {0}
    for group in ("periods", "epilogue"):
        for pc, jpc, pf, pc64, jpc64 in zip(pool[group], jpool[group], cache[group],
                                            pool64[group], jpool64[group]):
            for key, src in (("kp", pf["k"]), ("vp", pf["v"])):
                got, want = pc[key], jpc[key]
                assert got.shape == want.shape
                for r in rows:
                    for i in range(W):
                        slot = (..., int(TABLES[r][i // PAGE]), i % PAGE, slice(None),
                                slice(None))
                        np.testing.assert_array_equal(got[slot], src[..., r, i, :, :])
                        if i < LENGTHS[r]:
                            _assert_f64_twins(got[slot], want[slot], pc64[key][slot],
                                              jpc64[key][slot], F32_KV, f"{key} row {r}")
                for pid in set(range(1, N_PAGES)) - written:
                    assert not got[..., pid, :, :, :].any()
                    assert not want[..., pid, :, :, :].any()


def test_paged_decode_steps_match_jax(paged_runs):
    for i, ((logits, jlogits, tok, jtok), (logits64, jlogits64, tok64, _)) in enumerate(
            zip(paged_runs["decode"], paged_runs["f64"]["decode"])):
        np.testing.assert_array_equal(tok, jtok, err_msg=f"step {i}")
        np.testing.assert_array_equal(tok64, jtok, err_msg=f"step {i}")
        _assert_f64_twins(logits[:3], jlogits[:3], logits64[:3], jlogits64[:3], F32_LOGITS,
                          f"step {i}")


def test_supports_paged_decode_matches_jax():
    from repro.configs import archs as jarchs
    from repro_torch.configs import archs

    for name in sorted(jarchs.ARCHS):
        assert T.supports_paged_decode(archs.ARCHS[name]) == \
            JT.supports_paged_decode(jarchs.ARCHS[name]), name


# ---------------------------------------------------------------------------
# Backend against backend.
# ---------------------------------------------------------------------------
WALLS = {"m": 60.0, "m2": 30.0, "stub-hedge": 45.0}


def _fixed_wall(base):
    """``base`` with every batch reporting a fixed wall time, so seeded
    loops over the two packages resolve their races identically."""

    class FixedWall(base):
        def _finalize_handle(self, handle):
            if handle._wall_ms is None:
                handle.done_wall_ms = handle.dispatch_wall_ms + WALLS[handle.name]
                handle._wall_ms = WALLS[handle.name]
                self._note_done(handle.n_rows, handle._wall_ms)

    return FixedWall


@pytest.fixture(scope="module")
def twins():
    """Two-variant continuous backends of both packages (same weights),
    warmed, plus the port's dense ``JitBackend`` over variant ``m``."""
    pairs = [_twin_variant("m", seed=0), _twin_variant("m2", width=32, n_layers=1, seed=1,
                                                       quality=40.0)]
    jb = _fixed_wall(jbackend.ContinuousBatchingBackend)(JGEO)
    tb = _fixed_wall(backend.ContinuousBatchingBackend)(GEO, device="cpu")
    for jv, tv in pairs:
        jb.register(jv)
        tb.register(tv)
    jb.warmup()
    tb.warmup()
    tb.compiles_after_warmup = tb.compile_count
    dense = backend.JitBackend(max_len=GEO.max_len, device="cpu")
    dense.register(pairs[0][1])
    return jb, tb, dense


@pytest.mark.parametrize("B", [1, 3, 5])
def test_generate_matches_jax_and_dense(twins, B):
    """Ladder sizes and padded partials (3 -> 2+1, 5 -> 4+1)."""
    jb, tb, dense = twins
    toks = _prompts(B, seed=B)
    out, wall_ms = tb.generate("m", toks, GEN)
    assert out.dtype == np.int32 and out.shape == (B, GEN) and wall_ms > 0
    np.testing.assert_array_equal(out, jb.generate("m", toks, GEN)[0])
    np.testing.assert_array_equal(out, dense.generate("m", toks, GEN)[0])


def test_single_step_and_zero_step(twins):
    jb, tb, _ = twins
    toks = _prompts(2)
    np.testing.assert_array_equal(tb.generate("m", toks, 1)[0], jb.generate("m", toks, 1)[0])
    h = tb.submit_batch("m", toks, 0)
    assert h.poll() and h.result().shape == (2, 0)


def test_shape_validation(twins):
    _, tb, _ = twins
    with pytest.raises(ValueError):
        tb.submit_batch("m", np.zeros((1, GEO.prompt_width + 1), np.int32), GEN)
    with pytest.raises(ValueError):
        tb.submit_batch("m", _prompts(1), GEO.max_steps + 1)


def test_midflight_join_token_exact(twins):
    jb, tb, _ = twins
    toks = _prompts(5, seed=9)
    h1 = tb.submit_batch("m", toks[:3], GEN, sync=False)
    tb.pump()
    tb.pump()  # h1 is mid-decode...
    h2 = tb.submit_batch("m", toks[3:], GEN, sync=False)  # ...h2 joins
    assert all(t is not None and t > 0 for t in h2.ttft_wall_ms)
    out = np.vstack([h1.wait()[0], h2.wait()[0]])
    np.testing.assert_array_equal(out, jb.generate("m", toks, GEN)[0])


def test_early_release_recycles_slots(twins):
    jb, tb, _ = twins
    toks = _prompts(4, seed=11)
    free_before = len(tb._engines["m"].cache_mgr.free_slots)
    h = tb.submit_batch("m", toks, GEN, sync=False)
    tb.pump()
    h.release_rows([0], "hedge_win")
    h.release_rows([2], "cancel")
    assert h.released_rows == {0: "hedge_win", 2: "cancel"}
    out, _ = h.wait()
    assert len(tb._engines["m"].cache_mgr.free_slots) == free_before
    ref, _ = jb.generate("m", toks, GEN)
    np.testing.assert_array_equal(out[[1, 3]], ref[[1, 3]])
    assert np.array_equal(out[0, :2], ref[0, :2]) and (out[0, 2:] == 0).all()
    tb.check_conservation()


def test_zero_growth_of_compile_count_after_warmup(twins):
    """Every shape the tier has seen (ladder sizes, partials, joins,
    releases) ran through the warmup's entry-point shapes."""
    _, tb, _ = twins
    for B in (1, 3, 5, 8):
        tb.generate("m", _prompts(B), GEN)
    # Two variants x (3 ladder prefills + 3 grafts + 1 decode).
    assert tb.compiles_after_warmup == 14
    assert tb.compile_count == tb.compiles_after_warmup


def test_slot_and_page_conservation(twins):
    _, tb, _ = twins
    stats = tb.slot_stats("m")
    assert stats["freed"] == (stats["freed_resolved"] + stats["freed_hedge_win"]
                              + stats["freed_cancel"])
    assert stats["grafted"] == stats["freed"]
    assert stats["freed_hedge_win"] >= 1 and stats["freed_cancel"] >= 1
    assert stats["free_slots"] == GEO.n_slots
    assert stats["free_pages"] == GEO.total_pages - 1
    tb.check_conservation()
    assert tb.joined_total == tb.recycled_total


def _stub_hedge(base):
    class Hedge(base):
        hedge_name = "stub-hedge"

        def register(self, v):
            self.variants[v.name] = v

        def generate(self, name, tokens, n_steps):
            return np.full((np.shape(tokens)[0], n_steps), 7, np.int32), WALLS[name]

        def run_batch(self, name, batch, n_steps):
            return self.generate(name, batch, n_steps)

        def submit_hedge(self, batch, n_steps, *, sync=False):
            return self.submit_batch(self.hedge_name, batch, n_steps, sync=sync)

    return Hedge()


def _stepped_drain(pkg, remote):
    if pkg == "jax":
        hedge = _stub_hedge(jbackend.ExecutionBackend)
        Profile, Registry, Sched, Cfg, Loop = (JProfile, JRegistry, JScheduler,
                                               JSchedulerConfig, JLoop)
        trace = j_make_trace(24, JPoisson(60.0), JLognormal(120.0, 0.8), seed=5)
    else:
        hedge = _stub_hedge(backend.ExecutionBackend)
        Profile, Registry, Sched, Cfg, Loop = (ModelProfile, ModelRegistry,
                                               MDInferenceScheduler, SchedulerConfig,
                                               ServingLoop)
        trace = make_trace(24, PoissonArrivals(60.0), LognormalNetwork(120.0, 0.8), seed=5)
    registry = Registry([Profile("m2", 40.0, 30.0, 2.0), Profile("m", 80.0, 60.0, 4.0)])
    sched = Sched(registry, Profile("stub-hedge", 35.0, 45.0, 2.0),
                  Cfg(t_sla_ms=220.0, seed=2))
    loop = Loop(sched, remote, hedge, dispatch="stepped")
    prompts = _prompts(24, seed=13)
    return loop.drain_trace(trace, 50.0, tokens_for=lambda i: prompts[i], n_steps=GEN)


def test_stepped_drain_trace_twins(twins):
    jb, tb, _ = twins
    joined = tb.joined_total
    jc, jm = _stepped_drain("jax", jb)
    tc, tm = _stepped_drain("torch", tb)
    key = lambda c: (c.rid, c.model_name, c.hedged, c.used_remote, c.race_resolution,  # noqa: E731
                     tuple(c.tokens), round(c.latency_ms, 6), round(c.queue_wait_ms, 6))
    assert [key(c) for c in tc] == [key(c) for c in jc]
    assert tm.race_resolution == jm.race_resolution
    assert len(tc) + tm.n_rejected == 24
    assert {c.model_name for c in tc} == {"m", "m2"}
    assert all(c.ttft_ms is not None for c in tc)
    tb.check_conservation()
    assert tb.joined_total == tb.recycled_total and tb.joined_total - joined == len(tc)


# ---------------------------------------------------------------------------
# Streaming and the serve entry point.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dispatch", ["stepped", "sync"])
def test_stream_yields_every_decode_token_before_resolution(dispatch):
    _, tv = _twin_variant("m", seed=0)
    hedge = backend.OnDeviceBackend.from_zoo(max_len=GEO.max_len, device="cpu")
    engine = ServingEngine(hedge_backend=hedge, continuous=True, geometry=GEO,
                           dispatch=dispatch, device="cpu")
    engine.register(tv)
    assert engine.dispatch == "stepped"  # as in the JAX engine
    registry = engine.measure_profiles(prompt_len=PROMPT, gen_tokens=GEN, trials=2)
    ondevice = hedge.measure_profile(prompt_len=PROMPT, gen_tokens=GEN, trials=2)
    # Selective hedging with a huge SLA: the duplicate never engages, so
    # the remote decode stream runs to completion.
    sched = MDInferenceScheduler(registry, ondevice, SchedulerConfig(
        t_sla_ms=60_000.0, seed=0, hedge=HedgePolicy(always=False, deadline_headroom_ms=0.0)))
    chunks, done_at_yield, c = serve.stream_demo(engine, sched, _prompts(1, seed=9)[0], GEN,
                                                 60_000.0)
    assert c.used_remote and not c.hedged
    assert [ch.index for ch in chunks] == list(range(GEN))
    np.testing.assert_array_equal([ch.token for ch in chunks], c.tokens)
    assert all(a.wall_ms <= b.wall_ms for a, b in zip(chunks, chunks[1:]))
    assert c.ttft_ms is not None and c.ttft_ms > 0
    assert not any(done_at_yield[:-1])  # pushed while the request was in flight
    engine.backend.check_conservation()


@pytest.mark.parametrize("dispatch", ["stepped", "sync"])
def test_stream_of_a_hedge_won_row_may_end_early(dispatch):
    """A hedged row whose SLA budget is spent once its duplicate has
    finished is released (the ``InferenceFuture.stream()`` note): its stream
    may stop short of ``n_steps``, and ``result()`` stays the answer."""
    _, tv = _twin_variant("m", seed=0)
    hedge = backend.OnDeviceBackend.from_zoo(max_len=GEO.max_len, device="cpu")
    engine = ServingEngine(hedge_backend=hedge, continuous=True, geometry=GEO,
                           dispatch=dispatch, device="cpu")
    engine.register(tv)
    registry = engine.measure_profiles(prompt_len=PROMPT, gen_tokens=GEN, trials=2)
    ondevice = hedge.measure_profile(prompt_len=PROMPT, gen_tokens=GEN, trials=2)
    # The paper's policy (always hedge) with a 1 ms SLA: the budget is spent
    # before the remote decode can finish.
    sched = MDInferenceScheduler(registry, ondevice, SchedulerConfig(t_sla_ms=1.0, seed=0))
    chunks, _, c = serve.stream_demo(engine, sched, _prompts(1, seed=9)[0], GEN, 1.0)
    assert c.hedged
    # The stepped tier runs the duplicate inline, so it has finished before
    # the loop's first release check: the remote row is always released
    # before its last decode step, whatever the machine's speed.
    assert engine.backend.slot_stats("m")["freed_hedge_win"] == 1
    assert 1 <= len(chunks) < GEN
    assert [ch.index for ch in chunks] == list(range(len(chunks)))
    assert c.tokens.shape == (GEN,) and int(c.tokens.min()) >= 0
    engine.backend.check_conservation()


def test_serve_main_continuous_stream_on_cpu(capsys):
    # The streamed request is hedged (the paper's policy); a huge SLA keeps
    # its budget from running out, so its remote stream is never released
    # early and runs to all four tokens however slow the machine is.  The
    # early-release case is test_stream_of_a_hedge_won_row_may_end_early.
    assert serve.main(["--device", "cpu", "--continuous", "--stream", "--requests", "4",
                       "--gen", "4", "--sla", "600000"]) == 0
    out = capsys.readouterr().out
    assert "streaming demo" in out and "chunk[3]" in out
    assert "served 4 requests" in out and "dispatch=stepped" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("continuous tier   :"))
    assert "post-warmup recompiles=0 (conservation ok)" in line and "ttft p50/p99=" in line


def test_serve_stream_requires_continuous():
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--stream"])


def test_continuous_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        backend.ContinuousBatchingBackend(GEO)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(continuous=True, geometry=GEO)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_paged_cache(reduced("gemma-2b", d_model=64, n_layers=2), 4, 8)
