"""The port's dense model against the JAX model, on the CPU in f32.

Both packages run the same weights: the JAX ``init_params`` tree goes
through the weight bridge (``params_from_numpy``).  Prefill logits agree to
atol 1e-4 / rtol 1e-4 (the JAX model sums attention in chunks, the port's
plain path in one softmax), ring caches agree (k/v to the same tolerance,
slot positions exactly), and 16 greedy decode steps give the same tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.configs.mdinference_zoo import ONDEVICE_HEDGE as J_HEDGE  # noqa: E402
from repro.launch.serve import TIERS as J_TIERS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.configs.mdinference_zoo import ONDEVICE_HEDGE  # noqa: E402
from repro_torch.launch.serve import TIERS, tier_configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

MODELS = [name for name, *_ in TIERS] + ["hedge"]
PROMPT, STEPS, MAX_LEN, B = 12, 16, 40, 2


def _configs(name):
    """(JAX config, port config) of a serving tier or the hedge variant."""
    if name == "hedge":
        return J_HEDGE.config(), ONDEVICE_HEDGE.config()
    row = next(r for r in J_TIERS if r[0] == name)
    _, arch, width, n_layers, _ = row
    jcfg = jarchs.reduced(arch, d_model=width, n_layers=n_layers, n_heads=4,
                          n_kv_heads=2, head_dim=width // 4)
    return jcfg, dict((n, c) for n, c, _ in tier_configs())[name]


def _jax_init(jcfg, seed):
    """The JAX ``init_params`` tree, compiled once instead of run op by op."""
    return jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(seed))


@pytest.mark.parametrize("arch", sorted(jarchs.ARCHS))
def test_arch_configs_match(arch):
    assert dataclasses.asdict(archs.ARCHS[arch]) == dataclasses.asdict(jarchs.ARCHS[arch])
    assert dataclasses.asdict(archs.reduced(arch)) == dataclasses.asdict(jarchs.reduced(arch))


@pytest.mark.parametrize("name", MODELS)
def test_serving_configs_match(name):
    jcfg, cfg = _configs(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert TIERS == J_TIERS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trip(dtype):
    jcfg, cfg = _configs("tier-l")
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    jparams = jax.tree.map(np.asarray, _jax_init(jcfg, 3))
    params = T.params_from_numpy(cfg, jparams, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, t) in zip(flat_j, flat_t):
        assert tuple(t.shape) == a.shape, path
        back = t.float().numpy()
        np.testing.assert_array_equal(back, a.astype(np.float32), err_msg=str(path))
    assert params["periods"][0]["ln1"].dtype == torch.float32
    assert params["periods"][0]["attn"]["wq"].dtype == getattr(torch, dtype)


def test_seeded_init_is_reproducible():
    _, cfg = _configs("tier-s")
    a = T.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    c = T.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    assert torch.equal(a["periods"][0]["attn"]["wq"], b["periods"][0]["attn"]["wq"])
    assert not torch.equal(a["periods"][0]["attn"]["wq"], c["periods"][0]["attn"]["wq"])
    assert torch.all(a["final_norm"] == (0.0 if cfg.norm_offset else 1.0))


@pytest.fixture(scope="module")
def runs():
    """Prefill + greedy decode of every model on both packages (computed once)."""
    out = {}
    for name in MODELS:
        jcfg, cfg = _configs(name)
        jparams = _jax_init(jcfg, 0)
        params = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
        tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, PROMPT))
        jpre = jax.jit(lambda p, t, c=jcfg: JT.prefill(c, p, {"tokens": t}, max_len=MAX_LEN))
        jdec = jax.jit(lambda p, cache, t, pos, c=jcfg: JT.decode_step(c, p, cache, t, pos))
        jcache, jlogits = jpre(jparams, jnp.asarray(tokens, jnp.int32))
        with torch.inference_mode():
            cache, logits = T.prefill(cfg, params, {"tokens": torch.as_tensor(tokens)},
                                      max_len=MAX_LEN)
        res = dict(jlogits=np.asarray(jlogits), logits=logits.numpy().copy(),
                   jcache=jax.tree.map(np.asarray, jcache),
                   cache=jax.tree.map(lambda t: t.numpy().copy(), cache))
        jtok, tok = jnp.argmax(jlogits, -1).astype(jnp.int32), logits.argmax(-1)
        jtoks, toks, jsteps, steps = [], [], [], []
        for i in range(STEPS):
            jtoks.append(np.asarray(jtok))
            toks.append(tok.numpy().copy())
            pos = np.full((B,), PROMPT + i, np.int32)
            jl, jcache = jdec(jparams, jcache, jtok, jnp.asarray(pos))
            with torch.inference_mode():
                tl, cache = T.decode_step(cfg, params, cache, tok, torch.as_tensor(pos))
            jsteps.append(np.asarray(jl))
            steps.append(tl.numpy().copy())
            jtok, tok = jnp.argmax(jl, -1).astype(jnp.int32), tl.argmax(-1)
        res.update(jtoks=np.stack(jtoks, 1), toks=np.stack(toks, 1),
                   jsteps=np.stack(jsteps), steps=np.stack(steps))
        out[name] = res
    return out


@pytest.mark.parametrize("name", MODELS)
def test_prefill_logits_and_cache_match(runs, name):
    r = runs[name]
    np.testing.assert_allclose(r["logits"], r["jlogits"], atol=1e-4, rtol=1e-4)
    for group in ("periods", "epilogue"):
        assert len(r["cache"][group]) == len(r["jcache"][group])
        for layer, jlayer in zip(r["cache"][group], r["jcache"][group]):
            np.testing.assert_allclose(layer["k"], jlayer["k"], atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(layer["v"], jlayer["v"], atol=1e-4, rtol=1e-4)
            np.testing.assert_array_equal(layer["slot_pos"], jlayer["slot_pos"])


@pytest.mark.parametrize("name", MODELS)
def test_greedy_decode_matches(runs, name):
    r = runs[name]
    np.testing.assert_array_equal(r["toks"], r["jtoks"])
    np.testing.assert_allclose(r["steps"], r["jsteps"], atol=1e-4, rtol=1e-4)


def test_ring_cache_wraps_like_jax():
    """A prompt longer than the ring keeps its tail; decode keeps wrapping."""
    jcfg, cfg = _configs("hedge")
    jparams = _jax_init(jcfg, 2)
    params = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 11))
    jpre = jax.jit(lambda p, t: JT.prefill(jcfg, p, {"tokens": t}, max_len=8))
    jdec = jax.jit(lambda p, cache, t, pos: JT.decode_step(jcfg, p, cache, t, pos))
    jcache, jl = jpre(jparams, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        cache, tl = T.prefill(cfg, params, {"tokens": torch.as_tensor(tokens)}, max_len=8)
        tok = tl.argmax(-1)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        for i in range(5):
            pos = np.full((1,), 11 + i, np.int32)
            jl, jcache = jdec(jparams, jcache, jtok, jnp.asarray(pos))
            tl, cache = T.decode_step(cfg, params, cache, tok, torch.as_tensor(pos))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
            tok, jtok = tl.argmax(-1), jnp.argmax(jl, -1).astype(jnp.int32)
    np.testing.assert_array_equal(cache["periods"][0]["slot_pos"].numpy(),
                                  np.asarray(jcache["periods"][0]["slot_pos"]))
