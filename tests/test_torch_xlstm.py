"""The port's xLSTM family (xlstm-350m) against the JAX package, on the CPU
in f32.

* ``mlstm_apply`` / ``mlstm_decode_step`` and ``slstm_apply`` /
  ``slstm_decode_step`` on the same numpy-seeded weights (normal * 0.2, as
  tests/test_models.py draws them; the JAX oracles ``jax.jit``-ed), from
  zero and from a non-zero state:
  outputs and state atol 1e-5 (f32 summation order: the sLSTM's input
  projections run once over the sequence, the JAX package's per step).
* chunkwise == recurrent, after tests/test_models.py; the decay matrix is
  masked before its ``exp``, so gradients stay finite where the JAX form's
  upper triangle overflows.
* reduced xlstm end to end on weights bridged from the JAX ``init_params``:
  prefill and decode logits atol 5e-3, every state leaf within 1e-2 of its
  largest entry, greedy tokens equal over 8 decode steps.  The reduced
  config draws its stacked weights with fan-in = period count = 1, so f32
  itself is the limit: against the same prefill in float64, the JAX
  package's logits are 3.0e-3 off and the port's 1.7e-3 (|logits| up to
  1.4), the two 1.3e-3 apart; the state leaves agree to 4e-7 of their
  largest entry at the first layer and drift to 6e-3 at the last, the
  sLSTM (measured).  ``JitBackend`` tokens equal; the
  continuous tier refuses the family with the JAX package's error.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.backend as jbackend  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.configs.mdinference_zoo import ServingGeometry as JGeometry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
import repro_torch.serving.backend as backend  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.configs.mdinference_zoo import ServingGeometry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

ARCH = "xlstm-350m"
ATOL = 1e-5


def _cfg(**over):
    return archs.reduced(ARCH, **over)


def _cell_params(kind, cfg, seed):
    """Normal * 0.2 cell weights from numpy, as a JAX dict and a port dict."""
    rng = np.random.default_rng(seed)
    spec = getattr(xlstm, f"{kind}_init_spec")(cfg)
    assert spec == {k: s for k, (s, _) in getattr(jxlstm, f"{kind}_init_spec")(cfg).items()}
    p = {k: (0.2 * rng.standard_normal(s)).astype(np.float32) for k, s in spec.items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in p.items()}


def _x(seed, shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _state(kind, cfg, B, seed):
    """A non-zero state of the JAX layout (f32) for both packages."""
    jcache = getattr(jxlstm, f"{kind}_init_cache")(cfg, B)
    rng = np.random.default_rng(seed)
    arrs = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in jcache.items()}
    if kind == "slstm":
        arrs["n"] = np.abs(arrs["n"]) + 0.5  # a normalizer state is positive
    return {k: jnp.asarray(v) for k, v in arrs.items()}, {k: torch.from_numpy(v)
                                                           for k, v in arrs.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("start", ["zero", "state"])
def test_mlstm_apply_matches_jax(start):
    cfg = _cfg()
    jp, tp = _cell_params("mlstm", cfg, 1)
    x = _x(2, (2, 32, cfg.d_model))
    if start == "zero":
        jcarry = carry = None
    else:
        js, ts = _state("mlstm", cfg, 2, 3)
        jcarry, carry = (js["C"], js["n"]), (ts["C"], ts["n"])
    jout, (jC, jn) = jax.jit(lambda p, x, c: jxlstm.mlstm_apply(cfg, p, x, carry=c))(
        jp, jnp.asarray(x), jcarry)
    out, (C, n) = xlstm.mlstm_apply(cfg, tp, torch.from_numpy(x), carry=carry)
    _close(out, jout)
    _close(C, jC)
    _close(n, jn)


def test_mlstm_decode_step_matches_jax():
    cfg = _cfg()
    jp, tp = _cell_params("mlstm", cfg, 4)
    js, ts = _state("mlstm", cfg, 3, 5)
    x = _x(6, (3, 1, cfg.d_model))
    jout, jnew = jax.jit(lambda p, x, c: jxlstm.mlstm_decode_step(cfg, p, x, c))(
        jp, jnp.asarray(x), js)
    out, new = xlstm.mlstm_decode_step(cfg, tp, torch.from_numpy(x), ts)
    _close(out, jout)
    for key in ("C", "n"):
        _close(new[key], jnew[key])


@pytest.mark.parametrize("start", ["zero", "state"])
def test_slstm_apply_matches_jax(start):
    cfg = _cfg()
    jp, tp = _cell_params("slstm", cfg, 7)
    x = _x(8, (2, 24, cfg.d_model))
    js, ts = _state("slstm", cfg, 2, 9) if start == "state" else (None, None)
    jout, jst = jax.jit(lambda p, x, st: jxlstm.slstm_apply(cfg, p, x, state=st))(
        jp, jnp.asarray(x), js)
    out, st = xlstm.slstm_apply(cfg, tp, torch.from_numpy(x), state=ts)
    _close(out, jout)
    for key in ("c", "n", "h", "m"):
        _close(st[key], jst[key])


def test_slstm_decode_step_matches_jax():
    cfg = _cfg()
    jp, tp = _cell_params("slstm", cfg, 10)
    js, ts = _state("slstm", cfg, 3, 11)
    x = _x(12, (3, 1, cfg.d_model))
    jout, jst = jax.jit(lambda p, x, st: jxlstm.slstm_decode_step(cfg, p, x, st))(
        jp, jnp.asarray(x), js)
    out, st = xlstm.slstm_decode_step(cfg, tp, torch.from_numpy(x), ts)
    _close(out, jout)
    for key in ("c", "n", "h", "m"):
        _close(st[key], jst[key])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_chunkwise_equals_recurrent(kind):
    """The whole-sequence form (chunks of 8 over 32 steps) equals 32 decode
    steps, outputs and final state."""
    cfg = _cfg(xlstm_chunk=8)
    _, p = _cell_params(kind, cfg, 11)
    B, S = 2, 32
    x = torch.from_numpy(_x(12, (B, S, cfg.d_model)))
    full, final = getattr(xlstm, f"{kind}_apply")(cfg, p, x)
    cache = getattr(xlstm, f"{kind}_init_cache")(cfg, B, device="cpu")
    outs = []
    for t in range(S):
        o, cache = getattr(xlstm, f"{kind}_decode_step")(cfg, p, x[:, t:t + 1], cache)
        outs.append(o)
    _close(torch.cat(outs, 1), full)
    if kind == "mlstm":
        final = {"C": final[0], "n": final[1]}
    for key, t in final.items():
        _close(cache[key], t, atol=1e-4)


def test_mlstm_masked_decay_keeps_gradients_finite():
    """Forget gates near 0 make the chunk's cumulative log-decay fall by ~50
    a step, so the upper triangle of ``lf_i - lf_j`` reaches ~3e3, where
    ``exp`` overflows f32.  The port masks before the ``exp``: the forward
    equals the JAX package's and every gradient is finite."""
    cfg = _cfg(xlstm_chunk=64)
    jp, tp = _cell_params("mlstm", cfg, 13)
    jp["bf"] = jnp.full_like(jp["bf"], -50.0)
    tp["bf"] = torch.full_like(tp["bf"], -50.0)
    x = _x(14, (1, 64, cfg.d_model))
    jout, _ = jax.jit(lambda p, x: jxlstm.mlstm_apply(cfg, p, x))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    out, (C, n) = xlstm.mlstm_apply(cfg, leaves, xt)
    _close(out.detach(), jout)
    grads = torch.autograd.grad((out.sum() + C.sum() + n.sum()), [xt, *leaves.values()])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_mlstm_prefill_length_must_divide_the_chunk():
    cfg = _cfg(xlstm_chunk=8)
    jp, tp = _cell_params("mlstm", cfg, 15)
    x = _x(16, (1, 12, cfg.d_model))
    with pytest.raises(ValueError) as jerr:
        jxlstm.mlstm_apply(cfg, jp, jnp.asarray(x))
    with pytest.raises(ValueError) as terr:
        xlstm.mlstm_apply(cfg, tp, torch.from_numpy(x))
    assert str(terr.value) == str(jerr.value) == "seq 12 not divisible by xlstm_chunk 8"


# ---------------------------------------------------------------------------
# Reduced xlstm end to end.
# ---------------------------------------------------------------------------
PROMPT, STEPS, MAX_LEN, B = 16, 8, 32, 2


def _bridged(seed):
    jcfg, cfg = jarchs.reduced(ARCH), archs.reduced(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(seed))
    return jcfg, cfg, jparams, T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                   device="cpu")


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg, jparams, params = _bridged(0)
    assert cfg.pattern == ("mlstm",) * 7 + ("slstm",) and cfg.n_periods == 1
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, PROMPT))
    jcache, jlogits = jax.jit(lambda p, t: JT.prefill(jcfg, p, {"tokens": t}, max_len=MAX_LEN))(
        jparams, jnp.asarray(tokens, jnp.int32))
    jdec = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, p, c, t, pos))
    with torch.inference_mode():
        cache, logits = T.prefill(cfg, params, {"tokens": torch.as_tensor(tokens)},
                                  max_len=MAX_LEN)
    res = dict(jprefill=(np.asarray(jlogits), jax.tree.map(np.asarray, jcache)),
               prefill=(logits.numpy().copy(), jax.tree.map(lambda t: t.numpy().copy(), cache)))
    jtok, tok = jnp.argmax(jlogits, -1).astype(jnp.int32), logits.argmax(-1)
    steps = []
    for i in range(STEPS):
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jcache = jdec(jparams, jcache, jtok, jnp.asarray(pos))
        with torch.inference_mode():
            tl, same = T.decode_step(cfg, params, cache, tok, torch.as_tensor(pos))
        assert same is cache
        steps.append((np.asarray(jtok), tok.numpy().copy(), np.asarray(jl), tl.numpy().copy()))
        jtok, tok = jnp.argmax(jl, -1).astype(jnp.int32), tl.argmax(-1)
    res["steps"] = steps
    res["final"] = (jax.tree.map(np.asarray, jcache),
                    jax.tree.map(lambda t: t.numpy().copy(), cache))
    return res


def _states_close(cache, jcache):
    for group in ("periods", "epilogue"):
        assert len(cache[group]) == len(jcache[group])
        for layer, jlayer in zip(cache[group], jcache[group]):
            assert sorted(layer) == sorted(jlayer)
            for key, got in layer.items():
                assert got.shape == jlayer[key].shape and got.dtype == np.float32, key
                scale = np.abs(jlayer[key]).max()
                np.testing.assert_allclose(got, jlayer[key], atol=1e-2 * scale, rtol=0,
                                           err_msg=key)


def test_prefill_logits_and_every_state_leaf_match_jax(runs):
    (jlogits, jcache), (logits, cache) = runs["jprefill"], runs["prefill"]
    np.testing.assert_allclose(logits, jlogits, atol=5e-3, rtol=0)
    _states_close(cache, jcache)
    assert np.abs(cache["periods"][0]["C"]).max() > 0


def test_greedy_decode_matches_jax(runs):
    for i, (jtok, tok, jl, tl) in enumerate(runs["steps"]):
        np.testing.assert_array_equal(tok, jtok, err_msg=f"step {i}")
        np.testing.assert_allclose(tl, jl, atol=5e-3, rtol=0, err_msg=f"step {i}")
    _states_close(runs["final"][1], runs["final"][0])


@pytest.fixture(scope="module")
def jit_twins():
    jcfg, cfg, jparams, params = _bridged(4)
    jb = jbackend.JitBackend(max_len=32)
    jb.register(jbackend.Variant("tier-xlstm", jcfg, jparams, 28.0))
    tb = backend.JitBackend(max_len=32, device="cpu")
    tb.register(backend.Variant("tier-xlstm", cfg, params, 28.0))
    return cfg, jb, tb


@pytest.mark.parametrize("batch", [1, 3])
def test_jit_backend_generate_token_equal_to_jax(jit_twins, batch):
    cfg, jb, tb = jit_twins
    tokens = np.random.default_rng(batch).integers(0, cfg.vocab_size, (batch, 8))
    out, wall_ms = tb.generate("tier-xlstm", tokens, 6)
    assert out.dtype == np.int32 and out.shape == (batch, 6) and wall_ms > 0
    np.testing.assert_array_equal(out, np.asarray(jb.generate("tier-xlstm", tokens, 6)[0]))


def test_continuous_backend_refuses_the_family_like_jax():
    jcfg, cfg = jarchs.reduced(ARCH), archs.reduced(ARCH)
    assert not T.supports_paged_decode(cfg) and not JT.supports_paged_decode(jcfg)
    geo = dict(prompt_width=8, bs_ladder=(1, 2), n_slots=2, page_size=4, max_steps=4)
    with pytest.raises(ValueError) as jerr:
        jbackend.ContinuousBatchingBackend(JGeometry(**geo)).register(
            jbackend.Variant("tier-xlstm", jcfg, {}, 28.0))
    with pytest.raises(ValueError) as terr:
        backend.ContinuousBatchingBackend(ServingGeometry(**geo), device="cpu").register(
            backend.Variant("tier-xlstm", cfg, {}, 28.0))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="paged decode"):
        T.init_paged_cache(cfg, 4, 4, device="cpu")
