"""The port's hybrid recurrent family (recurrentgemma) against the JAX package,
on the CPU in f32.

Every case runs ``reduced("recurrentgemma-2b", n_layers=5)``: one period of
(recurrent, recurrent, local) plus the (recurrent, recurrent) epilogue, so
stacked and unstacked recurrent layers both run.  Weights come from the JAX
``init_params`` through the weight bridge (``params_from_numpy``); inputs
from numpy seeds.  On the CPU the port's scan is the plain sequential
version, the JAX model's an associative scan, so sums differ in order.

Tolerances, each with its reason: the RG-LRU block and its decode step
atol 2e-5 (scan order); logits and cache leaves atol 1e-4 + rtol 1e-4 (the
reduced config draws its stacked weights with fan-in = period count = 1,
so activations grow through the stack); slot positions and greedy tokens
exactly; ``loss_fn`` atol 2e-5 + rtol 1e-4; each gradient leaf within
1e-3 of its own largest entry (+ rtol 1e-4): the scan's adjoint sums in
another order than ``jax.grad`` of the associative scan and the large
stacked weights amplify it through the five layers (measured: about 1e-4
of the leaf's largest entry in most leaves, at most 3.3e-4, at the local
layer's ``ln1``, which sums over every position; a wrong or missing term
is off by the whole leaf).
"""
import dataclasses
import io
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving.backend as jbackend  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.configs.mdinference_zoo import ServingGeometry as JGeometry  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.serving.backend as backend  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.configs.mdinference_zoo import ServingGeometry  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "recurrentgemma-2b"
PROMPT, STEPS, MAX_LEN, B = 12, 16, 40, 2


def _configs(**over):
    """(JAX config, port config): reduced recurrentgemma, 5 layers."""
    over = {"n_layers": 5, **over}
    jcfg, cfg = jarchs.reduced(ARCH, **over), archs.reduced(ARCH, **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _bridged(jcfg, cfg, seed):
    """JAX params (compiled init) and the same weights as port tensors."""
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(seed))
    return jparams, T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _np(t):
    return t.detach().float().numpy()


def _pairs(jtree, ttree):
    """(path, jax leaf, torch leaf) over two trees of the same structure."""
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    return [(jax.tree_util.keystr(p), a, b) for (p, a), (_, b) in zip(flat_j, flat_t)]


def test_reduced_hybrid_has_a_period_and_an_epilogue():
    _, cfg = _configs()
    assert cfg.pattern == ("recurrent", "recurrent", "local")
    assert cfg.n_periods == 1 and cfg.epilogue == ("recurrent", "recurrent")
    T.check_supported(cfg)
    T.check_supported(archs.ARCHS[ARCH])
    for arch in ("olmoe-1b-7b", "xlstm-350m"):  # ported since: tests/test_torch_moe.py
        T.check_supported(archs.ARCHS[arch])
    for arch in ("hubert-xlarge", "paligemma-3b"):  # ported since: tests/test_torch_frontends.py
        for device in ("cpu", "cuda"):
            T.check_supported(archs.ARCHS[arch], device)
    with pytest.raises(ValueError, match="encoder-only"):  # hubert has no decode step
        T.check_supported(archs.ARCHS["hubert-xlarge"], "cuda", decode=True)


# ---------------------------------------------------------------------------
# Init recipe: the JAX package's fill rules and f32 leaves.
# ---------------------------------------------------------------------------
LEAF_NAMES = ["ln1", "ln2", "final_norm", "q_norm", "k_norm", "lamb", "bf", "bi", "bz", "bo",
              "gate_a_b", "gate_x_b", "conv_b", "conv_w", "gate_a", "gate_x", "wx", "wy",
              "wo", "wq", "tokens", "head"]


@pytest.mark.parametrize("norm_offset", [False, True])
def test_init_fill_rules_and_fp32_leaves_match_jax(norm_offset):
    """For every leaf name the JAX package knows: the same constant (or a
    random draw on both sides) and the same f32-or-model-dtype choice."""
    for name in LEAF_NAMES:
        assert T._fp32_leaf(name) == JT._fp32_leaf(name), name
        leaf = np.asarray(JT._init_leaf(jax.random.key(0), name, (64, 8), jnp.float32,
                                        norm_offset))
        fill = T._init_fill(name, norm_offset)
        if fill is None:
            assert np.unique(leaf).size > 1, name
        else:
            np.testing.assert_array_equal(leaf, np.full((64, 8), fill, np.float32),
                                          err_msg=name)


def test_init_params_recipe_matches_jax():
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16") for c in _configs())
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(0))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for path, a, t in _pairs(jparams, params):
        assert t.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[a.dtype.name], path
        assert tuple(t.shape) == a.shape, path
    for rec in [params["periods"][0]["rec"], params["epilogue"][0]["rec"]]:
        assert torch.all(rec["lamb"] == 0.65) and rec["lamb"].dtype == torch.float32
        for name in ("gate_a_b", "gate_x_b"):
            assert torch.all(rec[name] == 0) and rec[name].dtype == torch.float32
        assert torch.all(rec["conv_b"] == 0) and rec["conv_b"].dtype == torch.bfloat16
        assert rec["gate_a"].dtype == torch.bfloat16 and rec["gate_a"].float().std() > 0
    assert torch.all(params["epilogue"][1]["ln2"] == 0.0)  # (1 + w) norm


# ---------------------------------------------------------------------------
# The recurrent block alone.
# ---------------------------------------------------------------------------
def _block_params(cfg, seed):
    """Random block weights (normal * 0.2, as tests/test_models.py draws
    them) as a JAX dict and a port dict."""
    rng = np.random.default_rng(seed)
    p = {k: (0.2 * rng.standard_normal(s)).astype(np.float32)
         for k, s in rglru.rglru_init_spec(cfg).items()}
    assert {k: v.shape for k, v in p.items()} == {
        k: s for k, (s, _) in jrglru.rglru_init_spec(cfg).items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in p.items()}


def test_rglru_apply_and_decode_step_match_jax():
    _, cfg = _configs()
    jp, tp = _block_params(cfg, 9)
    rng = np.random.default_rng(10)
    W, K = cfg.lru_width, cfg.conv_width
    x = (0.5 * rng.standard_normal((B, 24, cfg.d_model))).astype(np.float32)
    h0 = (0.3 * rng.standard_normal((B, W))).astype(np.float32)
    tail = (0.3 * rng.standard_normal((B, K - 1, W))).astype(np.float32)
    for carry in (None, (h0, tail)):
        jkw = {} if carry is None else dict(h0=jnp.asarray(h0), conv_tail=jnp.asarray(tail))
        tkw = {} if carry is None else dict(h0=torch.from_numpy(h0),
                                            conv_tail=torch.from_numpy(tail))
        jout, (jh, jtail) = jax.jit(lambda p, x: jrglru.rglru_apply(cfg, p, x, **jkw))(jp, x)
        out, (h, new_tail) = rglru.rglru_apply(cfg, tp, torch.from_numpy(x), **tkw)
        for got, want in ((out, jout), (h, jh), (new_tail, jtail)):
            np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5, rtol=0)
    cache = {"h": h0, "conv_tail": tail}
    jout, jcache = jax.jit(lambda p, x, c: jrglru.rglru_decode_step(cfg, p, x, c))(
        jp, x[:, :1], cache)
    out, new = rglru.rglru_decode_step(cfg, tp, torch.from_numpy(x[:, :1]),
                                       {k: torch.from_numpy(v) for k, v in cache.items()})
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=2e-5, rtol=0)
    for key in ("h", "conv_tail"):
        np.testing.assert_allclose(_np(new[key]), np.asarray(jcache[key]), atol=2e-5, rtol=0)
    assert new["h"].dtype == torch.float32


def test_rglru_scan_equals_stepwise():
    """The port's prefill (the scan) against its own decode path, token by
    token (tests/test_models.py's check, on the port)."""
    _, cfg = _configs()
    _, tp = _block_params(cfg, 9)
    x = torch.from_numpy((0.5 * np.random.default_rng(10).standard_normal(
        (B, 24, cfg.d_model))).astype(np.float32))
    full, (h, tail) = rglru.rglru_apply(cfg, tp, x)
    cache = rglru.rglru_init_cache(cfg, B, device="cpu")
    outs = []
    for t in range(x.shape[1]):
        o, cache = rglru.rglru_decode_step(cfg, tp, x[:, t:t + 1], cache)
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(cache["h"]), _np(h), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(cache["conv_tail"]), _np(tail), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The model: prefill, caches, greedy decode.
# ---------------------------------------------------------------------------
def _serve_twins(window=None, prompt=PROMPT, steps=STEPS, max_len=MAX_LEN, seed=0):
    """Prefill + greedy decode on both packages; the port's cache object and
    its leaves' storage must stay the same through every step."""
    jcfg, cfg = _configs(**({} if window is None else {"window": window}))
    jparams, params = _bridged(jcfg, cfg, seed)
    tokens = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (B, prompt))
    jpre = jax.jit(lambda p, t: JT.prefill(jcfg, p, {"tokens": t}, max_len=max_len))
    jdec = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, p, c, t, pos))
    jcache, jlogits = jpre(jparams, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        cache, logits = T.prefill(cfg, params, {"tokens": torch.as_tensor(tokens)},
                                  max_len=max_len)
    res = dict(jlogits=np.asarray(jlogits), logits=logits.numpy().copy(),
               jcache=jax.tree.map(np.asarray, jcache),
               cache=jax.tree.map(lambda t: t.numpy().copy(), cache))
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    jtok, tok = jnp.argmax(jlogits, -1).astype(jnp.int32), logits.argmax(-1)
    jtoks, toks, jsteps, tsteps = [], [], [], []
    for i in range(steps):
        jtoks.append(np.asarray(jtok))
        toks.append(tok.numpy().copy())
        pos = np.full((B,), prompt + i, np.int32)
        jl, jcache = jdec(jparams, jcache, jtok, jnp.asarray(pos))
        with torch.inference_mode():
            tl, same = T.decode_step(cfg, params, cache, tok, torch.as_tensor(pos))
        assert same is cache
        jsteps.append(np.asarray(jl))
        tsteps.append(tl.numpy().copy())
        jtok, tok = jnp.argmax(jl, -1).astype(jnp.int32), tl.argmax(-1)
    assert [t.data_ptr() for t in tree_leaves(cache)] == ptrs  # updated in place
    res.update(jtoks=np.stack(jtoks, 1), toks=np.stack(toks, 1), jsteps=np.stack(jsteps),
               steps=np.stack(tsteps), jfinal=jax.tree.map(np.asarray, jcache),
               final=jax.tree.map(lambda t: t.numpy().copy(), cache))
    return res


@pytest.fixture(scope="module")
def runs():
    return _serve_twins()


def _caches_close(cache, jcache):
    for group in ("periods", "epilogue"):
        assert len(cache[group]) == len(jcache[group])
        for layer, jlayer in zip(cache[group], jcache[group]):
            assert sorted(layer) == sorted(jlayer)
            for key, got in layer.items():
                want = jlayer[key]
                assert got.shape == want.shape, key
                if key == "slot_pos":
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4,
                                               err_msg=f"{group} {key}")


def test_prefill_logits_and_every_cache_leaf_match_jax(runs):
    np.testing.assert_allclose(runs["logits"], runs["jlogits"], atol=1e-4, rtol=1e-4)
    _caches_close(runs["cache"], runs["jcache"])
    rec = runs["cache"]["periods"][0]
    assert rec["h"].dtype == np.float32 and rec["h"].shape == (1, B, 64)
    assert np.abs(rec["h"]).max() > 0 and np.abs(rec["conv_tail"]).max() > 0


def test_greedy_decode_matches_jax(runs):
    np.testing.assert_array_equal(runs["toks"], runs["jtoks"])
    np.testing.assert_allclose(runs["steps"], runs["jsteps"], atol=1e-4, rtol=1e-4)


def test_local_ring_wraps_like_jax():
    """Window 8: the local layer's ring wraps in prefill (16 prompt tokens)
    and keeps wrapping over 16 decode steps (tests/test_models.py:203)."""
    r = _serve_twins(window=8, prompt=16, max_len=48, seed=2)
    np.testing.assert_allclose(r["logits"], r["jlogits"], atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(r["toks"], r["jtoks"])
    np.testing.assert_allclose(r["steps"], r["jsteps"], atol=1e-4, rtol=1e-4)
    assert r["final"]["periods"][2]["k"].shape[2] == 8
    np.testing.assert_array_equal(r["final"]["periods"][2]["slot_pos"],
                                  r["jfinal"]["periods"][2]["slot_pos"])


# ---------------------------------------------------------------------------
# Training: loss_fn and every gradient.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_loss_fn_and_grads_match_jax(remat):
    jcfg, cfg = (dataclasses.replace(c, remat=remat) for c in _configs())
    jparams, params = _bridged(jcfg, cfg, 1)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, 49)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    batch = {"tokens": toks[:, :-1], "labels": labels}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))(jparams, batch)
    params = tree_map(lambda p: p.requires_grad_(True), params)
    loss, met = T.loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    tgrads = tree_map(lambda _: next(grads), params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(float(met["xent"].detach()), float(jmet["xent"]), atol=2e-5,
                               rtol=1e-4)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * 48 - 5
    for path, a, b in _pairs(jgrads, tgrads):
        scale = float(np.abs(np.asarray(a)).max())
        assert scale > 0, path
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-3 * scale, rtol=1e-4,
                                   err_msg=path)


def test_train_main_recurrentgemma_on_cpu():
    """``launch.train`` with no new flag: --layers 5 gives one period plus
    the (recurrent, recurrent) epilogue."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = train_launch.main(["--device", "cpu", "--arch", ARCH, "--d-model", "64",
                                  "--layers", "5", "--steps", "3", "--batch", "2",
                                  "--seq", "32", "--log-every", "1"])
    log = buf.getvalue()
    assert code == 0 and log.startswith(f"arch={ARCH} params~") and "device=cpu" in log
    losses = {int(m.group(1)): float(m.group(2))
              for m in re.finditer(r"step\s+(\d+)\s+loss\s+([\d.]+)", log)}
    assert sorted(losses) == [0, 1, 2] and all(np.isfinite(list(losses.values())))
    assert re.search(r"done: loss [\d.]+ -> [\d.]+ over 3 steps", log)


# ---------------------------------------------------------------------------
# Serving: the dense tier serves the family, the continuous tier refuses it.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def twin_backends():
    jcfg, cfg = _configs()
    jparams, params = _bridged(jcfg, cfg, 4)
    jb = jbackend.JitBackend(max_len=32)
    jb.register(jbackend.Variant("tier-rg", jcfg, jparams, 42.0))
    tb = backend.JitBackend(max_len=32, device="cpu")
    tb.register(backend.Variant("tier-rg", cfg, params, 42.0))
    return cfg, jb, tb


@pytest.mark.parametrize("batch", [1, 3])
def test_jit_backend_generate_token_equal_to_jax(twin_backends, batch):
    cfg, jb, tb = twin_backends
    tokens = np.random.default_rng(batch).integers(0, cfg.vocab_size, (batch, 10))
    jout, _ = jb.generate("tier-rg", tokens, 6)
    out, wall_ms = tb.generate("tier-rg", tokens, 6)
    assert out.dtype == np.int32 and out.shape == (batch, 6)
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert wall_ms > 0


def test_continuous_backend_refuses_the_family_like_jax():
    jcfg, cfg = _configs()
    assert not T.supports_paged_decode(cfg) and not JT.supports_paged_decode(jcfg)
    geo = dict(prompt_width=8, bs_ladder=(1, 2), n_slots=2, page_size=4, max_steps=4)
    with pytest.raises(ValueError) as jerr:
        jbackend.ContinuousBatchingBackend(JGeometry(**geo)).register(
            jbackend.Variant("tier-rg", jcfg, {}, 42.0))
    with pytest.raises(ValueError) as terr:
        backend.ContinuousBatchingBackend(ServingGeometry(**geo), device="cpu").register(
            backend.Variant("tier-rg", cfg, {}, 42.0))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="paged decode"):
        T.init_paged_cache(cfg, 4, 4, device="cpu")


def test_train_steps_match_jax():
    """Three ``make_train_step`` steps from the same bridged state (remat on,
    AdamW), as tests/test_torch_training.py runs the attention tiers.

    Each step is taken by the port from a copy of JAX's state of that
    step, so each step's function is held on its own:
    * loss, xent, lr and tokens rtol 1e-3, the gradient norm rtol 5e-3
      (measured at most 2.0e-4);
    * every parameter whose JAX gradient exceeds 1e-3 of its leaf's largest
      entry (the bound to which the port's gradient matches JAX's, see the
      module docstring) equals JAX's updated value within atol 1e-6 + rtol
      1e-5 (measured: no element beyond it);
    * the others, where Adam's ``m / sqrt(v)`` is the sign of a gradient
      within rounding of zero, within 2 lr of it (a step of +lr on one side,
      -lr on the other), and at most 1% of all elements beyond the tight
      tolerance (measured 27, 3 and 1 of 234176 at steps 0, 1, 2);
    * every leaf moved on both sides.
    Along the two free trajectories loss, xent, lr and tokens rtol 1e-3
    (measured at most 1.3e-4), and the gradient norm at step 0, where the
    states are the same.  The trajectories part at step 0's update through
    those sign flips (one embedding element's gradient reads -6.3e-6 in
    JAX and 2.7e-5 in the port, of a leaf whose largest entry is 3.8, so it
    steps by +lr on one side and -lr on the other), and step 2's gradient
    norm is chaotic in the parameters: noise of 1e-5 on every parameter of
    JAX's step-2 state moves it between 19.2 and 25.9, and the port's own
    trajectory reads 16.8 where JAX's reads 20.3 (on an AVX-512 CPU; its
    embedding leaf alone, swapped into JAX's state, gives 17.6)."""
    from repro import training as jtraining
    from repro.training import optimizer as jopt
    from repro_torch import training
    from repro_torch.training import optimizer

    jcfg, cfg = _configs()
    opt = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    jstate = jax.jit(lambda key: jtraining.init_train_state(jcfg, key, jtraining.TrainConfig()))(
        jax.random.key(2))
    state = training.train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jtraining.make_train_step(jcfg, jopt.OptimizerConfig(**opt), jtraining.TrainConfig())
    jgrad = jax.jit(jax.grad(lambda p, b: JT.loss_fn(jcfg, p, b)[0]))
    step_fn = training.make_train_step(cfg, optimizer.OptimizerConfig(**opt),
                                       training.TrainConfig())
    pipe = training.make_pipeline(training.DataConfig(batch_size=4, seq_len=32, seed=3), cfg)
    for step in range(3):
        batch = pipe.batch_at(step)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        before = jax.tree.map(np.asarray, jstate["params"])
        grads = jax.tree.map(np.asarray, jgrad(jstate["params"], jbatch))
        forced, fm = step_fn(training.train_state_from_numpy(
            cfg, jax.tree.map(np.asarray, jstate), device="cpu"), tbatch)
        jstate, jm = jstep(jstate, jbatch)
        state, m = step_fn(state, tbatch)
        for key in ("loss", "grad_norm", "lr", "xent", "tokens"):
            rtol = 5e-3 if key == "grad_norm" else 1e-3
            np.testing.assert_allclose(float(fm[key]), float(jm[key]), rtol=rtol,
                                       err_msg=f"step {step} {key}, from JAX's state")
            if key != "grad_norm" or step == 0:
                np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=rtol,
                                           err_msg=f"step {step} {key}")
        lr = float(jm["lr"])
        off, total = 0, 0
        for (path, a, b), (_, a0, _), (_, g, _) in zip(
                _pairs(jstate["params"], forced["params"]), _pairs(before, forced["params"]),
                _pairs(grads, forced["params"])):
            a, b, g = np.asarray(a), _np(b), np.abs(np.asarray(g))
            where = f"step {step} {path}"
            assert (b != a0).any() and (a != a0).any(), f"{where} did not move"
            diff = np.abs(a - b)
            beyond = diff > 1e-6 + 1e-5 * np.abs(a)
            assert not (beyond & (g > 1e-3 * g.max())).any(), where
            assert diff.max() <= 2 * lr * (1 + 1e-3), where
            off += int(beyond.sum())
            total += a.size
        assert off <= total // 100, f"step {step}: {off} of {total} parameters differ"
