"""The port's MoE family (olmoe-1b-7b, llama4-scout) against the JAX package,
on the CPU in f32.

* ``moe_apply`` alone, on the same numpy-seeded weights, mirroring
  tests/test_models.py's MoE cases: the dense-loop equivalence, capacity
  drops (no NaN, the same tokens dropped), group invariance and the
  sigmoid top-1 router with a shared expert.  Output and aux loss atol 1e-5
  (f32 summation order).
* reduced olmoe and llama4-scout end to end on weights bridged from the JAX
  ``init_params``: prefill logits allclose, greedy tokens equal over 8
  decode steps; ``JitBackend`` tokens equal; olmoe's continuous tier
  token-equal to the JAX ``ContinuousBatchingBackend`` (its pad tokens and
  inactive decode rows take expert capacity on both sides).
* ``check_supported`` accepts the MoE and xLSTM kinds, the int8 KV cache
  (which the paged tier still excludes) and the two frontends, and refuses
  hubert's decode; both kinds train (their gradients against the JAX
  package: tests/test_torch_train_zoo.py).
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
import repro_torch.serving.backend as backend  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.configs.mdinference_zoo import ServingGeometry  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ATOL = 1e-5
MOE_ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e")


# ---------------------------------------------------------------------------
# moe_apply alone.
# ---------------------------------------------------------------------------
def _moe_cfgs(**kw):
    base = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                head_dim=8, d_ff=0, vocab_size=64, pattern=("moe",), n_experts=4, top_k=2,
                expert_d_ff=32, moe_groups=1)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _moe_params(cfg, seed=3):
    """Normal * 0.2 weights from numpy, as a JAX dict and a port dict."""
    rng = np.random.default_rng(seed)
    spec = moe.moe_init_spec(cfg)
    p = {k: (0.2 * rng.standard_normal(s)).astype(np.float32) for k, s in spec.items()}
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    assert spec == {k: s for k, (s, _) in jmoe.moe_init_spec(jcfg).items()}
    return {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in p.items()}


def _x(seed, shape, scale):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _both(jcfg, cfg, jp, tp, x):
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_apply(jcfg, p, x))(jp, jnp.asarray(x))
    out, aux = moe.moe_apply(cfg, tp, torch.from_numpy(x))
    return np.asarray(jout), float(jaux), out.numpy(), float(aux)


MOE_CASES = {
    "dense_loop": dict(capacity_factor=100.0),
    "capacity_drops": dict(capacity_factor=0.25, moe_groups=2),
    "groups_2": dict(capacity_factor=100.0, moe_groups=2),
    "groups_4": dict(capacity_factor=100.0, moe_groups=4),
    "sigmoid_top1_shared": dict(top_k=1, router_type="sigmoid", n_shared_experts=1,
                                capacity_factor=100.0),
    "gelu": dict(mlp_type="gelu", capacity_factor=1.0),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case):
    jcfg, cfg = _moe_cfgs(**MOE_CASES[case])
    jp, tp = _moe_params(cfg)
    x = _x(4, (2, 8, 16), 1.0 if case == "capacity_drops" else 0.5)
    jout, jaux, out, aux = _both(jcfg, cfg, jp, tp, x)
    assert out.shape == x.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux, jaux, atol=ATOL, rtol=0)


def test_moe_matches_dense_loop():
    _, cfg = _moe_cfgs(capacity_factor=100.0)
    _, p = _moe_params(cfg)
    x = torch.from_numpy(_x(4, (2, 8, 16), 0.5))
    out, _ = moe.moe_apply(cfg, p, x)
    probs = torch.softmax(x.reshape(-1, 16) @ p["router"], -1)
    tg, ti = torch.topk(probs, 2)
    tg = tg / tg.sum(-1, keepdim=True)
    ref = torch.zeros(16, 16)
    xt = x.reshape(-1, 16)
    for t in range(16):
        for s in range(2):
            e = int(ti[t, s])
            h = torch.nn.functional.silu(xt[t] @ p["wi"][e]) * (xt[t] @ p["wg"][e])
            ref[t] += tg[t, s] * (h @ p["wo"][e])
    np.testing.assert_allclose(out.reshape(16, 16).numpy(), ref.numpy(), atol=ATOL)


def test_moe_capacity_drops_tokens_not_nans():
    """Capacity 2 per expert over 8 tokens x top-2: assignments overflow, and
    the tokens dropped are the JAX package's (the outputs agree, and the
    tokens whose every assignment was dropped come out zero on both)."""
    jcfg, cfg = _moe_cfgs(capacity_factor=0.25, moe_groups=2)
    assert moe.capacity(8, 4, 2, 0.25) == 2
    jp, tp = _moe_params(cfg)
    x = _x(5, (2, 8, 16), 1.0)
    jout, jaux, out, aux = _both(jcfg, cfg, jp, tp, x)
    assert np.isfinite(out).all() and aux > 0
    zero_rows = ~out.reshape(-1, 16).any(-1)
    assert zero_rows.any()  # some token lost every assignment
    np.testing.assert_array_equal(zero_rows, ~jout.reshape(-1, 16).any(-1))
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)


def test_moe_group_invariance():
    """Grouping must not change results when capacity is generous."""
    _, p = _moe_params(_moe_cfgs()[1])
    x = torch.from_numpy(_x(6, (2, 8, 16), 0.5))
    outs = [moe.moe_apply(_moe_cfgs(capacity_factor=100.0, moe_groups=g)[1], p, x)[0].numpy()
            for g in (1, 2, 4)]
    np.testing.assert_allclose(outs[0], outs[1], atol=ATOL)
    np.testing.assert_allclose(outs[0], outs[2], atol=ATOL)
    with pytest.raises(ValueError, match="not divisible by moe_groups 3"):
        moe.moe_apply(_moe_cfgs(moe_groups=3)[1], p, x)


def test_moe_sigmoid_router_top1_shared_expert():
    _, cfg = _moe_cfgs(top_k=1, router_type="sigmoid", n_shared_experts=1,
                       capacity_factor=100.0)
    _, p = _moe_params(cfg)
    x = torch.from_numpy(_x(7, (1, 8, 16), 0.5))
    out, _ = moe.moe_apply(cfg, p, x)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    # The shared expert contributes: zeroing it changes the output.
    out2, _ = moe.moe_apply(cfg, dict(p, shared_wo=torch.zeros_like(p["shared_wo"])), x)
    assert float((out - out2).abs().max()) > 1e-4
    # The routed expert's gate is the sigmoid of its logit, not a softmax.
    logits = x.reshape(-1, 16) @ p["router"]
    idx, gate, _ = moe._route(cfg, p["router"], x.reshape(-1, 16))
    torch.testing.assert_close(gate, torch.sigmoid(logits).gather(-1, logits.argmax(-1)[:, None]))


def test_moe_bf16_output_is_the_same_over_two_calls():
    """The combine gathers and reduces in a fixed order: two calls on the
    same bf16 input agree bitwise."""
    _, cfg = _moe_cfgs(capacity_factor=1.0, dtype="bfloat16")
    _, p = _moe_params(cfg)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    x = torch.from_numpy(_x(8, (4, 8, 16), 1.0)).to(torch.bfloat16)
    a, b = moe.moe_apply(cfg, p, x)[0], moe.moe_apply(cfg, p, x)[0]
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Configs, init and support.
# ---------------------------------------------------------------------------
NEW_LEAVES = ["router", "wi", "wg", "wo", "shared_wi", "shared_wg", "shared_wo", "wq", "wk",
              "wv", "wz", "wf", "bi", "bf", "bz", "bo", "ri", "rf", "rz", "ro", "wo_proj"]


@pytest.mark.parametrize("norm_offset", [False, True])
def test_new_leaves_fill_rules_and_fp32_match_jax(norm_offset):
    for name in NEW_LEAVES:
        assert T._fp32_leaf(name) == JT._fp32_leaf(name), name
        leaf = np.asarray(JT._init_leaf(jax.random.key(0), name, (64, 8), jnp.float32,
                                        norm_offset))
        fill = T._init_fill(name, norm_offset)
        if fill is None:
            assert np.unique(leaf).size > 1, name
        else:
            np.testing.assert_array_equal(leaf, np.full((64, 8), fill, np.float32), err_msg=name)


@pytest.mark.parametrize("arch", MOE_ARCHS + ("xlstm-350m",))
def test_init_params_tree_matches_jax(arch):
    """Same tree, shapes and dtypes as the JAX ``init_params`` (bf16)."""
    jcfg, cfg = jarchs.reduced(arch, dtype="bfloat16"), archs.reduced(arch, dtype="bfloat16")
    jparams = jax.eval_shape(lambda key: JT.init_params(jcfg, key), jax.random.key(0))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, t) in zip(flat_j, flat_t):
        key = jax.tree_util.keystr(path)
        assert tuple(t.shape) == a.shape, key
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name, key


def test_check_supported_accepts_the_new_kinds_and_refuses_the_rest():
    for arch in MOE_ARCHS + ("xlstm-350m",):
        cfg = archs.ARCHS[arch]
        T.check_supported(cfg)
        T.check_supported(cfg, "cuda")  # head dim 128 / no attention: kernels exist
        T.check_supported(archs.reduced(arch), "cpu")
    for arch in ("hubert-xlarge", "paligemma-3b"):  # the frontends, ported since
        for device in ("cpu", "cuda"):
            T.check_supported(archs.ARCHS[arch], device)
            T.check_supported(archs.reduced(arch), device)
    for device in ("cpu", "cuda"):  # an encoder has no decode step; prefix-LM has
        with pytest.raises(ValueError, match="encoder-only"):
            T.check_supported(archs.ARCHS["hubert-xlarge"], device, decode=True)
        T.check_supported(archs.ARCHS["paligemma-3b"], device, decode=True)
    # The int8 ring cache is served; the paged tier still excludes it.
    quant = archs.reduced("olmoe-1b-7b", kv_cache_quant=True)
    T.check_supported(quant, "cuda")
    assert not T.supports_paged_decode(quant)
    # A MoE stack's attention still needs a kernel head dim on the card.
    with pytest.raises(NotImplementedError, match="head dim 24 has no CUDA"):
        T.check_supported(archs.reduced("olmoe-1b-7b", head_dim=24), "cuda")


@pytest.mark.parametrize("arch", MOE_ARCHS + ("xlstm-350m",))
def test_the_new_kinds_train(arch):
    """MoE and xLSTM stacks train: a finite loss, a positive load-balancing
    loss exactly where there are MoE blocks, and the train command runs."""
    cfg = archs.reduced(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.long),
             "labels": torch.zeros((2, 16), dtype=torch.long)}
    loss, metrics = T.loss_fn(cfg, params, batch)
    assert torch.isfinite(loss)
    assert (float(metrics["aux"]) > 0) == ("moe" in cfg.layer_kinds())
    assert float(loss) == float(metrics["xent"] + 0.01 * metrics["aux"])
    assert train_launch.main(["--device", "cpu", "--arch", arch, "--d-model", "64",
                              "--steps", "1", "--batch", "2", "--seq", "16"]) == 0


# ---------------------------------------------------------------------------
# Reduced models end to end.
# ---------------------------------------------------------------------------
PROMPT, STEPS, MAX_LEN, B = 12, 8, 32, 2


def _bridged(arch, seed, **over):
    jcfg, cfg = jarchs.reduced(arch, **over), archs.reduced(arch, **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(seed))
    return jcfg, cfg, jparams, T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                   device="cpu")


def _serve_twins(arch, seed=0):
    """Prefill + greedy decode on both packages."""
    jcfg, cfg, jparams, params = _bridged(arch, seed)
    tokens = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (B, PROMPT))
    jcache, jlogits = jax.jit(lambda p, t: JT.prefill(jcfg, p, {"tokens": t}, max_len=MAX_LEN))(
        jparams, jnp.asarray(tokens, jnp.int32))
    jdec = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, p, c, t, pos))
    with torch.inference_mode():
        cache, logits = T.prefill(cfg, params, {"tokens": torch.as_tensor(tokens)},
                                  max_len=MAX_LEN)
    res = dict(jlogits=[np.asarray(jlogits)], logits=[logits.numpy().copy()], jtoks=[], toks=[])
    jtok, tok = jnp.argmax(jlogits, -1).astype(jnp.int32), logits.argmax(-1)
    for i in range(STEPS):
        res["jtoks"].append(np.asarray(jtok))
        res["toks"].append(tok.numpy().copy())
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jcache = jdec(jparams, jcache, jtok, jnp.asarray(pos))
        with torch.inference_mode():
            tl, _ = T.decode_step(cfg, params, cache, tok, torch.as_tensor(pos))
        res["jlogits"].append(np.asarray(jl))
        res["logits"].append(tl.numpy().copy())
        jtok, tok = jnp.argmax(jl, -1).astype(jnp.int32), tl.argmax(-1)
    res["jcache"] = jax.tree.map(np.asarray, jcache)
    res["cache"] = jax.tree.map(lambda t: t.numpy().copy(), cache)
    return res


@pytest.fixture(scope="module", params=MOE_ARCHS)
def runs(request):
    return _serve_twins(request.param)


def test_prefill_and_decode_logits_match_jax(runs):
    for i, (got, want) in enumerate(zip(runs["logits"], runs["jlogits"])):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=f"step {i}")


def test_greedy_tokens_match_jax(runs):
    np.testing.assert_array_equal(np.stack(runs["toks"]), np.stack(runs["jtoks"]))


def test_ring_cache_matches_jax(runs):
    for group in ("periods", "epilogue"):
        for layer, jlayer in zip(runs["cache"][group], runs["jcache"][group]):
            assert sorted(layer) == sorted(jlayer) == ["k", "slot_pos", "v"]
            np.testing.assert_array_equal(layer["slot_pos"], jlayer["slot_pos"])
            for key in ("k", "v"):
                np.testing.assert_allclose(layer[key], jlayer[key], atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def jit_twins(request):
    jcfg, cfg, jparams, params = _bridged(request.param, 4)
    jb = jbackend.JitBackend(max_len=32)
    jb.register(jbackend.Variant("tier-moe", jcfg, jparams, 54.0))
    tb = backend.JitBackend(max_len=32, device="cpu")
    tb.register(backend.Variant("tier-moe", cfg, params, 54.0))
    return cfg, jb, tb


@pytest.mark.parametrize("batch", [1, 3])
def test_jit_backend_generate_token_equal_to_jax(jit_twins, batch):
    cfg, jb, tb = jit_twins
    tokens = np.random.default_rng(batch).integers(0, cfg.vocab_size, (batch, 10))
    out, wall_ms = tb.generate("tier-moe", tokens, 6)
    assert out.dtype == np.int32 and out.shape == (batch, 6) and wall_ms > 0
    np.testing.assert_array_equal(out, np.asarray(jb.generate("tier-moe", tokens, 6)[0]))


@pytest.fixture(scope="module")
def continuous_twins():
    geo = dict(max_len=32, prompt_width=8, bs_ladder=(1, 2, 4), n_slots=4, page_size=4,
               max_steps=8)
    jcfg, cfg, jparams, params = _bridged("olmoe-1b-7b", 6)
    assert T.supports_paged_decode(cfg) and JT.supports_paged_decode(jcfg)
    jb = jbackend.ContinuousBatchingBackend(JGeometry(**geo))
    tb = backend.ContinuousBatchingBackend(ServingGeometry(**geo), device="cpu")
    jb.register(jbackend.Variant("tier-moe", jcfg, jparams, 54.0))
    tb.register(backend.Variant("tier-moe", cfg, params, 54.0))
    jb.warmup()
    tb.warmup()
    return jb, tb, tb.compile_count


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_continuous_backend_token_equal_to_jax(continuous_twins, batch):
    """Ladder sizes and a padded partial (3 -> 2 + 1); prompts shorter than
    the prefill width, so pad tokens take expert capacity on both sides."""
    jb, tb, compiles = continuous_twins
    tokens = np.random.default_rng(10 + batch).integers(0, 256, (batch, 6)).astype(np.int32)
    out, wall_ms = tb.generate("tier-moe", tokens, 5)
    assert out.shape == (batch, 5) and wall_ms > 0
    np.testing.assert_array_equal(out, np.asarray(jb.generate("tier-moe", tokens, 5)[0]))
    assert tb.compile_count == compiles
    tb.check_conservation()
