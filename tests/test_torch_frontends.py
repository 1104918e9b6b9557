"""The audio and vision frontends and prefix-LM attention: the port against
the JAX package, on the CPU in f32.

Reduced hubert-xlarge (frames through ``frontend.proj``, a bidirectional
encoder) and paligemma-3b (8 patches through ``frontend.proj``, scaled and
put before the tokens, with prefix-LM attention over them).  Weights and
train states come from the JAX ``init_*`` functions through the bridges,
inputs from numpy with fixed seeds.

* The plain prefix attention (``ref.flash_attention_ref``,
  ``ref.flash_attention_bwd_ref``, ``prefix_len=``) against the JAX
  model's ``flash_attention(..., prefix_len=)`` and ``jax.vjp`` of it, with
  prefixes 0, 1, 8, 100 and S and one per row that differ within the batch,
  causal, GQA: out atol 1e-5, gradients atol 3e-5 (the JAX model sums in
  key chunks; tests/test_torch_training.py's attention tolerance).  The
  model of the wgmma backward's tile walk
  (``ref.flash_attention_bwd_tiled_ref``) with prefixes that end inside a
  64-key tile, beside a window, against the same ``jax.vjp``: atol 3e-5.
* paligemma: prefill logits with the patches (atol 1e-4 + rtol 1e-4: the
  reduced stack's logits reach ~5, and the JAX prefill sums attention in
  chunks), then 8 greedy decode steps whose tokens equal JAX's, as in
  tests/test_models.py's teacher-forcing check; the decode logits at the
  same tolerance.
* hubert: forward logits (atol 1e-4 + rtol 1e-4), and ``loss_fn``'s loss
  (atol 2e-5 + rtol 1e-4) and every gradient leaf within 2e-4 of the
  leaf's largest entry (tests/test_torch_training.py's bound for reduced
  stacks), ``frontend.proj`` included; the same for paligemma.  hubert's
  token embedding is in the JAX tree but no input reaches it: its gradient
  is zero on both sides.
* Three ``make_train_step`` steps for each model: metrics rtol 1e-3, the
  parameters as tests/test_torch_training.py holds them.
* A train step gives zero gradients only to the leaves no input reaches
  (hubert's token embedding) and raises for any other leaf cut off from
  the loss; hubert's decode cache, decode step and serving backends are
  refused; ``launch.train`` runs both archs.  (``check_supported``'s
  acceptance of both is tests/test_torch_moe.py's.)
"""
import functools
import io
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import training as jtraining  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import training  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import backend  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402

FRONTEND_ARCHS = ("hubert-xlarge", "paligemma-3b")
OPT = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100)


def _np(t):
    return t.detach().float().numpy()


def _pairs(jtree, ttree):
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    return [(jax.tree_util.keystr(p), a, b) for (p, a), (_, b) in zip(flat_j, flat_t)]


# ---------------------------------------------------------------------------
# The plain prefix attention against the JAX model's.
# ---------------------------------------------------------------------------
S_ATTN = 128
# Prefix lengths per row: the same for both rows, then differing rows.
PREFIXES = [(0, 0), (1, 1), (8, 8), (100, 100), (S_ATTN, S_ATTN), (3, 77), (0, 1, 100, S_ATTN)]


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _jax_attention_vjp(q, k, v, dout, prefix, *, causal, window):
    """The JAX model's flash attention (model layout) and its vjp."""
    def f(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal, window=window,
                                     prefix_len=prefix)

    out, vjp = jax.vjp(f, q, k, v)
    return out, vjp(dout)


def _attention_case(prefix, S, seed, B_NQ_NKV_D=(4, 2, 16), causal=True, window=0):
    """Inputs in the model layout (B, S, N, D), the JAX out and gradients,
    and the port's kernel-layout tensors with its f32 out and LSE."""
    NQ, NKV, D = B_NQ_NKV_D
    B = len(prefix)
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, S, NQ, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, NKV, D)).astype(np.float32) for _ in range(2))
    pre = np.asarray(prefix, np.int32)
    jout, jgrads = _jax_attention_vjp(*(jnp.asarray(a) for a in (q, k, v, do, pre)),
                                      causal=causal, window=window)
    tq, tk, tv, tdo = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, do))
    tpre = torch.from_numpy(pre)
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                       return_lse=True, prefix_len=tpre)
    return (tq, tk, tv, tdo, tpre, out, lse), np.asarray(jout), [np.asarray(g) for g in jgrads]


def _kernel_to_model(t):
    return t.transpose(1, 2).numpy()


@pytest.mark.parametrize("prefix", PREFIXES, ids=lambda p: "-".join(map(str, p)))
def test_prefix_attention_plain_matches_jax(prefix):
    (q, k, v, do, pre, out, lse), jout, jgrads = _attention_case(prefix, S_ATTN, seed=sum(prefix))
    np.testing.assert_allclose(_kernel_to_model(out), jout, atol=1e-5, rtol=0)
    grads = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, prefix_len=pre)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(_kernel_to_model(g), jg, atol=3e-5, rtol=0, err_msg=name)


def test_prefix_changes_the_result():
    """A prefix of 0 is the causal mask; a longer one is not."""
    (q, k, v, *_), _, _ = _attention_case((0, 0), S_ATTN, seed=1)
    causal = ref.flash_attention_ref(q, k, v)
    none = ref.flash_attention_ref(q, k, v, prefix_len=torch.zeros(2, dtype=torch.int32))
    assert torch.equal(causal, none)
    some = ref.flash_attention_ref(q, k, v, prefix_len=torch.tensor([0, 9], dtype=torch.int32))
    assert torch.equal(some[0], causal[0]) and not torch.allclose(some[1], causal[1])
    # Rows past the prefix saw its keys already: only rows 0 .. 7 change.
    assert torch.equal(some[1, :, 9:], causal[1, :, 9:])


# (prefix per row, S, window): prefixes that end inside a 64-key tile, a
# prefix past the window, ragged S; the wgmma route's 64 x 64 tiles.
TILED_CASES = [
    ((70, 130), 200, 0),
    ((0, 64, 1), 129, 0),
    ((70, 5), 200, 37),
    ((200,), 200, 0),
]


@pytest.mark.parametrize("prefix,S,window", TILED_CASES,
                         ids=lambda c: str(c).replace(" ", ""))
def test_prefix_tiled_bwd_model_matches_jax(prefix, S, window):
    """The tile walk of the kernel's backward with the prefix's wider bands
    (``flash_attention_bwd_tiled_ref``), ragged head groups of a G = 4
    head, against ``jax.vjp`` of the JAX model's attention."""
    (q, k, v, do, pre, out, lse), _, jgrads = _attention_case(
        prefix, S, seed=S + window, B_NQ_NKV_D=(4, 1, 32), window=window)
    for hpg in (4, 3):
        grads = ref.flash_attention_bwd_tiled_ref(q, k, v, out, do, lse, window=window,
                                                  heads_per_group=hpg, prefix_len=pre)
        for name, g, jg in zip("qkv", grads, jgrads):
            np.testing.assert_allclose(_kernel_to_model(g), jg, atol=3e-5, rtol=0,
                                       err_msg=f"{name} hpg={hpg}")


# ---------------------------------------------------------------------------
# The models.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jparams(arch, seed=0):
    jcfg = jarchs.reduced(arch)
    return jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(seed))


def _bridged(arch, seed=0):
    jcfg, cfg = jarchs.reduced(arch), archs.reduced(arch)
    jp = _jparams(arch, seed)
    return jcfg, cfg, jp, T.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _inputs(cfg, B, S, seed):
    """Numpy model inputs: frames for audio; tokens (and patches) else."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_frontend_leaf_in_spec_and_bridge():
    for arch in FRONTEND_ARCHS:
        jcfg, cfg, jp, params = _bridged(arch)
        proj = params["frontend"]["proj"]
        assert tuple(proj.shape) == (cfg.frontend_dim, cfg.d_model)
        np.testing.assert_array_equal(_np(proj), np.asarray(jp["frontend"]["proj"]))
        init = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert init["frontend"]["proj"].shape == proj.shape and init["frontend"]["proj"].std() > 0


def test_paligemma_prefill_and_greedy_decode_match_jax():
    jcfg, cfg, jp, params = _bridged("paligemma-3b")
    B, S, steps = 2, 12, 8
    P = cfg.num_prefix_tokens
    batch = _inputs(cfg, B, S, seed=4)
    max_len = P + S + steps
    jcache, jlogits = jax.jit(lambda p, b: JT.prefill(jcfg, p, b, max_len))(jp, _jnp(batch))
    jdec = jax.jit(lambda p, c, t, pos: JT.decode_step(jcfg, p, c, t, pos))
    with torch.inference_mode():
        cache, logits = T.prefill(cfg, params, _torch(batch), max_len)
        assert tuple(logits.shape) == (B, cfg.vocab_size)
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
        # The cache holds the patches' keys, at positions 0 .. P - 1.
        assert int(cache["periods"][0]["slot_pos"][0, 0, P + S - 1]) == P + S - 1
        tok, jtok = logits.argmax(-1).to(torch.int32), jnp.argmax(jlogits, -1).astype(jnp.int32)
        for i in range(steps):
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok), err_msg=f"step {i}")
            pos = np.full((B,), P + S + i, np.int32)
            jlogits, jcache = jdec(jp, jcache, jtok, jnp.asarray(pos))
            logits, cache = T.decode_step(cfg, params, cache, tok, torch.from_numpy(pos))
            np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {i}")
            tok = logits.argmax(-1).to(torch.int32)
            jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)


def test_hubert_forward_logits_match_jax():
    jcfg, cfg, jp, params = _bridged("hubert-xlarge")
    batch = _inputs(cfg, 2, 24, seed=5)

    @jax.jit
    def jlogits(p, b):
        x, _, _ = JT.forward_hidden(jcfg, p, b)
        return JT._unembed(jcfg, p, x)

    with torch.inference_mode():
        x, _, _ = T.forward_hidden(cfg, params, _torch(batch))
        logits = T._unembed(cfg, params, x)
    want = np.asarray(jlogits(jp, _jnp(batch)))
    assert logits.shape == want.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), want, atol=1e-4, rtol=1e-4)


def _loss_batch(cfg, B, S, seed):
    batch = _inputs(cfg, B, S, seed)
    labels = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1  # ignored positions
    batch["labels"] = labels
    return batch


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_loss_fn_and_grads_match_jax(arch):
    jcfg, cfg, jp, params = _bridged(arch, seed=1)
    batch = _loss_batch(cfg, 2, 16, seed=len(arch))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))(jp, _jnp(batch))
    leaves = [p.requires_grad_(True) for p in jax.tree_util.tree_leaves(params)]
    loss, met = T.loss_fn(cfg, params, _torch(batch))
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True))
    tgrads = jax.tree_util.tree_map(lambda _: next(got), params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=2e-5, rtol=1e-4)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * 16 - 3
    for path, a, b in _pairs(jgrads, tgrads):
        a = np.asarray(a)
        scale = float(np.abs(a).max())
        if arch == "hubert-xlarge" and path == "['embed']['tokens']":
            assert scale == 0 and not b.any(), "no input reaches hubert's token embedding"
            continue
        assert scale > 0, path
        np.testing.assert_allclose(_np(b), a, atol=2e-4 * scale, rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_train_steps_match_jax(arch):
    jcfg, cfg = jarchs.reduced(arch), archs.reduced(arch)
    jstate = jax.jit(lambda key: jtraining.init_train_state(jcfg, key, jtraining.TrainConfig()))(
        jax.random.key(2))
    state = training.train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jtraining.make_train_step(jcfg, jopt.OptimizerConfig(**OPT), jtraining.TrainConfig())
    step_fn = training.make_train_step(cfg, optimizer.OptimizerConfig(**OPT),
                                       training.TrainConfig())
    pipe = training.make_pipeline(training.DataConfig(batch_size=4, seq_len=32, seed=3), cfg)
    for step in range(3):
        batch = pipe.batch_at(step)
        assert ("frames" in batch) == (cfg.frontend == "audio")
        assert ("patches" in batch) == (cfg.frontend == "vision")
        jstate, jm = jstep(jstate, _jnp(batch))
        state, m = step_fn(state, _torch(batch))
        for key in ("loss", "grad_norm", "lr", "xent", "tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-3,
                                       err_msg=f"step {step} {key}")
    off, total = 0, 0
    for path, a, b in _pairs(jstate["params"], state["params"]):
        a, b = np.asarray(a), _np(b)
        diff = np.abs(a - b)
        assert diff.max() <= 1e-3, path
        off += int((diff > 1e-6 + 1e-5 * np.abs(a)).sum())
        total += a.size
    assert off <= total // 1000, f"{off} of {total} parameters differ"


# ---------------------------------------------------------------------------
# Acceptance, refusals and the train command.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_only_leaves_no_input_reaches_get_zero_gradients(arch, monkeypatch):
    """A train step gives a zero gradient to exactly the leaves that
    ``unreached_leaves`` names (hubert's token embedding, as ``jax.grad``
    does); any other leaf cut off from the loss makes the step raise."""
    cfg = archs.reduced(arch)
    assert T.unreached_leaves(cfg) == ({"embed/tokens"} if arch == "hubert-xlarge" else set())
    state = training.init_train_state(cfg, torch.Generator().manual_seed(0),
                                      training.TrainConfig(), device="cpu")
    step_fn = training.make_train_step(cfg, optimizer.OptimizerConfig(**OPT),
                                       training.TrainConfig())
    pipe = training.make_pipeline(training.DataConfig(batch_size=2, seq_len=16, seed=3), cfg)
    step_fn(state, _torch(pipe.batch_at(0)))
    mu = state["opt"]["mu"]
    assert mu["frontend"]["proj"].any()
    assert mu["embed"]["tokens"].any() == (arch != "hubert-xlarge")
    loss_fn = T.loss_fn

    def proj_cut_off(c, params, batch):
        return loss_fn(c, {**params, "frontend": {"proj": params["frontend"]["proj"].detach()}},
                       batch)

    monkeypatch.setattr(T, "loss_fn", proj_cut_off)
    with pytest.raises(RuntimeError, match="not have been used in the graph"):
        step_fn(state, _torch(pipe.batch_at(1)))


def test_hubert_decode_is_refused():
    cfg = archs.reduced("hubert-xlarge")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="encoder-only architecture has no decode step"):
        T.init_cache(cfg, 2, 16, device="cpu")
    frames = torch.zeros(2, 8, cfg.frontend_dim)
    with pytest.raises(ValueError, match="encoder-only"):
        T.prefill(cfg, params, {"frames": frames}, 16)
    with pytest.raises(ValueError, match="paged decode"):
        T.init_paged_cache(cfg, 4, 4, device="cpu")
    for be in (backend.JitBackend(device="cpu"), backend.ContinuousBatchingBackend(device="cpu")):
        with pytest.raises(ValueError, match="encoder-only"):
            be.register(backend.Variant("hubert", cfg, params, 50.0))


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_launch_train_runs(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = train_launch.main(["--device", "cpu", "--arch", arch, "--d-model", "64",
                                  "--steps", "6", "--batch", "2", "--seq", "32",
                                  "--log-every", "1", "--lr", "1e-3"])
    out = buf.getvalue()
    assert code in (0, None), out
    losses = [float(x) for x in re.findall(r"loss\s+([0-9.]+)", out)]
    assert len(losses) >= 6 and all(np.isfinite(losses)), out
    assert "done: loss" in out
