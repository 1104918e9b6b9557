"""The port's training path against the JAX package, on the CPU in f32.

Inputs and weights are the same on both sides: arrays come from numpy with
a fixed seed, parameters and train states from the JAX ``init_*``
functions through the bridges (``params_from_numpy``,
``train_state_from_numpy``).  On the CPU the port's autograd Functions run
their plain versions (``flash_attention_bwd_ref``, ``rms_norm_bwd_ref``),
so these tests hold the CPU path of the same Functions the card runs.

Tolerances, each with its reason: attention and norm gradients atol 3e-5
(the JAX model's chunked ``custom_vjp`` sums in another order).  Loss
atol 2e-5 + rtol 1e-4; parameter gradients of the reduced tiers within
2e-4 of each leaf's largest entry (+ rtol 1e-4): the reduced tiers draw
their stacked weights with fan-in = period count, so activations grow
through the stack and amplify summation-order differences (measured <= 9e-5
of the leaf's largest entry).  Optimizer, schedule and compression rtol
1e-6 (one f32 step, elementwise); int8 codes and data batches exactly.
Three train steps: metrics rtol 1e-3 and parameters within atol 1e-6 +
rtol 1e-5 except at most 0.1% of the elements, none off by more than
1e-3: Adam's first steps set ``m / sqrt(v) = g / |g|``, so an element
whose gradient is within rounding of zero can step either way (measured:
<= 25 of 86336 elements, <= 1.1e-4).
"""
import dataclasses
import io
import re
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import training as jtraining  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.launch.serve import TIERS as J_TIERS  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import training  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.archs import reduced  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.serve import tier_configs  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.tree import named_leaves, tree_leaves, tree_map  # noqa: E402


def _t(a, requires_grad=False):
    """An owned torch tensor of a numpy / jax array (bf16 bit-exact)."""
    t = T.numpy_to_torch(np.asarray(a))
    return t.requires_grad_(requires_grad)


def _np(t):
    return t.detach().float().numpy()


def _pairs(jtree, ttree):
    """(path, jax leaf, torch leaf) over two trees of the same structure."""
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    return [(jax.tree_util.keystr(p), a, b) for (p, a), (_, b) in zip(flat_j, flat_t)]


# ---------------------------------------------------------------------------
# The autograd Functions on the CPU against the JAX model's gradients.
# ---------------------------------------------------------------------------
ATTN_CASES = [
    # (B, S, NQ, NKV, HD, causal, window)
    (2, 64, 4, 2, 16, True, 0),  # causal GQA
    (1, 64, 4, 1, 16, True, 24),  # windowed MQA
    (1, 48, 8, 1, 32, True, 0),  # MQA, G = 8
    (2, 40, 2, 2, 16, False, 0),  # bidirectional
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_grads_match_jax_custom_vjp(case):
    B, S, NQ, NKV, HD, causal, window = case
    rng = np.random.default_rng(S + NQ + window)
    q, dout = (rng.standard_normal((B, S, NQ, HD)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, NKV, HD)).astype(np.float32) for _ in range(2))

    def jloss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=causal, window=window, chunk=16)
        return jnp.sum(out * dout)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    qt, kt, vt = (_t(a, requires_grad=True) for a in (q, k, v))
    out = attention.flash_attention(qt, kt, vt, causal=causal, window=window)
    inner = out.grad_fn.next_functions[0][0]  # under the layout transpose
    assert type(inner).__name__.startswith("FlashAttention")
    got = torch.autograd.grad(out, (qt, kt, vt), _t(dout))
    for g, w, like in zip(got, want, (q, k, v)):
        assert tuple(g.shape) == like.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=3e-5, rtol=0)


@pytest.mark.parametrize("offset", [False, True])
def test_rms_norm_grads_match_jax(offset):
    rng = np.random.default_rng(3)
    x, dy = (rng.standard_normal((2, 5, 64)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal(64).astype(np.float32)

    def jloss(x, w):
        return jnp.sum(jlayers.rms_norm(x, w, offset=offset) * dy)

    want = jax.grad(jloss, argnums=(0, 1))(x, w)
    xt, wt = _t(x, True), _t(w, True)
    y = layers.rms_norm(xt, wt, offset=offset)
    assert type(y.grad_fn).__name__.startswith("RMSNorm")
    got = torch.autograd.grad(y, (xt, wt), _t(dy))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w_), atol=3e-5, rtol=0)


def test_serving_calls_bypass_the_autograd_functions(monkeypatch):
    """With grad off (serving runs under inference_mode) or no input that
    needs grad, ops never enters an autograd Function."""

    def refuse(*_):
        raise AssertionError("autograd Function entered on the serving path")

    monkeypatch.setattr(ops.RMSNorm, "apply", refuse)
    monkeypatch.setattr(ops.FlashAttention, "apply", refuse)
    _, cfg, _ = tier_configs()[0]
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8))
    with torch.inference_mode():
        T.prefill(cfg, params, {"tokens": tokens}, 16)
    T.prefill(cfg, params, {"tokens": tokens}, 16)  # grad on, nothing requires it
    x = torch.randn(2, 16, requires_grad=True)
    with torch.no_grad():
        ops.rms_norm(x, torch.ones(16))


# ---------------------------------------------------------------------------
# Optimizer, data, compression.
# ---------------------------------------------------------------------------
OPT = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100)


def test_lr_schedule_matches_jax():
    jcfg, cfg = jopt.OptimizerConfig(**OPT), optimizer.OptimizerConfig(**OPT)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 120]:
        np.testing.assert_allclose(float(optimizer.lr_at(cfg, step)),
                                   float(jopt.lr_at(jcfg, step)), rtol=1e-6, atol=0)


def _tree(rng, dtype, scale=1.0):
    shapes = {"a": (16, 8), "b": {"c": (8,), "d": (3, 4, 5)}, "p": ({"w": (2, 6)},)}
    return jax.tree.map(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32).astype(dtype),
        shapes, is_leaf=lambda s: isinstance(s, tuple) and all(isinstance(i, int) for i in s))


@pytest.mark.parametrize("clip_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype, clip_norm):
    jdt = jnp.dtype(dtype)
    rng = np.random.default_rng(11)
    params = jax.tree.map(np.asarray, _tree(rng, jdt))
    grads = jax.tree.map(np.asarray, _tree(rng, jdt, scale=0.3))
    mu = _tree(rng, np.float32, scale=0.01)
    nu = jax.tree.map(np.abs, _tree(rng, np.float32, scale=0.01))
    kw = dict(OPT, clip_norm=clip_norm)
    jstate = {"mu": mu, "nu": nu, "step": np.int32(3)}
    jp, jo, jm = jopt.adamw_update(jopt.OptimizerConfig(**kw), params, grads, jstate)
    tp, to_, tm = optimizer.adamw_update(
        optimizer.OptimizerConfig(**kw), jax.tree.map(_t, params), jax.tree.map(_t, grads),
        {"mu": jax.tree.map(_t, mu), "nu": jax.tree.map(_t, nu),
         "step": torch.tensor(3, dtype=torch.int32)})
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(to_["step"]) == int(jo["step"]) == 4
    for path, a, b in _pairs(jp, tp):
        assert b.dtype == getattr(torch, dtype), path
        # f32: one elementwise step; bf16: the same f32 value rounded, at
        # most one bf16 ulp apart.
        rtol = 1e-6 if dtype == "float32" else 2.0**-7
        np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), rtol=rtol, atol=1e-7,
                                   err_msg=path)
    for tree_j, tree_t in ((jo["mu"], to_["mu"]), (jo["nu"], to_["nu"])):
        for path, a, b in _pairs(tree_j, tree_t):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-9, err_msg=path)


def test_synthetic_batches_match_jax():
    jcfg = jarchs.reduced("gemma-2b")
    cfg = reduced("gemma-2b")
    dc = dict(batch_size=3, seq_len=40, seed=5)
    jpipe = jtraining.make_pipeline(jtraining.DataConfig(**dc), jcfg)
    pipe = training.make_pipeline(training.DataConfig(**dc), cfg)
    for step in (0, 1, 7, 1000):
        a, b = jpipe.batch_at(step), pipe.batch_at(step)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_matches_jax(dtype):
    jdt = jnp.dtype(dtype)
    rng = np.random.default_rng(4)
    grads = jax.tree.map(np.asarray, _tree(rng, jdt))
    efb = _tree(rng, np.float32, scale=0.05)
    for leaf in jax.tree.leaves(grads):
        jq, js = jcomp.quantize_int8(leaf)
        tq, ts = compression.quantize_int8(_t(leaf))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    for fb in (None, efb):
        jg, je = jcomp.quantize_dequantize(grads, fb)
        tg, te = compression.quantize_dequantize(
            jax.tree.map(_t, grads), None if fb is None else jax.tree.map(_t, fb))
        for path, a, b in _pairs(jg, tg):
            np.testing.assert_allclose(_np(b), np.asarray(a, np.float32), rtol=1e-6, atol=0,
                                       err_msg=path)
        if fb is None:
            assert je is None and te is None
        else:
            for path, a, b in _pairs(je, te):
                np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-7,
                                           err_msg=path)


# ---------------------------------------------------------------------------
# loss_fn, its gradients and train steps on bridged state.
# ---------------------------------------------------------------------------
def _tier(name):
    """(JAX config, port config) of a reduced serving tier."""
    _, arch, width, n_layers, _ = next(r for r in J_TIERS if r[0] == name)
    jcfg = jarchs.reduced(arch, d_model=width, n_layers=n_layers, n_heads=4,
                          n_kv_heads=2, head_dim=width // 4)
    return jcfg, dict((n, c) for n, c, _ in tier_configs())[name]


def _loss_batch(cfg, seed, B=2, S=48):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1  # ignored positions (prefix / padding)
    labels[1, -3:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("name", [name for name, *_ in J_TIERS])
def test_loss_fn_and_grads_match_jax(name, remat):
    jcfg, cfg = _tier(name)
    jcfg, cfg = (dataclasses.replace(c, remat=remat) for c in (jcfg, cfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(1))
    batch = _loss_batch(cfg, seed=len(name))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))(jparams, batch)

    params = tree_map(lambda p: p.requires_grad_(True),
                                T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                    device="cpu"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met = T.loss_fn(cfg, params, tbatch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    tgrads = tree_map(lambda _: next(grads), params)

    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=2e-5, rtol=1e-4)
    for key in ("xent", "aux", "tokens"):
        np.testing.assert_allclose(float(met[key].detach()), float(jmet[key]), atol=2e-5, rtol=1e-4)
    assert float(met["tokens"]) == 2 * 48 - 8
    for path, a, b in _pairs(jgrads, tgrads):
        scale = float(np.abs(np.asarray(a)).max())
        assert scale > 0, path
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=2e-4 * scale, rtol=1e-4,
                                   err_msg=path)


TRAIN_VARIANTS = {
    "plain": dict(),
    "microbatches2": dict(microbatches=2),
    "compression": dict(grad_compression=True),
}


@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_train_steps_match_jax(variant):
    jcfg, cfg = jarchs.reduced("gemma-2b"), reduced("gemma-2b")
    kw = TRAIN_VARIANTS[variant]
    jtc, tc = jtraining.TrainConfig(**kw), training.TrainConfig(**kw)
    jopt_cfg, opt_cfg = jopt.OptimizerConfig(**OPT), optimizer.OptimizerConfig(**OPT)
    jstate = jax.jit(lambda key: jtraining.init_train_state(jcfg, key, jtc))(jax.random.key(2))
    state = training.train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    assert state.keys() == jstate.keys()
    jstep = jtraining.make_train_step(jcfg, jopt_cfg, jtc)
    step_fn = training.make_train_step(cfg, opt_cfg, tc)
    pipe = training.make_pipeline(training.DataConfig(batch_size=4, seq_len=32, seed=3), cfg)
    for step in range(3):
        batch = pipe.batch_at(step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr", "xent", "tokens"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-3,
                                       err_msg=f"step {step} {key}")
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 3
    off, total = 0, 0
    for path, a, b in _pairs(jstate["params"], state["params"]):
        a, b = np.asarray(a), _np(b)
        diff = np.abs(a - b)
        assert diff.max() <= 1e-3, path
        off += int((diff > 1e-6 + 1e-5 * np.abs(a)).sum())
        total += a.size
    assert off <= total // 1000, f"{off} of {total} parameters differ"


# ---------------------------------------------------------------------------
# launch.train: loss falls, failure injection and bit-identical resume.
# ---------------------------------------------------------------------------
TRAIN_ARGS = [
    "--device", "cpu", "--arch", "gemma-2b", "--d-model", "64", "--layers", "2",
    "--steps", "12", "--batch", "2", "--seq", "32", "--ckpt-every", "4",
    "--log-every", "1",
]


def _run_train(extra):
    buf = io.StringIO()
    code = 0
    try:
        with redirect_stdout(buf):
            code = train_launch.main(TRAIN_ARGS + extra)
    except SystemExit as e:
        code = e.code or 0
    return code, buf.getvalue()


def _losses(log):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"step\s+(\d+)\s+loss\s+([\d.]+)", log)}


def test_train_main_reduces_loss():
    code, log = _run_train([])
    assert code == 0
    assert log.startswith("arch=gemma-2b params~") and "device=cpu" in log
    losses = _losses(log)
    assert sorted(losses) == list(range(12))
    assert losses[11] < losses[0]
    assert re.search(r"done: loss [\d.]+ -> [\d.]+ over 12 steps", log)


def test_train_main_failure_injection_and_bit_identical_resume(tmp_path):
    code, ref_log = _run_train(["--ckpt-dir", str(tmp_path / "ref")])
    assert code == 0
    ref = _losses(ref_log)
    ck = str(tmp_path / "ck")
    code, _ = _run_train(["--ckpt-dir", ck, "--inject-failure", "8"])
    assert code == 42  # injected crash after the step-8 checkpoint
    code, log = _run_train(["--ckpt-dir", ck])
    assert code == 0
    assert "resumed from checkpoint at step 8" in log
    resumed = _losses(log)
    assert sorted(resumed) == list(range(8, 12))
    for step in range(8, 12):
        assert resumed[step] == pytest.approx(ref[step], abs=1e-6), step


# ---------------------------------------------------------------------------
# Checkpoints (tests/test_checkpoint.py, minus resharding).
# ---------------------------------------------------------------------------
def _state(seed=0, dtype="float32"):
    cfg = dataclasses.replace(reduced("gemma-2b"), dtype=dtype)
    return training.init_train_state(cfg, torch.Generator().manual_seed(seed),
                                     training.TrainConfig(grad_compression=True), device="cpu")


def _assert_states_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.requires_grad == y.requires_grad
        assert torch.equal(x.detach(), y.detach())


def test_tree_walker_paths_and_order(tmp_path):
    """One walker names every leaf and lists it in tree_map's order; its
    paths are the checkpoint's array names."""
    tree = {"a": (1, [2, 3]), "b": {"c": 4}, "d": 5}
    assert list(named_leaves(tree)) == [("a/0", 1), ("a/1/0", 2), ("a/1/1", 3), ("b/c", 4),
                                        ("d", 5)]
    seen = []
    tree_map(seen.append, tree)
    assert seen == tree_leaves(tree) == [1, 2, 3, 4, 5]
    assert tree_map(lambda x, y: x + y, tree, tree) == {"a": (2, [4, 6]), "b": {"c": 8}, "d": 10}
    state = _state()
    CheckpointManager(tmp_path).save(1, state)
    arrays = CheckpointManager(tmp_path).manifest(1)["arrays"]
    assert list(arrays) == [path for path, _ in named_leaves(state)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    state = _state(dtype=dtype)
    mgr = CheckpointManager(tmp_path)
    mgr.save(10, state, extra={"loss": 1.5})
    restored, step = mgr.restore(_state(seed=9, dtype=dtype))
    assert step == 10
    _assert_states_equal(state, restored)
    manifest = mgr.manifest(10)
    assert manifest["extra"]["loss"] == 1.5
    assert manifest["arrays"]["params/embed/tokens"]["dtype"] == dtype
    assert (tmp_path / "step_00000010" / "arrays.npz").exists()


def test_checkpoint_latest_and_pruning(tmp_path):
    state = _state()
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_keep_steps_survive_pruning(tmp_path):
    state = _state()
    mgr = CheckpointManager(tmp_path, keep=1, keep_steps=(1,))
    for s in (1, 2, 3):
        mgr.save(s, state)
    assert 1 in mgr.all_steps()


def test_checkpoint_tmp_dirs_are_invisible(tmp_path):
    state = _state()
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, state)
    crashed = Path(tmp_path) / "step_00000009.tmp"
    crashed.mkdir()
    (crashed / "arrays.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 5
    _, step = mgr.restore(state)
    assert step == 5


def test_checkpoint_async_save_snapshots_before_returning(tmp_path):
    state = _state()
    expect = tree_map(
        lambda t: t.detach().clone().requires_grad_(t.requires_grad), state)
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(7, state)
    with torch.no_grad():  # the train loop goes on updating in place
        for leaf in tree_leaves(state["params"]):
            leaf.add_(1.0)
    mgr.wait()
    restored, step = mgr.restore(state)
    assert step == 7
    _assert_states_equal(expect, restored)


def test_checkpoint_restore_specific_step(tmp_path):
    s0, s1 = _state(0), _state(1)
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, s0)
    mgr.save(2, s1)
    restored, step = mgr.restore(s0, step=1)
    assert step == 1
    _assert_states_equal(s0, restored)


def test_checkpoint_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore(_state())
