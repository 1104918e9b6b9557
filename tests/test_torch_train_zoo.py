"""Training the MoE and xLSTM stacks: the port against the JAX package, on
the CPU in f32.

Reduced olmoe-1b-7b (softmax top-2 of 4 experts), llama4-scout (sigmoid
top-1, a shared expert) and xlstm-350m (7 mLSTM blocks and an sLSTM
block); parameters and train states come from the JAX ``init_*`` functions
through the bridges, batches from numpy with a fixed seed.

* ``loss_fn``: loss, ``xent``, ``aux`` and every gradient leaf against
  ``jax.value_and_grad`` of the JAX ``loss_fn``, remat on and off.
  Tolerances as tests/test_torch_training.py's for the reduced tiers: loss
  and metrics atol 2e-5 + rtol 1e-4; each MoE gradient leaf within 2e-4 of
  its largest entry + rtol 1e-4 (summation order; the reduced stacks
  amplify it through their depth).
* xlstm-350m's gradient is chaotic in f32 even reduced: the JAX package's
  f32 gradient sits 0.7-6 % of a leaf's largest entry from the float64
  one (measured on four seeds and lengths), the port's f32 gradient
  1.1-8 %.  So the whole model is held in float64: the port's ``loss_fn``
  on a float64 config against ``jax.value_and_grad`` of the JAX
  ``loss_fn`` under ``jax.enable_x64``, with the JAX modules' ``jnp``
  seen through :class:`jax_f64.Jnp64` (their explicit f32 casts become float64;
  no file of the JAX package changes): loss and ``xent`` within 1e-10,
  each gradient leaf within 1e-8 of its largest entry plus 1e-10 of the
  tree's (measured 3.2e-11).  Secondary, in f32: each leaf of the port's
  gradient within 3x the JAX f32 gradient's distance from float64 plus
  1e-3 of the leaf's largest entry, and the JAX one within 10 %.  Each
  xLSTM block's vjp is also held, teacher-forced on the same input, in
  float64 against JAX's and, for both packages' f32 runs, against that
  float64 result (see :func:`test_xlstm_block_vjp_matches_jax`).
* ``moe_apply``'s vjp under capacity drops: the same as JAX's, and exactly
  zero for a token all of whose assignments were dropped (the combine
  weights them 0; the aux loss is left out, as it reads every token).
* three ``make_train_step`` steps against the JAX train step (metrics rtol
  1e-3; parameters as tests/test_torch_training.py holds them).  For
  xlstm-350m the f32 trajectories part at once (step 1's gradient norm
  reads 18362 in the port, 17720 in JAX, 28621 in the port's float64
  run), so: losses and ``xent`` rtol 1e-2 (measured <= 0.23 %), ``lr``,
  ``aux`` and ``tokens`` as above, and step 0's gradient norm within 1 % of
  the float64 step's for both (measured 0.42 % and 0.11 %).
* ``launch.train`` lowers the loss for a MoE and an xLSTM arch.
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
from jax_f64 import Jnp64  # noqa: E402

from repro import training as jtraining  # noqa: E402
from repro.configs import archs as jarchs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import training  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e", "xlstm-350m")
OPT = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100)


def _np(t):
    return t.detach().float().numpy()


def _pairs(jtree, ttree):
    flat_j = jax.tree_util.tree_flatten_with_path(jtree)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    return [(jax.tree_util.keystr(p), a, b) for (p, a), (_, b) in zip(flat_j, flat_t)]


def _cfgs(arch, **over):
    jcfg, cfg = jarchs.reduced(arch, **over), archs.reduced(arch, **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _loss_batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1  # ignored positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _grads(cfg, params, batch):
    params = tree_map(lambda p: p.requires_grad_(True), params)
    loss, met = T.loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    return loss, met, tree_map(lambda _: next(grads), params)


def _assert_grads_match(jgrads, tgrads):
    for path, a, b in _pairs(jgrads, tgrads):
        a = np.asarray(a)
        scale = float(np.abs(a).max())
        assert scale > 0 and np.isfinite(_np(b)).all(), path
        np.testing.assert_allclose(_np(b), a, atol=2e-4 * scale, rtol=1e-4, err_msg=path)


def _f64(cfg, tree):
    """A float64 config and every floating leaf of ``tree`` in float64."""
    return (dataclasses.replace(cfg, dtype="float64"),
            tree_map(lambda t: t.detach().double().requires_grad_(True)
                     if t.is_floating_point() else t, tree))


def _jax_f64_value_and_grad(jcfg, jparams, batch, monkeypatch):
    """The JAX ``loss_fn``'s loss, metrics and gradient, all in float64."""
    for mod in (jlayers, jxlstm, JT):
        monkeypatch.setattr(mod, "jnp", Jnp64())
    try:
        with jax.enable_x64(True):
            c64 = dataclasses.replace(jcfg, dtype="float64")
            p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), jparams)
            (loss, met), grads = jax.jit(jax.value_and_grad(
                lambda p, b: JT.loss_fn(c64, p, b), has_aux=True))(p64, batch)
            out = jax.tree.map(np.asarray, (loss, met, grads))
    finally:
        monkeypatch.undo()
    assert all(a.dtype == np.float64 for a in jax.tree.leaves(out))
    return out


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _assert_as_exact_as_jax(jtree, ttree, exact, what, jax_within=None):
    """Each leaf of ``ttree`` (the port, f32) no farther from ``exact`` (the
    port's float64 run) than 3x the JAX f32 leaf, plus 1e-3 of the exact
    leaf's largest entry and 1e-6 of the tree's; with ``jax_within``, the
    JAX leaf within that share of the exact leaf's largest entry."""
    floor = 1e-6 * max(float(np.abs(_np(e)).max()) for e in tree_leaves(exact))
    for (path, a, b), (_, _, e) in zip(_pairs(jtree, ttree), _pairs(jtree, exact)):
        e = e.detach().double().numpy()
        scale = float(np.abs(e).max())
        err_t, err_j = _max_err(_np(b), e), _max_err(a, e)
        assert np.isfinite(_np(b)).all(), path
        assert err_t <= 3 * err_j + 1e-3 * scale + floor, \
            f"{what} {path}: {err_t:.3g} vs JAX {err_j:.3g}"
        if jax_within is not None:
            assert err_j <= jax_within * scale + floor, f"{what} {path}"


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(arch, remat, monkeypatch):
    jcfg, cfg = _cfgs(arch, remat=remat)
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(1))
    batch = _loss_batch(cfg, seed=len(arch))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))(jparams, batch)
    params = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    loss, met, tgrads = _grads(cfg, params, batch)

    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=2e-5, rtol=1e-4)
    for key in ("xent", "aux", "tokens"):
        np.testing.assert_allclose(float(met[key].detach()), float(jmet[key]), atol=2e-5,
                                   rtol=1e-4, err_msg=key)
    assert (float(met["aux"].detach()) > 0) == ("moe" in cfg.layer_kinds())
    assert float(met["tokens"]) == 2 * 16 - 3
    if "moe" in cfg.layer_kinds():
        _assert_grads_match(jgrads, tgrads)
        return
    c64, p64 = _f64(cfg, T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu"))
    loss64, met64, exact = _grads(c64, p64, batch)
    jloss64, jmet64, jgrads64 = _jax_f64_value_and_grad(jcfg, jparams, batch, monkeypatch)
    np.testing.assert_allclose(float(loss64.detach()), jloss64, rtol=1e-10)
    np.testing.assert_allclose(float(met64["xent"].detach()), jmet64["xent"], rtol=1e-10)
    floor = 1e-10 * max(float(np.abs(a).max()) for a in jax.tree.leaves(jgrads64))
    for path, a, b in _pairs(jgrads64, exact):
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=0,
                                   atol=1e-8 * float(np.abs(a).max()) + floor, err_msg=path)
    _assert_as_exact_as_jax(jgrads, tgrads, exact, "gradient", jax_within=0.1)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_vjp_matches_jax(kind, monkeypatch):
    """One xLSTM block (norm, cell, residual) of reduced xlstm-350m, its
    vjp for a fixed cotangent against ``jax.vjp`` of the JAX
    ``apply_block``, same input, in f32 and in float64.

    The float64 runs agree to 1e-12 of each array's largest entry
    (measured at most 1.2e-14).  Each f32 run is held to the float64
    result: the output within 5e-5 of its largest entry, each gradient
    within 1e-4 of its largest entry plus 1e-6 of the block's largest
    gradient entry.  The mLSTM block's output reaches 2.6e4 and its
    gradients 2.3e6, so the two f32 runs, summing in other orders, part by
    up to 2.5e-5 of the output's largest entry (0.649 on an AVX-512 CPU)
    while each lies within its own f32 rounding of the float64 result:
    measured worst 1.6e-5 of the output (JAX; the port 8.8e-6) and 5.3e-5
    of a gradient (JAX's ``dx``; the port's worst 2.9e-5), the bounds 3x
    and 2x those."""
    jcfg, cfg = _cfgs("xlstm-350m")
    i = cfg.pattern.index(kind)
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(1))
    jp = jax.tree.map(lambda a: a[0], jparams["periods"][i])
    rng = np.random.default_rng(11)
    B, S = 2, 16
    x, g = (rng.standard_normal((B, S, cfg.d_model)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()

    def jax_vjp(jcfg, jp, x, g):
        def block(p, x):
            return JT.apply_block(jcfg, kind, p, x,
                                  JT.SeqContext(positions=jnp.asarray(pos)), None)[0]

        jout, vjp = jax.vjp(block, jp, jnp.asarray(x))
        jgp, jgx = vjp(jnp.asarray(g))
        return [np.asarray(a, np.float64) for a in (jout, jgx, *jax.tree_util.tree_leaves(jgp))]

    def port_vjp(cfg, dtype):
        tp = tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype).requires_grad_(True),
                      jp)
        tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
        ctx = T.SeqContext(positions=torch.from_numpy(pos), sin=None, cos=None)
        out, _, aux = T.apply_block(cfg, kind, tp, tx, ctx, None)
        assert aux is None
        got = torch.autograd.grad(out, [tx, *jax.tree_util.tree_leaves(tp)],
                                  torch.from_numpy(g).to(dtype))
        return [t.detach().double().numpy() for t in (out, *got)]

    j32, t32 = jax_vjp(jcfg, jp, x, g), port_vjp(cfg, torch.float32)
    t64 = port_vjp(dataclasses.replace(cfg, dtype="float64"), torch.float64)
    for mod in (jlayers, jxlstm, JT):
        monkeypatch.setattr(mod, "jnp", Jnp64())
    with jax.enable_x64(True):
        j64 = jax_vjp(dataclasses.replace(jcfg, dtype="float64"),
                      jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), jp),
                      x.astype(np.float64), g.astype(np.float64))
    monkeypatch.undo()
    floor = 1e-6 * max(float(np.abs(w).max()) for w in j64[1:])
    for n, (a, b, exact, e64) in enumerate(zip(j32, t32, j64, t64)):
        scale = float(np.abs(exact).max())
        np.testing.assert_allclose(e64, exact, rtol=0, atol=1e-12 * scale, err_msg=f"{n} f64")
        atol = 5e-5 * scale if n == 0 else 1e-4 * scale + floor
        for side, got in (("jax", a), ("port", b)):
            np.testing.assert_allclose(got, exact, rtol=0, atol=atol, err_msg=f"{n} {side}")


def test_moe_stack_aux_sums_its_blocks_in_order():
    """``aux`` is the sum of every MoE block's load-balancing loss, added
    block after block from the first, and it reaches the loss as 0.01 *
    aux; the serving calls (with a cache) do not sum it."""
    cfg = archs.reduced("olmoe-1b-7b", n_layers=3)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    apply = moe.moe_apply

    def spy(*a):
        out, aux = apply(*a)
        seen.append(aux)
        return out, aux

    batch = _loss_batch(cfg, seed=5)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    moe.moe_apply = spy
    try:
        with torch.no_grad():
            loss, met = T.loss_fn(cfg, params, tb)
            assert len(seen) == 3
            want = (seen[0] + seen[1]) + seen[2]
            assert torch.equal(met["aux"], want)
            assert torch.equal(loss, met["xent"] + 0.01 * want)
            _, _, aux = T.forward_hidden(cfg, params, tb, cache=T.init_cache(cfg, 2, 16, "cpu"))
            assert aux is None
    finally:
        moe.moe_apply = apply


def test_moe_vjp_under_capacity_drops_matches_jax_and_dropped_tokens_get_zero():
    base = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                head_dim=8, d_ff=0, vocab_size=64, pattern=("moe",), n_experts=4, top_k=2,
                expert_d_ff=32, moe_groups=1, capacity_factor=0.25)
    jcfg, cfg = JModelConfig(**base), ModelConfig(**base)
    rng = np.random.default_rng(7)
    spec = moe.moe_init_spec(cfg)
    p = {k: (0.2 * rng.standard_normal(s)).astype(np.float32) for k, s in spec.items()}
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    g = rng.standard_normal((2, 16, 16)).astype(np.float32)

    def jout(p, x):
        return jmoe.moe_apply(jcfg, p, x)[0]

    _, vjp = jax.vjp(jout, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = moe.moe_apply(cfg, tp, tx)
    got = torch.autograd.grad(out, [tx, *tp.values()], torch.from_numpy(g))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jgx), atol=1e-5, rtol=1e-5)
    for (name, _), gp in zip(tp.items(), got[1:]):
        np.testing.assert_allclose(gp.numpy(), np.asarray(jgp[name]), atol=1e-5, rtol=1e-5,
                                   err_msg=name)

    # Which tokens lost every assignment: the port's routing, by hand.
    cap = moe.capacity(32, 4, 2, 0.25)
    idx, _, _ = moe._route(cfg, tp["router"].detach(), tx.detach().reshape(32, 16))
    counts = np.zeros(4, int)
    kept = np.zeros(32, int)
    for t, experts in enumerate(idx.numpy()):
        for e in experts:
            kept[t] += counts[e] < cap
            counts[e] += 1
    dropped = np.flatnonzero(kept == 0)
    assert 0 < len(dropped) < 32
    gx = got[0].reshape(32, 16)
    assert torch.count_nonzero(gx[dropped]) == 0
    assert bool((gx[kept > 0].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jtc, tc = jtraining.TrainConfig(), training.TrainConfig()
    jopt_cfg, opt_cfg = jopt.OptimizerConfig(**OPT), optimizer.OptimizerConfig(**OPT)
    jstate = jax.jit(lambda key: jtraining.init_train_state(jcfg, key, jtc))(jax.random.key(2))
    state = training.train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    jstep = jax.jit(jtraining.make_train_step(jcfg, jopt_cfg, jtc))
    step_fn = training.make_train_step(cfg, opt_cfg, tc)
    pipe = training.make_pipeline(training.DataConfig(batch_size=2, seq_len=16, seed=3), cfg)
    chaotic = "moe" not in cfg.layer_kinds()
    for step in range(3):
        batch = pipe.batch_at(step)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        if chaotic and step == 0:  # the port's float64 step, from the same state
            c64, p64 = _f64(cfg, state["params"])
            opt64 = tree_map(torch.clone, state["opt"])  # the step updates it in place
            _, m64 = training.make_train_step(c64, opt_cfg, tc)({"params": p64, "opt": opt64},
                                                                 tb)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step_fn(state, tb)
        for key in ("loss", "grad_norm", "lr", "xent", "aux", "tokens"):
            if chaotic and key == "grad_norm":
                if step == 0:  # both within 1 % of the float64 step's
                    for v in (m, jm):
                        np.testing.assert_allclose(float(v[key]), float(m64[key]), rtol=1e-2)
                continue
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-2 if chaotic else 1e-3, atol=1e-7,
                                       err_msg=f"step {step} {key}")
    if chaotic:
        return
    off, total = 0, 0
    for path, a, b in _pairs(jstate["params"], state["params"]):
        a, b = np.asarray(a), _np(b)
        diff = np.abs(a - b)
        assert diff.max() <= 1e-3, path
        off += int((diff > 1e-6 + 1e-5 * np.abs(a)).sum())
        total += a.size
    assert off <= total // 1000, f"{off} of {total} parameters differ"


@pytest.mark.parametrize("arch,lr", [("olmoe-1b-7b", "1e-3"), ("xlstm-350m", "1e-2")])
def test_train_main_reduces_loss(arch, lr):
    """24 steps; the mean of the last 10 losses below the first 10's (each
    step draws its own batch, and single losses wander by ~0.3 for olmoe,
    ~0.06 for xlstm)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        code = train_launch.main(["--device", "cpu", "--arch", arch, "--d-model", "64",
                                  "--steps", "24", "--batch", "2", "--seq", "32", "--lr", lr,
                                  "--log-every", "1"])
    log = buf.getvalue()
    assert code == 0
    losses = [float(x) for x in re.findall(r"step\s+\d+\s+loss\s+([\d.]+)", log)]
    assert len(losses) == 24 and np.mean(losses[-10:]) < np.mean(losses[:10])
    assert re.search(r"done: loss [\d.]+ -> [\d.]+ over 24 steps", log)
    assert ("aux " in log) == (arch == "olmoe-1b-7b")


def test_train_main_stops_at_the_first_non_finite_step(tmp_path):
    """A step whose loss or gradient norm is not finite ends the run with
    exit code 1 and is not checkpointed (xlstm-350m's full-config gradient
    is NaN at 2 x 2048 on the card; here a learning rate of 1e30 makes the
    second step's gradient NaN)."""
    from repro_torch.checkpoint import CheckpointManager

    buf = io.StringIO()
    with redirect_stdout(buf):
        code = train_launch.main(["--device", "cpu", "--arch", "gemma-2b", "--d-model", "64",
                                  "--layers", "2", "--steps", "6", "--batch", "2", "--seq",
                                  "16", "--lr", "1e30", "--log-every", "1", "--ckpt-dir",
                                  str(tmp_path), "--ckpt-every", "1"])
    log = buf.getvalue()
    assert code == 1
    assert re.search(r"step\s+1\s+not finite: loss \S+\s+gnorm nan", log), log
    assert "done:" not in log
    assert CheckpointManager(str(tmp_path)).latest_step() == 1  # step 0's state only
