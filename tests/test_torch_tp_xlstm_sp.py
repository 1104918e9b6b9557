"""The xLSTM stack on a split ``model`` axis, and sequence parallelism
(``RULES_2D_SP``), of the port against the JAX package and the port's
unsharded run, on the CPU.

One fixture runs, at once: four gloo processes of the port
(``torch_tp_worker.py xsp-rank``) and the JAX package on four forced host
devices (``torch_tp_worker.py xsp-jax``), each over every run of ``RUNS``:
a train step's gradients (``make_grads_fn`` on the mesh; JAX's
``jax.value_and_grad`` of ``loss_fn`` under the rules with the parameters'
shardings) or a prefill of a batch of 4 prompts and greedy decoding (JAX's
``T.prefill`` / ``T.decode_step`` jitted under the rules, as the dry-run's
``build_cell``).  Every case starts from the same numpy-seeded JAX
``init_train_state`` / ``init_params`` and numpy batch or prompt; each
port rank also runs unsharded, for the port-against-port checks.  A (1, 2)
mesh runs as two replicas of it over the four ranks.

Cases (reduced configs, d 64, the vocab 1024 so the head is split on it):
xlstm-350m (two periods of an mLSTM and an sLSTM block, 4 heads,
``xlstm_chunk`` 8, sequences of 32 and prompts of 16: the JAX package's
f32 xLSTM gradient turns NaN from 128 tokens; a period of the full 7 + 1
blocks quadruples the JAX package's compile time for the same code) on
(1, 4), (1, 2) and (2, 2) under ``RULES_2D`` and on (1, 4) under
``RULES_2D_SP``; llama3-8b (8 q heads over 2 kv heads, each read whole by
two ranks) and recurrentgemma-2b (two RG-LRU blocks and a local-attention
block whose 32-slot window ring wraps in the prefill) on (1, 4) under
``RULES_2D_SP``, beside their ``RULES_2D`` runs.  The JAX package runs
every run but the ``RULES_2D`` runs of llama3-8b and recurrentgemma-2b
and the xLSTM's ``RULES_2D_SP`` run (each held to the port's run of the
other table).

Tolerances, each with its reason (measured worst in brackets):

* xlstm-350m runs in float64 on both sides (every parameter widened; the
  JAX modules' f32 casts kept float64 through ``jax_f64.Jnp64``): its f32
  gradient is chaotic even reduced (``test_torch_train_zoo.py``: 0.7-8 %
  of a leaf between hosts), so a wrong sum could hide in f32 and cannot in
  float64.  Every gradient leaf within ``F64_RTOL`` of its largest entry
  of the port's unsharded gradient, of the JAX package's sharded one and,
  under ``RULES_2D_SP``, of the port's ``RULES_2D`` one [8.5e-13, 9.8e-13,
  1.2e-12]; loss and xent rtol ``F64_RTOL`` [2.6e-16]; logits and caches
  within ``F64_RTOL`` of the largest entry [2.5e-14, 1.9e-14].
* llama3-8b and recurrentgemma-2b run in f32: the tensor split adds the
  ranks' partial products, and sequence parallelism their rows (a
  reduce-scatter for an all-reduce), in another order than one matmul.
  Gradients within ``GRAD_RTOL`` of a leaf's largest entry of the port's
  unsharded and ``RULES_2D`` gradients and ``JAX_GRAD_RTOL`` of the JAX
  package's (``test_torch_tensor_parallel.py``'s ``GRAD_TOL`` /
  ``JAX_GRAD_TOL``) [llama3-8b 1.7e-5, 9.1e-6 / 4.2e-5]; recurrentgemma-2b's
  RG-LRU gates amplify that rounding, so its gradients are held within
  ``RG_GRAD_RTOL`` everywhere [5.4e-4 against the unsharded gradient on
  ``RULES_2D`` and on ``RULES_2D_SP`` alike, 1.0e-4 against ``RULES_2D``,
  2.7e-4 against JAX's; the port's unsharded gradient is 2.9e-4 from
  JAX's sharded one].  Loss and xent rtol ``METRIC_RTOL`` [1.4e-7]; logits
  within ``test_torch_tp_serve.py``'s ``UNSHARDED_RTOL`` / ``JAX_RTOL``
  [1.6e-5 / 1.6e-5], the caches within its ``CACHE_RTOL`` [4.9e-6].
* greedy tokens: equal in every run.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.archs import reduced as jreduced
from repro.models import transformer as JT
from repro.training import train_loop as jtrain
from repro_torch.configs.archs import reduced
from repro_torch.distributed import api
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.launch import mesh
from repro_torch.training import (
    TrainConfig, make_grads_fn, place_state, state_shardings, train_state_from_numpy,
)
from repro_torch.tree import named_leaves

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_tp_worker as worker  # noqa: E402

WORLD = 4
VOCAB = 1024
B, S_TRAIN = 4, 32
F64 = ("xlstm",)
CASES = {  # name: (arch, overrides, prompt length, max_len, decode steps)
    "xlstm": ("xlstm-350m", {"pattern": ("mlstm", "slstm"), "n_layers": 4}, 16, 32, 6),
    "llama": ("llama3-8b", {"n_heads": 8, "n_kv_heads": 2}, 16, 32, 6),
    "recurrentgemma": ("recurrentgemma-2b", {}, 40, 64, 6),
}
TRAIN_RUNS = [
    ("xlstm", (1, 4), "RULES_2D"), ("xlstm", (1, 2), "RULES_2D"), ("xlstm", (2, 2), "RULES_2D"),
    ("xlstm", (1, 4), "RULES_2D_SP"),
    ("llama", (1, 4), "RULES_2D_SP"), ("llama", (1, 4), "RULES_2D"),
    ("recurrentgemma", (1, 4), "RULES_2D_SP"), ("recurrentgemma", (1, 4), "RULES_2D"),
]
SERVE_RUNS = [
    ("xlstm", (1, 4), "RULES_2D"), ("xlstm", (1, 2), "RULES_2D"), ("xlstm", (2, 2), "RULES_2D"),
    ("llama", (1, 4), "RULES_2D_SP"), ("llama", (1, 4), "RULES_2D"),
    ("recurrentgemma", (1, 4), "RULES_2D_SP"), ("recurrentgemma", (1, 4), "RULES_2D"),
]
RUNS = [("train", *r) for r in TRAIN_RUNS] + [("serve", *r) for r in SERVE_RUNS]
# The JAX package runs the xLSTM's RULES_2D runs and every RULES_2D_SP run
# but the xLSTM's (which the port's RULES_2D run holds).
JAX_TRAIN = [r for r in TRAIN_RUNS if (r[0] == "xlstm") == (r[2] == "RULES_2D")]
JAX_SERVE = [r for r in SERVE_RUNS if (r[0] == "xlstm") == (r[2] == "RULES_2D")]
JAX_RUNS = [("train", *r) for r in JAX_TRAIN] + [("serve", *r) for r in JAX_SERVE]
SP_TRAIN = [r for r in TRAIN_RUNS if r[2] == "RULES_2D_SP"]
SP_SERVE = [r for r in SERVE_RUNS if r[2] == "RULES_2D_SP"]
F64_RTOL = 1e-8
GRAD_RTOL = 1e-4  # test_torch_tensor_parallel.py's GRAD_TOL
JAX_GRAD_RTOL = 1e-3  # and its JAX_GRAD_TOL
RG_GRAD_RTOL = 1e-3
METRIC_RTOL = 1e-6
UNSHARDED_RTOL = 1e-4
JAX_RTOL = 2e-4
CACHE_RTOL = 1e-4


def _tag(run):
    return worker.run_tag(*run)


def _jcfg(name):
    arch, over = CASES[name][:2]
    return jreduced(arch, vocab_size=VOCAB, **over)


def _batch(seed, S=S_TRAIN):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1  # ignored positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _train_state(name, seed):
    cfg = _jcfg(name)
    return jax.tree.map(np.asarray, jtrain.init_train_state(cfg, jax.random.key(seed)))


def _spawn(out):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE), os.environ.get("PYTHONPATH", "")])}
    script = str(HERE / "torch_tp_worker.py")
    cmds = [[script, "xsp-jax", str(out)]] + [
        [script, "xsp-rank", str(r), str(WORLD), str(out / "store"), str(out)]
        for r in range(WORLD)]
    return [subprocess.Popen([sys.executable, *c], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for c in cmds]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(who, kind, run): npz dict}: the JAX package's run ("jax") and each
    port rank's ("torch", rank); "probe": the message of the odd sequence's
    error."""
    out = tmp_path_factory.mktemp("tp_xsp")
    train, serve = {}, {}
    for i, (name, (arch, over, S, max_len, steps)) in enumerate(CASES.items()):
        over = {"vocab_size": VOCAB, **over}
        train[name] = (arch, over, _train_state(name, i), _batch(10 + i))
        params = jax.tree.map(np.asarray, JT.init_params(_jcfg(name), jax.random.key(i)))
        prompt = np.random.default_rng(100 + i).integers(0, VOCAB, (B, S)).astype(np.int32)
        serve[name] = (arch, over, params, prompt, max_len, steps)
    probe = train["llama"][:3] + (_batch(20, S=30),)
    spec = {"train": train, "serve": serve, "runs": RUNS, "jax_runs": JAX_RUNS, "f64": F64,
            "probe": probe}
    (out / "xsp.pkl").write_bytes(pickle.dumps(spec))
    t0 = time.time()
    procs = _spawn(out)
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    print(f"xLSTM / sequence-parallel processes: {time.time() - t0:.1f} s")
    res = {"probe": (out / "xsp_probe.txt").read_text()}
    for kind, *run in RUNS:
        run = tuple(run)
        if (kind, *run) in JAX_RUNS:
            res[("jax", kind, run)] = dict(np.load(out / f"xsp_jax_{kind}_{_tag(run)}.npz"))
        ranks = [0] if kind == "train" else range(WORLD)
        for r in ranks:
            res[(("torch", r), kind, run)] = dict(
                np.load(out / f"xsp_torch_{kind}_{_tag(run)}_r{r}.npz"))
    return res


def _rel(got, want):
    """max |got - want| over the largest |want|."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-300)


def _leaves(res, prefix):
    return {k.split("/", 1)[1]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _hold_grads(got, want, rtol, what):
    assert got and sorted(got) == sorted(want), what
    for path, g in got.items():
        assert np.isfinite(g).all(), f"{what} {path}"
        err = _rel(g, want[path])
        assert err <= rtol, f"{what} {path}: {err:.3g} of the leaf's largest entry"


def _grad_rtol(name, jax_run=False):
    if name in F64:
        return F64_RTOL
    if name == "recurrentgemma":
        return RG_GRAD_RTOL
    return JAX_GRAD_RTOL if jax_run else GRAD_RTOL


@pytest.mark.parametrize("run", TRAIN_RUNS, ids=_tag)
def test_gradients_match_the_unsharded_step(runs, run):
    got = runs[(("torch", 0), "train", run)]
    _hold_grads(_leaves(got, "grad"), _leaves(got, "plain"), _grad_rtol(run[0]),
                f"{_tag(run)} vs unsharded")
    for key in ("loss", "xent", "tokens"):
        np.testing.assert_allclose(got[f"metric/{key}"], got[f"plain_metric/{key}"],
                                   rtol=F64_RTOL if run[0] in F64 else METRIC_RTOL,
                                   err_msg=f"{_tag(run)} {key}")


@pytest.mark.parametrize("run", JAX_TRAIN, ids=_tag)
def test_gradients_match_the_jax_sharded_step(runs, run):
    got, want = runs[(("torch", 0), "train", run)], runs[("jax", "train", run)]
    _hold_grads(_leaves(got, "grad"), _leaves(want, "grad"), _grad_rtol(run[0], True),
                f"{_tag(run)} vs JAX")
    for key in ("loss", "xent", "tokens"):
        np.testing.assert_allclose(got[f"metric/{key}"], want[f"metric/{key}"],
                                   rtol=F64_RTOL if run[0] in F64 else METRIC_RTOL,
                                   err_msg=f"{_tag(run)} {key}")


@pytest.mark.parametrize("run", SP_TRAIN, ids=_tag)
def test_sequence_parallel_gradients_match_rules_2d(runs, run):
    """The same case on the same mesh under RULES_2D: the split of the
    residual stream moves no gradient past the tolerance."""
    sp = runs[(("torch", 0), "train", run)]
    base = runs[(("torch", 0), "train", (run[0], run[1], "RULES_2D"))]
    _hold_grads(_leaves(sp, "grad"), _leaves(base, "grad"), _grad_rtol(run[0]),
                f"{_tag(run)} vs RULES_2D")


@pytest.mark.parametrize("run", TRAIN_RUNS, ids=_tag)
def test_residual_stream_between_blocks(runs, run):
    """Every block reads (B / data, S / model, D) under RULES_2D_SP and
    (B / data, S, D) under RULES_2D."""
    (data, model), sp = run[1], run[2] == "RULES_2D_SP"
    shapes = runs[(("torch", 0), "train", run)]["residual"]
    want = (B // data, S_TRAIN // (model if sp else 1), 64)
    assert [tuple(s) for s in shapes] == [want]


@pytest.mark.parametrize("run", SERVE_RUNS, ids=_tag)
def test_logits_and_tokens_match_the_unsharded_run(runs, run):
    """Logits of the prefill and every decode step against the port's
    unsharded run; greedy tokens equal."""
    got = runs[(("torch", 0), "serve", run)]
    rtol = F64_RTOL if run[0] in F64 else UNSHARDED_RTOL
    assert _rel(got["logits"], got["plain_logits"]) <= rtol
    np.testing.assert_array_equal(got["tokens"], got["plain_tokens"])


@pytest.mark.parametrize("run", JAX_SERVE, ids=_tag)
def test_logits_and_tokens_match_the_jax_sharded_run(runs, run):
    got, want = runs[(("torch", 0), "serve", run)], runs[("jax", "serve", run)]
    assert _rel(got["logits"], want["logits"]) <= (F64_RTOL if run[0] in F64 else JAX_RTOL)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("run", SP_SERVE, ids=_tag)
def test_sequence_parallel_prefill_matches_rules_2d(runs, run):
    sp = runs[(("torch", 0), "serve", run)]
    base = runs[(("torch", 0), "serve", (run[0], run[1], "RULES_2D"))]
    assert _rel(sp["logits"], base["logits"]) <= UNSHARDED_RTOL
    np.testing.assert_array_equal(sp["tokens"], base["tokens"])


def _hold_cache(res, got, want, rtol, what):
    paths = sorted(_leaves(res, want))
    assert paths and paths == sorted(_leaves(res, got)), what
    for path in paths:
        a, b = res[f"{got}/{path}"], res[f"{want}/{path}"]
        assert a.shape == b.shape, (what, path, a.shape, b.shape)
        if path.endswith("slot_pos"):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")
        elif np.abs(b).max() > 0:
            assert _rel(a, b) <= rtol, f"{what} {path}: {_rel(a, b):.3g}"


@pytest.mark.parametrize("run", SERVE_RUNS, ids=_tag)
def test_cache_slices_are_the_unsharded_cache(runs, run):
    """Each rank's cache is its slice (``shard_tree``) of the unsharded cache
    (the mLSTM state whole on every rank, the sLSTM state its channels), and
    ``gather_tree`` of the slices is the unsharded cache."""
    rtol = F64_RTOL if run[0] in F64 else CACHE_RTOL
    for r in range(WORLD):
        _hold_cache(runs[(("torch", r), "serve", run)], "local", "want", rtol,
                    f"{_tag(run)} rank {r}")
    _hold_cache(runs[(("torch", 0), "serve", run)], "whole", "plain", rtol, f"{_tag(run)} whole")


def test_xlstm_cache_layout(runs):
    """On (1, 4) every rank holds the whole mLSTM state and a quarter of the
    sLSTM channels."""
    run = ("xlstm", (1, 4), "RULES_2D")
    local = _leaves(runs[(("torch", 1), "serve", run)], "local")
    plain = _leaves(runs[(("torch", 0), "serve", run)], "plain")
    pattern = reduced("xlstm-350m", **CASES["xlstm"][1]).pattern
    assert sorted(local) == sorted(plain)
    for path, t in local.items():
        _, i, _ = path.split("/")
        full = plain[path].shape
        want = full if pattern[int(i)] == "mlstm" else (*full[:-1], full[-1] // 4)
        assert t.shape == tuple(want), (path, t.shape, full)


def test_odd_sequence_raises(runs):
    assert "sequence 30 does not split over 4" in runs["probe"]


@pytest.mark.parametrize("size,over,match", [
    (3, {}, "4 xLSTM heads .* whole heads over 3"),
    (8, {}, "4 xLSTM heads .* whole heads over 8"),
    (2, {"xlstm_heads": 3, "d_model": 96}, "3 xLSTM heads .* whole heads over 2"),
], ids=["heads-4-over-3", "heads-4-over-8", "heads-3-over-2"])
def test_xlstm_heads_that_do_not_split_raise(size, over, match):
    with pytest.raises(ValueError, match=match):
        tpm.check_config(reduced("xlstm-350m", **over), size)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_xlstm_heads_that_split_pass(size):
    tpm.check_config(reduced("xlstm-350m"), size)
    tpm.check_config(reduced("xlstm-350m", pattern=("slstm",)), size)


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group over a FileStore in ``tmp_path``."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("table", ["RULES_2D", "RULES_2D_SP"])
@pytest.mark.parametrize("name", ["llama", "xlstm", "recurrentgemma"])
def test_model_axis_of_one_is_bitwise_the_unsharded_step(world1, name, table):
    """Under RULES_2D or RULES_2D_SP on a (1, 1) mesh the tensor axis has
    one rank, so nothing splits: loss, metrics and every gradient leaf are
    bitwise those of the step with no rules."""
    arch, over = CASES[name][:2]
    cfg = reduced(arch, vocab_size=VOCAB, **over)
    state = train_state_from_numpy(cfg, _train_state(name, 7), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(30).items()}
    m = mesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    rules = api.AxisRules(m, getattr(api, table))
    placed = place_state(state, state_shardings(cfg, m, rules))
    loss, met, grads = make_grads_fn(cfg, TrainConfig(), mesh=m, rules=rules)(
        placed["params"], batch)
    ploss, pmet, pgrads = make_grads_fn(cfg)(state["params"], batch)
    assert torch.equal(loss, ploss)
    for key in ("xent", "aux", "tokens"):
        assert torch.equal(met[key], pmet[key]), key
    for (path, g), (_, p) in zip(named_leaves(grads), named_leaves(pgrads)):
        assert torch.equal(g.to_local(), p), path
