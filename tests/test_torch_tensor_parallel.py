"""Tensor-parallel training of the port against the JAX package and the
port's unsharded step, on the CPU in f32 (mirrors what GSPMD does with the
JAX model's ``constrain`` calls on a ``model`` axis).

One fixture runs, at once: four gloo processes of the port
(``torch_tp_worker.py rank``) over (1, 4), (2, 2) and (4, 1) ("data",
"model") meshes, and the JAX package on four forced host devices
(``torch_tp_worker.py jax``) over the first two; meanwhile this process
takes the port's unsharded gradients and step.  Every case starts from
the same numpy-seeded JAX ``init_train_state`` (``train_state_from_numpy``)
and the same numpy batch: uniform tokens over the vocab, so every rank's
vocab columns hold targets, and a few ignored labels.

Cases (reduced configs, 2 layers, d 64, head dim 16, the vocab 1024 so the
head is split on it): gemma-2b (4 q heads over 1 kv head, a tied table),
llama3-8b with 8 q heads over 2 kv heads (each kv head read whole by two
ranks at tensor size 4) and over 4, qwen3-14b (qk-norm), olmoe-1b-7b (4
experts top-2, qk-norm, 4 MoE groups so they split over 4 data ranks),
paligemma-3b (8 patches before the tokens, tied), hubert-xlarge (frames,
its 256-entry head whole) and recurrentgemma-2b (two RG-LRU blocks, their
``lru`` width 64 split over the tensor axis, and a local-attention block).
Heads that do not split over the four ranks of (1, 4), which GSPMD pads
(only that mesh): llama3-8b with 6 q heads over 2 kv heads (2 / 2 / 1 / 1
q heads a rank, rank 1's spanning both kv heads) and over 3,
recurrentgemma-2b with 10 heads (3 / 3 / 2 / 2 over its one kv head) and
gemma-2b with 2 heads (ranks 2 and 3 hold none).

Tolerances, each with its reason (measured worst in brackets):

* gradients against the port's unsharded step: each leaf within
  ``GRAD_TOL`` of its own largest entry: the sums over the tensor axis add
  the ranks' partial products in another order than one matmul [2.5e-5,
  gemma-2b's table at (1, 4)];
* gradients against the JAX package's sharded gradients: within
  ``JAX_GRAD_TOL`` of the leaf's largest entry: GSPMD's partitioned
  program moves the JAX package's gradients that far from its own
  unsharded ones [2.3e-4, gemma-2b at (1, 4)] and from the port's [2.9e-4]
  [port tensor-parallel against JAX sharded: 2.6e-4];
* recurrentgemma-2b with 10 heads runs in float64 on both sides (``F64``:
  every floating leaf of the state widened, the JAX modules' f32 casts
  kept float64 through ``jax_f64.Jnp64``), its gradients within
  ``F64_RTOL`` of a leaf's largest entry (``test_torch_tp_xlstm_sp.py``'s
  float64 bound): in f32 its RG-LRU gates' gradients cancel so far that
  the JAX package's own sharded and unsharded gradients part by 5.9e-4
  and the port's unsharded one is 1.3e-3 from JAX's sharded one, past
  ``JAX_GRAD_TOL``, so only float64 can show a wrong sum there;
* loss, xent, aux and tokens rtol ``METRIC_RTOL`` [6.8e-8]; the gradient
  norm rtol ``NORM_RTOL`` [2.6e-5 against JAX, 2e-6 against the port];
* parameters after one AdamW step within ``POST_ATOL`` = 2 * lr of the
  JAX package's sharded step: the first step is close to ``lr *
  sign(g)``, so an element whose gradient is within rounding of zero can
  step either way [4.2e-4; the port's unsharded step is 3.8e-4 from JAX's
  sharded one, and JAX's sharded step 3.5e-4 from its own unsharded one].
* on the (4, 1) mesh, which has no tensor axis, the gradients are held to
  the unsharded ones at ``GRAD_TOL`` like every mesh's, and the step to
  the unsharded step at ``SHARDED_ATOL``, the two-rank data-parallel
  tolerance of ``test_torch_sharding.py``, on every element whose
  unsharded gradient is ``FIRM`` times farther from zero than the two
  runs' gradient gap [5.8e-6]; the rest, whose gradient the gap can move
  by more than 4 % where the step is still near ``lr * g / eps``
  (olmoe-1b-7b's table: a gradient of -4.8e-7 against -5.3e-7 steps
  7.08e-4 against 7.28e-4), are held to ``POST_ATOL``, and at most
  ``LOOSE_MAX`` of a leaf's elements may step past ``SHARDED_ATOL`` [one
  of olmoe-1b-7b's 65536 table entries, 2.1e-5].
"""
import os
import pickle
import re
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
from repro.training import train_loop as jtrain
from repro_torch.configs.archs import reduced
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.training import (
    OptimizerConfig, TrainConfig, make_grads_fn, make_train_step,
)
from repro_torch.tree import named_leaves

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_tp_worker as worker  # noqa: E402

CASES = {
    "gemma": ("gemma-2b", {}),
    "llama_kv2": ("llama3-8b", {"n_heads": 8, "n_kv_heads": 2}),
    "llama_kv4": ("llama3-8b", {"n_heads": 8, "n_kv_heads": 4}),
    "qwen3": ("qwen3-14b", {}),
    "olmoe": ("olmoe-1b-7b", {"moe_groups": 4}),
    "paligemma": ("paligemma-3b", {}),
    "hubert": ("hubert-xlarge", {"vocab_size": 256}),
    "recurrentgemma": ("recurrentgemma-2b", {}),
    "llama_q6_kv2": ("llama3-8b", {"n_heads": 6, "n_kv_heads": 2}),
    "llama_q6_kv3": ("llama3-8b", {"n_heads": 6, "n_kv_heads": 3}),
    "recurrentgemma_q10": ("recurrentgemma-2b", {"n_heads": 10}),
    "gemma_q2": ("gemma-2b", {"n_heads": 2}),
}
TP_MESHES = [(1, 4), (2, 2)]
MESHES = TP_MESHES + [(4, 1)]
# The cases of heads that do not split over four ranks run on (1, 4) alone.
CASE_MESHES = {name: [(1, 4)] for name in
               ("llama_q6_kv2", "llama_q6_kv3", "recurrentgemma_q10", "gemma_q2")}


def _runs(meshes):
    """(case, mesh) pairs of every case on each of ``meshes`` it runs on."""
    return [pytest.param(c, m, id=f"{c}-{m[0]}x{m[1]}") for c in CASES
            for m in CASE_MESHES.get(c, MESHES) if m in meshes]
B, S = 4, 16
GRAD_TOL = 1e-4
JAX_GRAD_TOL = 1e-3
F64 = ("recurrentgemma_q10",)  # run in float64 on both sides
F64_RTOL = 1e-8  # test_torch_tp_xlstm_sp.py's float64 bound
METRIC_RTOL = 1e-6
NORM_RTOL = 1e-4
POST_ATOL = 2 * worker.LR
SHARDED_ATOL = 2e-5
# The first AdamW step of an element is lr * c g / (c |g| + eps) (c the
# clip's scale, the same in both runs to NORM_RTOL), which moves by at most
# lr * gap / (4 |g|) when g moves by gap: within SHARDED_ATOL / 2 where |g|
# is FIRM times the gap or more.
FIRM = worker.LR / (2 * SHARDED_ATOL)
LOOSE_MAX = 1e-3  # share of a leaf's elements that may step past SHARDED_ATOL


def _over(over):
    return {"vocab_size": 1024, **over}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32),
                "labels": labels}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": labels}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _spawn(out):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE), os.environ.get("PYTHONPATH", "")])}
    script = str(HERE / "torch_tp_worker.py")
    cmds = [[script, "jax", str(out)]] + [
        [script, "rank", str(r), "4", str(out / "store"), str(out)] for r in range(4)]
    return [subprocess.Popen([sys.executable, *c], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for c in cmds]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(case, mesh or None): npz dict} for the port's ranks ("torch"), the
    JAX package ("jax") and this process's unsharded step ("plain")."""
    out = tmp_path_factory.mktemp("tp")
    cases = {}
    for i, (name, (arch, over)) in enumerate(CASES.items()):
        jcfg = jreduced(arch, **_over(over))
        state = jax.tree.map(np.asarray, jtrain.init_train_state(jcfg, jax.random.key(i)))
        cases[name] = (arch, _over(over), state, _batch(jcfg, 100 + i))
    spec = {"cases": cases, "meshes": MESHES, "case_meshes": CASE_MESHES, "f64": F64}
    (out / "cases.pkl").write_bytes(pickle.dumps(spec))
    t0 = time.time()
    procs = _spawn(out)
    res = {}
    try:
        for name in cases:
            cfg, state, batch = worker.port_case(spec, name)
            init = {f"init/{k}": p.detach().numpy().copy()
                    for k, p in named_leaves(state["params"])}
            _, _, grads = make_grads_fn(cfg)(state["params"], batch)
            state, metrics = make_train_step(cfg, OptimizerConfig(**worker.opt_kwargs()))(
                state, batch)
            res[("plain", name, None)] = {
                **init,
                **{f"grad/{k}": g.numpy() for k, g in named_leaves(grads)},
                **{f"metric/{k}": v.numpy() for k, v in metrics.items()},
                **{f"param/{k}": p.detach().numpy() for k, p in named_leaves(state["params"])}}
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    print(f"tensor-parallel processes: {time.time() - t0:.1f} s")
    for name in cases:
        for d, m in CASE_MESHES.get(name, MESHES):
            for who in ("torch", "jax"):
                f = out / f"{who}_{name}_{d}x{m}.npz"
                if f.exists():
                    res[(who, name, (d, m))] = dict(np.load(f))
    return res


def _close(got, want, tol, what):
    """The max |got - want| of a leaf over its largest |want|, held to ``tol``."""
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"{what}: max |err| {err:.3g} of the leaf's largest entry"
    return err


def _metrics(got, want, what):
    for k in ("loss", "xent", "aux", "tokens", "grad_norm", "lr"):
        np.testing.assert_allclose(got[f"metric/{k}"], want[f"metric/{k}"],
                                   rtol=NORM_RTOL if k == "grad_norm" else METRIC_RTOL,
                                   err_msg=f"{what} {k}")


def _keys(res, prefix):
    return sorted(k for k in res if k.startswith(prefix))


@pytest.mark.parametrize("case,mesh", _runs(MESHES))
def test_gradients_match_the_unsharded_step(runs, case, mesh):
    got, want = runs[("torch", case, mesh)], runs[("plain", case, None)]
    assert _keys(got, "grad/") == _keys(want, "grad/")
    tol = F64_RTOL if case in F64 else GRAD_TOL
    for k in _keys(want, "grad/"):
        _close(got[k], want[k], tol, f"{case} {mesh} {k}")
    _metrics(got, want, f"{case} {mesh}")


@pytest.mark.parametrize("case,mesh", _runs(TP_MESHES))
def test_step_matches_the_jax_sharded_step(runs, case, mesh):
    got, want = runs[("torch", case, mesh)], runs[("jax", case, mesh)]
    assert _keys(got, "grad/") == _keys(want, "grad/")
    tol = F64_RTOL if case in F64 else JAX_GRAD_TOL
    for k in _keys(want, "grad/"):
        _close(got[k], want[k], tol, f"{case} {mesh} {k}")
    _metrics(got, want, f"{case} {mesh}")
    for k in _keys(want, "param/"):
        np.testing.assert_allclose(got[k], want[k].astype(got[k].dtype), rtol=0,
                                   atol=POST_ATOL, err_msg=f"{case} {mesh} {k}")


@pytest.mark.parametrize("case", [c for c in CASES if (4, 1) in CASE_MESHES.get(c, MESHES)])
def test_data_axis_alone_stays_within_the_two_rank_tolerance(runs, case):
    """The (4, 1) step against the unsharded one: ``SHARDED_ATOL`` where the
    unsharded gradient is farther from zero than ``FIRM`` times the two
    runs' gradient gap, ``POST_ATOL`` elsewhere, on at most ``LOOSE_MAX`` of
    a leaf's elements (see the module docstring)."""
    got, want = runs[("torch", case, (4, 1))], runs[("plain", case, None)]
    for k in _keys(want, "param/"):
        path = k[len("param/"):]
        g_got, g_want = got[f"grad/{path}"], want[f"grad/{path}"]
        firm = np.abs(g_want) > FIRM * np.abs(g_got - g_want)
        err = np.abs(got[k] - want[k])
        bad = (firm & (err > SHARDED_ATOL)) | (err > POST_ATOL)
        loose = ~firm & (err > SHARDED_ATOL)
        if bad.any() or loose.sum() > LOOSE_MAX * err.size:
            i = np.unravel_index(np.argmax(np.where(bad | loose, err, -1.0)), err.shape)
            init = want[f"init/{path}"][i]
            pytest.fail(
                f"{case} {path}{list(i)}: gradients {g_got[i]!r} (4, 1) / {g_want[i]!r} "
                f"unsharded, steps {got[k][i] - init!r} / {want[k][i] - init!r} "
                f"({'firm' if firm[i] else 'loose'}; {int(bad.sum())} beyond their bound, "
                f"{int(loose.sum())} of {err.size} loose past {SHARDED_ATOL})")


@pytest.mark.parametrize("nq,nkv,size,want", [
    (8, 8, 4, [(0, 2, 0, 2, True), (6, 2, 6, 2, True)]),
    (32, 8, 4, [(0, 8, 0, 2, True), (24, 8, 6, 2, True)]),
    (8, 2, 4, [(0, 2, 0, 1, False), (2, 2, 0, 1, False), (4, 2, 1, 1, False),
               (6, 2, 1, 1, False)]),
    (8, 1, 4, [(0, 2, 0, 1, False), (6, 2, 0, 1, False)]),
    (16, 16, 2, [(0, 8, 0, 8, True), (8, 8, 8, 8, True)]),
])
def test_local_heads(nq, nkv, size, want):
    cfg = reduced("llama3-8b", n_heads=nq, n_kv_heads=nkv)
    ranks = range(size) if len(want) == size else (0, size - 1)
    for r, w in zip(ranks, want):
        h = tpm.local_heads(cfg, r, size)
        assert (h.q0, h.nq, h.kv0, h.nkv, h.kv_split) == w, (r, h)


@pytest.mark.parametrize("nq,nkv,size,want", [
    (10, 1, 4, [(0, 3, 0, 1, False, False), (3, 3, 0, 1, False, False),
                (6, 2, 0, 1, False, False), (8, 2, 0, 1, False, False)]),
    (6, 2, 4, [(0, 2, 0, 1, False, False), (2, 2, 0, 2, False, True),
               (4, 1, 1, 1, False, False), (5, 1, 1, 1, False, False)]),
    (6, 3, 4, [(0, 2, 0, 1, False, False), (2, 2, 1, 1, False, False),
               (4, 1, 2, 1, False, False), (5, 1, 2, 1, False, False)]),
    (2, 1, 4, [(0, 1, 0, 1, False, False), (1, 1, 0, 1, False, False),
               (2, 0, 1, 0, False, False), (2, 0, 1, 0, False, False)]),
    (12, 4, 8, [(0, 2, 0, 1, False, False), (2, 2, 0, 2, False, True),
                (4, 2, 1, 1, False, False), (6, 2, 2, 1, False, False),
                (8, 1, 2, 1, False, False), (9, 1, 3, 1, False, False),
                (10, 1, 3, 1, False, False), (11, 1, 3, 1, False, False)]),
    (6, 2, 2, [(0, 3, 0, 1, True, False), (3, 3, 1, 1, True, False)]),
], ids=["10-over-1-on-4", "6-over-2-on-4", "6-over-3-on-4", "2-over-1-on-4", "12-over-4-on-8",
        "6-over-2-on-2"])
def test_local_heads_that_do_not_split(nq, nkv, size, want):
    """Balanced contiguous q heads (the first ``nq % size`` ranks one more,
    a rank maybe none) and the kv heads they read; ``expand`` where a
    rank's q heads span two kv heads without making whole groups."""
    cfg = reduced("llama3-8b", n_heads=nq, n_kv_heads=nkv)
    got = [tpm.local_heads(cfg, r, size) for r in range(size)]
    assert [(h.q0, h.nq, h.kv0, h.nkv, h.kv_split, h.expand) for h in got] == want
    group = nq // nkv
    assert [h.kv0 + i for h in got for i in h.kv_index(group)] == [q // group for q in range(nq)]


@pytest.mark.parametrize("n,size", [(30, 4), (509, 4), (32, 4), (2, 4), (7, 3)])
def test_sequence_rows_pad_to_equal_blocks(n, size):
    """Each rank's block of ``ceil(n / size)`` rows; the blocks tile the
    sequence padded with zero rows, and ``unpad`` gives the sequence back."""
    per = -(-n // size)
    ranks = [tpm.TensorParallel(None, r, size, seq_len=n) for r in range(size)]
    assert [tp.block() for tp in ranks] == [(r * per, per) for r in range(size)]
    x = torch.arange(2 * n, dtype=torch.float32).reshape(1, n, 2)
    padded = ranks[0].pad(x)
    assert padded.shape == (1, per * size, 2) and torch.equal(padded[:, :n], x)
    assert not padded[:, n:].any() and torch.equal(ranks[0].unpad(padded), x)
    assert torch.equal(torch.cat([padded.narrow(1, *tp.block()) for tp in ranks], 1), padded)


@pytest.mark.parametrize("vocab,size", [(1024, 4), (128256, 4), (1000, 3), (5, 4)])
def test_vocab_ranges_are_the_shards_chunks(vocab, size):
    chunks = torch.arange(vocab).chunk(size)
    for r in range(size):
        v0, v1 = tpm.vocab_range(vocab, r, size)
        want = chunks[r] if r < len(chunks) else torch.arange(0)
        assert list(range(v0, v1)) == want.tolist()


def test_no_context_without_a_split_tensor_axis(tmp_path):
    from repro_torch.distributed.api import AxisRules, RULES_2D, axis_rules
    from repro_torch.launch.mesh import MeshShape, make_mesh

    assert tpm.context() is None
    with axis_rules(AxisRules(MeshShape((16, 16), ("data", "model")), RULES_2D)):
        assert tpm.context() is None  # a mesh shape has no group
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        with axis_rules(AxisRules(make_mesh((1, 1), ("data", "model"), device="cpu"),
                                  RULES_2D)):
            assert tpm.context() is None
    finally:
        dist.destroy_process_group()


def _losses(out):
    """{step: loss} of ``launch.train``'s step lines (every rank prints them)."""
    return {int(m[0]): float(m[1]) for m in re.findall(r"step +(\d+)  loss ([\d.]+)", out)}


def test_launch_train_under_torchrun_reshards(tmp_path):
    """``launch.train --device cpu`` under torchrun with 4 ranks: the elastic
    mesh is (1, 4) (tensor-parallel) and the run dies after step 2 with its
    checkpoint saved; relaunched with ``--model-parallel 2`` it restores
    onto a (2, 2) mesh and trains step 3.  Each step's loss is the
    one-process run's (printed to 4 decimals; f32 sums over the ranks)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
        [str(HERE.parent / "src"), os.environ.get("PYTHONPATH", "")])}
    args = ["-m", "repro_torch.launch.train", "--device", "cpu", "--arch", "llama3-8b",
            "--d-model", "64", "--layers", "2", "--batch", "4", "--seq", "16", "--steps", "3",
            "--log-every", "1"]
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2"]
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "4"]

    def start(cmd):
        return subprocess.Popen(cmd, env=env, cwd=tmp_path, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    single = start([sys.executable, *args])
    first = start([*torchrun, *args, *ckpt, "--inject-failure", "2"])
    out1 = first.communicate(timeout=240)[0]
    second = start([*torchrun, *args, *ckpt, "--model-parallel", "2"])
    out2, out0 = second.communicate(timeout=240)[0], single.communicate(timeout=240)[0]
    assert single.returncode == 0, out0[-3000:]
    assert first.returncode != 0 and "injected failure at step 2" in out1, out1[-3000:]
    assert "mesh {'data': 1, 'model': 4}" in out1, out1[-3000:]
    assert second.returncode == 0, out2[-3000:]
    assert "mesh {'data': 2, 'model': 2}" in out2 and "resumed from checkpoint at step 2" in out2
    want, got = _losses(out0), {**_losses(out1), **_losses(out2)}
    assert sorted(want) == sorted(got) == [0, 1, 2], (out1[-2000:], out2[-2000:])
    for step, loss in want.items():
        assert abs(got[step] - loss) <= 2e-4, (step, got[step], loss)
