"""Tensor-parallel serving of the port against the JAX package and the
port's unsharded run, on the CPU in f32: ``T.prefill`` and
``T.decode_step`` under ``axis_rules(AxisRules(mesh, table))`` on a
("data", "model") mesh, as the JAX package's dry-run ``build_cell`` lowers
them.

One fixture runs, at once: four gloo processes of the port
(``torch_tp_worker.py serve-rank``) and the JAX package on four forced host
devices (``torch_tp_worker.py serve-jax``), each over every run of
``RUNS``: a prefill of a batch of 4 prompts, then greedy decoding.  Every
case starts from the same numpy-seeded JAX ``init_params``
(``params_from_numpy``) and prompt.  Each port rank also serves unsharded,
so the cache it holds is compared with its slice of the unsharded cache.

Cases (reduced configs, d 64, head dim 16, the vocab 1024 so the head is
split on it): llama3-8b with 8 q heads over 2 kv heads (the kv heads split
at tensor size 2, read whole by two ranks each at 4), its ring wrapping in
decode, and with the int8 cache; gemma-2b (4 q heads over 1 kv head, a
tied table) with a prompt shorter than one rank's slots, so that two ranks
hold no valid slot in any step; qwen3-14b (qk-norm); olmoe-1b-7b (4
experts top-2) with one MoE group (every data rank routes the whole batch)
and with 4 (two on each data rank); recurrentgemma-2b (3 layers: two
RG-LRU blocks, the ``lru`` width 64 split, and a local-attention block
whose 32-slot window ring wraps in the prefill).  Heads that do not split
over the four ranks of (1, 4), which GSPMD pads: llama3-8b with 6 q heads
over 2 kv heads and over 3, recurrentgemma-2b with 10 heads (3 / 3 / 2 / 2
a rank) and gemma-2b with 2 heads (ranks 2 and 3 hold none); their decode
steps gather the q rows over the heads padded to the largest count.

Tolerances, each with its reason (measured worst in brackets); every one
is of the largest entry of what it holds (the logits of a run, a cache
leaf):

* logits against the port's unsharded run: ``UNSHARDED_RTOL``: the sums
  over the tensor axis add the ranks' partial products in another order
  than one matmul, and the decode softmax is folded from the ranks' rows
  [4.0e-5 recurrentgemma-2b at (1, 4), whose RG-LRU gates amplify
  rounding; 2.7e-6 the attention and MoE stacks];
* logits against the JAX package's sharded run: ``JAX_RTOL``: the port's
  unsharded logits are that far from JAX's sharded ones too, and JAX's
  (1, 4) and (2, 2) runs 8e-5 from each other [9.1e-5 recurrentgemma-2b
  at (2, 2); 7.7e-6 the rest]; ``test_torch_hybrid.py`` holds the
  unsharded recurrentgemma-2b to JAX at 1e-4 + rtol 1e-4;
* greedy tokens: equal in all three runs;
* each rank's cache slice against its slice of the unsharded cache, and the
  gathered cache against the unsharded cache: ``CACHE_RTOL`` [4.2e-5
  recurrentgemma-2b's ``h``; 2.3e-6 the rest]; the int8 cache's codes may
  move by one where a value sits at a rounding boundary, so its
  dequantised entries are held one step of their scale further.
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

from repro.configs.archs import reduced as jreduced
from repro.models import transformer as JT
from repro_torch.kernels import ref

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_tp_worker as worker  # noqa: E402

B = 4
VOCAB = 1024
# name: (arch, overrides, prompt length, max_len, decode steps)
CASES = {
    "llama_kv2": ("llama3-8b", {"n_heads": 8, "n_kv_heads": 2}, 12, 32, 6),
    "llama_wrap": ("llama3-8b", {"n_heads": 8, "n_kv_heads": 2}, 12, 16, 8),
    "llama_int8": ("llama3-8b", {"n_heads": 8, "n_kv_heads": 2, "kv_cache_quant": True},
                   12, 32, 6),
    "gemma": ("gemma-2b", {}, 5, 32, 6),
    "qwen3": ("qwen3-14b", {}, 12, 32, 6),
    "olmoe": ("olmoe-1b-7b", {}, 12, 32, 6),
    "olmoe_g4": ("olmoe-1b-7b", {"moe_groups": 4}, 12, 32, 6),
    "recurrentgemma": ("recurrentgemma-2b", {}, 40, 64, 6),
    "llama_q6_kv2": ("llama3-8b", {"n_heads": 6, "n_kv_heads": 2}, 12, 32, 6),
    "llama_q6_kv3": ("llama3-8b", {"n_heads": 6, "n_kv_heads": 3}, 12, 32, 6),
    "recurrentgemma_q10": ("recurrentgemma-2b", {"n_heads": 10}, 40, 64, 6),
    "gemma_q2": ("gemma-2b", {"n_heads": 2}, 5, 32, 6),
}
RUNS = [
    ("llama_kv2", (1, 4), "RULES_2D"), ("llama_kv2", (2, 2), "RULES_2D"),
    ("llama_kv2", (1, 4), "RULES_2D_DEC"), ("llama_kv2", (2, 2), "RULES_2D_DEC"),
    ("llama_wrap", (1, 4), "RULES_2D"), ("llama_int8", (1, 4), "RULES_2D"),
    ("gemma", (1, 4), "RULES_2D"), ("qwen3", (1, 4), "RULES_2D"),
    ("olmoe", (2, 2), "RULES_2D_DEC"), ("olmoe", (2, 2), "RULES_2D"),
    ("olmoe_g4", (2, 2), "RULES_2D"),
    ("recurrentgemma", (1, 4), "RULES_2D"), ("recurrentgemma", (2, 2), "RULES_2D_DEC"),
    ("llama_q6_kv2", (1, 4), "RULES_2D"), ("llama_q6_kv3", (1, 4), "RULES_2D_DEC"),
    ("recurrentgemma_q10", (1, 4), "RULES_2D"), ("gemma_q2", (1, 4), "RULES_2D"),
]
UNSHARDED_RTOL = 1e-4
JAX_RTOL = 2e-4
CACHE_RTOL = 1e-4
WORLD = 4


def _tag(run):
    return worker.run_tag(*run)


def _spawn(out):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE), os.environ.get("PYTHONPATH", "")])}
    script = str(HERE / "torch_tp_worker.py")
    cmds = [[script, "serve-jax", str(out)]] + [
        [script, "serve-rank", str(r), str(WORLD), str(out / "store"), str(out)]
        for r in range(WORLD)]
    return [subprocess.Popen([sys.executable, *c], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for c in cmds]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(who, run): npz dict}: the JAX package's run ("jax") and each port
    rank's ("torch", rank)."""
    out = tmp_path_factory.mktemp("tp_serve")
    cases = {}
    for i, (name, (arch, over, S, max_len, steps)) in enumerate(CASES.items()):
        over = {"vocab_size": VOCAB, **over}
        jcfg = jreduced(arch, **over)
        params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(i)))
        prompt = np.random.default_rng(100 + i).integers(0, VOCAB, (B, S)).astype(np.int32)
        cases[name] = (arch, over, params, prompt, max_len, steps)
    (out / "serve.pkl").write_bytes(pickle.dumps({"cases": cases, "runs": RUNS}))
    t0 = time.time()
    procs = _spawn(out)
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    print(f"tensor-parallel serving processes: {time.time() - t0:.1f} s")
    res = {}
    for run in RUNS:
        res[("jax", run)] = dict(np.load(out / f"serve_jax_{_tag(run)}.npz"))
        for r in range(WORLD):
            res[(("torch", r), run)] = dict(np.load(out / f"serve_torch_{_tag(run)}_r{r}.npz"))
    return res


def _err(got, want):
    """max |got - want| and the largest |want|."""
    want = want.astype(np.float64)
    return float(np.abs(got.astype(np.float64) - want).max()), float(np.abs(want).max())


@pytest.mark.parametrize("run", RUNS, ids=_tag)
def test_logits_match_the_unsharded_run(runs, run):
    got = runs[(("torch", 0), run)]
    assert got["logits"].shape == got["plain_logits"].shape
    err, top = _err(got["logits"], got["plain_logits"])
    assert err <= UNSHARDED_RTOL * top, (f"{_tag(run)}: logits {err / top:.3g} from the "
                                         "unsharded run")


@pytest.mark.parametrize("run", RUNS, ids=_tag)
def test_logits_match_the_jax_sharded_run(runs, run):
    got, want = runs[(("torch", 0), run)], runs[("jax", run)]
    assert got["logits"].shape == want["logits"].shape
    err, top = _err(got["logits"], want["logits"])
    assert err <= JAX_RTOL * top, f"{_tag(run)}: logits {err / top:.3g} from the JAX package's"


@pytest.mark.parametrize("run", RUNS, ids=_tag)
def test_greedy_tokens_are_equal(runs, run):
    got = runs[(("torch", 0), run)]
    np.testing.assert_array_equal(got["tokens"], runs[("jax", run)]["tokens"])
    np.testing.assert_array_equal(got["tokens"], got["plain_tokens"])


def _dequant(res, prefix, path):
    """A leaf of the cache, its int8 k / v dequantised (f64) with their scales."""
    leaf = res[f"{prefix}/{path}"].astype(np.float64)
    name = path.rsplit("/", 1)[-1]
    if name in ("k", "v") and f"{prefix}/{path}_scale" in res:
        return leaf * res[f"{prefix}/{path}_scale"][..., None], res[f"{prefix}/{path}_scale"]
    return leaf, None


def _hold_cache(res, got, want, what):
    paths = sorted(k.split("/", 1)[1] for k in res if k.startswith(f"{want}/"))
    assert paths and paths == sorted(k.split("/", 1)[1] for k in res
                                     if k.startswith(f"{got}/")), what
    for path in paths:
        a, scale = _dequant(res, got, path)
        b, _ = _dequant(res, want, path)
        assert a.shape == b.shape, (what, path, a.shape, b.shape)
        if path.endswith("slot_pos"):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")
            continue
        err, top = _err(a, b)
        tol = CACHE_RTOL * top + (0.0 if scale is None else float(scale.max()))
        assert err <= tol, f"{what} {path}: {err:.3g} beyond {tol:.3g}"


@pytest.mark.parametrize("run", RUNS, ids=_tag)
def test_cache_slices_are_the_unsharded_cache(runs, run):
    """Each rank's cache is its slice (``shard_tree``) of the unsharded
    cache, and ``gather_tree`` of the slices is the unsharded cache."""
    for r in range(WORLD):
        _hold_cache(runs[(("torch", r), run)], "local", "want", f"{_tag(run)} rank {r}")
    _hold_cache(runs[(("torch", 0), run)], "whole", "plain", f"{_tag(run)} gathered")


@pytest.mark.parametrize("run", [("gemma", (1, 4), "RULES_2D"),
                                 ("llama_kv2", (1, 4), "RULES_2D")], ids=_tag)
def test_ranks_without_a_valid_slot_are_covered(runs, run):
    """The prompt and the decoded tokens fill rank 0's slots (and part of
    rank 1's or 2's): rank 3 holds no valid slot, so every decode step folds
    its rows at weight 0; the logits tests above hold the result."""
    last = runs[(("torch", WORLD - 1), run)]
    slots = [v for k, v in last.items() if k.startswith("local/") and k.endswith("slot_pos")]
    assert slots and all((s == -1).all() for s in slots)
    first = runs[(("torch", 0), run)]
    assert all((v >= 0).all() for k, v in first.items()
               if k.startswith("local/") and k.endswith("slot_pos"))


def test_decode_lse_against_float64():
    """The plain ring decode's log-sum-exp (``return_lse``) against a
    float64 masked log-sum-exp of the same numpy inputs: rows with a
    window, with empty slots, and one with no valid slot at all (-1e30)."""
    rng = np.random.default_rng(7)
    Bq, NKV, G, S, D = 3, 2, 4, 40, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Bq, NKV, G, D), (Bq, NKV, S, D), (Bq, NKV, S, D)))
    slot_pos = np.tile(np.arange(S, dtype=np.int32), (Bq, 1))
    slot_pos[1, 25:] = -1
    pos = np.array([30, 20, -1], dtype=np.int32)
    for window in (0, 8):
        out, lse = ref.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, slot_pos,
                                                                            pos)),
                                            window=window, return_lse=True)
        assert out.shape == (Bq, NKV, G, D) and lse.shape == (Bq, NKV, G)
        assert lse.dtype == torch.float32
        s = np.einsum("bhgd,bhsd->bhgs", q.astype(np.float64), k.astype(np.float64)) * D**-0.5
        ok = (slot_pos >= 0) & (slot_pos <= pos[:, None])
        if window:
            ok &= slot_pos > pos[:, None] - window
        s = np.where(ok[:, None, None, :], s, -np.inf)
        m = s.max(-1)
        want = m[:2] + np.log(np.exp(s[:2] - m[:2, ..., None]).sum(-1))
        np.testing.assert_allclose(lse[:2].numpy(), want, rtol=0, atol=2e-6)
        assert (lse[2] == -1e30).all()  # no valid slot: the sentinel's
        np.testing.assert_allclose(out[2].numpy(), np.broadcast_to(v[2].mean(1)[:, None],
                                                                   (NKV, G, D)), atol=1e-6)
