"""The port's roofline, counter, dry-run and report (mirrors
``tests/test_roofline.py``, on the H100's terms).

The counter counts each kernel call's function-level work, so its count is
the same on meta tensors, the CPU's plain versions and (on the card) the
CUDA kernels; it is held here meta against CPU, against a hand formula, and
against the JAX package's unrolled ``cost_analysis`` within a measured
band.  ``repro.launch.dryrun`` is never imported: it sets ``XLA_FLAGS`` to
512 host devices at import, so its ``model_flops`` is read out of its
source."""
import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.configs.archs import ARCH_IDS
from repro.configs.archs import get_config as jget
from repro.configs.archs import reduced as jreduced
from repro.launch import report as jreport
from repro.launch.roofline import cost_analysis_dict
from repro.models import transformer as J
from repro_torch.configs.archs import get_config, reduced
from repro_torch.distributed import api
from repro_torch.kernels import cost, ref
from repro_torch.kernels.cost import CostCounter
from repro_torch.launch import dryrun, mesh, report
from repro_torch.launch import roofline as rf
from repro_torch.models import transformer as T
from repro_torch.serving import profiles
from repro_torch.training import OptimizerConfig, TrainConfig, init_train_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
# The counter's FLOPs over JAX's cost_analysis of the unrolled loss_fn
# forward and backward (remat off), reduced configs, B = 2, S = 64.
# Measured on an x86 CPU: llama3-8b 1.694, gemma-2b 1.650,
# olmoe-1b-7b 1.699, recurrentgemma-2b 0.946 (S = 512: 1.741, 1.719,
# 1.742, 0.934).  The counter counts matmul FLOPs and each kernel's
# visible-pair work, where XLA counts every elementwise op and its CPU
# backend leaves some dots to library calls it does not count.
RATIO_BAND = (0.9, 1.8)


def _jax_model_flops():
    """``model_flops`` from ``src/repro/launch/dryrun.py``'s source."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "model_flops")
    ns = {"SHAPES": jshapes.SHAPES}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "dryrun.py", "exec"), ns)
    return ns["model_flops"]


def _count(fn, prefix_len=None):
    with CostCounter(prefix_len=prefix_len) as c:
        fn()
    return c


def _batch(cfg, B, S, device, gen):
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    if cfg.frontend == "audio":
        return {"frames": torch.randn(B, S, cfg.frontend_dim, generator=gen).to(device),
                "labels": labels.to(device)}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(device),
             "labels": labels.to(device)}
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn(B, cfg.num_prefix_tokens, cfg.frontend_dim,
                                       generator=gen).to(device)
    return batch


def _params(cfg, device):
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    return T.init_params(cfg, gen, device=device)


def _loss_and_grad(cfg, device):
    params = tree_map(lambda p: p.requires_grad_(True), _params(cfg, device))
    batch = _batch(cfg, 2, 32, device, torch.Generator().manual_seed(1))

    def run():
        loss, _ = T.loss_fn(cfg, params, batch)
        torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)

    return _count(run, prefix_len=cfg.num_prefix_tokens or None)


# ---------------------------------------------------------------------------
# Terms, components, reports.
# ---------------------------------------------------------------------------
def test_hw_is_the_h100_table():
    assert rf.HW == profiles.H100 == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                                      "link_bw": 450e9}


def test_combine_components_scales_by_multiplier():
    comps = [
        rf.Component("layer", flops=10.0, bytes_accessed=100.0,
                     coll_bytes={"all-reduce": 5}, multiplier=32),
        rf.Component("ends", flops=7.0, bytes_accessed=3.0,
                     coll_bytes={"all-gather": 2}, multiplier=1),
    ]
    tot = rf.combine_components(comps)
    assert tot["flops"] == 10 * 32 + 7
    assert tot["bytes"] == 100 * 32 + 3
    assert tot["coll_bytes"] == 5 * 32 + 2
    assert tot["coll_by_kind"] == {"all-reduce": 160.0, "all-gather": 2.0}


def test_cost_terms_units():
    terms = rf.cost_terms({"flops": rf.HW["peak_flops"], "bytes": rf.HW["hbm_bw"],
                           "coll_bytes": rf.HW["link_bw"]}, chips=256)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(1.0)
    assert terms["collective_s"] == pytest.approx(1.0)


def test_cell_report_dominant_and_ratio():
    rep = rf.CellReport(
        arch="a", shape="s", mesh="m", chips=4,
        terms_s={"compute_s": 0.5, "memory_s": 2.0, "collective_s": 0.1},
        totals={"flops": 100.0, "bytes": 1.0, "coll_bytes": 0.0},
        model_flops=300.0, bytes_per_device=None, coll_census={},
    )
    assert rep.dominant == "memory_s"
    assert rep.useful_ratio == pytest.approx(300.0 / 400.0)
    j = rep.to_json()
    assert j["dominant"] == "memory_s"
    assert j["model_flops_over_hlo"] == pytest.approx(0.75)


def test_reckoned_collectives_hand_count():
    """A (2, 4) ("data", "model") mesh, RULES_2D: batch and embed on data,
    heads / ffn / expert_ffn on model; 64 global tokens, 32 per device."""
    m = mesh.MeshShape((2, 4), ("data", "model"))
    rules = mesh.make_rules(m)
    weights = [
        (("attn", "wq"), (8, 16), ("embed", "heads"), 2),   # 256 bytes
        (("attn", "wo"), (16, 8), ("heads", "embed"), 2),   # 256 bytes
        (("ln1",), (8,), ("embed",), 4),                    # 32 bytes
        (("cell", "bi"), (4,), (None,), 4),                 # 16 bytes, replicated
        (("moe", "wo"), (2, 16, 8), ("experts", "expert_ffn", "embed"), 2),  # 512 bytes
    ]
    out, count = rf.reckon_collectives(weights, rules, m, tokens=64, itemsize=2, train=True,
                                       top_k=2)
    # all-gather over data, result sharded by model only; twice (remat).
    gather = 2 * (256 // 4 + 256 // 4 + 32 + 512 // 4)
    # gradient reduce-scatter: the full shard; bi's all-reduce over data.
    scatter = 256 // 8 + 256 // 8 + 32 // 2 + 512 // 8
    # activation all-reduce after a contraction on model, twice, and once
    # more for the region input's gradient: wo 32 tokens x 8 x 2 bytes; the
    # expert wo 32 x top-2 x 8 x 2.
    reduce = 16 + 3 * (32 * 8 * 2 + 32 * 2 * 8 * 2)
    assert out == {"all-gather": gather, "reduce-scatter": scatter, "all-reduce": reduce}
    assert count == {"all-gather": 8, "reduce-scatter": 4, "all-reduce": 7}
    out, count = rf.reckon_collectives(weights, rules, m, tokens=64, itemsize=2, train=False,
                                       top_k=2)
    assert out == {"all-gather": gather // 2, "all-reduce": (reduce - 16) // 3}
    dec = mesh.make_rules(m, decode_opt=True)  # weights not sharded over data
    out, _ = rf.reckon_collectives(weights, dec, m, tokens=64, itemsize=2, train=False, top_k=2)
    assert "all-gather" not in out


_SP_WEIGHTS = [
    (("attn", "wq"), (8, 16), ("embed", "heads"), 2),
    (("attn", "wo"), (16, 8), ("heads", "embed"), 2),
    (("moe", "wo"), (2, 16, 8), ("experts", "expert_ffn", "embed"), 2),
]


@pytest.mark.parametrize("train", [True, False], ids=["train", "prefill"])
def test_reckoned_collectives_sequence_parallel(train):
    """RULES_2D_SP on the (2, 4) mesh: each activation all-reduce of a
    train step or a prefill becomes one reduce-scatter (its result over the
    4 model ranks) and one all-gather of its size; the weights' collectives
    are RULES_2D's; a decode step keeps the all-reduce."""
    m = mesh.MeshShape((2, 4), ("data", "model"))
    kw = dict(tokens=64, itemsize=2, train=train, top_k=2)
    base, _ = rf.reckon_collectives(_SP_WEIGHTS, mesh.make_rules(m), m, **kw)
    out, count = rf.reckon_collectives(_SP_WEIGHTS, mesh.make_rules(m, seq_parallel=True), m,
                                       **kw)
    n = 3 if train else 1  # forward, remat's forward, the input's gradient
    act = n * (32 * 8 * 2 + 32 * 2 * 8 * 2)
    assert base["all-reduce"] == act
    assert out == {"all-gather": base["all-gather"] + act,
                   "reduce-scatter": base.get("reduce-scatter", 0) + act // 4}
    # three weights gathered over data per pass, two activations per call
    assert count["all-gather"] == 3 * (2 if train else 1) + 2 * n
    dec = rf.reckon_collectives(_SP_WEIGHTS, mesh.make_rules(m, seq_parallel=True), m,
                                decode=True, **kw)
    assert dec == rf.reckon_collectives(_SP_WEIGHTS, mesh.make_rules(m), m, decode=True, **kw)


def test_reckoned_collectives_skip_one_rank_axes():
    """On a (1, 4) mesh the data axis has one rank: no weight is gathered or
    its gradient scattered over it; the activations' all-reduces remain."""
    m = mesh.MeshShape((1, 4), ("data", "model"))
    out, count = rf.reckon_collectives(_SP_WEIGHTS, mesh.make_rules(m), m, tokens=64,
                                       itemsize=2, train=True, top_k=2)
    assert out == {"all-reduce": 3 * (64 * 8 * 2 + 64 * 2 * 8 * 2)}
    assert count == {"all-reduce": 6}


@pytest.mark.parametrize("seq_parallel", [False, True], ids=["RULES_2D", "RULES_2D_SP"])
def test_reckoned_collectives_tied_vocab(seq_parallel):
    """A tied token table that the loss reads as its vocab-split head: a
    train step all-reduces the table's gradient over the tensor axis (its
    whole bytes); a prefill, or an untied table, adds nothing."""
    m = mesh.MeshShape((1, 4), ("data", "model"))
    rules = mesh.make_rules(m, seq_parallel=seq_parallel)
    table = [(("embed", "tokens"), (2048, 8), (None, "embed"), 2)]
    kw = dict(tokens=64, itemsize=2, top_k=1)
    assert rf.reckon_collectives(table, rules, m, train=True, tied_vocab=True, **kw) == (
        {"all-reduce": 2048 * 8 * 2}, {"all-reduce": 1})
    assert rf.reckon_collectives(table, rules, m, train=False, tied_vocab=True, **kw) == ({}, {})
    assert rf.reckon_collectives(table, rules, m, train=True, **kw) == ({}, {})


# ---------------------------------------------------------------------------
# The counter.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,causal,window,prefix", [
    (1, True, 0, 0), (37, True, 0, 0), (64, False, 0, 0), (100, True, 16, 0),
    (100, False, 16, 0), (70, True, 0, 5), (70, True, 16, 40), (30, True, 0, 64),
    (128, False, 48, 7), (65, True, 1, 0),
])
def test_visible_pairs_equals_the_mask(S, causal, window, prefix):
    pre = torch.tensor([prefix], dtype=torch.int32) if prefix else None
    mask = ref._scores_mask(S, S, causal=causal, window=window, device="cpu", prefix_len=pre)
    assert cost.visible_pairs(S, causal=causal, window=window, prefix=prefix) == int(mask.sum())


def test_work_bound_picks_the_larger_term():
    ms, by = cost.Work(flops=989e9, bytes=1).bound()
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = cost.Work(bytes=3.35e9).bound()
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = cost.Work(bytes=1, f32_ops=67e9).bound()
    assert (ms, by) == (pytest.approx(1.0), "operations")
    w = cost.flash_fwd_work(2, 8, 1, 16, 4, 2, pairs=100, lse=True)
    assert (w.flops, w.bytes) == (4 * 8 * 4 * 100, 2 * (2 * 2 * 8 * 16 * 4 + 2 * 2 * 16 * 4)
                                  + 4 * 2 * 8 * 16)


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-2b", "olmoe-1b-7b", "xlstm-350m",
                                  "hubert-xlarge", "paligemma-3b"])
def test_meta_count_equals_cpu_count(arch):
    cfg = reduced(arch)
    cpu, meta = _loss_and_grad(cfg, "cpu"), _loss_and_grad(cfg, "meta")
    assert cpu.totals() == meta.totals()
    assert cpu.kernels == meta.kernels and cpu.by_op == meta.by_op


@pytest.mark.parametrize("arch", ["qwen3-14b", "recurrentgemma-2b", "xlstm-350m"])
def test_meta_decode_count_equals_cpu_count(arch):
    """A decode step with every ring slot live (a meta trace counts every
    slot), under inference mode."""
    cfg, B, P = reduced(arch), 3, 16
    params = _params(cfg, "cpu")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        cache, logits = T.prefill(cfg, params, {"tokens": prompt}, max_len=P + 1)
        token, pos = logits.argmax(-1), torch.full((B,), P, dtype=torch.int32)
        cpu = _count(lambda: T.decode_step(cfg, params, cache, token, pos))
        mp, mc = _params(cfg, "meta"), T.init_cache(cfg, B, P + 1, device="meta")
        meta = _count(lambda: T.decode_step(
            cfg, mp, mc, torch.empty(B, dtype=token.dtype, device="meta"),
            torch.empty(B, dtype=torch.int32, device="meta")))
    assert cpu.totals() == meta.totals() and cpu.kernels == meta.kernels
    assert cpu.flops > 0


@pytest.mark.parametrize("tc", [TrainConfig(), TrainConfig(microbatches=2, grad_compression=True)],
                         ids=["plain", "microbatched-compressed"])
def test_meta_train_step_count_equals_cpu_count(tc):
    cfg = reduced("gemma-2b")
    batch = {k: torch.zeros((4, 32), dtype=torch.int32) for k in ("tokens", "labels")}
    step = make_train_step(cfg, OptimizerConfig(), tc)
    cpu_state = init_train_state(cfg, torch.Generator().manual_seed(0), tc, device="cpu")
    cpu = _count(lambda: step(cpu_state, batch))
    meta_state = init_train_state(cfg, None, tc, device="meta")
    meta_batch = {k: v.to("meta") for k, v in batch.items()}
    meta = _count(lambda: step(meta_state, meta_batch))
    assert cpu.totals() == meta.totals() and cpu.by_op == meta.by_op


@pytest.mark.parametrize("remat", [False, True])
def test_flops_equal_hand_formula(remat):
    """Reduced llama3-8b, B = 2, S = 64: 6 FLOPs per block matmul parameter
    and token (8 for the head: each loss chunk's logits are recomputed in
    the backward), remat adding one more block forward less its last
    matmul (the MLP's ``wo``, whose output the backward does not need:
    ``torch.utils.checkpoint`` stops its recompute there); per attention
    layer 4 * NQ * D per visible pair forward (twice under remat) and
    10 * NQ * D backward."""
    cfg = dataclasses.replace(reduced("llama3-8b"), remat=remat)
    B, S = 2, 64
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    block = d * hd * (nq + 2 * nkv) + nq * hd * d + 3 * d * cfg.d_ff
    tokens = B * S
    pairs = B * S * (S + 1) // 2
    fwd = 2 if remat else 1
    want = (6 * cfg.n_layers * block * tokens + 8 * d * cfg.vocab_size * tokens
            + 2 * (fwd - 1) * cfg.n_layers * (block - cfg.d_ff * d) * tokens
            + cfg.n_layers * (4 * fwd + 10) * nq * hd * pairs)
    params = tree_map(lambda p: p.requires_grad_(True), T.init_params(cfg, device="meta"))
    batch = {k: torch.zeros((B, S), dtype=torch.int32, device="meta") for k in ("tokens", "labels")}

    def run():
        loss, _ = T.loss_fn(cfg, params, batch)
        torch.autograd.grad(loss, tree_leaves(params))

    c = _count(run)
    assert c.flops == want
    assert c.kernels["flash_attention_fwd"][0] == fwd * cfg.n_layers
    assert c.kernels["flash_attention_bwd"][0] == cfg.n_layers


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma-2b", "olmoe-1b-7b", "recurrentgemma-2b"])
def test_flops_against_jax_cost_analysis(arch):
    B, S = 2, 64
    jcfg = dataclasses.replace(jreduced(arch), unroll_scans=True, remat=False)
    cfg = dataclasses.replace(reduced(arch), remat=False)
    p = J.init_params(jcfg, jax.random.key(0))
    jb = {"tokens": jnp.zeros((B, S), jnp.int32), "labels": jnp.zeros((B, S), jnp.int32)}
    f = jax.jit(jax.value_and_grad(lambda p, b: J.loss_fn(jcfg, p, b)[0]))
    jflops = cost_analysis_dict(f.lower(p, jb).compile())["flops"]
    params = tree_map(lambda t: t.requires_grad_(True), T.init_params(cfg, device="meta"))
    batch = {k: torch.zeros((B, S), dtype=torch.int32, device="meta") for k in ("tokens", "labels")}

    def run():
        loss, _ = T.loss_fn(cfg, params, batch)
        torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)

    ratio = _count(run).flops / jflops
    assert RATIO_BAND[0] <= ratio <= RATIO_BAND[1], ratio


# ---------------------------------------------------------------------------
# The dry-run.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_jax(arch):
    jmf = _jax_model_flops()
    for shape in jshapes.SHAPES:
        cfg = dryrun._tune_cfg(get_config(arch), shape)
        jcfg = dataclasses.replace(jget(arch), **{k: getattr(cfg, k)
                                                  for k in ("remat", "moe_groups")})
        assert dryrun.model_flops(cfg, shape) == jmf(jcfg, shape)


def test_temp_bytes_hand_count():
    """Reduced llama3-8b (vocabulary 2048, an untied head over the tensor
    axis) on a (2, 2) mesh (RULES_2D): heads, ffn and vocab over model,
    batch over data."""
    cfg = reduced("llama3-8b", vocab_size=2048)
    m = mesh.MeshShape((2, 2), ("data", "model"))
    rules = mesh.make_rules(m)
    d, V = cfg.d_model, cfg.vocab_size
    act = 2 * d + (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim // 2 + 3 * cfg.d_ff // 2
    # decode_32k: 128 rows over data -> 64 tokens; f32 logits, vocab untied over model.
    assert dryrun.temp_bytes(cfg, "decode_32k", m, rules) == act * 64 * 4 + 64 * (V // 2) * 4
    # train_4k: 128 rows x 4096 tokens per device.
    tok = 128 * 4096
    grads = 0
    for _, shape, axes, _ in dryrun._model_weights(cfg):
        n = 4
        for dim, s in zip(api.named_sharding(m, rules, axes).shard_shape(shape), shape):
            n *= dim
        grads += n
    want = (grads + cfg.n_periods * tok * d * 4 + act * tok * 4
            + 2 * 128 * min(cfg.loss_chunk, 4096) * (V // 2) * 4)
    assert dryrun.temp_bytes(cfg, "train_4k", m, rules) == want
    # The gradient term by hand: wq (64, 32) -> (32, 16) on the (2, 2) mesh.
    wq = next(w for w in dryrun._model_weights(cfg) if w[0][-1] == "wq")
    assert api.named_sharding(m, rules, wq[2]).shard_shape(wq[1]) == (
        wq[1][0], -(-wq[1][1] // 2), -(-wq[1][2] // 2))


def test_dryrun_cell_in_process(tmp_path):
    """One real cell, as the JAX package's subprocess test: xlstm-350m
    decode_32k on the single pod, traced on meta tensors."""
    out = tmp_path / "cell.json"
    rc = dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--mesh", "single",
                      "--out", str(out)])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["hw"] == rf.HW
    cell = data["cells"][0]
    assert cell["status"] == "ok" and cell["chips"] == 256
    assert cell["collectives"] == "reckoned from the rules"
    assert cell["dominant"] in cell["terms_s"]
    assert set(cell) >= {"arch", "shape", "mesh", "variant", "chips", "global_batch", "status",
                         "lower_s", "compile_s", "memory", "collective_census",
                         "full_step_cost_analysis", "terms_s", "totals", "coll_by_kind",
                         "model_flops", "model_flops_over_hlo", "dominant", "components"}
    mem = cell["memory"]
    assert mem["per_device_total"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                       + mem["output_bytes"] - mem["alias_bytes"])
    # lm_zoo_registry refines xlstm-350m's mu from the cell by its formula.
    prompt, gen = 128, 16
    refined = profiles.lm_zoo_registry(prompt=prompt, gen_tokens=gen, chips=1,
                                       roofline_json=str(out))
    analytic = profiles.lm_zoo_registry(prompt=prompt, gen_tokens=gen, chips=1)
    per_token = 1e3 * max(cell["terms_s"].values()) / cell["global_batch"]
    mu = dict(zip(refined.names, refined.mu))
    want = per_token * gen + dict(zip(analytic.names, analytic.mu))["xlstm-350m"] * 0.1
    assert mu["xlstm-350m"] == pytest.approx(want, rel=1e-6)  # the registry keeps f32
    assert mu["gemma-2b"] == dict(zip(analytic.names, analytic.mu))["gemma-2b"]
    # A second run resumes from the file; a file of another table is refused.
    assert dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--mesh", "single",
                        "--out", str(out)]) == 0
    assert len(json.loads(out.read_text())["cells"]) == 1
    other = tmp_path / "v5e.json"
    other.write_text(json.dumps({"cells": []}))
    with pytest.raises(SystemExit, match="not written by this dry-run"):
        dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--out", str(other)])


def test_dryrun_skips_as_jax(tmp_path):
    out = tmp_path / "skip.json"
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "long_500k", "--mesh", "both",
                        "--out", str(out), "--no-components"]) == 0
    cells = json.loads(out.read_text())["cells"]
    want = jshapes.skip_reason(jget("hubert-xlarge"), "long_500k")
    assert [(c["mesh"], c["status"], c["note"]) for c in cells] == [
        ("single_pod", "skipped", want), ("multi_pod", "skipped", want)]


def test_report_table_equals_jax(tmp_path):
    out = tmp_path / "cells.json"
    dryrun.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--mesh", "both",
                 "--out", str(out)])
    cells = json.loads(out.read_text())["cells"] + [
        {"arch": "hubert-xlarge", "shape": "long_500k", "mesh": "single_pod", "variant": "",
         "status": "skipped", "note": "encoder-only architecture has no decode step"},
        {"arch": "gemma-2b", "shape": "train_4k", "mesh": "single_pod", "variant": "",
         "status": "error", "note": "RuntimeError: something"},
    ]
    for variant in ("", "other"):
        assert report.fmt_table(cells, variant) == jreport.fmt_table(cells, variant)
    (tmp_path / "all.json").write_text(json.dumps({"cells": cells}))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.report", "--json",
                          str(tmp_path / "all.json")], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == jreport.fmt_table(cells).strip()
