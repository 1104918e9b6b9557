"""Dry-run: the roofline of every (arch x shape x mesh) cell on the H100, the
JAX package's ``launch/dryrun.py`` in PyTorch, with its flags and JSON row
keys.

For each cell this:
  1. takes the production mesh's shape (16x16 single pod, 2x16x16 multi
     pod; one process cannot hold their ranks, and nothing here needs them),
  2. reckons the per-device memory of the step's arguments (parameters,
     optimizer state, cache, inputs) from the logical axes and the rules on
     that shape, each sharded dim divided by its mesh axes' sizes rounded
     up, and its temporaries by :func:`temp_bytes`'s stated method,
  3. traces the roofline's *cost components* (one block per layer kind,
     forward or forward and backward; the sLSTM's one step and the mLSTM's
     short sequence, scaled as the JAX package scales them; the 0-layer
     ends; the optimizer) on meta tensors at the cell's global shapes
     through :class:`~repro_torch.kernels.cost.CostCounter`, so each
     kernel call counts its function-level work, and combines them by
     their layer counts into the three terms of
     :mod:`repro_torch.launch.roofline` (single pod; both meshes get the
     per-device totals), with collective bytes reckoned from the rules.

Nothing here touches a GPU or allocates a tensor's data: meta tensors only,
as the JAX dry-run only compiles on placeholder host devices.  Row keys are
the JAX package's; ``compile_s`` holds the seconds the component traces
took and ``lower_s`` those of the memory and collective reckoning;
``collective_census`` counts the reckoned collectives per step by kind
(``"collectives": "reckoned from the rules"`` says where they come from);
``full_step_cost_analysis`` holds the per-device totals of the components
(the port has no compiled full step to read).  ``model_flops`` is the JAX
package's ``6 N D`` (train) / ``2 N D`` count.

The JSON is what ``serving.profiles.lm_zoo_registry(roofline_json=...)``
reads.  It records the H100 table it was reckoned with (``"hw"``), and the
dry-run resumes only from a file with the same table: a TPU dry-run's rows
never mix in.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from collections import Counter
from pathlib import Path

import torch

from repro_torch.configs.archs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, input_specs, skip_reason
from repro_torch.distributed.api import AxisRules, mesh_axes, named_sharding
from repro_torch.distributed.tensor_parallel import VOCAB_SPLIT_MIN
from repro_torch.kernels.cost import CostCounter
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_custom_mesh, make_production_mesh, make_rules
from repro_torch.models import layers, xlstm
from repro_torch.models import transformer as T
from repro_torch.training.optimizer import OptimizerConfig, adamw_update, init_opt_state
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["OPT_CFG", "model_flops", "cost_components", "memory", "temp_bytes", "run_cell",
           "main"]

OPT_CFG = OptimizerConfig()
META = "meta"


def _tune_cfg(cfg, shape):
    """Execution knobs for production shapes (architecture unchanged)."""
    over = {"remat": True}
    if "moe" in cfg.pattern:
        # One group per batch row: groups sharded exactly like the batch.
        over["moe_groups"] = SHAPES[shape].global_batch
    return dataclasses.replace(cfg, **over)


def model_flops(cfg, shape) -> float:
    cell = SHAPES[shape]
    n_active = cfg.param_count(active_only=True)
    tokens = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
    mult = 6 if cell.kind == "train" else 2
    return float(mult * n_active * tokens)


# ---------------------------------------------------------------------------
# Meta stand-ins.
# ---------------------------------------------------------------------------
def _meta(shape, dtype, grad=False):
    return torch.empty(shape, dtype=dtype, device=META).requires_grad_(grad)


def _block_params(cfg, kind, grad=False):
    """Meta parameters of one block of ``kind``."""
    return T._walk_spec(T.block_spec(cfg, kind),
                        lambda path, shape: _meta(shape, T._leaf_dtype(cfg, path[-1]), grad))


def _model_params(cfg, grad=False):
    return tree_map(lambda p: p.requires_grad_(grad), T.init_params(cfg, device=META))


def _weights(cfg, kind):
    """``[(path, shape, axes, bytes per element)]`` of one block's leaves."""
    out = []
    T._walk_axes(T.block_spec(cfg, kind), T.block_axes(cfg, kind),
                 lambda path, shape, ax: out.append(
                     (path, shape, ax, T._leaf_dtype(cfg, path[-1]).itemsize)))
    return out


def _model_weights(cfg):
    out = []
    T._walk_axes(T.model_spec(cfg), T._model_axes(cfg),
                 lambda path, shape, ax: out.append(
                     (path, T._full_shape(cfg, path, shape),
                      (None, *ax) if path[0] == "periods" else ax,
                      T._leaf_dtype(cfg, path[-1]).itemsize)))
    return out


def _grad(objective, leaves):
    torch.autograd.grad(objective, [p for p in leaves if p.requires_grad], allow_unused=True)


def _ctx(cfg, B, s_len, decode):
    pos = _meta((B, s_len), torch.int32)
    dtype = getattr(torch, cfg.dtype)
    sin, cos = layers.rope(pos, cfg.head_dim, cfg.rope_theta,
                           dtype=torch.promote_types(dtype, torch.float32))
    prefix = _meta((B,), torch.int32) if cfg.frontend == "vision" and not decode else None
    return T.SeqContext(positions=pos, sin=sin, cos=cos, decode=decode, prefix_len=prefix)


def _trace(fn, cfg):
    with CostCounter(prefix_len=cfg.num_prefix_tokens or None) as c:
        fn()
    return c


# ---------------------------------------------------------------------------
# Cost components.
# ---------------------------------------------------------------------------
def cost_components(cfg, shape):
    """``[(name, counter, multiplier, weights, tokens)]``: each component
    traced once at the cell's global shapes (``weights`` and ``tokens``
    feed the collective reckoning)."""
    cell = SHAPES[shape]
    cfgu = dataclasses.replace(cfg, unroll_scans=True, remat=False)
    B, S = cell.global_batch, cell.seq_len
    train, decode = cell.kind == "train", cell.kind == "decode"
    dtype = getattr(torch, cfg.dtype)
    comps = []

    for kind, count in Counter(cfg.layer_kinds()).items():
        if decode and kind == "slstm":
            continue  # as in the JAX package: no decode sLSTM component
        weights = _weights(cfgu, kind)
        if kind == "slstm":
            # Sequential cell: ONE timestep, scaled by S * count.
            bp = _block_params(cfgu, kind, train)
            st = {k: _meta((B, cfgu.d_model), torch.float32) for k in "cnhm"}
            xt = _meta((B, 1, cfgu.d_model), torch.float32)

            def slstm_one(bp=bp, st=st, xt=xt):
                _, st2 = xlstm._slstm_scan(bp["cell"], cfgu.d_model // cfgu.xlstm_heads, xt, st)
                obj = sum((v * v).sum() for v in st2.values())
                if train:
                    _grad(obj, tree_leaves(bp))

            comps.append(("slstm_step", _trace(slstm_one, cfgu), float(S * count), weights, B))
            continue
        s_len, mult = (1 if decode else S), float(count)
        if kind == "mlstm" and not decode:
            # Linear in the chunk count: a short sequence, scaled.
            s_len = min(S, cfgu.xlstm_chunk * 8)
            mult = float(count) * (S / s_len)

        bp = _block_params(cfgu, kind, train)
        ctx = _ctx(cfgu, B, s_len, decode)
        x = _meta((B, s_len, cfgu.d_model), dtype)
        cache = T._block_cache(cfgu, kind, B, S, dtype, META) if decode else None

        def block(kind=kind, bp=bp, ctx=ctx, x=x, cache=cache):
            out, _, aux = T.apply_block(cfgu, kind, bp, x, ctx, cache)
            obj = (out.float() ** 2).sum() + (0.0 if aux is None else aux)
            if train:
                _grad(obj, tree_leaves(bp))

        comps.append((f"block_{kind}", _trace(block, cfgu), mult, weights, B * s_len))

    # Ends: embedding + final norm + loss / logits with a 0-layer config.
    cfg0 = dataclasses.replace(cfgu, n_layers=0)
    specs = input_specs(cfg0, shape)

    p0 = _model_params(cfg0, train)

    def ends():
        if train:
            loss, _ = T.loss_fn(cfg0, p0, specs["inputs"])
            _grad(loss, tree_leaves(p0))
        elif cell.kind == "prefill":
            if cfg0.encoder_only:  # no cache: the hidden states and the last logits
                x, _, _ = T.forward_hidden(cfg0, p0, specs["inputs"])
                T._unembed(cfg0, p0, x[:, -1:])
            else:
                T.prefill(cfg0, p0, specs["inputs"], max_len=S)
        else:
            T.decode_step(cfg0, p0, specs["cache"], specs["token"], specs["pos"])

    ends_weights = [w for w in _model_weights(cfg0) if w[0][0] not in ("periods", "epilogue")]
    comps.append(("ends", _trace(ends, cfg0), 1.0, ends_weights, B * (1 if decode else S)))

    if train:
        params = _model_params(cfg)
        grads = tree_map(lambda p: _meta(p.shape, torch.float32), params)
        opt = init_opt_state(params)
        comps.append(("optimizer", _trace(lambda: adamw_update(OPT_CFG, params, grads, opt), cfg),
                      1.0, [], 0))
    return comps


# ---------------------------------------------------------------------------
# Memory.
# ---------------------------------------------------------------------------
def _shard_bytes(shape, itemsize, sharding) -> int:
    n = itemsize
    for s in sharding.shard_shape(shape):
        n *= s
    return n


def _tree_bytes(shapes_axes, mesh, rules) -> int:
    """``[(shape, axes, itemsize)]`` -> per-device bytes."""
    return sum(_shard_bytes(shape, item, named_sharding(mesh, rules, ax))
               for shape, ax, item in shapes_axes)


def _leaves_with_axes(tree, axes):
    """``[(shape, axes, itemsize)]`` of a tensor tree and its axes tree."""
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), axes, tree.element_size())]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves_with_axes(tree[k], axes[k])]
    return [x for t, a in zip(tree, axes) for x in _leaves_with_axes(t, a)]


def _act_per_token(cfg, kind, k) -> int:
    """Activation elements one block keeps per token: the residual and its
    norm (2 d) plus its kind's widest intermediates, each divided by the
    mesh axes its logical axis maps to (``k(axis)``)."""
    d, hd = cfg.d_model, cfg.head_dim
    if kind in ("attn", "local", "moe"):
        width = (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd // k("heads")
        if kind == "moe":
            width += 3 * cfg.top_k * cfg.expert_d_ff // k("expert_ffn")
        else:
            width += 3 * cfg.d_ff // k("ffn")
    elif kind == "recurrent":
        width = 4 * cfg.lru_width // k("lru") + 3 * cfg.d_ff // k("ffn")
    elif kind == "mlstm":
        width = 5 * int(d * cfg.xlstm_proj_factor) // k("lru")
    else:  # slstm
        width = 8 * d // k("lru")
    return 2 * d + width


def temp_bytes(cfg, shape, mesh, rules) -> int:
    """The step's temporaries per device, reckoned (not traced): with
    ``tok`` this device's tokens (the global tokens over the batch axes,
    rounded up), ``it`` the model dtype's bytes, ``act(kind)`` the
    elements :func:`_act_per_token` gives and ``V`` the vocabulary over its
    axes:

    * train: the f32 gradient of every parameter shard; one saved residual
      per period, ``n_periods * tok * d * it`` (remat); the largest
      block's activations, recomputed, ``max(act) * tok * it``; and one
      loss chunk's f32 logits and log-probabilities, ``2 * B_local *
      min(loss_chunk, S) * V * 4``;
    * prefill: the largest block's activations plus the last position's
      f32 logits, ``B_local * V * 4``;
    * decode: the largest block's activations at one token per row plus
      the f32 logits.
    """
    cell = SHAPES[shape]
    names, sizes = mesh_axes(mesh)
    size = dict(zip(names, sizes))

    def k(logical):
        entry = rules.table.get(logical)
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n = 1
        for ax in axes:
            n *= size[ax]
        return n

    B_local = -(-cell.global_batch // k("batch"))
    tok = B_local * (1 if cell.kind == "decode" else cell.seq_len)
    it = getattr(torch, cfg.dtype).itemsize
    # Logits shard on the vocabulary where the head does (an untied head of
    # at least 1024 entries; a tied head is the token table, unsharded there).
    V = -(-cfg.vocab_size // (k("vocab") if not cfg.tie_embeddings and cfg.vocab_size >= 1024
                              else 1))
    act = max(_act_per_token(cfg, kind, k) for kind in set(cfg.layer_kinds())) * tok * it
    logits = B_local * V * 4
    if cell.kind != "train":
        return act + logits
    grads = _tree_bytes([(shape_, ax, 4) for _, shape_, ax, _ in _model_weights(cfg)],
                        mesh, rules)
    residuals = cfg.n_periods * tok * cfg.d_model * it
    return grads + residuals + act + 2 * B_local * min(cfg.loss_chunk, cell.seq_len) * V * 4


def memory(cfg, shape, mesh, rules) -> dict:
    """Per-device bytes of the step's arguments, outputs (donated state or
    cache aliased), temporaries, and their total, as JAX's
    ``memory_analysis`` names them."""
    cell = SHAPES[shape]
    specs = input_specs(cfg, shape)
    params = [(shape_, ax, item) for _, shape_, ax, item in _model_weights(cfg)]
    p_bytes = _tree_bytes(params, mesh, rules)
    B = cell.global_batch
    batch_leaf = lambda t: (tuple(t.shape), ("batch",) + (None,) * (t.dim() - 1),  # noqa: E731
                            t.element_size())
    logits = _shard_bytes((B, cfg.vocab_size), 4, named_sharding(mesh, rules, ("batch", None)))
    if cell.kind == "decode":
        cache = _tree_bytes(_leaves_with_axes(specs["cache"], T.cache_axes(cfg)), mesh, rules)
        tok = _tree_bytes([batch_leaf(specs["token"]), batch_leaf(specs["pos"])], mesh, rules)
        arg, out, alias = p_bytes + cache + tok, cache + logits, cache
    else:
        inputs = _tree_bytes([batch_leaf(t) for t in specs["inputs"].values()], mesh, rules)
        if cell.kind == "train":  # the state is donated: aliased by the new one
            state = p_bytes + 2 * _tree_bytes([(s, ax, 4) for s, ax, _ in params], mesh, rules) + 4
            arg, out, alias = state + inputs, state + 6 * 4, state
        else:
            cache = 0 if cfg.encoder_only else _tree_bytes(_leaves_with_axes(
                T.init_cache(cfg, B, cell.seq_len, device=META), T.cache_axes(cfg)), mesh, rules)
            arg, out, alias = p_bytes + inputs, cache + logits, 0
    mem = {"argument_bytes": int(arg), "output_bytes": int(out),
           "temp_bytes": int(temp_bytes(cfg, shape, mesh, rules)), "alias_bytes": int(alias)}
    mem["per_device_total"] = (mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
                               - mem["alias_bytes"])
    return mem


# ---------------------------------------------------------------------------
# Driver.
# ---------------------------------------------------------------------------
def run_cell(arch, shape, mesh_kind, *, with_components=True, verbose=True,
             seq_parallel=False, decode_opt=False, mesh_shape=None, variant="",
             traces=None):
    """One row.  ``traces``: a dict the caller keeps across cells, so the
    two meshes of an (arch, shape) share one trace of its components."""
    cfg = _tune_cfg(get_config(arch), shape)
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "skipped",
                "note": reason, "variant": variant}
    mesh = (make_custom_mesh(*mesh_shape) if mesh_shape
            else make_production_mesh(multi_pod=mesh_kind == "multi_pod"))
    rules = make_rules(mesh, seq_parallel=seq_parallel, decode_opt=decode_opt)
    cell = SHAPES[shape]
    names, sizes = mesh_axes(mesh)
    data_size = 1
    for n, s in zip(names, sizes):
        if n != "model":
            data_size *= s
    if cell.kind == "decode" and cell.global_batch < data_size:
        # Small-batch decode: the batch cannot cover the data axes.
        table = dict(rules.table, batch=None, moe_groups=None)
        rules = AxisRules(mesh, table)
    chips = mesh.size()

    t0 = time.perf_counter()
    mem = memory(cfg, shape, mesh, rules)
    t_lower = time.perf_counter() - t0
    row = {"arch": arch, "shape": shape, "mesh": mesh_kind, "variant": variant,
           "chips": chips, "global_batch": cell.global_batch, "status": "ok",
           "lower_s": round(t_lower, 1), "compile_s": 0.0, "memory": mem,
           "collectives": "reckoned from the rules", "collective_census": {},
           "full_step_cost_analysis": {"flops": None, "bytes": None}}
    if with_components:
        traces = {} if traces is None else traces
        key = (arch, shape)
        t0 = time.perf_counter()
        if key not in traces:
            traces[key] = cost_components(cfg, shape)
        t_trace = time.perf_counter() - t0
        train = cell.kind == "train"
        tied_vocab = cfg.tie_embeddings and cfg.vocab_size >= VOCAB_SPLIT_MIN
        comps, census = [], Counter()
        for name, counter, mult, weights, tokens in traces[key]:
            coll, count = rf.reckon_collectives(
                weights, rules, mesh, tokens=tokens, itemsize=getattr(torch, cfg.dtype).itemsize,
                train=train and name != "optimizer", top_k=cfg.top_k or 1,
                decode=cell.kind == "decode", tied_vocab=name == "ends" and tied_vocab)
            for kind, n in count.items():
                census[kind] += n * mult
            comps.append(rf.Component(name, counter.flops / chips, counter.bytes / chips, coll,
                                      multiplier=mult))
        totals = rf.combine_components(comps)
        row["compile_s"] = round(t_trace, 1)
        row["collective_census"] = {k: int(round(v)) for k, v in census.items()}
        row["full_step_cost_analysis"] = {"flops": totals["flops"], "bytes": totals["bytes"]}
        if mesh_kind == "single_pod":
            terms = rf.cost_terms(totals, chips)
            mf = model_flops(cfg, shape)
            row.update({
                "terms_s": terms,
                "totals": {k: v for k, v in totals.items() if k != "coll_by_kind"},
                "coll_by_kind": totals["coll_by_kind"],
                "model_flops": mf,
                "model_flops_over_hlo": mf / max(totals["flops"] * chips, 1.0),
                "dominant": max(terms, key=lambda k: terms[k]),
                "components": [{"name": c.name, "flops": c.flops, "mult": c.multiplier}
                               for c in comps],
            })
    if verbose:
        print(f"[{mesh_kind}] {arch:24s} {shape:12s} trace={row['compile_s']:6.1f}s "
              f"mem/dev={mem['per_device_total'] / 2**30:6.2f}GiB "
              f"census={row['collective_census']} dom={row.get('dominant', '-')}", flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/roofline_torch.json")
    ap.add_argument("--no-components", action="store_true")
    ap.add_argument("--sp", action="store_true", help="sequence-parallel rules")
    ap.add_argument("--decode-opt", action="store_true", help="weight-stationary decode rules")
    ap.add_argument("--mesh-shape", default="", help="e.g. 64x4 (single pod)")
    ap.add_argument("--variant", default="", help="label recorded per row")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": ["single_pod"], "multi": ["multi_pod"],
              "both": ["single_pod", "multi_pod"]}[args.mesh]
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split("x")) if args.mesh_shape else None

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    cells = []
    if out_path.exists():
        data = json.loads(out_path.read_text())
        if data.get("hw") != rf.HW:
            raise SystemExit(f"{out_path} was not written by this dry-run on {rf.HW} "
                             f"(it records {data.get('hw')}); pass another --out")
        cells = data.get("cells", [])
    done = {(c["arch"], c["shape"], c["mesh"], c.get("variant", "")) for c in cells}
    traces = {}
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                if (arch, shape, mesh_kind, args.variant) in done:
                    continue
                try:
                    row = run_cell(arch, shape, mesh_kind,
                                   with_components=not args.no_components,
                                   seq_parallel=args.sp, decode_opt=args.decode_opt,
                                   mesh_shape=mesh_shape, variant=args.variant, traces=traces)
                except Exception as e:  # record failures: they are bugs
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "variant": args.variant, "status": "error",
                           "note": f"{type(e).__name__}: {e}"}
                cells.append(row)
                out_path.write_text(json.dumps({"hw": rf.HW, "cells": cells}, indent=1))
            traces.clear()

    ok = sum(1 for c in cells if c["status"] == "ok")
    skip = sum(1 for c in cells if c["status"] == "skipped")
    err = sum(1 for c in cells if c["status"] == "error")
    print(f"\n=== dry-run: {ok} ok / {skip} skipped / {err} errors -> {out_path}")
    return 1 if err else 0


if __name__ == "__main__":
    raise SystemExit(main())
