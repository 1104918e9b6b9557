"""The processes of ``test_torch_tensor_parallel.py``,
``test_torch_tp_serve.py`` and ``test_torch_tp_xlstm_sp.py``: four gloo
ranks of the port, or the JAX package on four forced host devices.

    python torch_tp_worker.py rank RANK WORLD STORE_FILE OUT_DIR
    python torch_tp_worker.py jax OUT_DIR
    python torch_tp_worker.py serve-rank RANK WORLD STORE_FILE OUT_DIR
    python torch_tp_worker.py serve-jax OUT_DIR
    python torch_tp_worker.py xsp-rank RANK WORLD STORE_FILE OUT_DIR
    python torch_tp_worker.py xsp-jax OUT_DIR

Training (``rank`` / ``jax``):

Both read ``OUT_DIR/cases.pkl``: ``{"cases": {name: (arch, overrides,
state, batch)}, "meshes": [(data, model), ...], "case_meshes": {name:
[meshes]}, "f64": [names]}`` with the JAX package's ``init_train_state`` as
numpy and a numpy batch; a case named in ``case_meshes`` runs on those
meshes instead of ``meshes``, one named in ``f64`` in float64 on both sides
(every floating leaf of the state widened; the JAX modules' ``jnp`` seen
through ``jax_f64.Jnp64`` under ``jax.enable_x64``, :func:`jax_float64`).
For every case and mesh, with ``make_rules`` and one AdamW step of
:func:`opt_kwargs`:

* a port rank places the state on ``state_shardings``, takes the sharded
  gradients (``make_grads_fn(..., mesh=, rules=)``) and one sharded train
  step; rank 0 writes the gathered gradients, the metrics and the new
  parameters to ``OUT_DIR/torch_{case}_{data}x{model}.npz`` (keys
  ``grad/PATH``, ``metric/NAME``, ``param/PATH``);
* the JAX process (meshes with a ``model`` axis above 1 only) takes
  ``jax.value_and_grad`` of ``loss_fn`` under ``axis_rules`` with the
  state's shardings, and the JAX package's sharded ``make_train_step``,
  and writes the same keys to ``OUT_DIR/jax_{case}_{data}x{model}.npz``.

Serving (``serve-rank`` / ``serve-jax``) reads ``OUT_DIR/serve.pkl``:
``{"cases": {name: (arch, overrides, params, prompt, max_len, steps)},
"runs": [(name, (data, model), table), ...]}`` with the JAX package's
``init_params`` as numpy and a numpy prompt; ``table`` names a rule table
(``RULES_2D`` or ``RULES_2D_DEC``).  For every run, greedy decoding of
``steps`` tokens after the prefill (:func:`serve_port`):

* a port rank serves under ``axis_rules(AxisRules(mesh, table))`` with the
  parameters placed on their shardings (DTensors; under ``RULES_2D_DEC``
  whole tensors, each rank reading its slices) and serves unsharded too;
  it writes ``OUT_DIR/serve_torch_{run}_r{rank}.npz``: ``local/PATH`` its
  cache slice and ``want/PATH`` the unsharded cache cut by
  ``shard_tree``; rank 0 adds ``logits``, ``tokens``, ``whole/PATH`` (the
  cache put together by ``gather_tree``) and ``plain_logits``,
  ``plain_tokens``, ``plain/PATH`` of the unsharded run;
* the JAX process jits ``T.prefill`` and ``T.decode_step`` under the rules
  with ``in_shardings`` from ``param_axes`` / ``cache_axes``, as the
  dry-run's ``build_cell`` does, and writes ``logits`` and ``tokens`` to
  ``OUT_DIR/serve_jax_{run}.npz``.

``{run}`` is ``{name}_{data}x{model}_{table}``.

The xLSTM split and sequence parallelism (``xsp-rank`` / ``xsp-jax``) read
``OUT_DIR/xsp.pkl``: ``{"train": {name: (arch, overrides, state, batch)},
"serve": {name: (arch, overrides, params, prompt, max_len, steps)},
"runs": [(kind, name, (data, model), table), ...], "jax_runs": [the runs
the JAX process takes too], "f64": [names]}``; ``kind`` is ``train`` or
``serve``, ``table`` a rule table of ``distributed/api.py``.  A case named
in ``f64`` runs in float64 on both sides (every parameter widened; the
JAX modules' ``jnp`` seen through ``jax_f64.Jnp64`` under
``jax.enable_x64``).  A mesh of fewer ranks than the world runs as
``WORLD / (data * model)`` replicas of it (a ("rep", "data", "model")
mesh, each rank on its replica's submesh); JAX places it on the first
devices.  Per run:

* a port rank of a ``train`` run takes the sharded gradients
  (``make_grads_fn(..., mesh=, rules=)``) and the unsharded ones, and
  records the shape of every block's input (the residual stream between
  blocks); rank 0 writes ``grad/PATH``, ``metric/NAME``, ``plain/PATH``,
  ``plain_metric/NAME`` and ``residual`` (the distinct shapes) to
  ``OUT_DIR/xsp_torch_train_{run}_r0.npz``; a ``serve`` run writes what
  ``serve-rank`` writes, to ``OUT_DIR/xsp_torch_serve_{run}_r{rank}.npz``;
* the JAX process writes ``grad/PATH`` and ``metric/NAME`` (``train``) or
  ``logits`` and ``tokens`` (``serve``) to
  ``OUT_DIR/xsp_jax_{kind}_{run}.npz``.
"""
import contextlib
import dataclasses
import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np

LR = 1e-3


def opt_kwargs():
    """One AdamW step at the full rate (the first step's warmup is 1)."""
    return dict(learning_rate=LR, warmup_steps=1, total_steps=10)


def _save(path, grads, metrics, params):
    np.savez(path, **{f"grad/{k}": v for k, v in grads.items()},
             **{f"metric/{k}": v for k, v in metrics.items()},
             **{f"param/{k}": v for k, v in params.items()})


def case_meshes(spec, name):
    """The meshes a training case of ``cases.pkl`` runs on."""
    return spec.get("case_meshes", {}).get(name, spec["meshes"])


def port_case(spec, name):
    """``(cfg, state, batch)`` of a training case of ``cases.pkl`` for the
    port, on the CPU: in float64 where ``f64`` names it."""
    import torch

    from repro_torch.configs.archs import reduced
    from repro_torch.training import train_state_from_numpy

    arch, over, state_np, batch_np = spec["cases"][name]
    cfg = reduced(arch, **over)
    state = train_state_from_numpy(cfg, state_np, device="cpu")
    if name in spec.get("f64", ()):
        cfg, state = dataclasses.replace(cfg, dtype="float64"), _f64_tree(state)
    return cfg, state, {k: torch.from_numpy(v) for k, v in batch_np.items()}


@contextlib.contextmanager
def jax_float64(on):
    """Within the block (when ``on``), the JAX package in float64: every
    loaded ``repro`` module's ``jnp`` replaced by ``jax_f64.Jnp64`` (its
    explicit f32 casts then keep float64) under ``jax.enable_x64``."""
    if not on:
        yield
        return
    import jax
    import jax.numpy as jnp

    from jax_f64 import Jnp64

    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("repro.") and getattr(m, "jnp", None) is jnp]
    for m in mods:
        m.jnp = Jnp64()
    try:
        with jax.enable_x64(True):
            yield
    finally:
        for m in mods:
            m.jnp = jnp


def run_ranks(rank, world, store, out):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.tensor_parallel import gather
    from repro_torch.launch.mesh import make_mesh, make_rules
    from repro_torch.training import (
        OptimizerConfig, TrainConfig, make_grads_fn, make_train_step, place_state,
        state_shardings,
    )
    from repro_torch.tree import named_leaves

    torch.set_num_threads(1)  # four ranks share the host's cores
    spec = pickle.loads((Path(out) / "cases.pkl").read_bytes())
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu")
                  for shape in spec["meshes"]}
        for name in spec["cases"]:
            for shape in case_meshes(spec, name):
                t0 = time.perf_counter()
                cfg, state, batch = port_case(spec, name)
                mesh = meshes[shape]
                rules = make_rules(mesh)
                shardings = state_shardings(cfg, mesh, rules)
                state = place_state(state, shardings)
                _, _, grads = make_grads_fn(cfg, TrainConfig(), mesh=mesh, rules=rules)(
                    state["params"], batch)
                grads = {k: gather(g).numpy() for k, g in named_leaves(grads)}
                step = make_train_step(cfg, OptimizerConfig(**opt_kwargs()), TrainConfig(),
                                       mesh=mesh, rules=rules)
                state, metrics = step(state, batch)
                params = {k: gather(p).detach().numpy() for k, p in named_leaves(state["params"])}
                if rank == 0:
                    _save(Path(out) / f"torch_{name}_{shape[0]}x{shape[1]}.npz", grads,
                          {k: v.numpy() for k, v in metrics.items()}, params)
                print(f"{name} {shape}: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()


def run_jax(out):
    # Four host devices, one thread each: the test shares the host's cores.
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    from repro.configs.archs import reduced
    from repro.distributed.api import axis_rules, named_sharding
    from repro.launch.mesh import make_mesh, make_rules
    from repro.models import transformer as JT
    from repro.training import OptimizerConfig
    from repro.training.train_loop import make_train_step, state_shardings

    spec = pickle.loads((Path(out) / "cases.pkl").read_bytes())

    def flat(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def wide(a):  # float64 for every floating leaf
        return np.asarray(a, np.float64) if np.issubdtype(np.asarray(a).dtype, np.floating) else a

    for name, (arch, over, state_np, batch_np) in spec["cases"].items():
        f64 = name in spec.get("f64", ())
        cfg = reduced(arch, **over)
        if f64:
            cfg, state_np = dataclasses.replace(cfg, dtype="float64"), jax.tree.map(wide, state_np)
        for shape in case_meshes(spec, name):
            if shape[1] == 1:
                continue
            t0 = time.perf_counter()
            mesh = make_mesh(shape, ("data", "model"))
            rules = make_rules(mesh)
            st_sh = state_shardings(cfg, mesh, rules)
            b_sh = named_sharding(mesh, rules, ("batch",))
            with jax_float64(f64):
                state = jax.device_put(jax.tree.map(jnp.asarray, state_np), st_sh)
                batch = jax.device_put({k: jnp.asarray(v) for k, v in batch_np.items()}, b_sh)

                def loss_grads(params, batch, cfg=cfg, rules=rules):
                    with axis_rules(rules):
                        return jax.value_and_grad(lambda p: JT.loss_fn(cfg, p, batch),
                                                  has_aux=True)(params)

                (_, _), grads = jax.jit(loss_grads, in_shardings=(st_sh["params"], b_sh))(
                    state["params"], batch)
                grads = flat(grads)
                step = make_train_step(cfg, OptimizerConfig(**opt_kwargs()), mesh=mesh,
                                       rules=rules)
                new_state, metrics = step(state, batch)
                _save(Path(out) / f"jax_{name}_{shape[0]}x{shape[1]}.npz", grads,
                      {k: np.asarray(v) for k, v in metrics.items()}, flat(new_state["params"]))
            print(f"{name} {shape}: {time.perf_counter() - t0:.1f} s", flush=True)


def emulated_split(cfg, block, leaves, axes, x, size, cot, prefix=()):
    """One block's tensor split emulated in this process, over a one-rank
    gloo group whose collectives are the identity: the partial outputs
    ``block(p, x, tp)`` of ``size`` ranks, each from the leaves as
    ``local_params`` reads them (whole where ``reads_whole`` says, at path
    ``prefix + (name,)``; else its slice of the ``RULES_2D`` tensor-axis
    dims), summed as ``leave`` sums them, and the vjp of the sum with
    ``cot``, whose gradients sum over the ranks as ``share`` and ``enter``
    sum them.  Returns (output, {"x" or leaf name: gradient})."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import api
    from repro_torch.distributed import tensor_parallel as tpm

    on_axis = tpm._tensor_logical(api.RULES_2D)
    whole = tpm.reads_whole(cfg, size)
    xin = x.detach().clone().requires_grad_(True)
    held = {k: t.detach().clone().requires_grad_(True) for k, t in leaves.items()}
    total = 0
    for r in range(size):
        p = {}
        for k, t in held.items():
            if not whole((*prefix, k), axes[k]):
                for d, ax in enumerate(axes[k]):
                    if ax in on_axis:
                        per = t.shape[d] // size
                        t = t.narrow(d, r * per, per)
            p[k] = t
        total = total + block(p, xin, tpm.TensorParallel(dist.group.WORLD, r, size))
    grads = torch.autograd.grad(total, [xin, *held.values()], cot)
    return total.detach(), dict(zip(["x", *held], grads))


def emulated_block_error(cfg, kind, size, seed=0, B=2, S=16):
    """The largest error, over a leaf's (or the output's) largest entry, of
    one block of ``kind`` split over ``size`` ranks (:func:`emulated_split`)
    against the unsharded block, in float64: its output and the vjp's
    gradients of the input and of every leaf.  ``kind`` is an attention
    kind (the block's ``attn``) or an xLSTM cell (its ``cell``)."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    c = dataclasses.replace(cfg, dtype="float64")
    key = "cell" if kind in ("mlstm", "slstm") else "attn"
    period = T.init_params(c, torch.Generator().manual_seed(seed), "cpu")["periods"]
    leaves = T._unstack(period[list(cfg.pattern).index(kind)], cfg.n_periods)[0][key]
    axes = T.block_axes(cfg, kind)[key]
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((B, S, cfg.d_model), generator=gen, dtype=torch.float64)
    cot = torch.randn((B, S, cfg.d_model), generator=gen, dtype=torch.float64)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    sin, cos = layers.rope(pos, cfg.head_dim, cfg.rope_theta, dtype=torch.float64)

    def block(p, x, tp):
        ctx = T.SeqContext(positions=pos, sin=sin, cos=cos, tp=tp)
        if key == "cell":
            return T._xlstm_cell(c, kind, p, x, ctx, None)
        return T._attention(c, p, x, ctx, kind, None)

    got, grads = emulated_split(c, block, leaves, axes, x, size, cot, prefix=(key,))
    xin = x.clone().requires_grad_(True)
    held = {k: t.detach().clone().requires_grad_(True) for k, t in leaves.items()}
    want = block(held, xin, None)
    plain = dict(zip(["x", *held], torch.autograd.grad(want, [xin, *held.values()], cot)))
    want = want.detach()

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)

    return max([rel(got, want)] + [rel(grads[k], plain[k]) for k in plain])


def run_tag(name, shape, table):
    return f"{name}_{shape[0]}x{shape[1]}_{table}"


def serve_port(T, cfg, params, prompt, max_len, steps):
    """Greedy decoding after the prefill: ``(logits (steps + 1, B, V),
    tokens (steps, B), cache)``."""
    import torch

    cache, logits = T.prefill(cfg, params, {"tokens": prompt}, max_len)
    out, toks = [logits], []
    pos = torch.full((prompt.shape[0],), prompt.shape[1], dtype=torch.int32)
    for i in range(steps):
        toks.append(logits.argmax(-1).to(torch.int32))
        logits, cache = T.decode_step(cfg, params, cache, toks[-1], pos + i)
        out.append(logits)
    return torch.stack(out), torch.stack(toks), cache


def run_serve_ranks(rank, world, store, out):
    import torch
    import torch.distributed as dist

    from repro_torch.configs.archs import reduced
    from repro_torch.distributed import api
    from repro_torch.distributed.tensor_parallel import gather_tree, shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training import place_state
    from repro_torch.tree import named_leaves, tree_map

    torch.set_num_threads(1)  # four ranks share the host's cores
    spec = pickle.loads((Path(out) / "serve.pkl").read_bytes())
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        meshes = {}
        with torch.no_grad():
            for name, shape, table in spec["runs"]:
                arch, over, params_np, prompt_np, max_len, steps = spec["cases"][name]
                cfg = reduced(arch, **over)
                params = T.params_from_numpy(cfg, params_np, device="cpu")
                prompt = torch.from_numpy(prompt_np)
                plain = serve_port(T, cfg, params, prompt, max_len, steps)
                if shape not in meshes:
                    meshes[shape] = make_mesh(shape, ("data", "model"), device="cpu")
                mesh = meshes[shape]
                rules = api.AxisRules(mesh, getattr(api, table))
                if table == "RULES_2D":  # placed on their shardings, as build_cell's
                    params = place_state(params, tree_map(
                        lambda p, ax, mesh=mesh, rules=rules: api.named_sharding(mesh, rules, ax),
                        params, T.param_axes(cfg)))
                axes = T.cache_axes(cfg)
                with api.axis_rules(rules):
                    logits, toks, cache = serve_port(T, cfg, params, prompt, max_len, steps)
                    want = shard_tree(plain[2], axes)
                    whole = gather_tree(cache, axes)
                res = {**{f"local/{k}": v.numpy() for k, v in named_leaves(cache)},
                       **{f"want/{k}": v.numpy() for k, v in named_leaves(want)}}
                if rank == 0:
                    res.update({f"whole/{k}": v.numpy() for k, v in named_leaves(whole)})
                    res.update({f"plain/{k}": v.numpy() for k, v in named_leaves(plain[2])})
                    res.update(logits=logits.numpy(), tokens=toks.numpy(),
                               plain_logits=plain[0].numpy(), plain_tokens=plain[1].numpy())
                np.savez(Path(out) / f"serve_torch_{run_tag(name, shape, table)}_r{rank}.npz",
                         **res)
    finally:
        dist.destroy_process_group()


def run_serve_jax(out):
    # Four host devices, one thread each: the test shares the host's cores.
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    from repro.configs.archs import reduced
    from repro.distributed import api
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as JT

    spec = pickle.loads((Path(out) / "serve.pkl").read_bytes())

    def is_axes(x):
        return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)

    for name, shape, table in spec["runs"]:
        arch, over, params_np, prompt_np, max_len, steps = spec["cases"][name]
        cfg = reduced(arch, **over)
        mesh = make_mesh(shape, ("data", "model"))
        rules = api.AxisRules(mesh, getattr(api, table))

        def sharding(axes, mesh=mesh, rules=rules):
            return jax.tree.map(lambda ax: api.named_sharding(mesh, rules, ax), axes,
                                is_leaf=is_axes)

        def prefill_fn(params, inputs, cfg=cfg, rules=rules, max_len=max_len):
            with api.axis_rules(rules):
                return JT.prefill(cfg, params, inputs, max_len=max_len)

        def decode_fn(params, cache, token, pos, cfg=cfg, rules=rules):
            with api.axis_rules(rules):
                return JT.decode_step(cfg, params, cache, token, pos)

        p_sh, c_sh = sharding(JT.param_axes(cfg)), sharding(JT.cache_axes(cfg))
        b_sh = api.named_sharding(mesh, rules, ("batch",))
        prefill = jax.jit(prefill_fn, in_shardings=(p_sh, b_sh))
        decode = jax.jit(decode_fn, in_shardings=(p_sh, c_sh, b_sh, b_sh))
        params = jax.device_put(jax.tree.map(jnp.asarray, params_np), p_sh)
        cache, logits = prefill(params, {"tokens": jnp.asarray(prompt_np)})
        outs, toks = [np.asarray(logits)], []
        B, S = prompt_np.shape
        for i in range(steps):
            toks.append(np.asarray(logits).argmax(-1).astype(np.int32))
            logits, cache = decode(params, jax.device_put(cache, c_sh), jnp.asarray(toks[-1]),
                                   jnp.full((B,), S + i, jnp.int32))
            outs.append(np.asarray(logits))
        np.savez(Path(out) / f"serve_jax_{run_tag(name, shape, table)}.npz",
                 logits=np.stack(outs), tokens=np.stack(toks))


def _f64_tree(tree):
    """Every floating leaf of a parameter / state tree widened to float64."""
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().double().requires_grad_(t.requires_grad)
                    if t.is_floating_point() else t, tree)


def _xsp_mesh(shape, world, cache):
    """The port's ("data", "model") mesh of ``shape``: over the world, or
    over this rank's replica of a ("rep", "data", "model") mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_mesh

    if shape not in cache:
        n = shape[0] * shape[1]
        cache[shape] = (make_mesh(shape, ("data", "model"), device="cpu") if n == world else
                        init_device_mesh("cpu", (world // n, *shape),
                                         mesh_dim_names=("rep", "data", "model"))
                        ["data", "model"])
    return cache[shape]


def run_xsp_ranks(rank, world, store, out):
    import torch
    import torch.distributed as dist

    from repro_torch.configs.archs import reduced
    from repro_torch.distributed import api
    from repro_torch.distributed.tensor_parallel import gather, gather_tree, shard_tree
    from repro_torch.models import transformer as T
    from repro_torch.training import (
        TrainConfig, make_grads_fn, place_state, state_shardings, train_state_from_numpy,
    )
    from repro_torch.tree import named_leaves, tree_map

    torch.set_num_threads(1)  # four ranks share the host's cores
    spec = pickle.loads((Path(out) / "xsp.pkl").read_bytes())
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    meshes, shapes = {}, []
    apply_block = T.apply_block

    def recording(cfg, kind, p, x, ctx, cache):  # the residual stream a block reads
        shapes.append(tuple(x.shape))
        return apply_block(cfg, kind, p, x, ctx, cache)

    def train_state(name):
        arch, over, state_np, batch_np = spec["train"][name]
        cfg = reduced(arch, **over)
        state = train_state_from_numpy(cfg, state_np, device="cpu")
        if name in spec["f64"]:
            cfg, state = dataclasses.replace(cfg, dtype="float64"), _f64_tree(state)
        return cfg, state, {k: torch.from_numpy(v) for k, v in batch_np.items()}

    try:
        for kind, name, shape, table in spec["runs"]:
            t0 = time.perf_counter()
            mesh = _xsp_mesh(shape, world, meshes)
            rules = api.AxisRules(mesh, getattr(api, table))
            tag = run_tag(name, shape, table)
            if kind == "train":
                cfg, state, batch = train_state(name)
                placed = place_state(state, state_shardings(cfg, mesh, rules))
                shapes.clear()
                T.apply_block = recording
                try:
                    loss, metrics, grads = make_grads_fn(cfg, TrainConfig(), mesh=mesh,
                                                         rules=rules)(placed["params"], batch)
                finally:
                    T.apply_block = apply_block
                grads = {k: gather(g).numpy() for k, g in named_leaves(grads)}
                ploss, pmetrics, pgrads = make_grads_fn(cfg)(state["params"], batch)
                if rank == 0:
                    np.savez(Path(out) / f"xsp_torch_train_{tag}_r0.npz",
                             residual=np.array(sorted(set(shapes))),
                             **{f"grad/{k}": v for k, v in grads.items()},
                             **{f"metric/{k}": v.numpy() for k, v in
                                {"loss": loss, **metrics}.items()},
                             **{f"plain/{k}": v.numpy() for k, v in named_leaves(pgrads)},
                             **{f"plain_metric/{k}": v.detach().numpy() for k, v in
                                {"loss": ploss, **pmetrics}.items()})
                print(f"{kind} {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
                continue
            arch, over, params_np, prompt_np, max_len, steps = spec["serve"][name]
            cfg = reduced(arch, **over)
            params = T.params_from_numpy(cfg, params_np, device="cpu")
            if name in spec["f64"]:
                cfg, params = dataclasses.replace(cfg, dtype="float64"), _f64_tree(params)
            prompt = torch.from_numpy(prompt_np)
            with torch.no_grad():
                plain = serve_port(T, cfg, params, prompt, max_len, steps)
                if not table.endswith("_DEC"):  # placed on their shardings, as build_cell's
                    params = place_state(params, tree_map(
                        lambda p, ax, mesh=mesh, rules=rules: api.named_sharding(mesh, rules, ax),
                        params, T.param_axes(cfg)))
                axes = T.cache_axes(cfg)
                with api.axis_rules(rules):
                    logits, toks, cache = serve_port(T, cfg, params, prompt, max_len, steps)
                    want = shard_tree(plain[2], axes)
                    whole = gather_tree(cache, axes)
            res = {**{f"local/{k}": v.numpy() for k, v in named_leaves(cache)},
                   **{f"want/{k}": v.numpy() for k, v in named_leaves(want)}}
            if rank == 0:
                res.update({f"whole/{k}": v.numpy() for k, v in named_leaves(whole)})
                res.update({f"plain/{k}": v.numpy() for k, v in named_leaves(plain[2])})
                res.update(logits=logits.numpy(), tokens=toks.numpy(),
                           plain_logits=plain[0].numpy(), plain_tokens=plain[1].numpy())
            np.savez(Path(out) / f"xsp_torch_serve_{tag}_r{rank}.npz", **res)
            print(f"{kind} {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()


def run_xsp_jax(out):
    # Four host devices, one thread each: the test shares the host's cores.
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    from repro.configs.archs import reduced
    from repro.distributed import api
    from repro.models import transformer as JT

    spec = pickle.loads((Path(out) / "xsp.pkl").read_bytes())

    def is_axes(x):
        return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)

    def flat(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    for kind, name, shape, table in spec["jax_runs"]:
        t0 = time.perf_counter()
        f64 = name in spec["f64"]
        arch, over, tree_np = spec[kind][name][:3]
        cfg = reduced(arch, **over)
        n = shape[0] * shape[1]
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
        rules = api.AxisRules(mesh, getattr(api, table))

        def sharding(axes, mesh=mesh, rules=rules):
            return jax.tree.map(lambda ax: api.named_sharding(mesh, rules, ax), axes,
                                is_leaf=is_axes)

        p_sh = sharding(JT.param_axes(cfg))
        b_sh = api.named_sharding(mesh, rules, ("batch",))
        with jax_float64(f64):
            if f64:
                cfg = dataclasses.replace(cfg, dtype="float64")
            wide = (lambda a: np.asarray(a, np.float64)) if f64 else jnp.asarray
            if kind == "train":
                params = jax.device_put(jax.tree.map(wide, tree_np["params"]), p_sh)
                batch_np = spec["train"][name][3]
                batch = jax.device_put({k: jnp.asarray(v) for k, v in batch_np.items()}, b_sh)

                def loss_grads(params, batch, cfg=cfg, rules=rules):
                    with api.axis_rules(rules):
                        return jax.value_and_grad(lambda p: JT.loss_fn(cfg, p, batch),
                                                  has_aux=True)(params)

                (loss, metrics), grads = jax.jit(loss_grads, in_shardings=(p_sh, b_sh))(
                    params, batch)
                np.savez(Path(out) / f"xsp_jax_train_{run_tag(name, shape, table)}.npz",
                         **{f"grad/{k}": v for k, v in flat(grads).items()},
                         **{f"metric/{k}": np.asarray(v) for k, v in
                            {"loss": loss, **metrics}.items()})
                print(f"{kind} {run_tag(name, shape, table)}: {time.perf_counter() - t0:.1f} s",
                      flush=True)
                continue
            _, _, _, prompt_np, max_len, steps = spec["serve"][name]
            c_sh = sharding(JT.cache_axes(cfg))

            def prefill_fn(params, inputs, cfg=cfg, rules=rules, max_len=max_len):
                with api.axis_rules(rules):
                    return JT.prefill(cfg, params, inputs, max_len=max_len)

            def decode_fn(params, cache, token, pos, cfg=cfg, rules=rules):
                with api.axis_rules(rules):
                    return JT.decode_step(cfg, params, cache, token, pos)

            prefill = jax.jit(prefill_fn, in_shardings=(p_sh, b_sh))
            decode = jax.jit(decode_fn, in_shardings=(p_sh, c_sh, b_sh, b_sh))
            params = jax.device_put(jax.tree.map(wide, tree_np), p_sh)
            cache, logits = prefill(params, {"tokens": jnp.asarray(prompt_np)})
            outs, toks = [np.asarray(logits)], []
            B, S = prompt_np.shape
            for i in range(steps):
                toks.append(np.asarray(logits).argmax(-1).astype(np.int32))
                logits, cache = decode(params, jax.device_put(cache, c_sh),
                                       jnp.asarray(toks[-1]), jnp.full((B,), S + i, jnp.int32))
                outs.append(np.asarray(logits))
            np.savez(Path(out) / f"xsp_jax_serve_{run_tag(name, shape, table)}.npz",
                     logits=np.stack(outs), tokens=np.stack(toks))
            print(f"{kind} {run_tag(name, shape, table)}: {time.perf_counter() - t0:.1f} s",
                  flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif sys.argv[1] == "serve-rank":
        run_serve_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif sys.argv[1] == "serve-jax":
        run_serve_jax(sys.argv[2])
    elif sys.argv[1] == "xsp-rank":
        run_xsp_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif sys.argv[1] == "xsp-jax":
        run_xsp_jax(sys.argv[2])
    else:
        run_jax(sys.argv[2])
