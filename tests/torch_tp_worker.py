"""The processes of ``test_torch_tensor_parallel.py``: four gloo ranks of
the port, or the JAX package on four forced host devices.

    python torch_tp_worker.py rank RANK WORLD STORE_FILE OUT_DIR
    python torch_tp_worker.py jax OUT_DIR

Both read ``OUT_DIR/cases.pkl``: ``{"cases": {name: (arch, overrides,
state, batch)}, "meshes": [(data, model), ...]}`` with the JAX package's
``init_train_state`` as numpy and a numpy batch.  For every case and mesh,
with ``make_rules`` and one AdamW step of :func:`opt_kwargs`:

* a port rank places the state on ``state_shardings``, takes the sharded
  gradients (``make_grads_fn(..., mesh=, rules=)``) and one sharded train
  step; rank 0 writes the gathered gradients, the metrics and the new
  parameters to ``OUT_DIR/torch_{case}_{data}x{model}.npz`` (keys
  ``grad/PATH``, ``metric/NAME``, ``param/PATH``);
* the JAX process (meshes with a ``model`` axis above 1 only) takes
  ``jax.value_and_grad`` of ``loss_fn`` under ``axis_rules`` with the
  state's shardings, and the JAX package's sharded ``make_train_step``,
  and writes the same keys to ``OUT_DIR/jax_{case}_{data}x{model}.npz``.
"""
import os
import pickle
import sys
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


def run_ranks(rank, world, store, out):
    import torch
    import torch.distributed as dist

    from repro_torch.configs.archs import reduced
    from repro_torch.distributed.tensor_parallel import gather
    from repro_torch.launch.mesh import make_mesh, make_rules
    from repro_torch.training import (
        OptimizerConfig, TrainConfig, make_grads_fn, make_train_step, place_state,
        state_shardings, train_state_from_numpy,
    )
    from repro_torch.tree import named_leaves

    torch.set_num_threads(1)  # four ranks share the host's cores
    spec = pickle.loads((Path(out) / "cases.pkl").read_bytes())
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu")
                  for shape in spec["meshes"]}
        for name, (arch, over, state_np, batch_np) in spec["cases"].items():
            cfg = reduced(arch, **over)
            batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
            for shape, mesh in meshes.items():
                rules = make_rules(mesh)
                shardings = state_shardings(cfg, mesh, rules)
                state = place_state(train_state_from_numpy(cfg, state_np, device="cpu"), shardings)
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

    for name, (arch, over, state_np, batch_np) in spec["cases"].items():
        cfg = reduced(arch, **over)
        for shape in spec["meshes"]:
            if shape[1] == 1:
                continue
            mesh = make_mesh(shape, ("data", "model"))
            rules = make_rules(mesh)
            st_sh = state_shardings(cfg, mesh, rules)
            b_sh = named_sharding(mesh, rules, ("batch",))
            state = jax.device_put(jax.tree.map(jnp.asarray, state_np), st_sh)
            batch = jax.device_put({k: jnp.asarray(v) for k, v in batch_np.items()}, b_sh)

            def loss_grads(params, batch, cfg=cfg, rules=rules):
                with axis_rules(rules):
                    return jax.value_and_grad(lambda p: JT.loss_fn(cfg, p, batch),
                                              has_aux=True)(params)

            (_, _), grads = jax.jit(loss_grads, in_shardings=(st_sh["params"], b_sh))(
                state["params"], batch)
            grads = flat(grads)
            step = make_train_step(cfg, OptimizerConfig(**opt_kwargs()), mesh=mesh, rules=rules)
            new_state, metrics = step(state, batch)
            _save(Path(out) / f"jax_{name}_{shape[0]}x{shape[1]}.npz", grads,
                  {k: np.asarray(v) for k, v in metrics.items()}, flat(new_state["params"]))


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        run_ranks(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        run_jax(sys.argv[2])
