"""One rank of the two-rank CPU checks in ``test_torch_sharding.py`` (gloo
over a ``FileStore``, no TCP port).

    python torch_dist_worker.py RANK WORLD STORE_FILE OUT_DIR

Each rank, on a (WORLD, 1) ("data", "model") mesh with ``make_rules``:

* one sharded train step of reduced gemma-2b (f32, the clip binding), plain,
  with ``grad_compression``, and with both and two microbatches; rank 0
  writes the gathered parameters and the metrics to
  ``OUT_DIR/step_{plain,compressed,microbatched}.npz``;
* ``CheckpointManager(OUT_DIR/ckpt).restore(..., shardings=...)`` of the
  state the test saved there; each rank writes its local shards to
  ``OUT_DIR/restore_RANK.npz``;
* ``compressed_psum`` of ``OUT_DIR/psum_in.npy``'s row RANK; each rank
  writes its result to ``OUT_DIR/psum_RANK.npy``.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.archs import reduced
from repro_torch.distributed.compression import compressed_psum
from repro_torch.launch.mesh import make_mesh, make_rules
from repro_torch.training import (
    OptimizerConfig, TrainConfig, init_train_state, make_train_step, place_state,
    state_shardings,
)
from repro_torch.tree import named_leaves

# The clip binds: step 0's gradient norm is ~10 against a clip of 0.5.
OPT = OptimizerConfig(learning_rate=1e-2, clip_norm=0.5, warmup_steps=1)
TRAIN_CFGS = {"plain": TrainConfig(), "compressed": TrainConfig(grad_compression=True),
              "microbatched": TrainConfig(microbatches=2, grad_compression=True)}


def model():
    """Reduced gemma-2b: 2 layers, d 64, f32."""
    return dataclasses.replace(reduced("gemma-2b", d_model=64, n_layers=2), dtype="float32")


def batch():
    """4 rows of 16 tokens; some labels -1 (ignored), unevenly per row."""
    cfg = model()
    g = torch.Generator().manual_seed(3)
    return {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=g),
            "labels": torch.randint(-1, cfg.vocab_size, (4, 16), generator=g)}


def main(rank, world, store, out):
    out = Path(out)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
        rules = make_rules(mesh)
        cfg, opt_cfg, batch_ = model(), OPT, batch()
        for name, tc in TRAIN_CFGS.items():
            state = init_train_state(cfg, torch.Generator().manual_seed(0), tc, device="cpu")
            state = place_state(state, state_shardings(cfg, mesh, rules, tc))
            step = make_train_step(cfg, opt_cfg, tc, mesh=mesh, rules=rules)
            state, metrics = step(state, batch_)
            full = {k: v.full_tensor().detach().numpy() for k, v in named_leaves(state["params"])}
            if rank == 0:
                np.savez(out / f"step_{name}.npz", **full,
                         **{f"metric_{k}": v.numpy() for k, v in metrics.items()})

        template = init_train_state(cfg, torch.Generator().manual_seed(1), device="cpu")
        restored, _ = CheckpointManager(out / "ckpt").restore(
            template, shardings=state_shardings(cfg, mesh, rules))
        local = {}
        want = dict(named_leaves(template))
        for k, v in named_leaves(restored):
            assert v.requires_grad == want[k].requires_grad and v.dtype == want[k].dtype, k
            t = v.to_local().detach()
            local[k] = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
            local[f"placements/{k}"] = np.array(str(v.placements))
        np.savez(out / f"restore_{rank}.npz", **local)

        x = torch.from_numpy(np.load(out / "psum_in.npy")[rank])
        np.save(out / f"psum_{rank}.npy", compressed_psum(x).numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
