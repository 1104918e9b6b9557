"""End-to-end training entry point with fault tolerance, on one GPU.

The JAX package's ``launch/train.py`` in PyTorch, with the same flags and
output lines, plus ``--device`` (``cuda`` by default; the CPU only when
asked for):

  * resume-from-checkpoint (atomic saves, async writer),
  * deterministic data resumption (counter-based pipeline keyed by step),
  * failure injection (``--inject-failure N`` exits with code 42 after step
    N; a relaunch continues bit-identically),
  * optional int8 gradient compression with error feedback.

Reduced configs by default; ``--full-config`` trains the architecture as
published (full-width gemma-2b, recurrentgemma-2b and phi3-mini-3.8b fit
one 80 GB card with AdamW at batch 2 x 2048; xlstm-350m fits too, but its
gradient overflows to NaN there, so it trains at 8 x 128) and ignores
``--layers``, as the JAX driver does.  A step whose loss or gradient norm
is not finite ends the run with exit code 1, before the update is
checkpointed.  On the card, a config whose
weights, gradients and f32 moments alone exceed its memory is refused with
that reckoning before anything is allocated (llama4-scout), and one that
runs out of memory exits 1 with it (olmoe-1b-7b: 6.92 B parameters, ~83 GB
of the 85 GB before any activation).  Every served stack trains, MoE
stacks with their load-balancing loss (``aux`` on the step lines), and the
two frontends: hubert-xlarge trains on seeded 512-d frames (a
bidirectional encoder) and paligemma-3b on seeded 1152-d image patches
before its text (prefix-LM over the patches), both at full width on one
card (~11 GB and ~30 GB of state).  The
hybrid recurrentgemma-2b reduced to one period plus its (recurrent,
recurrent) epilogue is ``--layers 5``.

Under ``torchrun`` (``WORLD_SIZE`` > 1) the process group is initialized
(NCCL on ``cuda``, one card per local rank; gloo on ``--device cpu``) and
the step is built on ``make_elastic_mesh()`` with ``make_rules(mesh)``, as
the JAX package's ``launch/train.py`` does on more than one device.  That
mesh keeps a tensor axis of up to ``--model-parallel`` ranks (16, the JAX
package's), every other rank data-parallel, and every block kind trains
tensor-parallel on it (:mod:`repro_torch.distributed.tensor_parallel`);
heads, an RG-LRU width or xLSTM heads that do not split over it raise
``ValueError``.  A relaunch
on another mesh (another world size or ``--model-parallel``) restores the
checkpoint onto its shardings and goes on.  World size 1 is the plain
path.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --full-config
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b --full-config --batch 2 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m --full-config --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge --full-config --batch 2 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma-3b --full-config --batch 2 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch llama3-8b --steps 100
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 4 \
      -m repro_torch.launch.train --device cpu --arch llama3-8b --d-model 64 --steps 3
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.archs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_elastic_mesh, make_rules
from repro_torch.training import (
    DataConfig,
    OptimizerConfig,
    TrainConfig,
    init_train_state,
    make_pipeline,
    make_train_step,
    place_state,
    state_shardings,
)


def state_bytes(cfg) -> int:
    """Bytes of a train state before any activation: weights and gradients
    in the model dtype plus AdamW's f32 ``mu`` and ``nu``."""
    return cfg.param_count() * (2 * torch.finfo(getattr(torch, cfg.dtype)).bits // 8 + 8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--d-model", type=int, default=256, help="reduced width")
    ap.add_argument("--layers", type=int, default=0, help="0 = family default")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--inject-failure", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train: cuda (the hand-written kernels, the "
                    "default) or cpu (the plain PyTorch versions, only when "
                    "asked for)")
    ap.add_argument("--model-parallel", type=int, default=16,
                    help="under torchrun: the elastic mesh's tensor axis, at most this "
                    "many ranks")
    ap.epilog = ("Under torchrun (WORLD_SIZE > 1) the step runs on make_elastic_mesh() "
                 "with make_rules(mesh): tensor-parallel over its model axis (every block "
                 "kind; heads or widths that do not split over it raise ValueError), "
                 "data-parallel over the rest.")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        try:
            mesh = make_elastic_mesh(args.model_parallel, device=device.type)
            return _main(args, device, mesh, make_rules(mesh))
        finally:
            dist.destroy_process_group()
    return _main(args, device)


def _main(args, device, mesh=None, rules=None):

    if args.full_config:
        cfg = get_config(args.arch)
    else:
        over = dict(d_model=args.d_model, head_dim=max(32, args.d_model // 8))
        if args.layers:
            over["n_layers"] = args.layers
        cfg = reduced(args.arch, **over)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M device={device}")
    if mesh is not None:
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)
    if device.type == "cuda":
        have = torch.cuda.get_device_properties(device).total_memory
        reckoning = (f"{cfg.name}'s weights, gradients and f32 moments take "
                     f"{state_bytes(cfg) / 1e9:.1f} GB of the card's {have / 1e9:.1f} GB before "
                     "any activation (--full-config trains every layer)")
        if state_bytes(cfg) > have:
            print(f"does not fit this card: {reckoning}", flush=True)
            return 1
        try:
            return _train(args, cfg, device, mesh, rules)
        except torch.cuda.OutOfMemoryError:
            print(f"out of memory: {reckoning}", flush=True)
            return 1
    return _train(args, cfg, device, mesh, rules)


def _train(args, cfg, device, mesh=None, rules=None):
    opt_cfg = OptimizerConfig(
        learning_rate=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
        total_steps=args.steps,
    )
    train_cfg = TrainConfig(
        microbatches=args.microbatches, grad_compression=args.grad_compression
    )
    step_fn = make_train_step(cfg, opt_cfg, train_cfg, mesh=mesh, rules=rules)
    pipe = make_pipeline(
        DataConfig(batch_size=args.batch, seq_len=args.seq, seed=args.seed), cfg
    )

    state = init_train_state(cfg, torch.Generator().manual_seed(args.seed), train_cfg,
                             device=device)
    shardings = None
    if mesh is not None:
        shardings = state_shardings(cfg, mesh, rules, train_cfg)
        state = place_state(state, shardings)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if mgr.latest_step() is not None:
            state, start_step = mgr.restore(state, shardings=shardings)
            print(f"resumed from checkpoint at step {start_step}")

    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        gnorm = float(metrics["grad_norm"])
        if not (np.isfinite(losses[-1]) and np.isfinite(gnorm)):
            print(f"step {step:5d}  not finite: loss {losses[-1]}  gnorm {gnorm}", flush=True)
            if mgr:
                mgr.wait()
            return 1
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            aux = f"aux {float(metrics['aux']):.4f}  " if "moe" in cfg.layer_kinds() else ""
            print(
                f"step {step:5d}  loss {losses[-1]:.4f}  {aux}"
                f"gnorm {gnorm:.3f}  "
                f"lr {float(metrics['lr']):.2e}  {dt:.1f}s",
                flush=True,
            )
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step + 1, state)
        if args.inject_failure and step + 1 == args.inject_failure:
            print(f"!!! injected failure at step {step + 1}", flush=True)
            if mgr:
                mgr.wait()
            sys.exit(42)

    if mgr:
        mgr.save(args.steps, state)
        mgr.wait()
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"done: loss {first:.4f} -> {last:.4f} over {len(losses)} steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
