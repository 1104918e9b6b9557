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
published (full-width gemma-2b and recurrentgemma-2b fit one 80 GB card
with AdamW at batch 2 x 2048).  MoE and xLSTM configs are refused
(``NotImplementedError``): their training is a later slice.  The hybrid recurrentgemma-2b reduced to one
period plus its (recurrent, recurrent) epilogue is ``--layers 5``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --full-config
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b --full-config --batch 2 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch llama3-8b --steps 100
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.archs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.transformer import check_trainable
from repro_torch.training import (
    DataConfig,
    OptimizerConfig,
    TrainConfig,
    init_train_state,
    make_pipeline,
    make_train_step,
)


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
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.full_config:
        cfg = get_config(args.arch)
    else:
        over = dict(d_model=args.d_model, head_dim=max(32, args.d_model // 8))
        if args.layers:
            over["n_layers"] = args.layers
        cfg = reduced(args.arch, **over)
    check_trainable(cfg)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M device={device}")

    opt_cfg = OptimizerConfig(
        learning_rate=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
        total_steps=args.steps,
    )
    train_cfg = TrainConfig(
        microbatches=args.microbatches, grad_compression=args.grad_compression
    )
    step_fn = make_train_step(cfg, opt_cfg, train_cfg)
    pipe = make_pipeline(
        DataConfig(batch_size=args.batch, seq_len=args.seq, seed=args.seed), cfg
    )

    state = init_train_state(cfg, torch.Generator().manual_seed(args.seed), train_cfg,
                             device=device)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if mgr.latest_step() is not None:
            state, start_step = mgr.restore(state)
            print(f"resumed from checkpoint at step {start_step}")

    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(
                f"step {step:5d}  loss {losses[-1]:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
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
