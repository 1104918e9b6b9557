#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an sm_90 card:

    python3 chip_smoke.py

Phases (each passes or raises; any failure exits non-zero with no result):

1. device: CUDA present, capability >= 9.0; prints the card's name and
   power limit; TF32 off for f32 matmuls and convolutions.
2. build: compiles every CUDA kernel (one ``nvcc`` per source, in
   parallel, with ``-Xptxas -v``) and JITs the Triton kernel; prints the
   seconds, the tensor-core flash kernels' (forward and backward)
   registers, shared memory and spills, and the count of HGMMA (``wgmma``)
   instructions in their SASS (``cuobjdump -sass``), failing if one of the
   ten instantiations of either (bf16 and f16 at D = 64, 80, 96, 128, 256)
   has none.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the kernel-test sweep shapes and at the full-width shapes of the main
   path, with f32 atol 1e-4 (summation order) and bf16 atol 2e-2 + rtol
   1e-2 (one bf16 rounding step); times (CUDA events over CUDA-graph
   replays, median) of the kernel, the plain version, one PyTorch call as
   a yardstick where one exists, and the bound, plus the kernel's eager
   time with its launch cost.  The flash forward, ring decode and flash
   backward sweeps include recurrentgemma's G = 10, D = 256 heads.  The
   flash forward sweep runs f32 (the CUDA-core kernel), bf16 and f16 (the
   tensor-core kernel at D >= 64) with long and ragged S (63, 65, 1000,
   2047, 2048, 2100) at D = 80 / 96 / 128 / 256 and window edges inside a
   64-key tile; it has
   full-width rows at the serve prefill and at both train shapes (gemma-2b
   q (2, 8, 2048, 256), recurrentgemma q (2, 10, 2048, 256) window 2048,
   with the LSE).  The ring decode sweep runs f32, bf16 and f16, G = 5 / 8
   / 10 / 16, S below one chunk, empty slots that leave chunks of masked
   keys only, and all-masked rows under splitting; its full-width rows at
   tier-l's and tier-rg's decode step also check that the output is
   bitwise the same over five calls; rings of 70000 and 2^20 slots (chunks
   of many 256-key steps) run against the plain version too.  The paged
   decode kernel runs the sweep of tests/test_kernels.py (every ladder
   size, windows, masked rows bitwise inert, D 16..256, G=5), a sweep of
   its split across the live span (plans of 1, 2, 3 and many chunks, rows
   with no valid key, spans shorter than the split, mid-page windows, live
   spans of 4096 to 70000 keys, each bitwise the same over five calls) and
   a full-width row at the continuous serve phase's pool geometry that
   reports its block count.  Head dims 80 and 96 run in the flash forward,
   flash backward, ring and paged sweeps (f32, bf16, f16).  The
   flash backward kernel runs the tests/test_kernels.py cases plus D 128 /
   256, G 5 / 8 / 10, ragged S, windowed and bidirectional, in f32, bf16
   and f16 (the forward kernel's LSE is checked too); then its wgmma route
   (bf16 / f16 at D = 64 / 80 / 96 / 128 / 256) on S up to 3000, ragged
   head groups, windows cut mid-tile and a window of 1, each bitwise equal
   over two launches; and full-width rows at the train shapes (gemma-2b q
   (2, 8, 2048, 256) causal, recurrentgemma-2b q (2, 10, 2048, 256) window
   2048, olmoe-1b-7b q (2, 16, 2048, 128) with one q head per kv head, G =
   1, hubert-xlarge q (2, 16, 2048, 80) bidirectional, phi3-mini-3.8b q (2,
   32, 2048, 96) causal; the forward at the last two too),
   each bitwise equal over two launches, whose library time is the
   backward of ``F.scaled_dot_product_attention`` alone, eager, printed
   beside the kernel's eager time.  The RG-LRU scan kernel (S
   cut into chunks across a thread-block cluster) and its reverse mode
   (the backward, one launch) run the tests/test_kernels.py sweep, ragged S
   and W with a non-zero h0, S = 1, one chunk up to 128 steps and one step
   past a cluster of 8 chunks of 16 to 128, S = 8192 and 65536 at W = 64,
   forced plans (S = L - 1, L, L + 1 and 8L + 1, clusters of 2 to 8),
   strided operands on both load routes (TMA and per-thread loads), f32
   and bf16; each case against the plain versions, bitwise against the
   model of the kernel's arithmetic (``rglru_scan_chunked_ref`` with the
   launch's plan), bitwise equal over two launches, and for one chunk in
   f32 bitwise equal to the sequential plain version.  Full-width rows at
   the hybrid serve shape (4, 128, 2560) and the recurrentgemma train shape
   (2, 2048, 2560), forward and backward, f32 as the model runs it, with
   the plan's block count.  No single PyTorch call computes a linear
   recurrence, so their library time is null.  The norm and
   the flash forward and backward are also held against their plain
   versions at the shapes the recurrentgemma phases give them: the serve
   prefill (norm (4, 128, 2560), flash q (4, 10, 128, 256)) and the train
   step (norm (2, 2048, 2560), flash q (2, 10, 2048, 256) with window
   2048), bf16, the norm with the ``(1 + w)`` offset.  The zoo
   phase's olmoe-1b-7b adds full-width rows at G = 1: its prefill q (4, 16,
   128, 128) over 16 kv heads, its ring decode q (4, 16, 1, 128) and its
   paged decode q (8, 16, 1, 128) at the continuous geometry; its train
   phase adds the flash forward at q (2, 16, 2048, 128) with the LSE.
4. model: the three reduced serving tiers, the hedge variant and reduced
   recurrentgemma (5 layers: one period and the epilogue), prefill plus
   16 greedy decode steps in f32, on the card through the kernels and on
   the CPU through the plain versions: logits allclose, tokens equal; then
   for the attention-only stacks the same on the paged path
   (``prefill_ragged`` + graft + 16 ``paged_decode_step``s, rows at
   different positions); then, for the three tiers and recurrentgemma,
   ``loss_fn`` and every parameter gradient (remat on), card against CPU:
   a gradient cut on the card would show here.  The same for two layers of
   phi3-mini-3.8b at its full width (d 3072, 32 heads x 96, f32): head dim
   96 through every attention kernel.  And two full-width layers of
   olmoe-1b-7b (d 2048, 64 experts top-8, qk-norm, f32), dense, paged and
   ``loss_fn`` (its load-balancing loss included) with every gradient.
   The three tiers again with the int8 ring cache (``kv_cache_quant``), a
   24-token prompt into 16 slots (the write wraps) and 16 greedy steps,
   the CPU quantising the card's keys and values: the prefill's codes and
   scales bitwise equal, logits allclose, tokens equal (a free-running CPU
   run reported beside it: its codes flip where f32 rounding crosses a
   code boundary).  Then ``loss_fn``'s bf16
   gradient, leaf by leaf, through the flash backward's wgmma route on two
   full-width layers of gemma-2b and of olmoe-1b-7b (batch 2 x 2048),
   within 1.5x + 4e-5 of the plain version of the kernel's arithmetic's
   distance from the plain f32 backward; olmoe's bitwise the same twice.
5. serve: a ``ServingEngine`` whose ``JitBackend`` hosts tier-s, tier-m
   (reduced as served) and tier-l, qwen3-14b at its full width cut to
   ``TIER_L_LAYERS`` (3) of its 40 layers (bf16, seeded weights on the
   card), plus the zoo's measured hedge; then
   ``measure_profiles``, an ``MDInferenceScheduler`` and
   ``ServingLoop.drain_trace`` over Poisson requests under sync and async
   dispatch.  Checks conservation, that tier-l served requests, finite
   tier-l logits, and that the dense path's kernels were launched.
6. continuous serve: a ``ContinuousBatchingBackend`` over the same
   ``Variant`` objects (no second copy of the weights), the same hedge;
   warmup, ``measure_profiles``, ``drain_trace`` under stepped and sync
   dispatch and one request streamed through ``InferenceClient``.  Checks
   conservation of requests, slots and pages, zero post-warmup growth of
   ``compile_count``, tier-l traffic with finite logits, TTFT on every
   completion, the stream's chunks before resolution, and that the paged
   path's kernels were launched.  Then tier-l with the int8 ring cache on
   the same weights: ``generate`` twice (tokens bitwise equal), finite
   logits, ring-decode launches counted, and the dequantise pass's device
   ms per decode step beside the ring kernel's.
   Between phases 5 and 6, cluster serve: a ``ClusterBackend`` of two
   in-process replicas behind inline transports (``--transport inline``),
   ``power_of_two`` routing and the heterogeneous spec ``2:8:0.5,1``,
   hosting phase 5's ``Variant`` objects (no second copy: nothing is
   allocated building the pool) with the same hedge; ``measure_profiles``
   and ``drain_trace`` of 32 requests under sync and async dispatch, each
   with replica 0 killed at half the trace's span (and one fault injected
   on replica 1) and rejoined at three quarters.  Checks conservation per
   replica and in aggregate, that the killed replica is handed nothing
   between kill and rejoin, that lost rows are requeued or fail over to the
   hedge, that both replicas served tier-l, that the dense path's kernels
   were launched, and that a probe batch's tokens are bitwise equal on
   replica 0, on replica 1, on both at once (two threads) and on phase 5's
   plain ``JitBackend``.
6b. process transport: phase 5's weights copied to the host and phase 5
   released; a ``ClusterBackend`` of two spawned workers (``--transport
   process``), each a ``JitBackend`` on its own CUDA context hosting the
   three tiers with tier-l at full width, the weights sent as raw bytes in
   128 MiB pieces and checksummed; the probe tokens of each worker against
   phase 5's plain backend; ``measure_profiles`` and an async
   ``drain_trace`` during which worker 0 is killed with a batch in flight
   (``ReplicaDied`` on its rows, breaker open, traffic on the survivor);
   worker 1 SIGKILLed mid-batch (the seconds to ``ReplicaDied``); then
   worker 0 rejoined (old process reaped, respawned, re-registered) and a
   batch served by it.  Prints registration seconds and rates,
   spawn-to-ready seconds, the workers' and the parent's peak host RSS and
   the workers' device memory; the workers' launch counters (read over
   their pipe) add to the phase's, except the drain's launches on the
   killed worker, which die with it.
6c. serve command: ``repro_torch.launch.serve`` run in this process on the
   card with ``--replicas 2 --transport inline --kill-replica-at 300
   --rejoin-replica-at 700 --tenants interactive:4,batch:1:batch:32
   --controller --max-pending 8 --overload 2 --overload-policy shed
   --trace-out ... --metrics-out ...``: the exports pass
   ``benchmarks/validate_obs.py``, request conservation balances, and the
   same command untraced, untraced and traced again (in that order) gives
   two trace-on/off p99 ratios.
7. hybrid serve: once tier-l is released, a ``JitBackend`` engine whose one
   remote tier, tier-rg, is recurrentgemma-2b at its full published
   configuration (26 layers, bf16, seeded weights) with the measured
   hedge; ``measure_profiles`` and ``drain_trace`` under sync and async
   dispatch, as in phase 5.  Checks conservation, requests on tier-rg,
   finite logits, that the hybrid path's kernels (the scan included) were
   launched, and, counted on their own afterwards, the launches of one
   prefill and one decode step against those worked out from the layer
   kinds (18 scans and 8 flash launches per prefill, 8 ring-decode
   launches and no scan per decode step).
8b. zoo: once tier-rg is released, the rest of the zoo at full width,
   each released before the next.  olmoe-1b-7b as published (16 layers,
   64 experts top-8, 6.92 B parameters, bf16) as tier-moe of a
   ``JitBackend`` engine with the measured hedge: ``measure_profiles`` and
   sync / async ``drain_trace`` as in phase 5, launches per prefill and
   decode step from the layer kinds, greedy tokens bitwise the same over
   two runs of one batch; then on a ``ContinuousBatchingBackend`` (ladder
   1/2/4/8, 8 slots, page 8): warmup, one streamed request, slot and page
   conservation, no ``compile_count`` growth.  llama4-scout at full width,
   depth cut to ``SCOUT_LAYERS`` of 48 (the full model's 216 GB of bf16
   weights exceed the card): sigmoid top-1 router and shared expert
   through a ``JitBackend``, measured profile, finite logits, tokens
   bitwise the same over two runs.  xlstm-350m as published (24 layers) as
   tier-xlstm: the dense engine as olmoe's, the continuous tier refusing
   it, and the model card against CPU: the whole model in f32 reported
   beside a float64 CPU run, each block's cell teacher-forced in float64
   held within 1e-6 (f32 is chaotic at this depth under the JAX init).
   Then Table III on the card: every zoo tier this run built at full
   width (tier-l, tier-rg, tier-moe, tier-scout, tier-xlstm), its measured
   mu / sigma beside ``lm_zoo_registry``'s H100 roofline mu at chips=1;
   and the paper's simulator (paper zoo and the H100 LM zoo,
   ``FixedCVNetwork(100, 0.5)``, SLA 250 ms, 10 000 requests, seed 0,
   every algorithm with and without duplication) with selection on the
   card and on the CPU: ``model_index`` and metrics identical.
8. profile (only with ``--profile``): ``torch.profiler`` over one tier-l
   ``generate`` at batch 1 and 4 on the dense and on the continuous
   backend and one tier-rg ``generate`` at batch 4 — device busy share,
   device time by kernel family, port-kernel launches per generate.
9. train: once the serve phases have released their weights, full-width
   gemma-2b (all 18 layers, bf16, remat, tied 256k vocab; seeded weights),
   olmoe-1b-7b at full width cut to 8 of 16 layers (3.56 B parameters,
   its load-balancing loss printed each step, every expert that took
   tokens given a gradient; MFU from the active parameters) and, last,
   full-width recurrentgemma-2b (all 26 layers) each train for 12
   steps of ``make_train_step`` (the code path of ``python -m
   repro_torch.launch.train --full-config``) on batch 2 x 2048 tokens of
   ``SyntheticTokens`` seed 0.  Prints loss, grad norm and ms per step,
   tokens/s, model FLOPs utilisation against 989 TFLOP/s, peak device
   memory and kernel launches per step.  Checks finite losses, the loss of
   a fixed held-out batch (``batch_at(1000)``) lower after the 12 steps
   than before and the mean of the last 3 below the first (not for olmoe,
   whose plain witness run, ``scripts/train_witness.py``, does not learn
   beyond its batch noise in 12 steps), a finite non-zero gradient for every leaf
   at step 0, and the flash and scan launches per step (forward and
   backward counted apart) worked out from the layer kinds (remat reruns
   the periods' forward, not the epilogue's).  Then one more step of each
   under ``torch.profiler``: device busy share and the flash backward
   family's device ms (printed in full with ``--profile``).
   Then the user's command ``python -m repro_torch.launch.train --arch
   phi3-mini-3.8b --full-config --batch 2 --seq 2048`` for 3 steps, in this
   process (its launches counted): exit 0, finite losses, the last below
   the first, the flash launches worked out from the layer kinds, peak
   device memory; and ``--arch xlstm-350m`` the same way for 3 steps (no
   learning check), followed by its gradient block by block: each of the
   24 blocks' vjp, teacher-forced from the CPU float64 forward, card
   against CPU in float64 within 1e-6 (its f32 forward is chaotic).
9b. frontends, before recurrentgemma-2b trains: paligemma-3b at its full
   published width (18 layers, bf16, seeded weights): ``prefill`` of 4
   rows of 256 seeded image patches before a 128-token prompt (prefix-LM
   over the patches), 16 greedy decode steps over the ring cache, run
   twice, tokens bitwise equal, one flash launch per layer per prefill and
   one ring-decode launch per layer per step; its prefill logits held to
   the plain versions on the same card tensors against an f32 run, and
   each of its flash calls, on the model's own q, k, v and prefix, to
   float64 (within 1.5x the plain bf16 version's error).  hubert-xlarge
   (48 layers, bidirectional, D = 80): a forward over 2 x 2048 seeded
   frames, logits finite, held the same two ways.  Then the train commands
   ``--arch paligemma-3b`` and ``--arch hubert-xlarge`` (``--full-config
   --batch 2 --seq 2048``) for 3 steps each, as the phi3 command (both
   witnesses learn, so the last loss must be below the first), and each
   model's bf16 gradient at full width, 2 layers, leaf by leaf against
   the plain backward (``frontend.proj`` included; hubert's token
   embedding, which no input reaches, zero).  The kernels phase holds the
   prefix-LM forward and backward on every route to their plain versions
   (``_prefix_sweep``) and times paligemma's prefill and train shapes and
   hubert's bidirectional D = 80 shape, forward and backward.

10. the distributed and analysis tooling.  After the serve phase,
   tier-l's decode step at batch 4 (a 129-slot ring, every slot live) is
   counted on the card by ``kernels/cost.py``'s ``CostCounter`` (each
   kernel call reports its function-level work, the formulas behind the
   kernels line's bound column) and traced on meta tensors: FLOPs and
   bytes equal as integers, and its roofline at chips=1 beside its median
   ms.  After gemma-2b's train run: step 0's gradient with
   ``microbatches=2`` against the unsplit one, leaf by leaf (relative
   Frobenius distance within ``MB_GRAD_REL_BOUND``); 3 steps with
   ``microbatches=2`` and ``grad_compression`` (finite losses); one full
   train step counted on the card against its meta trace (equal as
   integers) and its roofline beside the train run's median step; then,
   over an NCCL process group of one rank, ``make_train_step`` on a (1, 1)
   mesh with ``make_rules`` bitwise the unsharded step over two steps
   (gemma-2b at full width, 2 layers), ``restore(..., shardings=)`` bitwise
   the saved parameters, ``compressed_psum`` bitwise the requantize
   formula.  After the zoo: the dry-run over every arch x shape x both
   meshes (meta tensors, no device), every row ok or skipped with
   ``skip_reason``'s note, a line per cell, and ``lm_zoo_registry`` refined
   from its JSON beside the analytic roofline mu and the zoo's measured
   ``mu_ms``.
11. tensor parallel (after the tooling's sharded step): four processes of
   this script on the one card, a gloo group over a FileStore; llama3-8b,
   gemma-2b and xlstm-350m on a (1, 4) ("data", "model") mesh and
   olmoe-1b-7b on (2, 2), full width at 2 layers (xlstm-350m one period,
   7 mLSTM + 1 sLSTM, at 8 x 128 tokens), batch 2 x 2048, then llama3-8b
   again under ``RULES_2D_SP`` (sequence parallelism): bf16 train steps
   through the kernels at each rank's heads (launches counted per rank),
   the gradient in bf16 and in float64 against the unsharded ones (see
   ``phase_tensor_parallel``), per-rank step ms, memory and the bytes of
   every collective held to ``launch/roofline.py``'s reckoning (the
   xLSTM's cells teacher-forced: its whole-model gradient is chaotic);
   then, in the same processes, the serving cases
   (``phase_tensor_parallel_serve``: prefill and greedy decode, xlstm-350m
   and llama3-8b under ``RULES_2D_SP`` among them).

Every run measures every column of the kernels line: each serve phase (the
zoo's serve paths included) and each train run set the launch counters to
0 just before they start and read them just after, and a kernel's
``launches`` is the sum over those phases of the same run (the tensor
parallel phase's ranks count in their own processes and report).  The last lines are the card line, one
``{"kernels": [...]}`` JSON line and the ``{"ok": true, "device": ...}``
JSON line.
Each release between phases prints what stays allocated: the bytes of live
CUDA tensors, the (cuBLAS handle, stream) pairs the serving backends'
``generate`` used on the device's stream set (one stream per call in
flight at once, at the peak), and (from the hybrid
phase's release on) what is left after clearing PyTorch's cuBLAS
workspaces; the serving phases' releases keep them, so their lines show
whether one drain grows them over another.
``--tier-l-layers`` sets tier-l's depth (never its width): 3 of 40 by
default, so that the run ends well within its time limit.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16

# The serve phase's request shape and the batch of the full-width kernel
# timings.
REQUESTS = 16
PROMPT = 128
GEN = 16
BATCH = 4
SLA_MS = 2000.0
# tier-l, qwen3-14b at its full width, is cut to 3 of its 40 layers: its
# weights are built, served, copied to the host and sent to two worker
# processes (twice to one of them), and at 40 layers those phases took
# ~340 s of a 1011 s run on an H100 80GB HBM3 at 700 W, which must end
# within 1200 s; 10 layers left no room for the xLSTM and
# sequence-parallel cases of the tensor-parallel phases (PERF.md, PR 28).
TIER_L_LAYERS = 3
# The continuous serve phase's geometry (its pool: 1 + 8 * 18 = 145 pages).
PAGE = 8
N_SLOTS = 8
# The hybrid serve phase: recurrentgemma-2b at full width as tier-rg, with
# the JAX package's quality for it (src/repro/serving/profiles.py:38).
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_TIER = "tier-rg"
HYBRID_QUALITY = 42.0
# The train phase: full-width gemma-2b, then recurrentgemma-2b; batch x
# sequence, steps.
TRAIN_ARCHS = ("gemma-2b", "recurrentgemma-2b")
TRAIN_BATCH = 2
TRAIN_SEQ = 2048
TRAIN_STEPS = 12
HELD_OUT_BATCH = 1000  # a batch index the train runs never reach
# phi3-mini-3.8b (head dim 96): two full-width layers card vs CPU in the
# model phase, and the user's train command at full configuration.
PHI3_ARCH = "phi3-mini-3.8b"
PHI3_TRAIN_STEPS = 3
# The cluster serve phase: requests (a kill at half the trace's span and a
# rejoin at three quarters need several ticks) and the heterogeneous pool.
CLUSTER_REQUESTS = 32
# Tracing's cost is read from p99 over this many requests of one seeded
# trace (p99 of 64 interpolates below the largest), four runs of the trace
# at 12 req/s.  A run lasts as long as the pool takes to serve its
# requests, most of them on tier-l, not the trace's span.
TRACING_REQUESTS = 64
TRACING_RATE = 12.0
CLUSTER_SPEC = "2:8:0.5,1"
# The zoo phase: the MoE and xLSTM models of the zoo (their qualities are
# ``repro_torch.serving.profiles.QUALITY``, the JAX package's).
MOE_ARCH = "olmoe-1b-7b"
SCOUT_ARCH = "llama4-scout-17b-a16e"
SCOUT_LAYERS = 4  # of 48: the full model's 216 GB of bf16 weights exceed the card
XLSTM_ARCH = "xlstm-350m"
# The train phase: olmoe-1b-7b at full width cut to 8 of its 16 layers (its
# 6.92 B parameters with bf16 gradients and f32 moments are ~83 GB, over the
# card's 80); no learning check, as its plain witness run does not learn in
# 12 steps (scripts/train_witness.py).  The xlstm-350m train command runs 3
# steps at the command's default batch of 8 x 128 tokens: under the JAX
# init its gradient overflows to non-finite values from 512 tokens a row,
# on the CPU as on the card, and its sLSTM's time loop takes ~33 s a step
# at 2 x 2048.
MOE_TRAIN_LAYERS = 8
MOE_LEARNS = False
XLSTM_TRAIN_STEPS = 3
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ = 8, 128
# The frontends (the audio and vision frontends and prefix-LM attention):
# paligemma-3b served at full width (its 256 image patches and a PROMPT-token
# prompt at batch BATCH, then GEN greedy decode steps over the ring cache)
# and a forward of hubert-xlarge over TRAIN_BATCH x TRAIN_SEQ frames; then
# both train commands at TRAIN_BATCH x TRAIN_SEQ (paligemma's text with its
# 256 patches before it) for FRONTEND_TRAIN_STEPS steps, each with the
# learning check: both plain witness runs learn (scripts/train_witness.py:
# held-out falls of 2.99 and 0.166 in 12 steps against train-loss wanders
# of 0.358 and 0.013, 8.3x and 12.7x; PERF.md, PR 23).
PALI_ARCH = "paligemma-3b"
HUBERT_ARCH = "hubert-xlarge"
FRONTEND_TRAIN_STEPS = 3
SIM_REQUESTS = 10_000
SIM_SLA_MS = 250.0
# A run still going after this long fails (stacks printed, workers killed)
# inside the 1200 s a run may take.
WATCHDOG_S = 1150.0


# The kernels each serve phase's path must launch (the hedge tier's dense
# decode may or may not run during the continuous phase).
DENSE_PATH_KERNELS = ("rms_norm_fwd", "flash_attention_fwd", "decode_attention_fwd")
PAGED_PATH_KERNELS = ("rms_norm_fwd", "flash_attention_fwd", "decode_attention_paged_fwd")
HYBRID_PATH_KERNELS = DENSE_PATH_KERNELS + ("rglru_scan_fwd",)
ZOO_PATH_KERNELS = DENSE_PATH_KERNELS + ("decode_attention_paged_fwd",)
TRAIN_PATH_KERNELS = ("rms_norm_fwd", "flash_attention_fwd", "flash_attention_bwd")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# Phase 1: device.
# ---------------------------------------------------------------------------
def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability(0)
    check(cap >= (9, 0), f"compute capability {cap} < (9, 0)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} capability {cap} "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"[device] nvidia-smi: {card}", flush=True)
    return card


# ---------------------------------------------------------------------------
# Phase 2: build.
# ---------------------------------------------------------------------------
def phase_build(torch, ptxas: bool):
    from repro_torch.kernels import cuda_build, ops

    t0 = time.perf_counter()
    built = cuda_build.build(ptxas_verbose=True)
    for name, (seconds, stderr) in built.items():
        print(f"[build] nvcc {name}.cu: {seconds:.1f}s", flush=True)
        _ptxas_report(stderr, ptxas)
    _hgmma_report(cuda_build)
    x = torch.randn(2, 64, device="cuda")
    t1 = time.perf_counter()
    ops.rms_norm(x, torch.ones(64, device="cuda"))
    torch.cuda.synchronize()
    print(f"[build] CUDA libraries {t1 - t0:.1f}s (parallel), Triton first "
          f"launch {time.perf_counter() - t1:.1f}s", flush=True)
    ops.reset_launch_counts()


# The tensor-core kernels: (library, kernel name) and the pattern of their
# mangled names (element type, head dim).
_WGMMA_KERNELS = (("flash_attention", "flash_fwd_wgmma_kernel"),
                  ("flash_attention_bwd", "flash_bwd_wgmma_kernel"))
_WGMMA = re.compile(r"(flash_(?:fwd|bwd)_wgmma_kernel)I(?:\d+)?(\w+?)Li(\d+)E")


def _ptxas_report(stderr: str, every: bool):
    """``-Xptxas -v`` lines (registers, shared memory, spills): always for the
    tensor-core flash kernels (forward and backward), for every kernel with
    ``--ptxas``."""
    entry = None
    for line in stderr.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
            if every:
                print(f"[build]   {line.strip()}")
            continue
        if not ("registers" in line or "spill" in line):
            continue
        m = _WGMMA.search(entry or "")
        if m:
            print(f"[build]   {m.group(1)}<{m.group(2)}, D={m.group(3)}>: "
                  f"{line.strip().removeprefix('ptxas info    : ')}", flush=True)
        elif every:
            print(f"[build]   {line.strip()}")


def _hgmma_report(cuda_build):
    """Counts HGMMA (wgmma) instructions in the SASS of each tensor-core flash
    kernel, forward and backward; fails if one has none."""
    for lib, kernel in _WGMMA_KERNELS:
        sass = cuda_build.sass(lib)
        if sass is None:
            print("[build] cuobjdump not in the toolkit: HGMMA count not measured", flush=True)
            return
        counts, func = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                m = _WGMMA.search(line)
                func = f"{m.group(2)}, D={m.group(3)}" if m and m.group(1) == kernel else None
                if func:
                    counts[func] = 0
            elif func and "HGMMA" in line:
                counts[func] += 1
        check(len(counts) == 10, f"expected 10 {kernel} instantiations in the SASS, found {counts}")
        for func, n in counts.items():
            check(n > 0, f"{kernel}<{func}> has no HGMMA instruction")
        print(f"[build] HGMMA instructions per {kernel} (cuobjdump -sass): {counts}", flush=True)


# ---------------------------------------------------------------------------
# Phase 3: kernels.
# ---------------------------------------------------------------------------
def _tol(torch, dtype):
    return (dict(atol=1e-4, rtol=0.0) if dtype == torch.float32
            else dict(atol=2e-2, rtol=1e-2))


def _compare(torch, name, got, want, dtype):
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = _tol(torch, dtype)
    ok = bool(torch.allclose(got, want, **tol))
    check(ok, f"{name}: kernel vs plain max |err| {err:.3g} beyond {tol}")
    return err


_WARMUP_STREAM = []


def _warmup_stream(torch):
    """The one stream every timing warms up on (PyTorch keeps a cuBLAS
    workspace per handle and stream, so a new stream per timing adds one)."""
    if not _WARMUP_STREAM:
        _WARMUP_STREAM.append(torch.cuda.Stream())
    return _WARMUP_STREAM[0]


def time_ms(torch, fn, launches: int = 20, trials: int = 7, graph: bool = True) -> float:
    """Median over ``trials`` of (CUDA-event time of ``launches`` calls) / launches.

    With ``graph`` the calls are captured once into a CUDA graph and the
    graph is replayed, so the time is the device's alone (back-to-back
    kernels, no Python launch cost); without it the calls run eagerly and
    the time includes whatever the host adds between launches."""
    side = _warmup_stream(torch)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(launches):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(launches):
                fn()
    per = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / launches)
    return statistics.median(per)


def _randn(torch, shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(device="cuda", dtype=dtype)


def _ring(torch, B, S):
    """Ring-buffer slot positions as in tests/test_kernels.py (some wrapped)."""
    pos = torch.full((B,), S + S // 2, dtype=torch.int32)
    slot = (pos[:, None] - S + 1) + (torch.arange(S) + S // 2) % S
    return slot.to(torch.int32).cuda(), pos.cuda()


def _sm_count(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def _sdpa(torch, q, k, v, **kw):
    import torch.nn.functional as F

    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:  # older torch: repeat the kv heads
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), **kw)


def phase_kernels(torch, full):
    """Sweep + full-width comparisons; returns the kernels JSON entries."""
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk

    gen = torch.Generator().manual_seed(0)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    n = 0
    # -- RMSNorm sweep (tests/test_kernels.py shapes + the served widths).
    for dtype in (f32, bf16):
        for offset in (False, True):
            for shape in ((4, 128, 256), (3, 7, 512), (1, 1, 64), (2, 5, 16),
                          (2, 9, 3, 128), (4, 128, 5120), (3, 100)):
                x = _randn(torch, shape, dtype, gen)
                w = _randn(torch, shape[-1:], f32, gen)
                _compare(torch, f"rms_norm{shape} {dtype} offset={offset}",
                         rk.rms_norm_fwd(x, w, offset=offset),
                         ref.rms_norm_ref(x, w, offset=offset), dtype)
                n += 1
    # -- Flash sweep: (B, NQ, NKV, S, D, causal, window); model layout views.
    flash_cases = [
        (2, 4, 2, 256, 64, True, 0), (1, 4, 1, 256, 64, True, 0),
        (2, 2, 2, 128, 32, True, 0), (1, 8, 2, 512, 128, True, 0),
        (1, 2, 2, 128, 128, True, 0), (1, 4, 1, 256, 64, True, 32),
        (1, 4, 1, 256, 64, True, 96), (2, 2, 2, 128, 64, False, 0),
        (1, 10, 2, 100, 128, True, 0), (2, 2, 1, 37, 16, True, 0),
        (1, 8, 1, 70, 256, True, 0), (1, 4, 2, 200, 64, False, 48),
        (2, 40, 8, 128, 128, True, 0),
        # recurrentgemma's local layers: G = 10, D = 256, windowed
        (2, 10, 1, 256, 256, True, 0), (1, 10, 1, 300, 256, True, 128),
        # long and ragged S at D = 128 / 256 (a wrong fragment order in the
        # tensor-core kernel passes at S <= 64 and fails here)
        (1, 4, 1, 1000, 128, True, 0), (1, 2, 1, 2047, 256, True, 0),
        (1, 4, 2, 2048, 128, True, 0), (1, 2, 1, 2100, 256, True, 0),
        (1, 2, 2, 2100, 128, False, 0),
        # window edges inside a 64-key tile
        (1, 4, 1, 1000, 128, True, 100), (1, 4, 2, 300, 64, True, 65),
        (1, 2, 1, 517, 256, False, 130), (1, 2, 1, 700, 256, True, 127),
        # head dims 80 (hubert, bidirectional) and 96 (phi3-mini, 32 heads,
        # MHA): the CUDA-core kernel in f32, the tensor-core kernel's 16 /
        # 32-wide feature boxes in bf16 / f16; ragged and long S, windows
        # cut mid-tile
        (2, 4, 2, 256, 80, True, 0), (1, 4, 4, 300, 96, True, 64), (1, 2, 1, 129, 96, False, 0),
        (1, 32, 32, 200, 96, True, 0), (1, 2, 1, 517, 80, False, 130),
        (1, 4, 1, 63, 80, True, 0), (1, 4, 2, 65, 96, False, 0), (1, 16, 16, 1000, 80, False, 0),
        (1, 8, 8, 2047, 96, True, 0), (1, 4, 4, 2100, 80, False, 0), (1, 4, 2, 2100, 96, True, 100),
        (1, 8, 2, 1000, 80, True, 130), (1, 2, 1, 2047, 96, False, 65),
    ]
    for dtype in (f32, bf16, f16):
        for B, NQ, NKV, S, D, causal, window in flash_cases:
            q = _randn(torch, (B, S, NQ, D), dtype, gen).transpose(1, 2)
            k = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            v = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            out, lse = fk.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                              return_lse=True)
            want, want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                                     window=window, return_lse=True)
            tag = f"flash{(B, NQ, NKV, S, D)} causal={causal} window={window} {dtype}"
            _compare(torch, tag, out, want, dtype)
            # The LSE is f32 in both dtypes (the backward recomputes from it).
            _compare(torch, tag + " lse", lse, want_lse, f32)
            n += 1
    # -- Decode sweep: (B, NKV, G, S, D, window); ring slots as in the tests.
    decode_cases = [
        (2, 2, 2, 256, 64, 0), (1, 1, 8, 512, 128, 0), (2, 2, 1, 256, 64, 64),
        (1, 4, 2, 128, 32, 0), (2, 8, 5, 152, 128, 0), (2, 1, 2, 40, 16, 0),
        (1, 1, 10, 96, 256, 0), (3, 2, 4, 33, 64, 16),
        # recurrentgemma's local layers: G = 10
        (4, 1, 10, 152, 256, 0), (2, 1, 10, 300, 256, 128),
        # G = 8 / 16, S below the planner's minimum chunk, a single slot
        (1, 2, 8, 300, 128, 0), (1, 1, 16, 300, 256, 0), (2, 1, 16, 64, 64, 8),
        (1, 2, 8, 7, 128, 0), (2, 1, 5, 1, 64, 0),
        # head dims 80 / 96 (16 lanes per key in bf16, the spare ones zero),
        # phi3-mini's decode step (32 kv heads, G = 1)
        (2, 2, 5, 152, 80, 0), (1, 4, 16, 300, 96, 0), (2, 1, 10, 40, 80, 16),
        (2, 32, 1, 152, 96, 0), (1, 2, 8, 300, 96, 8),
    ]
    for dtype in (f32, bf16, f16):
        for B, NKV, G, S, D, window in decode_cases:
            q = _randn(torch, (B, NKV, G, D), dtype, gen)
            kc = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            vc = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            sp, pos = _ring(torch, B, S)
            _compare(torch, f"decode{(B, NKV, G, S, D)} window={window} {dtype}",
                     dk.decode_attention_fwd(q, kc, vc, sp, pos, window=window),
                     ref.decode_attention_ref(q, kc, vc, sp, pos, window=window), dtype)
            n += 1
    # Empty slots (only the first 10 valid): every chunk past the first
    # holds masked keys only; pos = -1 masks the whole row (the mean of v)
    # under splitting, and pos = 3 leaves one chunk with valid keys.
    for B, NKV, G, S, D in ((2, 2, 2, 128, 32), (4, 1, 10, 152, 256), (2, 8, 5, 300, 128)):
        q = _randn(torch, (B, NKV, G, D), f32, gen)
        kc = _randn(torch, (B, NKV, S, D), f32, gen)
        vc = _randn(torch, (B, NKV, S, D), f32, gen)
        sp = torch.where(torch.arange(S) < 10, torch.arange(S), -1).to(torch.int32)
        sp = sp.expand(B, S).contiguous().cuda()
        for p in (9, -1, 3):
            pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
            _compare(torch, f"decode {(B, NKV, G, S, D)} empty slots pos={p} (plan "
                     f"{dk.split_plan(B, NKV, G, S, _sm_count(torch))})",
                     dk.decode_attention_fwd(q, kc, vc, sp, pos),
                     ref.decode_attention_ref(q, kc, vc, sp, pos), f32)
            n += 1
    n += _decode_lse_sweep(torch, gen)
    n += _long_ring_sweep(torch, gen)
    n += _paged_sweep(torch, gen)
    n += _paged_split_sweep(torch, gen)
    n += _bwd_sweep(torch, gen)
    n += _prefix_sweep(torch, gen)
    n += _rglru_sweep(torch, gen)
    n += _hybrid_shapes(torch, gen)
    print(f"[kernels] {n} kernel-vs-plain comparisons within tolerance", flush=True)

    entries = []
    for B in sorted({1, full["batch"], 8}):
        rows = _full_width(torch, full, B, gen)
        for e in rows:
            _print_entry(e)
        if B == full["batch"]:
            entries = rows
    paged = _full_width_paged(torch, full, gen)
    _print_entry(paged)
    # The flash forward at both train shapes (with the LSE the backward
    # reads) and the ring decode at the hybrid serve phase's decode step.
    gemma, hybrid = get_config(TRAIN_ARCHS[0]), get_config(HYBRID_ARCH)
    # olmoe's one query head per kv head (G = 1) on the ring and paged
    # decode, and its prefill (16 kv heads).
    olmoe = get_config(MOE_ARCH)
    pali, hubert = get_config(PALI_ARCH), get_config(HUBERT_ARCH)
    phi3, llama = get_config(PHI3_ARCH), get_config("llama3-8b")
    olmoe_paged = _full_width_paged(torch, dict(full, n_heads=olmoe.n_heads,
                                                n_kv_heads=olmoe.n_kv_heads,
                                                head_dim=olmoe.head_dim), gen)
    _print_entry(olmoe_paged)
    more = [
        _flash_row(torch, gen, full["batch"], olmoe.n_heads, olmoe.n_kv_heads, full["prompt"],
                   olmoe.head_dim, 0, False, "olmoe prefill"),
        _decode_row(torch, gen, full["batch"], olmoe.n_kv_heads, 1, olmoe.head_dim,
                    full["max_len"], full["prompt"] + 1, "olmoe G = 1"),
        _flash_row(torch, gen, TRAIN_BATCH, gemma.n_heads, gemma.n_kv_heads, TRAIN_SEQ,
                   gemma.head_dim, 0, True, "gemma-2b training"),
        _flash_row(torch, gen, TRAIN_BATCH, hybrid.n_heads, hybrid.n_kv_heads, TRAIN_SEQ,
                   hybrid.head_dim, hybrid.window, True, "recurrentgemma training"),
        _flash_row(torch, gen, TRAIN_BATCH, olmoe.n_heads, olmoe.n_kv_heads, TRAIN_SEQ,
                   olmoe.head_dim, 0, True, "olmoe training"),
        _decode_row(torch, gen, full["batch"], hybrid.n_kv_heads,
                    hybrid.n_heads // hybrid.n_kv_heads, hybrid.head_dim,
                    min(hybrid.window, full["max_len"]), full["prompt"] + 1, "tier-rg"),
        # The tensor-parallel serve phase's decode on one rank of llama3-8b's
        # (1, 4) mesh: every head over the rank's slot slice, live up to its
        # last step, without and with the LSE the ranks' rows are folded by.
        *(_decode_row(torch, gen, TPS_BATCH, llama.n_kv_heads,
                      llama.n_heads // llama.n_kv_heads, llama.head_dim, TPS_MAX_LEN // 4,
                      TPS_PROMPT + TPS_STEPS, "llama3-8b tensor-parallel rank", lse=lse)
          for lse in (False, True)),
        # The frontends: paligemma's prefill (256 patches and the prompt) and
        # its train shape (256 patches and TRAIN_SEQ tokens), prefix 256;
        # hubert's bidirectional encoder at D = 80 (16-wide feature boxes);
        # phi3-mini's train shape at D = 96 (32-wide boxes).
        _flash_row(torch, gen, full["batch"], pali.n_heads, pali.n_kv_heads,
                   pali.num_prefix_tokens + full["prompt"], pali.head_dim, 0, False,
                   "paligemma prefill", prefix=pali.num_prefix_tokens),
        _flash_row(torch, gen, TRAIN_BATCH, pali.n_heads, pali.n_kv_heads,
                   pali.num_prefix_tokens + TRAIN_SEQ, pali.head_dim, 0, True,
                   "paligemma training", prefix=pali.num_prefix_tokens),
        _flash_row(torch, gen, TRAIN_BATCH, hubert.n_heads, hubert.n_kv_heads, TRAIN_SEQ,
                   hubert.head_dim, 0, True, "hubert training", causal=False),
        _flash_row(torch, gen, TRAIN_BATCH, phi3.n_heads, phi3.n_kv_heads, TRAIN_SEQ,
                   phi3.head_dim, 0, True, "phi3-mini training"),
    ]
    for e in more:
        _print_entry(e)
    bwd = [_full_width_bwd(torch, gen, arch) for arch in TRAIN_ARCHS + (MOE_ARCH,)]
    bwd += [_full_width_bwd(torch, gen, PALI_ARCH, S=pali.num_prefix_tokens + TRAIN_SEQ,
                            prefix=pali.num_prefix_tokens),
            _full_width_bwd(torch, gen, HUBERT_ARCH), _full_width_bwd(torch, gen, PHI3_ARCH)]
    for e in bwd:
        _print_entry(e)
    print("[kernels] rglru_scan_fwd / rglru_scan_bwd have no library yardstick: no single "
          "PyTorch call computes a linear recurrence (library_ms null)", flush=True)
    for B, S, label in ((full["batch"], full["prompt"], "hybrid serve prefill"),
                        (TRAIN_BATCH, TRAIN_SEQ, "recurrentgemma training")):
        scan = _full_width_rglru(torch, gen, B, S, hybrid.lru_width, label)
        _print_entry(scan)
    scan_bwd = _full_width_rglru_bwd(torch, gen, TRAIN_BATCH, TRAIN_SEQ, hybrid.lru_width,
                                     "recurrentgemma training")
    _print_entry(scan_bwd)
    return entries + more + [paged, olmoe_paged, *bwd, scan, scan_bwd]


def _print_entry(e):
    lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms"
    print(f"[kernels] {e['name']:26s} {e['shape']}: kernel {e['ms']:.4f} ms "
          f"(eager with launch cost {e['eager_ms']:.4f} ms), "
          f"plain {e['plain_ms']:.4f} ms, library {lib}, "
          f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
          f"max|err| {e['max_abs_err']:.3g}", flush=True)


def _rglru_case(torch, gen, B, S, W, dtype, h0_dtype=None):
    """Decays in (0, 1), small inputs, a non-zero h0: the RG-LRU regime of
    tests/test_kernels.py."""
    a = torch.sigmoid(2.0 * torch.randn((B, S, W), generator=gen)).to("cuda", dtype)
    b = _randn(torch, (B, S, W), dtype, gen, scale=0.1)
    h0 = _randn(torch, (B, W), h0_dtype or torch.float32, gen, scale=0.1)
    return a, b, h0


def _rglru_check(torch, gen, tag, a, b, h0, dtype, want_route=None, chunk=None,
                 tile_w=None) -> int:
    """One scan case, forward then backward: the kernel against the plain
    versions within tolerance, bitwise against the model of its own
    arithmetic (``rglru_scan_chunked_ref`` with the launch's plan), bitwise
    equal over two launches, and, for a single chunk in f32, bitwise equal
    to the sequential ``rglru_scan_ref``.  ``chunk`` / ``tile_w`` force a
    plan instead of the planner's.  Returns the comparisons made."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rk

    B, S, W = a.shape
    if chunk is None:
        plan_f, plan_b = rk.launch_plan(a), rk.launch_plan(a, reverse=True)
    else:
        plan_f, plan_b = (rk.make_plan(B, S, W, a.element_size(), rev, chunk, tile_w)
                          for rev in (False, True))
    route = rk.load_route(a, b)
    check(want_route is None or route == want_route,
          f"{tag}: load route {route}, expected {want_route}")
    tag = (f"{tag} (L {plan_f.chunk}/{plan_b.chunk}, {plan_f.tile_w} channels, cluster "
           f"{plan_f.cluster}, {plan_f.groups}/{plan_b.groups} groups, {route})")
    h = rk.rglru_scan_fwd(a, b, h0, plan=plan_f)
    want = ref.rglru_scan_ref(a, b, h0)
    _compare(torch, tag, h, want, dtype)
    check(torch.equal(h, rk.rglru_scan_fwd(a, b, h0, plan=plan_f)),
          f"{tag}: two launches differ")
    if S <= 8192:  # the model walks S in Python, step by step
        model = ref.rglru_scan_chunked_ref(a, b, h0, chunk=plan_f.chunk, cluster=plan_f.cluster)
        check(torch.equal(h, model), f"{tag}: not bitwise the chunked model's arithmetic "
              f"(max |diff| {float((h.float() - model.float()).abs().max()):.3g})")
    if S <= plan_f.chunk and dtype == torch.float32:
        check(torch.equal(h, want), f"{tag}: one chunk is not bit-equal to rglru_scan_ref")
    dh = _randn(torch, (B, S, W), dtype, gen)
    got = rk.rglru_scan_bwd(a, h, h0, dh, plan=plan_b)
    plain = ref.rglru_scan_bwd_ref(a, h, h0, dh)
    for part, g, w in zip(("da", "db", "dh0"), got, plain):
        check(g.dtype == w.dtype and g.shape == w.shape, f"{tag} bwd {part} dtype/shape")
        _compare(torch, f"{tag} bwd {part}", g, w, dtype)
    if S <= plan_b.chunk and dtype == torch.float32:
        check(all(torch.equal(g, w) for g, w in zip(got, plain)),
              f"{tag} bwd: one chunk is not bit-equal to rglru_scan_bwd_ref")
    again = rk.rglru_scan_bwd(a, h, h0, dh, plan=plan_b)
    check(all(torch.equal(x, y) for x, y in zip(got, again)), f"{tag} bwd: two launches differ")
    if S <= 8192:
        model = ref.rglru_scan_chunked_ref(a, dh, h0, chunk=plan_b.chunk, cluster=plan_b.cluster,
                                           reverse=True, h=h)
        check(all(torch.equal(x, y) for x, y in zip(got, model)),
              f"{tag} bwd: not bitwise the chunked model's arithmetic")
    return 2


def _rglru_sweep(torch, gen) -> int:
    """The scan kernel and its reverse mode (the backward), every case as
    ``_rglru_check``, f32 and bf16: the tests/test_kernels.py shapes, ragged
    S and W, a bf16 h0; on the planner's plans S = 1, 127 and 128 (one
    chunk) and 129, 257, 513, 1025 (one step past a cluster of 8 chunks of
    16, 32, 64, 128), S = 8192 and 65536 at W = 64 (a cluster looping over
    many groups); on forced plans S = L - 1, L, L + 1 and 8L + 1 for L = 8
    and 32 and clusters of 2 to 8; strided operands on both load routes;
    and the carry across what were the Pallas kernel's sequence blocks."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rk

    n = 0
    f32 = torch.float32
    for dtype in (f32, torch.bfloat16):
        for B, S, W, h0_dtype in ((2, 256, 128, None), (1, 512, 256, None), (3, 128, 64, None),
                                  (2, 300, 2500, None), (2, 77, 130, dtype), (1, 5, 7, None),
                                  (2, 1, 130, None), (3, 127, 64, None), (2, 129, 40, dtype),
                                  (2, 257, 160, None), (1, 513, 96, None), (1, 1025, 64, None),
                                  (2, 2049, 256, None)):
            a, b, h0 = _rglru_case(torch, gen, B, S, W, dtype, h0_dtype)
            n += _rglru_check(torch, gen, f"rglru{(B, S, W)} {dtype} h0 {h0.dtype}", a, b, h0,
                              dtype)
        for B, S, W, chunk, tile_w in ((2, 7, 130, 8, 64), (2, 8, 130, 8, 64), (2, 9, 130, 8, 64),
                                       (1, 33, 64, 8, 32), (2, 65, 40, 8, 64),
                                       (2, 31, 256, 32, 128), (2, 32, 256, 32, 128),
                                       (2, 33, 256, 32, 128), (1, 257, 64, 32, 64),
                                       (2, 300, 250, 64, 128), (2, 1000, 96, 128, 32),
                                       (1, 2049, 64, 8, 32)):
            a, b, h0 = _rglru_case(torch, gen, B, S, W, dtype)
            n += _rglru_check(torch, gen, f"rglru{(B, S, W)} {dtype} forced", a, b, h0, dtype,
                              chunk=chunk, tile_w=tile_w)
    for S in (8192, 65536):
        a, b, h0 = _rglru_case(torch, gen, 1, S, 64, f32)
        n += _rglru_check(torch, gen, f"rglru long {(1, S, 64)}", a, b, h0, f32)
    # Strided operands: steps padded to 264 channels (16-byte strides, the
    # TMA route), then the same views shifted by one channel (pointers off
    # 16 bytes: per-thread loads), and W = 7 (28-byte strides); each on a
    # one-chunk and a clustered plan.
    for dtype in (f32, torch.bfloat16):
        for S in (100, 300):
            for off, route in ((0, "tma"), (1, "ldg")):
                pad_a, pad_b, h0 = _rglru_case(torch, gen, 2, S, 264, dtype)
                a, b = pad_a[..., off:off + 256], pad_b[..., off:off + 256]
                n += _rglru_check(torch, gen, f"rglru strided {(2, S, 256)} +{off} {dtype}",
                                  a, b, h0[:, :256].contiguous(), dtype, want_route=route)
            a, b, h0 = _rglru_case(torch, gen, 2, S, 7, dtype)
            n += _rglru_check(torch, gen, f"rglru W=7 S={S} {dtype}", a, b, h0, dtype,
                              want_route="ldg")
    n += _rglru_refusals(torch, gen)
    a = torch.full((1, 256, 64), 0.99, device="cuda")
    b = torch.full((1, 256, 64), 0.01, device="cuda")
    h = rk.rglru_scan_fwd(a, b, torch.zeros(1, 64, device="cuda"))
    _compare(torch, "rglru carry", h, ref.rglru_scan_ref(a, b, torch.zeros(1, 64, device="cuda")),
             f32)
    check(float(h[0, -1, 0]) > float(h[0, 63, 0]) > float(h[0, 0, 0]),
          "rglru carry: the state did not accumulate across the sequence")
    return n + 1


def _rglru_refusals(torch, gen) -> int:
    """What the scan cannot take raises, with no fallback: a plan made for
    another shape (the entry point's check), a plan whose shared memory the
    card cannot give a block (the card refuses the cluster launch), and a
    TMA map over 28-byte steps (``cuTensorMapEncodeTiled`` refuses it; the
    wrapper itself routes such operands to per-thread loads, so the entry
    point is called directly).  A scan right after each must still be
    right."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rk

    f32 = torch.float32
    a, b, h0 = _rglru_case(torch, gen, 1, 4096, 256, f32)
    for what, plan in (("a plan for another shape", rk.make_plan(1, 64, 256, 4, False, 8, 128)),
                       ("a block's shared memory past the card's",
                        rk.make_plan(1, 4096, 256, 4, False, 128, 128))):
        try:
            rk.rglru_scan_fwd(a, b, h0, plan=plan)
        except RuntimeError as e:
            print(f"[kernels] rglru refuses {what} ({plan.smem} bytes): {e}", flush=True)
        else:
            fail(f"rglru: {what} was launched")
        _compare(torch, f"rglru after refusing {what}", rk.rglru_scan_fwd(a, b, h0),
                 ref.rglru_scan_ref(a, b, h0), f32)
    a, b, h0 = _rglru_case(torch, gen, 1, 64, 7, f32)
    out = torch.empty_like(a)
    plan = rk.make_plan(1, 64, 7, 4, False, 8, 32)
    err = rk._lib().rglru_scan_launch(
        0, 0, 0, 1, 64, 7, a.data_ptr(), *a.stride()[:2], b.data_ptr(), *b.stride()[:2],
        None, 0, 0, h0.data_ptr(), h0.stride(0), out.data_ptr(), *out.stride()[:2], None, 0, 0,
        None, plan.chunk, plan.tile_w, plan.cluster, plan.stages, 1, plan.smem,
        torch.cuda.current_stream().cuda_stream)
    check(err == -1, f"rglru: a TMA map over 28-byte steps returned {err}, not -1 (refused)")
    check(rk.load_route(a, b) == "ldg", "rglru: 28-byte steps not routed to per-thread loads")
    return 3


def _full_width_rglru(torch, gen, B, S, W, label):
    """The scan kernel at a full-width recurrentgemma shape, f32 as the
    model feeds it (its gates are computed in f32)."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import rglru_scan as rk

    f32 = torch.float32
    a, b, h0 = _rglru_case(torch, gen, B, S, W, f32)
    err = _compare(torch, f"rglru full width {(B, S, W)}", rk.rglru_scan_fwd(a, b, h0),
                   ref.rglru_scan_ref(a, b, h0), f32)
    dh = _randn(torch, (B, S, W), f32, gen)
    h = rk.rglru_scan_fwd(a, b, h0)
    for part, g, w in zip(("da", "db", "dh0"), rk.rglru_scan_bwd(a, h, h0, dh),
                          ref.rglru_scan_bwd_ref(a, h, h0, dh)):
        _compare(torch, f"rglru full width {(B, S, W)} bwd {part}", g, w, f32)
    plan = rk.launch_plan(a)
    # a and b read once, h written once, h0 read once; one multiply and one
    # add per element on the CUDA cores.
    bound_ms, bound_by = cost.rglru_scan_work(a.numel(), a.element_size(), h0.numel(),
                                              h0.element_size()).bound()
    # The plain version is a Python loop of S steps: few graph replays.
    return dict(
        name="rglru_scan_fwd", route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:59", max_abs_err=err,
        shape=f"a, b {(B, S, W)} f32 ({label}, {plan.blocks} blocks: L {plan.chunk}, "
              f"{plan.tile_w} channels, clusters of {plan.cluster}, {plan.groups} groups, "
              f"{rk.load_route(a, b)})",
        ms=time_ms(torch, lambda: rk.rglru_scan_fwd(a, b, h0)),
        eager_ms=time_ms(torch, lambda: rk.rglru_scan_fwd(a, b, h0), graph=False),
        plain_ms=time_ms(torch, lambda: ref.rglru_scan_ref(a, b, h0), launches=2, trials=3),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
    )


def _full_width_rglru_bwd(torch, gen, B, S, W, label):
    """The scan's backward (the kernel in reverse, the whole
    ``rglru_scan_bwd`` call) at the recurrentgemma train shape, f32."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import rglru_scan as rk

    f32 = torch.float32
    a, b, h0 = _rglru_case(torch, gen, B, S, W, f32)
    h = rk.rglru_scan_fwd(a, b, h0)
    dh = _randn(torch, (B, S, W), f32, gen)
    err = max(_compare(torch, f"rglru bwd full width {(B, S, W)} {part}", g, w, f32)
              for part, g, w in zip(("da", "db", "dh0"), rk.rglru_scan_bwd(a, h, h0, dh),
                                    ref.rglru_scan_bwd_ref(a, h, h0, dh)))
    plan = rk.launch_plan(a, reverse=True)
    # a, dh and h read once, da and db written once (20 bytes per element in
    # f32), h0 read and dh0 written once; three multiplies and an add per
    # element.
    bound_ms, bound_by = cost.rglru_scan_bwd_work(a.numel(), a.element_size(), h0.numel(),
                                                  h0.element_size()).bound()
    return dict(
        name="rglru_scan_bwd", route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:59", max_abs_err=err,
        shape=f"a, dh, h {(B, S, W)} f32 ({label}, {plan.blocks} blocks: L {plan.chunk}, "
              f"{plan.tile_w} channels, clusters of {plan.cluster}, {plan.groups} groups, "
              f"{rk.load_route(a, dh, h)})",
        ms=time_ms(torch, lambda: rk.rglru_scan_bwd(a, h, h0, dh)),
        eager_ms=time_ms(torch, lambda: rk.rglru_scan_bwd(a, h, h0, dh), graph=False),
        plain_ms=time_ms(torch, lambda: ref.rglru_scan_bwd_ref(a, h, h0, dh), launches=2,
                         trials=3),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
    )


def _paged_case(torch, gen, B, dtype, NKV=2, G=2, D=32, page=8, NB=3, model_layout=False):
    """One pool + per-row page tables as in tests/test_kernels.py; page 0 is
    the trash page.  ``model_layout`` passes (P, NKV, page, D) transposed
    views of (P, page, NKV, D) pools, as the model does."""
    P = 1 + B * NB
    q = _randn(torch, (B, NKV, G, D), dtype, gen)
    if model_layout:
        kp = _randn(torch, (P, page, NKV, D), dtype, gen).transpose(1, 2)
        vp = _randn(torch, (P, page, NKV, D), dtype, gen).transpose(1, 2)
    else:
        kp = _randn(torch, (P, NKV, page, D), dtype, gen)
        vp = _randn(torch, (P, NKV, page, D), dtype, gen)
    tables = (1 + torch.arange(B * NB, dtype=torch.int32)).reshape(B, NB).cuda()
    pos = ((3 + 5 * torch.arange(B, dtype=torch.int32)) % (NB * page)).cuda()
    return q, kp, vp, tables, pos


def _paged_sweep(torch, gen) -> int:
    """The paged-decode sweep of tests/test_kernels.py, kernel vs plain."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    for dtype in (f32, bf16):
        for B in (1, 2, 4, 8):  # every ladder size
            args = _paged_case(torch, gen, B, dtype, model_layout=B % 4 == 0)
            _compare(torch, f"paged B={B} {dtype}", dk.decode_attention_paged_fwd(*args),
                     ref.decode_attention_paged_ref(*args), dtype)
            n += 1
        for window in (0, 8):
            args = _paged_case(torch, gen, 4, dtype)
            _compare(torch, f"paged window={window} {dtype}",
                     dk.decode_attention_paged_fwd(*args, window=window),
                     ref.decode_attention_paged_ref(*args, window=window), dtype)
            n += 1
        for D in (16, 64, 80, 96, 128, 256):  # head dims, G = 5
            args = _paged_case(torch, gen, 2, dtype, G=5, D=D, model_layout=True)
            _compare(torch, f"paged D={D} G=5 {dtype}", dk.decode_attention_paged_fwd(*args),
                     ref.decode_attention_paged_ref(*args), dtype)
            n += 1
    # Masked rows (pos 0, all-trash tables) of a padded 8-row batch are
    # inert: the real rows equal, bitwise, those of the same 8-row batch
    # whose other rows are live (the split plan depends on B, so the
    # comparison holds B fixed), and the same rows run alone within the
    # tolerance.
    for n_real in (1, 3, 5, 7):
        q, kp, vp, tables, pos = _paged_case(torch, gen, 8, f32)
        live = dk.decode_attention_paged_fwd(q, kp, vp, tables, pos)
        tables[n_real:] = 0
        pos[n_real:] = 0
        padded = dk.decode_attention_paged_fwd(q, kp, vp, tables, pos)
        check(not bool(torch.isnan(padded).any()), f"paged n_real={n_real}: NaN in padded rows")
        check(bool(torch.equal(padded[:n_real], live[:n_real])),
              f"paged n_real={n_real}: masked rows perturb the real rows")
        alone = dk.decode_attention_paged_fwd(q[:n_real], kp, vp, tables[:n_real], pos[:n_real])
        _compare(torch, f"paged n_real={n_real} alone vs padded", alone, padded[:n_real], f32)
        _compare(torch, f"paged n_real={n_real}", padded,
                 ref.decode_attention_paged_ref(q, kp, vp, tables, pos), f32)
        n += 1
    return n


def _long_ring_sweep(torch, gen) -> int:
    """The ring decode past 65536 slots (chunks longer than one 256-key
    step), against its plain version: a wrapped ring, only the first 10
    slots filled (chunks of masked keys only), and a row with no valid key."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref

    n = 0
    for S, dtype in ((70000, torch.bfloat16), (70000, torch.float32), (1 << 20, torch.bfloat16)):
        q = _randn(torch, (1, 1, 4, 128), dtype, gen)
        kc = _randn(torch, (1, 1, S, 128), dtype, gen)
        vc = _randn(torch, (1, 1, S, 128), dtype, gen)
        plan = dk.split_plan(1, 1, 4, S, _sm_count(torch))
        sp, pos = _ring(torch, 1, S)
        _compare(torch, f"decode S={S} {dtype} (plan {plan})",
                 dk.decode_attention_fwd(q, kc, vc, sp, pos),
                 ref.decode_attention_ref(q, kc, vc, sp, pos), dtype)
        sp = torch.where(torch.arange(S) < 10, torch.arange(S), -1).to(torch.int32)[None].cuda()
        for p in (9, -1):
            pos = torch.full((1,), p, dtype=torch.int32, device="cuda")
            _compare(torch, f"decode S={S} {dtype} empty slots pos={p}",
                     dk.decode_attention_fwd(q, kc, vc, sp, pos),
                     ref.decode_attention_ref(q, kc, vc, sp, pos), dtype)
        n += 3
    print(f"[kernels] ring decode past 65536 slots: S 70000 and {1 << 20} within tolerance",
          flush=True)
    return n


def _paged_split_sweep(torch, gen) -> int:
    """The paged kernel's split across the live span: plans of 1, 2, 3 and
    many chunks; rows with no valid key (pos -1, and a window past the pool),
    spans shorter than the split, spans and windows that start and end
    mid-page, the whole pool; f32, bf16 and f16 at D = 80 / 96 / 128; then
    live spans of 4096 to 70000 keys (chunks of many 256-key steps).  Each
    case against the plain version, and five more calls bitwise equal."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref

    n, splits = 0, set()
    # (B, NKV, G, page, NB): the continuous tier's shape (one resident wave),
    # 2, 1 and 3 chunks (S caps them at 16 keys each), many for a lone row.
    shapes = ((8, 8, 5, 8, 18), (16, 8, 5, 8, 4), (32, 8, 5, 8, 2), (8, 8, 5, 8, 6),
              (1, 1, 1, 8, 40))
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in (80, 96, 128):
            for (B, NKV, G, page, NB), window in zip(shapes * 2, (0,) * 5 + (5, 13, 1, 20, 37)):
                S = NB * page
                q, kp, vp, tables, _ = _paged_case(torch, gen, B, dtype, NKV=NKV, G=G, D=D,
                                                   page=page, NB=NB, model_layout=True)
                pos = torch.randint(0, S, (B,), generator=gen, dtype=torch.int32)
                pos[0] = -1
                if B > 1:
                    pos[1] = S + window + 3  # an empty span when windowed
                if B > 2:
                    pos[2] = 1  # 2 keys
                pos = pos.cuda()
                heads, n_split = dk.paged_launch_plan(q, S)
                splits.add(n_split)
                got = dk.decode_attention_paged_fwd(q, kp, vp, tables, pos, window=window)
                _compare(torch, f"paged split {(B, NKV, G, D, page, NB)} window={window} "
                         f"{dtype} (heads {heads}, {n_split} chunks)", got,
                         ref.decode_attention_paged_ref(q, kp, vp, tables, pos, window=window),
                         dtype)
                check(all(torch.equal(got, dk.decode_attention_paged_fwd(
                    q, kp, vp, tables, pos, window=window)) for _ in range(5)),
                    f"paged split {(B, NKV, G, D, page, NB)}: output differs from run to run")
                n += 1
    check({1, 2, 3} <= splits and max(splits) > 100, f"paged split plans covered {splits}")
    for span, window in ((4096, 0), (9000, 0), (9000, 3000), (70000, 0)):
        page, NB = 16, -(-span // 16) + 2
        q, kp, vp, tables, _ = _paged_case(torch, gen, 2, torch.bfloat16, NKV=2, G=5, D=128,
                                           page=page, NB=NB, model_layout=True)
        pos = torch.tensor([span - 1, span // 2 + 3], dtype=torch.int32, device="cuda")
        got = dk.decode_attention_paged_fwd(q, kp, vp, tables, pos, window=window)
        _compare(torch, f"paged split live span {span} window={window} (plan "
                 f"{dk.paged_launch_plan(q, NB * page)})", got,
                 ref.decode_attention_paged_ref(q, kp, vp, tables, pos, window=window),
                 torch.bfloat16)
        check(all(torch.equal(got, dk.decode_attention_paged_fwd(q, kp, vp, tables, pos,
                                                                 window=window))
                  for _ in range(5)), f"paged split span {span}: output differs from run to run")
        n += 1
    print(f"[kernels] paged split: plans of {sorted(splits)} chunks, live spans up to 70000 "
          "keys, each bitwise the same over five calls", flush=True)
    return n


def _bwd_f64(torch, q, k, v, out, dout, lse, causal, window, round_to=None, scale=None,
             split_p=True, prefix_len=None):
    """The flash backward's math (``ref.flash_attention_bwd_ref``) in float64
    on the card, returning float64 dq, dk, dv.  With ``round_to``, the
    operands as the kernels round them: ds rounded to that dtype, and p as
    the sum of p rounded and its remainder rounded (two products in the
    wgmma kernels) or, without ``split_p``, p rounded once (the WMMA
    kernels at D = 16 / 32): the plain version of the kernel's arithmetic."""
    from repro_torch.kernels import ref

    B, NQ, S, D = q.shape
    NKV = k.shape[1]
    G, f64 = NQ // NKV, torch.float64
    scale = D**-0.5 if scale is None else scale
    qd = q.to(f64).reshape(B, NKV, G, S, D)
    dod = dout.to(f64).reshape(B, NKV, G, S, D)
    kd, vd = k.to(f64), v.to(f64)
    delta = (dout.to(f64) * out.to(f64)).sum(-1).reshape(B, NKV, G, S, 1)
    s = torch.einsum("bkgqd,bksd->bkgqs", qd, kd) * scale
    ok = ref._scores_mask(S, S, causal=causal, window=window, device=q.device,
                          prefix_len=prefix_len)
    s = torch.where(ok, s, torch.full_like(s, ref._NEG_INF))
    p = torch.exp(s - lse.to(f64).reshape(B, NKV, G, S, 1))
    del s
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dod, vd) - delta) * scale
    if round_to is not None:
        hi = p.to(round_to).to(f64)
        p = hi + (p - hi).to(round_to).to(f64) if split_p else hi
        ds = ds.to(round_to).to(f64)
    return (torch.einsum("bkgqs,bksd->bkgqd", ds, kd).reshape(B, NQ, S, D),
            torch.einsum("bkgqs,bkgqd->bksd", ds, qd),
            torch.einsum("bkgqs,bkgqd->bksd", p, dod))


def _rel_err(torch, got, want):
    """(whole, per tile): the relative Frobenius error of ``got`` against
    float64 ``want`` ((B, N, S, D)), over the tensor and over each 64 rows of
    S (all batches, heads and columns)."""
    d2 = ((got.to(torch.float64) - want) ** 2).sum((0, 1, 3))
    w2 = (want ** 2).sum((0, 1, 3))
    pad = -len(d2) % 64
    d2t = torch.nn.functional.pad(d2, (0, pad)).view(-1, 64).sum(1)
    w2t = torch.nn.functional.pad(w2, (0, pad)).view(-1, 64).sum(1)
    return (float((d2.sum() / w2.sum().clamp_min(1e-300)).sqrt()),
            (d2t / w2t.clamp_min(1e-300)).sqrt())


# The relative-error gate of the bf16 / f16 backward: against float64, each
# of dq, dk, dv, whole and per 64-row tile, within REL_GATE times the error
# of the plain version of the kernel's arithmetic (``_bwd_f64`` with the
# kernel's operand rounding, the rest float64, the result rounded), plus
# REL_FLOOR (a hundredth of one bf16 rounding step, 2^-8) where both are
# near zero.
# Unlike atol, it scales with the gradients: a kernel that drops a tile's
# keys or a q head of a group fails it at any magnitude.
REL_GATE = 1.5
REL_FLOOR = 4e-5


def _rel_gate(torch, tag, q, k, v, out, dout, lse, got, causal, window, prefix_len=None):
    """Holds the kernel's ``got`` (dq, dk, dv) to the gate above; returns
    {part: (kernel error, plain error, worst tile's kernel / plain)}."""
    from repro_torch.kernels.flash_attention_bwd import bwd_route

    exact = _bwd_f64(torch, q, k, v, out, dout, lse, causal, window, prefix_len=prefix_len)
    split = bwd_route(q.dtype, q.shape[-1]) == "wgmma"
    plain = [t.to(q.dtype) for t in _bwd_f64(torch, q, k, v, out, dout, lse, causal, window,
                                                round_to=q.dtype, split_p=split,
                                                prefix_len=prefix_len)]
    readings = {}
    for part, g, p, w in zip(("dq", "dk", "dv"), got, plain, exact):
        (ke, kt), (pe, pt) = _rel_err(torch, g, w), _rel_err(torch, p, w)
        check(ke <= REL_GATE * pe + REL_FLOOR,
              f"{tag} {part}: relative error {ke:.4g} against float64, beyond {REL_GATE}x the "
              f"plain bf16 version's {pe:.4g}")
        bad = torch.nonzero(kt > REL_GATE * pt + REL_FLOOR).flatten().tolist()
        check(not bad, f"{tag} {part}: 64-row tiles {bad[:8]} beyond {REL_GATE}x the plain "
              f"version's relative error (kernel {kt[bad[:8]].tolist()}, plain "
              f"{pt[bad[:8]].tolist()})")
        readings[part] = (ke, pe, float((kt / pt.clamp_min(REL_FLOOR)).max()))
    del exact, plain
    return readings


def _bwd_sweep(torch, gen) -> int:
    """The flash backward kernel against ``flash_attention_bwd_ref``, both
    fed the forward kernel's output and LSE, on model-layout views: the
    tests/test_kernels.py cases, then D 128 / 256, G 5 / 8 / 10 (MQA), ragged S,
    windowed and bidirectional; f32 (the CUDA-core kernels), bf16 and f16
    (the tensor-core kernels: wgmma at D = 64 / 80 / 96 / 128 / 256, WMMA
    at 16 / 32).  Then, bf16 and f16 only, the wgmma route's own cases: D
    64 / 80 / 96 / 128 / 256, S 63 / 65 / 1000 / 2047 / 2048 / 2100 /
    3000, G 8 / 10 with ragged head groups (the planner's 3 + 3 + 2, 4 + 4
    + 2 and 3 + 3 + 3 + 1), windows cut mid-tile, a window of 1 (every
    off-diagonal pair masked) and rows past S that see no key; each also
    bitwise equal over two launches, and from S = 1000 up (but the window
    of 1, whose dq and dk are exactly 0) held to the relative-error gate
    (``_rel_gate``).  Last, bf16 only, three cases at a train step's
    magnitudes (q, k, v drawn x 8, dout x 1e-9, as gemma-2b's first step
    gives them: |q| to ~50, |dout| ~3e-9, LSE ~490), where atol says
    nothing and the gate does: gemma-2b's, recurrentgemma-2b's and
    phi3-mini's heads, all on the wgmma route."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as bk
    from repro_torch.kernels import ref

    cases = [
        # (B, NQ, NKV, S, D, causal, window)
        (1, 2, 2, 128, 32, True, 0), (1, 4, 2, 128, 32, True, 0), (1, 4, 1, 128, 32, True, 0),
        (1, 2, 2, 128, 32, False, 0), (1, 2, 1, 128, 32, True, 48),
        (1, 10, 2, 256, 128, True, 0), (2, 8, 1, 256, 256, True, 0),
        (1, 8, 1, 200, 256, True, 0), (2, 10, 2, 130, 128, False, 40),
        (1, 5, 1, 200, 64, True, 64), (2, 6, 2, 100, 16, True, 0), (1, 4, 4, 77, 256, False, 0),
        # recurrentgemma's local layers: G = 10, D = 256
        (2, 10, 1, 256, 256, True, 0), (1, 10, 1, 200, 256, True, 64),
        # head dims 96 (phi3-mini: 32 heads, MHA) and 80
        (1, 4, 2, 200, 96, True, 0), (2, 4, 4, 130, 80, False, 40), (1, 32, 32, 128, 96, True, 0),
    ]
    # D = 80 / 96: 16 / 32-wide feature boxes, 128 fixed rows a block
    # (hubert-xlarge bidirectional, MHA; phi3-mini causal, MHA; GQA with
    # ragged groups, windows cut mid-tile)
    wgmma_cases = [
        (1, 8, 1, 63, 64, True, 0), (1, 10, 1, 65, 128, True, 0), (1, 8, 1, 1000, 256, True, 0),
        (1, 10, 1, 2047, 256, True, 0), (1, 8, 2, 2048, 128, True, 0),
        (1, 10, 1, 2100, 128, True, 0), (2, 10, 1, 2100, 64, True, 100),
        (1, 8, 1, 3000, 256, True, 0), (1, 10, 1, 2900, 256, False, 0),
        (1, 10, 2, 517, 128, True, 130), (2, 4, 4, 2048, 64, False, 65),
        (1, 4, 2, 1000, 64, True, 1), (1, 2, 1, 1, 256, True, 0),
        (1, 8, 1, 63, 80, True, 0), (1, 10, 1, 65, 96, True, 0), (1, 16, 16, 1000, 80, False, 0),
        (1, 8, 8, 2047, 96, True, 0), (1, 10, 2, 2100, 80, True, 100),
        (2, 4, 4, 2100, 96, False, 65), (1, 10, 1, 1000, 96, True, 130),
        (1, 8, 2, 2047, 80, False, 0),
    ]
    train_scale_cases = [
        (1, 8, 1, 2048, 256, True, 0), (1, 10, 1, 2048, 256, True, 1000),
        (1, 32, 32, 1024, 96, True, 0),
    ]
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for B, NQ, NKV, S, D, causal, window in cases + (
                wgmma_cases if dtype != torch.float32 else []) + (
                train_scale_cases if dtype == torch.bfloat16 else []):
            case = (B, NQ, NKV, S, D, causal, window)
            xs, ds = (8.0, 1e-9) if case in train_scale_cases else (1.0, 1.0)
            q = _randn(torch, (B, S, NQ, D), dtype, gen, xs).transpose(1, 2)
            k = _randn(torch, (B, S, NKV, D), dtype, gen, xs).transpose(1, 2)
            v = _randn(torch, (B, S, NKV, D), dtype, gen, xs).transpose(1, 2)
            dout = _randn(torch, (B, S, NQ, D), dtype, gen, ds).transpose(1, 2)
            out, lse = fk.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                              return_lse=True)
            got = bk.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window)
            want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                                               window=window)
            route = bk.bwd_route(dtype, D)
            tag = (f"flash bwd{(B, NQ, NKV, S, D)} causal={causal} window={window} {dtype} "
                   f"({route})")
            for part, g, w in zip(("dq", "dk", "dv"), got, want):
                _compare(torch, f"{tag} {part}", g, w, dtype)
            if case in wgmma_cases:
                again = bk.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                               window=window)
                check(all(torch.equal(g, g2) for g, g2 in zip(got, again)),
                      f"{tag}: two launches differ (plan "
                      f"{bk.bwd_plan(B, NQ, NKV, S, D, _sm_count(torch))})")
            if (case in wgmma_cases and S >= 1000 and window != 1) or case in train_scale_cases:
                rel = _rel_gate(torch, tag, q, k, v, out, dout, lse, got, causal, window)
                print(f"[kernels] {tag}" + (" at train magnitudes" if xs != 1.0 else "")
                      + ": relative error against float64 (kernel / plain / worst tile's "
                      "ratio) " + ", ".join(f"{p} {a:.5f} / {b:.5f} / {c:.3f}"
                                            for p, (a, b, c) in rel.items()), flush=True)
            n += 1
    return n


def _prefix_sweep(torch, gen) -> int:
    """Prefix-LM attention (the JAX model's ``(causal & window) | (kpos <
    prefix_len[b])``) on every route the frontends reach, forward and
    backward, each against its plain version: f32 (the CUDA-core kernels),
    bf16 and f16 (wgmma at D = 64 / 80 / 96 / 128 / 256, the CUDA-core
    forward and the WMMA backward at D = 32).  Per-row prefix lengths that differ
    within a batch, 0, 1, lengths that end inside a 64-key tile and one
    that is all of S, paligemma's G = 8 and D = 256, a window beside a
    prefix.  The forward (out and LSE) against ``flash_attention_ref``, the
    gradients against the model of the kernels' tile walk
    (``flash_attention_bwd_tiled_ref``, with the wgmma route's head groups),
    at ``_tol``; the wgmma route's gradients also bitwise equal over two
    launches.  (hubert's bidirectional attention at D = 80 is in the flash
    and backward sweeps.)"""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as bk
    from repro_torch.kernels import ref

    # (prefix per row, NQ, NKV, S, D, window)
    cases = [
        ((0, 1, 70, 256), 8, 1, 384, 256, 0), ((256, 100), 8, 1, 300, 256, 0),
        ((1, 0), 4, 2, 130, 128, 0), ((63, 65, 64), 4, 1, 200, 64, 0),
        ((37, 300), 4, 4, 300, 80, 0), ((129, 5), 2, 1, 257, 96, 0),
        ((70, 3), 4, 1, 300, 64, 37), ((200,), 2, 1, 200, 32, 0),
        ((1000, 63), 8, 2, 2100, 80, 0), ((65, 2047), 4, 1, 2047, 96, 100),
    ]
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for prefix, NQ, NKV, S, D, window in cases:
            B = len(prefix)
            q = _randn(torch, (B, S, NQ, D), dtype, gen).transpose(1, 2)
            k = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            v = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            dout = _randn(torch, (B, S, NQ, D), dtype, gen).transpose(1, 2)
            pre = torch.tensor(prefix, dtype=torch.int32, device="cuda")
            kw = dict(window=window, prefix_len=pre)
            route = bk.bwd_route(dtype, D)
            tag = (f"prefix {prefix} flash{(B, NQ, NKV, S, D)} window={window} {dtype} "
                   f"({fk.flash_route(dtype, D)} / {route})")
            out, lse = fk.flash_attention_fwd(q, k, v, return_lse=True, **kw)
            want, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
            _compare(torch, tag, out, want, dtype)
            _compare(torch, tag + " lse", lse, want_lse, torch.float32)
            got = bk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            hpg = bk.bwd_plan(B, NQ, NKV, S, D, _sm_count(torch))[1] if route == "wgmma" else None
            want = ref.flash_attention_bwd_tiled_ref(q, k, v, out, dout, lse,
                                                     heads_per_group=hpg, **kw)
            for part, g, w in zip(("dq", "dk", "dv"), got, want):
                _compare(torch, f"{tag} {part}", g, w, dtype)
            if route == "wgmma":
                again = bk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
                check(all(torch.equal(g, g2) for g, g2 in zip(got, again)),
                      f"{tag}: two launches differ")
            n += 1
    return n


def _hybrid_shapes(torch, gen) -> int:
    """The norm and flash forward kernels against their plain versions at
    the shapes the hybrid serve prefill and the recurrentgemma train step
    give them (bf16, the ``(1 + w)`` norm, the local layers' window);
    prints each with the kernel's and the plain version's times (the flash
    forward's at the train shape, and the flash backward's there, are rows
    of the kernels line)."""
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk

    cfg = get_config(HYBRID_ARCH)
    bf16 = torch.bfloat16
    NQ, NKV, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    n = 0
    for B, S, label, train in ((BATCH, PROMPT, "hybrid serve prefill", False),
                               (TRAIN_BATCH, TRAIN_SEQ, "recurrentgemma training", True)):
        x = _randn(torch, (B, S, cfg.d_model), bf16, gen)
        w = _randn(torch, (cfg.d_model,), torch.float32, gen, scale=0.1)
        err = _compare(torch, f"rms_norm {tuple(x.shape)} offset ({label})",
                       rk.rms_norm_fwd(x, w, offset=True),
                       ref.rms_norm_ref(x, w, offset=True), bf16)
        print(f"[kernels] {label}: rms_norm_fwd x {tuple(x.shape)} bf16 offset: kernel "
              f"{time_ms(torch, lambda: rk.rms_norm_fwd(x, w, offset=True)):.4f} ms, plain "
              f"{time_ms(torch, lambda: ref.rms_norm_ref(x, w, offset=True)):.4f} ms, "
              f"max|err| {err:.3g}", flush=True)
        n += 1
        q = _randn(torch, (B, S, NQ, D), bf16, gen).transpose(1, 2)
        k = _randn(torch, (B, S, NKV, D), bf16, gen).transpose(1, 2)
        v = _randn(torch, (B, S, NKV, D), bf16, gen).transpose(1, 2)
        kw = dict(causal=True, window=window, return_lse=train)
        got, want = fk.flash_attention_fwd(q, k, v, **kw), ref.flash_attention_ref(q, k, v, **kw)
        tag = f"flash q {tuple(q.shape)} window {window} bf16 ({label})"
        if train:
            err = _compare(torch, tag, got[0], want[0], bf16)
            _compare(torch, tag + " lse", got[1], want[1], torch.float32)
        else:
            err = _compare(torch, tag, got, want, bf16)
        n += 1
        if not train:  # the train shape's times are a row of the kernels line
            kernel_ms = time_ms(torch, lambda: fk.flash_attention_fwd(q, k, v, **kw))
            plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw))
            print(f"[kernels] {label}: flash_attention_fwd q {tuple(q.shape)} bf16 window "
                  f"{window}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"max|err| {err:.3g}", flush=True)
    return n


def _full_width_bwd(torch, gen, arch, S=TRAIN_SEQ, prefix=0):
    """The flash backward kernel at a train phase's shape, bf16: gemma-2b q
    (2, 8, 2048, 256) causal and recurrentgemma-2b q (2, 10, 2048, 256)
    with its window of 2048, one kv head each, olmoe-1b-7b's q (2, 16,
    2048, 128) with a kv head per q head (G = 1), paligemma-3b's q (2, 8,
    2304, 256) causal with its 256-key prefix, hubert-xlarge's q (2, 16,
    2048, 80) bidirectional and phi3-mini-3.8b's q (2, 32, 2048, 96)
    causal (16 / 32-wide feature boxes).  Also checks that two
    launches are bitwise equal, holds the gradients to the relative-error
    gate and, with a prefix or bidirectional, to the model of the kernel's
    tile walk (``ref.flash_attention_bwd_tiled_ref``), and prints the
    kernel's eager time beside SDPA's eager backward, like with like."""
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as bk

    cfg = get_config(arch)
    bf16 = torch.bfloat16
    B, NQ, NKV, D = TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window, causal = cfg.window or 0, cfg.causal
    q = _randn(torch, (B, S, NQ, D), bf16, gen).transpose(1, 2)
    k = _randn(torch, (B, S, NKV, D), bf16, gen).transpose(1, 2)
    v = _randn(torch, (B, S, NKV, D), bf16, gen).transpose(1, 2)
    dout = _randn(torch, (B, S, NQ, D), bf16, gen).transpose(1, 2)
    pre = torch.full((B,), prefix, dtype=torch.int32, device="cuda") if prefix else None
    kw = dict(causal=causal, window=window, prefix_len=pre)
    out, lse = fk.flash_attention_fwd(q, k, v, return_lse=True, **kw)

    def kernel():
        return bk.flash_attention_bwd(q, k, v, out, dout, lse, **kw)

    def plain():
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, **kw)

    first, second = kernel(), kernel()
    err = max(_compare(torch, f"flash bwd full width {arch} {part}", g, w, bf16)
              for part, g, w in zip(("dq", "dk", "dv"), first, plain()))
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          f"flash bwd full width {arch}: two launches differ")
    route = bk.bwd_route(bf16, D)
    plan = bk.bwd_plan(B, NQ, NKV, S, D, _sm_count(torch)) if route == "wgmma" else None
    if prefix or not causal:
        tiled = ref.flash_attention_bwd_tiled_ref(
            q, k, v, out, dout, lse, heads_per_group=plan[1] if plan else None, **kw)
        for part, g, w in zip(("dq", "dk", "dv"), first, tiled):
            _compare(torch, f"flash bwd full width {arch} {part} vs the tiled model", g, w, bf16)
        del tiled
    rel = _rel_gate(torch, f"flash bwd full width {arch}", q, k, v, out, dout, lse, first,
                    causal, window, prefix_len=pre)
    print(f"[kernels] flash_attention_bwd {arch}: relative error against float64 (kernel / "
          f"plain bf16 version / worst 64-row tile's ratio): "
          + ", ".join(f"{p} {a:.5f} / {b:.5f} / {c:.3f}" for p, (a, b, c) in rel.items()),
          flush=True)
    # The library yardstick: the backward of SDPA alone (its forward runs
    # once, outside the timing), through torch.autograd.grad; a window of S
    # is causal attention, a prefix a boolean mask.
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = _attention_library(torch, qq, kk, vv, causal, window, pre)()

    def library():
        return torch.autograd.grad(o, (qq, kk, vv), dout, retain_graph=True)

    # q, k, v, out, dout and the f32 LSE read once; dq, dk, dv written once.
    # The function needs five S x S x D products over the visible (q, k)
    # pairs: s = q.k^T, dp = dout.v^T, dv = p^T.dout, dq = ds.k,
    # dk = ds^T.q.  (This kernel's dq pass recomputes s and dp and it adds
    # p's rounding remainder to dv, eight in all: that is its own cost, not
    # the bound's.)
    bound_ms, bound_by = cost.flash_bwd_work(
        B, NQ, NKV, S, D, q.element_size(),
        B * cost.visible_pairs(S, causal=causal, window=window, prefix=prefix)).bound()
    mask = _mask_label(causal, window, prefix)
    e = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention_bwd.py:161", max_abs_err=err,
        shape=f"q {tuple(q.shape)} kv heads {NKV} bf16 {mask} ({arch} training, {route})",
        ms=time_ms(torch, kernel, launches=5),
        eager_ms=time_ms(torch, kernel, launches=5, graph=False),
        plain_ms=time_ms(torch, plain, launches=5),
        library_ms=time_ms(torch, library, launches=5, graph=False),
        library="SDPA backward (eager)", bound_ms=bound_ms, bound_by=bound_by,
    )
    print(f"[kernels] flash_attention_bwd {arch}: route {route}, plan (rows, "
          f"heads per group, groups) {plan}, two launches bitwise equal; eager {e['eager_ms']:.4f}"
          f" ms vs SDPA backward eager {e['library_ms']:.4f} ms ({e['eager_ms'] / e['library_ms']:.2f}"
          f"x); device (graph) {e['ms']:.4f} ms, {e['ms'] / e['bound_ms']:.2f}x its bound",
          flush=True)
    return e


def _full_width_paged(torch, full, gen):
    """The paged kernel at the continuous serve phase's tier-l shapes: one
    decode step of the full 8-slot batch at position 128 (the prompt plus
    the first token), each row's pages scattered over the 145-page pool."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import decode_attention as dk

    bf16 = torch.bfloat16
    B, NQ, NKV, D = N_SLOTS, full["n_heads"], full["n_kv_heads"], full["head_dim"]
    G = NQ // NKV
    NB = -(-(full["prompt"] + full["gen"]) // PAGE)
    P = 1 + B * NB
    q = _randn(torch, (B, NKV, G, D), bf16, gen)
    kp = _randn(torch, (P, PAGE, NKV, D), bf16, gen).transpose(1, 2)
    vp = _randn(torch, (P, PAGE, NKV, D), bf16, gen).transpose(1, 2)
    perm = 1 + torch.randperm(P - 1, generator=gen)
    tables = perm.to(torch.int32).reshape(B, NB).cuda()
    valid = full["prompt"] + 1
    pos = torch.full((B,), valid - 1, dtype=torch.int32, device="cuda")

    def kernel():
        return dk.decode_attention_paged_fwd(q, kp, vp, tables, pos)

    def plain():
        return ref.decode_attention_paged_ref(q, kp, vp, tables, pos)

    got = kernel()
    err = _compare(torch, "paged decode full width", got, plain(), bf16)
    check(all(torch.equal(got, kernel()) for _ in range(5)),
          "paged decode full width: output differs from run to run")
    heads, n_split = dk.paged_launch_plan(q, NB * PAGE)
    blocks = n_split * B * NKV * -(-G // heads)
    check(blocks >= _sm_count(torch), f"paged decode full width: {blocks} blocks, under a wave")
    # The library yardstick: SDPA over the dense view gathered beforehand
    # (no single PyTorch call reads page tables); the gather is not timed.
    flat = (tables.long()[:, :, None] * PAGE + torch.arange(PAGE, device="cuda")).reshape(B, -1)
    kd = kp.transpose(1, 2).reshape(P * PAGE, NKV, D)[flat].transpose(1, 2)
    vd = vp.transpose(1, 2).reshape(P * PAGE, NKV, D)[flat].transpose(1, 2)
    mask = (torch.arange(NB * PAGE, device="cuda") <= pos[:, None])[:, None, None, :]
    qs = q.reshape(B, NQ, 1, D)
    # Live keys only: k and v of positions 0..pos once, q read, out written.
    bound_ms, bound_by = cost.paged_decode_work(B, NQ, NKV, D, NB, q.element_size(),
                                                B * valid).bound()
    # The same kernel with the ring planner's split alone (one wave of SMs,
    # not of resident blocks): what the resident-wave plan gains.
    launch_plan = dk.paged_launch_plan
    ring_heads, ring_split, _ = dk.split_plan(B, NKV, G, NB * PAGE, _sm_count(torch))
    dk.paged_launch_plan = lambda q_, S_: (ring_heads, ring_split)
    try:
        _compare(torch, "paged decode full width, ring plan", kernel(), plain(), bf16)
        ring_plan_ms = time_ms(torch, kernel)
    finally:
        dk.paged_launch_plan = launch_plan
    print(f"[kernels] decode_attention_paged_fwd with the ring planner's {ring_split} chunks "
          f"({ring_split * B * NKV * -(-G // ring_heads)} blocks): {ring_plan_ms:.4f} ms",
          flush=True)
    return dict(
        name="decode_attention_paged_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:207", max_abs_err=err,
        shape=f"q {tuple(q.shape)} pool {(P, PAGE, NKV, D)} {valid} live keys bf16 "
              f"({blocks} blocks, {heads} heads x {n_split} chunks of the live span; "
              "bitwise stable)",
        ms=time_ms(torch, kernel), eager_ms=time_ms(torch, kernel, graph=False),
        plain_ms=time_ms(torch, plain),
        library_ms=time_ms(torch, lambda: _sdpa(torch, qs, kd, vd, attn_mask=mask)),
        library="SDPA on the pre-gathered dense view", ring_plan_ms=ring_plan_ms,
        bound_ms=bound_ms, bound_by=bound_by,
    )


def _full_width(torch, full, B, gen):
    """Kernel vs plain vs library vs bound at the serve phase's qwen3-14b shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import rmsnorm as rk

    bf16 = torch.bfloat16
    S, d = full["prompt"], full["d_model"]
    NQ, NKV, D, S_cache = full["n_heads"], full["n_kv_heads"], full["head_dim"], full["max_len"]
    entries = []

    x = _randn(torch, (B, S, d), bf16, gen)
    w = torch.ones(d, device="cuda")
    err = _compare(torch, "rms_norm full width", rk.rms_norm_fwd(x, w), ref.rms_norm_ref(x, w), bf16)
    bound_ms, bound_by = cost.rms_norm_work(x.numel(), x.element_size(), w.numel(),
                                            w.element_size()).bound()
    entries.append(dict(
        name="rms_norm_fwd", route="triton", source="src/repro_torch/kernels/rmsnorm.py",
        replaces="src/repro/kernels/rmsnorm.py:43", max_abs_err=err,
        shape=f"x {tuple(x.shape)} bf16 (ln1/ln2 at prefill)",
        ms=time_ms(torch, lambda: rk.rms_norm_fwd(x, w)),
        eager_ms=time_ms(torch, lambda: rk.rms_norm_fwd(x, w), graph=False),
        plain_ms=time_ms(torch, lambda: ref.rms_norm_ref(x, w)),
        library_ms=time_ms(torch, lambda: F.rms_norm(x, (d,), w.to(bf16), 1e-6)),
        bound_ms=bound_ms, bound_by=bound_by,
    ))

    entries.append(_flash_row(torch, gen, B, NQ, NKV, S, D, 0, False, "prefill"))
    entries.append(_decode_row(torch, gen, B, NKV, NQ // NKV, D, S_cache, S + 1, "tier-l"))
    return entries


def _mask_label(causal, window, prefix):
    return (("causal" if causal else "bidirectional") + (f" window {window}" if window else "")
            + (f" prefix {prefix}" if prefix else ""))


def _attention_library(torch, q, k, v, causal, window, prefix_len):
    """One PyTorch call computing the same attention: SDPA, causal,
    bidirectional or with the prefix-LM mask as a boolean ``attn_mask``."""
    from repro_torch.kernels import ref

    S = q.shape[2]
    if prefix_len is not None:
        mask = ref._scores_mask(S, S, causal=causal, window=window, device="cuda",
                                prefix_len=prefix_len)[:, 0]  # (B, 1, S, S)
        return lambda q=q, k=k, v=v: _sdpa(torch, q, k, v, attn_mask=mask)
    check(window in (0, S) or not causal, f"SDPA has no window of {window} < S")
    return lambda q=q, k=k, v=v: _sdpa(torch, q, k, v, is_causal=causal)


def _flash_row(torch, gen, B, NQ, NKV, S, D, window, lse, label, causal=True, prefix=0):
    """The flash forward at q (B, NQ, S, D), bf16, model-layout views, causal
    or bidirectional, with a prefix-LM prefix of ``prefix`` keys on every
    row when it is not 0: kernel vs plain vs SDPA vs bound (with the f32 LSE
    the train path keeps when ``lse``)."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import flash_attention as fk

    bf16 = torch.bfloat16
    q = _randn(torch, (B, S, NQ, D), bf16, gen).transpose(1, 2)
    k = _randn(torch, (B, S, NKV, D), bf16, gen).transpose(1, 2)
    v = _randn(torch, (B, S, NKV, D), bf16, gen).transpose(1, 2)
    pre = torch.full((B,), prefix, dtype=torch.int32, device="cuda") if prefix else None
    kw = dict(causal=causal, window=window, return_lse=lse, prefix_len=pre)

    def kernel():
        return fk.flash_attention_fwd(q, k, v, **kw)

    def plain():
        return ref.flash_attention_ref(q, k, v, **kw)

    got, want = kernel(), plain()
    mask = _mask_label(causal, window, prefix)
    tag = f"flash q {tuple(q.shape)} {mask} ({label})"
    if lse:
        err = _compare(torch, tag, got[0], want[0], bf16)
        _compare(torch, tag + " lse", got[1], want[1], torch.float32)
    else:
        err = _compare(torch, tag, got, want, bf16)
    # q, k, v read once; out (and the LSE) written once.  The visible
    # (q, k) pairs, two products of 2 * D FLOPs each.
    bound_ms, bound_by = cost.flash_fwd_work(
        B, NQ, NKV, S, D, q.element_size(),
        B * cost.visible_pairs(S, causal=causal, window=window, prefix=prefix), lse=lse).bound()
    reps = 5 if S > 512 else 20  # launches per timed replay
    return dict(
        name="flash_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:119", max_abs_err=err,
        shape=f"q {tuple(q.shape)} kv heads {NKV} bf16 {mask}{' +lse' if lse else ''} ({label})",
        ms=time_ms(torch, kernel, reps), eager_ms=time_ms(torch, kernel, reps, graph=False),
        plain_ms=time_ms(torch, plain, reps),
        library_ms=time_ms(torch, _attention_library(torch, q, k, v, causal, window, pre), reps),
        bound_ms=bound_ms, bound_by=bound_by,
    )


def _decode_lse_sweep(torch, gen) -> int:
    """The ring decode with its log-sum-exp (``return_lse``, what the
    tensor-parallel decode folds the ranks' rows by) against the plain
    version's, out and LSE, and out bitwise the call without it: a rank's
    slot slice at llama3-8b's, gemma-2b's and recurrentgemma-2b's
    tensor-parallel decode shapes with live slots and with none at all (an
    LSE of -1e30, the mean of v), small ragged cases, a window, every
    dtype.  (B, NKV, G, S, D, window, live): the first ``live`` slots valid,
    the rest empty; ``pos`` the last live slot, or 527 with none."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref

    cases = [(4, 8, 4, 2048, 128, 0, 528), (4, 8, 4, 2048, 128, 0, 0),
             (4, 1, 2, 2048, 256, 0, 528), (4, 1, 2, 2048, 256, 0, 0),
             (4, 1, 5, 1024, 256, 2048, 512), (4, 1, 5, 1024, 256, 2048, 0),
             (2, 2, 2, 256, 64, 16, 200), (3, 2, 5, 33, 64, 0, 20), (2, 1, 10, 7, 80, 0, 0)]
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for B, NKV, G, S, D, window, live in cases:
            q = _randn(torch, (B, NKV, G, D), dtype, gen)
            kc = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            vc = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            sp = torch.where(torch.arange(S) < live, torch.arange(S), -1).to(torch.int32)
            sp = sp.expand(B, S).contiguous().cuda()
            pos = torch.full((B,), live - 1 if live else 527, dtype=torch.int32, device="cuda")
            out, lse = dk.decode_attention_fwd(q, kc, vc, sp, pos, window=window,
                                               return_lse=True)
            want, want_lse = ref.decode_attention_ref(q, kc, vc, sp, pos, window=window,
                                                      return_lse=True)
            tag = f"decode{(B, NKV, G, S, D)} window={window} live={live} {dtype} +lse"
            _compare(torch, tag, out, want, dtype)
            _compare(torch, tag + " lse", lse, want_lse, torch.float32)
            check(torch.equal(out, dk.decode_attention_fwd(q, kc, vc, sp, pos, window=window)),
                  f"{tag}: out differs from the call without the LSE")
            if not live:
                check(bool((lse == -1e30).all()), f"{tag}: LSE {lse.flatten()[:4]} with no "
                      "valid slot, want the -1e30 sentinel")
            n += 1
    return n


def _decode_row(torch, gen, B, NKV, G, D, S_cache, valid, label, lse=False):
    """The ring decode at one decode step of a served batch: q (B, NKV, G, D)
    over a (B, S_cache, NKV, D) ring cache whose first ``valid`` slots are
    live; kernel vs plain vs SDPA vs bound, and the output bitwise the same
    over five calls.  With ``lse`` the kernel and the plain version also
    return the rows' log-sum-exp."""
    from repro_torch.kernels import cost, ref
    from repro_torch.kernels import decode_attention as dk

    bf16 = torch.bfloat16
    NQ = NKV * G
    qd = _randn(torch, (B, NKV, G, D), bf16, gen)
    kc = _randn(torch, (B, S_cache, NKV, D), bf16, gen).transpose(1, 2)
    vc = _randn(torch, (B, S_cache, NKV, D), bf16, gen).transpose(1, 2)
    sp = torch.where(torch.arange(S_cache) < valid, torch.arange(S_cache), -1)
    sp = sp.to(torch.int32).expand(B, S_cache).contiguous().cuda()
    pos = torch.full((B,), valid - 1, dtype=torch.int32, device="cuda")

    def kernel():
        return dk.decode_attention_fwd(qd, kc, vc, sp, pos, return_lse=lse)

    def plain():
        return ref.decode_attention_ref(qd, kc, vc, sp, pos, return_lse=lse)

    got, want = kernel(), plain()
    err = _compare(torch, f"decode full width ({label})", got[0] if lse else got,
                   want[0] if lse else want, bf16)
    if lse:
        _compare(torch, f"decode full width ({label}) lse", got[1], want[1], torch.float32)
    check(all(torch.equal(got[0] if lse else got, kernel()[0] if lse else kernel())
              for _ in range(5)),
          f"decode full width ({label}): output differs from run to run")
    heads, n_split, chunk = dk.split_plan(B, NKV, G, S_cache, _sm_count(torch))
    blocks = n_split * B * NKV * -(-G // heads)
    mask = (sp >= 0) & (sp <= pos[:, None])
    bound_ms, bound_by = cost.decode_work(B, NQ, NKV, D, S_cache, qd.element_size(),
                                          B * valid, lse=lse).bound()
    return dict(
        name="decode_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:88", max_abs_err=err,
        shape=f"q {tuple(qd.shape)} cache {(B, S_cache, NKV, D)} {valid} live slots bf16 "
              f"{'+lse ' if lse else ''}({label}: {blocks} blocks, {heads} heads x {n_split} "
              f"chunks of {chunk}; bitwise stable)",
        ms=time_ms(torch, kernel), eager_ms=time_ms(torch, kernel, graph=False),
        plain_ms=time_ms(torch, plain),
        library_ms=time_ms(torch, lambda: _sdpa(
            torch, qd.reshape(B, NQ, 1, D), kc, vc, attn_mask=mask[:, None, None, :])),
        bound_ms=bound_ms, bound_by=bound_by,
    )


# ---------------------------------------------------------------------------
# Phase 4: small models, card vs CPU.
# ---------------------------------------------------------------------------
def phase_model(torch):
    import dataclasses

    from repro_torch.configs.archs import get_config, reduced
    from repro_torch.configs.mdinference_zoo import ONDEVICE_HEDGE
    from repro_torch.launch.serve import tier_configs
    from repro_torch.models import transformer as T

    models = [(name, cfg) for name, cfg, _ in tier_configs()]
    models.append(("hedge", ONDEVICE_HEDGE.config()))
    # One period of (recurrent, recurrent, local) and the (recurrent,
    # recurrent) epilogue; window 32, so 16 decode steps wrap the ring.
    models.append(("hybrid", reduced(HYBRID_ARCH, n_layers=5)))
    # phi3-mini at its full width (d 3072, 32 heads x 96, MHA), 2 layers, f32.
    models.append(("phi3", get_config(PHI3_ARCH, n_layers=2, dtype="float32")))
    # olmoe at its full width (d 2048, 64 experts top-8, qk-norm), 2 layers, f32.
    models.append(("olmoe", get_config(MOE_ARCH, n_layers=2, dtype="float32")))
    for name, cfg in models:
        cpu_params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        gpu_params = T.params_to(cpu_params, "cuda")
        _card_vs_cpu(torch, name, cfg, cpu_params, gpu_params, S=24)
        if T.supports_paged_decode(cfg):  # recurrent state is not paged
            _model_paged(torch, name, cfg, cpu_params, gpu_params)
        if name.startswith("tier-"):  # the int8 ring cache on the same weights
            _model_int8(torch, name, dataclasses.replace(cfg, kv_cache_quant=True), cpu_params,
                        gpu_params)
        if name != "hedge":
            _model_grads(torch, name, cfg, cpu_params, f64_reference=name == "phi3")
        del cpu_params, gpu_params
    _model_bf16_grads(torch, get_config(TRAIN_ARCHS[0], n_layers=2))
    _model_bf16_grads(torch, get_config(MOE_ARCH, n_layers=2))
    _model_bf16_grads(torch, get_config(PHI3_ARCH, n_layers=2))


def _model_bf16_grads(torch, cfg):
    """``loss_fn``'s bf16 gradient through the flash backward's tensor-core
    routes, leaf by leaf, on the card: gemma-2b at its full width (d 2048,
    8 q heads / 1 kv head x 256, bf16) and olmoe-1b-7b at its (d 2048, 16 q
    / 16 kv heads x 128, 64 experts top-8), 2 layers each, batch 2 x 2048
    tokens (the train phase's attention shapes); the frontends' train
    commands add paligemma-3b (its 256 patches before the 2048 tokens,
    prefix-LM) and hubert-xlarge (2048 frames, bidirectional, D = 80), and
    the model phase phi3-mini-3.8b (d 3072, 32 heads x 96, MHA), each batch
    the train pipeline's first.  Three runs differ only in
    the attention backward, the forward being the same kernels (a swapped
    forward could flip a near-tied top-k choice and move whole expert
    leaves): the kernel; the plain version (``ref.flash_attention_bwd_ref``,
    f32, p and ds not rounded); and the plain version of the kernel's
    arithmetic (``_bwd_f64`` with p and ds rounded to bf16, p as the
    route rounds it).  Each leaf of
    the kernel's run stays within REL_GATE times the rounded plain run's
    relative Frobenius distance from the f32 plain run, plus REL_FLOOR;
    every leaf finite and non-zero (but hubert's token embedding, which no
    input reaches, in the JAX tree as here: zero).  For the MoE stack the kernel's run is
    made twice and must be bitwise the same (the combine's index backward
    accumulates, dropped assignments adding exact zeros).  The model
    phase's other gradient checks are f32 (the CUDA-core route)."""
    from repro_torch.kernels import flash_attention_bwd as bk
    from repro_torch.kernels import ref
    from repro_torch.models import transformer as T
    from repro_torch.tree import named_leaves, tree_map

    B, S = TRAIN_BATCH, TRAIN_SEQ
    route = bk.bwd_route(torch.bfloat16, cfg.head_dim)
    check(route in ("wgmma", "wmma") and cfg.dtype == "bfloat16",
          f"model bf16 grads: {cfg.name} does not take a tensor-core route")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    if cfg.frontend == "none":
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                             generator=torch.Generator().manual_seed(4))
        batch = {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda()}
    else:  # frames or patches: the train pipeline's batch
        from repro_torch.training import DataConfig, make_pipeline

        pipe = make_pipeline(DataConfig(batch_size=B, seq_len=S, seed=4), cfg)
        batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(0).items()}
    unused = T.unreached_leaves(cfg)

    def rounded(q, k, v, out, dout, lse, *, causal=True, window=0, scale=None, prefix_len=None):
        return tuple(t.to(q.dtype) for t in _bwd_f64(
            torch, q, k, v, out, dout, lse, causal, window, round_to=q.dtype, scale=scale,
            split_p=route == "wgmma", prefix_len=prefix_len))

    kernel = bk.flash_attention_bwd
    moe = "moe" in cfg.layer_kinds()
    runs = {}
    try:
        for label, bwd in ((("kernel", kernel),) + ((("again", kernel),) if moe else ())
                           + (("plain", ref.flash_attention_bwd_ref), ("rounded", rounded))):
            bk.flash_attention_bwd = bwd
            leaves = tree_map(lambda p: p.detach().clone().requires_grad_(p.is_floating_point()),
                              params)
            named = [(path, leaf) for path, leaf in named_leaves(leaves) if leaf.requires_grad]
            loss, _ = T.loss_fn(cfg, leaves, batch)
            runs[label] = (float(loss.detach()),
                           torch.autograd.grad(loss, [leaf for _, leaf in named],
                                               allow_unused=True, materialize_grads=True))
    finally:
        bk.flash_attention_bwd = kernel
    check(runs["kernel"][0] == runs["plain"][0], "model bf16 grads: the forwards differ")
    if moe:
        check(all(torch.equal(a, b) for a, b in zip(runs["kernel"][1], runs["again"][1])),
              f"model bf16 grads: {cfg.name}'s gradient differs between two runs")
        del runs["again"]
    worst_k = worst_r = worst_ratio = 0.0
    for (path, _), g, p, r in zip(named, runs["kernel"][1], runs["plain"][1], runs["rounded"][1]):
        if path in unused:
            check(not g.any(), f"model bf16 grads: {path} reached by no input, but non-zero")
            continue
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
              f"model bf16 grads: gradient {path} zero or not finite through the kernel")
        norm = max(float(p.double().norm()), 1e-300)
        dk, dr = (float((x.double() - p.double()).norm()) / norm for x in (g, r))
        check(dk <= REL_GATE * dr + REL_FLOOR,
              f"model bf16 grads: gradient {path} {dk:.4g} (relative) from the plain f32 "
              f"backward's run, beyond {REL_GATE}x the rounded plain version's {dr:.4g}")
        worst_k, worst_r = max(worst_k, dk), max(worst_r, dr)
        worst_ratio = max(worst_ratio, dk / max(dr, REL_FLOOR))
    print(f"[model] {cfg.name} width, {cfg.n_layers} layers, bf16, batch {B} x {S}: loss_fn + "
          f"grads with the {route} backward vs the plain f32 backward, {len(named)} leaves, "
          f"all non-zero{f' but {sorted(unused)} (no input reaches it)' if unused else ''}"
          f"{', bitwise equal over two runs' if moe else ''}: "
          f"worst relative distance {worst_k:.4g} (the plain version of the kernel's "
          f"arithmetic: {worst_r:.4g}; worst leaf's ratio {worst_ratio:.3f}, gate {REL_GATE})",
          flush=True)
    del params, runs
    torch.cuda.empty_cache()


def _model_int8(torch, name, cfg, cpu_params, gpu_params, S=24, ring=16, B=2, steps=16):
    """The int8 ring cache (``cfg.kv_cache_quant``) card against CPU: a
    prefill of ``S`` tokens into a ring of ``ring`` slots (its write wraps)
    and ``steps`` greedy decode steps (each quantises its write and
    dequantises the whole ring before the ring kernel).

    The card's and the CPU's f32 keys and values differ in their last bits,
    and a code flips where one lies within rounding of a code boundary,
    moving that key's score by a whole code step.  So the checked CPU run
    quantises the card's keys and values (recorded at every call, in call
    order) in place of its own: the prefill's int8 codes and scales must be
    bitwise the card's (the quantisation's arithmetic and the wrapped
    write), and the logits allclose (atol 1e-3, rtol 1e-3) with tokens
    equal (the dequantise and the ring kernel against the plain version).
    A free-running CPU run is reported beside it: the codes that differ and
    its logits' distance."""
    from repro_torch.models import transformer as T

    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(5))
    quant, card_x = T._kv_quant, []

    def recording(x):
        card_x.append(x.to("cpu", copy=True))
        return quant(x)

    def replaying(x):
        return quant(forced.pop(0).to(x.dtype))

    runs = {}
    for run, device, params in (("card", "cuda", gpu_params), ("free", "cpu", cpu_params),
                                ("forced", "cpu", cpu_params)):
        forced = list(card_x)
        T._kv_quant = {"card": recording, "free": quant, "forced": replaying}[run]
        try:
            with torch.inference_mode():
                cache, logits = T.prefill(cfg, params, {"tokens": tokens.to(device)}, ring)
                # Copies: the decode steps below update the cache in place.
                codes = [(layer[k].to("cpu", copy=True), layer[k + "_scale"].to("cpu", copy=True))
                         for layer in cache["periods"] for k in ("k", "v")]
                all_logits, toks, tok = [logits.float().cpu()], [], logits.argmax(-1)
                for i in range(steps):
                    toks.append(tok.cpu())
                    pos = torch.full((B,), S + i, dtype=torch.int32, device=device)
                    logits, cache = T.decode_step(cfg, params, cache, tok, pos)
                    all_logits.append(logits.float().cpu())
                    tok = logits.argmax(-1)
        finally:
            T._kv_quant = quant
        runs[run] = (torch.stack(all_logits), torch.stack(toks), codes)
    check(len(card_x) == 2 * cfg.n_layers * (1 + steps) and not forced,
          f"model {name} int8: {len(card_x)} quantisations on the card")
    check(all(torch.equal(a, b) for (qc, sc), (qf, sf) in zip(runs["card"][2], runs["forced"][2])
              for a, b in ((qc, qf), (sc, sf))),
          f"model {name} int8: the prefill's codes or scales differ from the CPU's on the same "
          "keys and values")
    off = sum(int((qc != qh).sum()) for (qc, _), (qh, _) in zip(runs["card"][2], runs["free"][2]))
    total = sum(qc.numel() for qc, _ in runs["card"][2])
    err = float((runs["card"][0] - runs["forced"][0]).abs().max())
    free = float((runs["card"][0] - runs["free"][0]).abs().max())
    check(bool(torch.allclose(runs["card"][0], runs["forced"][0], atol=1e-3, rtol=1e-3)),
          f"model {name} int8: card vs CPU logits max |err| {err:.3g} beyond atol 1e-3")
    check(bool(torch.equal(runs["card"][1], runs["forced"][1])),
          f"model {name} int8: greedy tokens differ between card and CPU")
    print(f"[model] {name:6s} int8 ring: prefill of {S} into {ring} slots + {steps} greedy "
          f"steps, the CPU quantising the card's keys and values: codes and scales of the "
          f"prefill bitwise equal, logits max|err| {err:.3g} (atol 1e-3), tokens equal; free-"
          f"running CPU: {off} of {total} prefill codes differ, logits max|err| {free:.3g}, "
          f"tokens {'equal' if torch.equal(runs['card'][1], runs['free'][1]) else 'differ'}",
          flush=True)


def _card_vs_cpu(torch, name, cfg, cpu_params, gpu_params, S, B=2, steps=16):
    """Prefill of (B, S) seeded tokens plus ``steps`` greedy decode steps on
    the card through the kernels and on the CPU through the plain versions:
    logits allclose (atol 1e-3, rtol 1e-3), tokens equal."""
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    runs = {where: _prefill_decode(torch, cfg, params, tokens.to(device), steps)
            for where, params, device in (("card", gpu_params, "cuda"), ("cpu", cpu_params, "cpu"))}
    err = float((runs["card"][0] - runs["cpu"][0]).abs().max())
    scale = float(runs["cpu"][0].abs().max())
    check(bool(torch.allclose(runs["card"][0], runs["cpu"][0], atol=1e-3, rtol=1e-3)),
          f"model {name}: card vs CPU logits max |err| {err:.3g} (largest logit {scale:.3g}) "
          "beyond atol 1e-3 rtol 1e-3")
    check(bool(torch.equal(runs["card"][1], runs["cpu"][1])),
          f"model {name}: greedy tokens differ between card and CPU")
    print(f"[model] {name:6s} {cfg.name}: prefill of {S} + {steps} greedy steps, card vs CPU "
          f"logits max|err| {err:.3g} of largest {scale:.3g} (atol 1e-3), tokens equal",
          flush=True)


def _model_grads(torch, name, cfg, cpu_params, f64_reference=False):
    """``loss_fn`` and every parameter gradient (remat on, labels < 0
    ignored), card against CPU, in f32.  Tolerance: the loss to atol 1e-4;
    each gradient leaf elementwise within 2e-3 of its own largest entry
    plus rtol 1e-3 — the reduced tiers' stacked weights are drawn with
    fan-in = period count, so activations grow through the stack and
    amplify summation-order differences; a gradient cut at a norm or an
    attention is off by the whole leaf.  Every leaf must be finite and
    non-zero on the card.

    ``f64_reference`` (full-width phi3): at d 3072 that growth makes f32
    itself the limit — the card with the plain attention backward in place
    of the kernel is as far from the CPU as with it.  So each leaf is held
    against the same gradient computed in float64 on the CPU: the card's
    max error within three times the CPU f32 gradient's own max error (or
    2e-3 of the leaf's largest entry), so the card is as exact as f32 on
    the CPU; both errors are printed."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.tree import named_leaves, tree_map

    B, S = 2, 64
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=torch.Generator().manual_seed(3))
    labels = toks[:, 1:].clone()
    labels[0, :5] = -1
    runs = {}
    f64 = torch.float64
    cases = (("cuda", None), ("cpu", None)) + ((("cpu", f64),) if f64_reference else ())
    for device, dtype in cases:
        c = cfg if dtype is None else dataclasses.replace(cfg, dtype="float64")
        params = tree_map(lambda p: p.detach().to(device, dtype=dtype if p.is_floating_point()
                                                  else None, copy=True).requires_grad_(True),
                          cpu_params)
        named = list(named_leaves(params))
        batch = {"tokens": toks[:, :-1].to(device), "labels": labels.to(device)}
        loss, metrics = T.loss_fn(c, params, batch)
        grads = torch.autograd.grad(loss, [leaf for _, leaf in named])
        runs[device if dtype is None else "f64"] = (
            float(loss.detach()), float(metrics["tokens"]),
            [(path, g.to(torch.float64 if f64_reference else torch.float32).cpu())
             for (path, _), g in zip(named, grads)])
    (loss_c, tok_c, card), (loss_h, tok_h, host) = runs["cuda"], runs["cpu"]
    check(tok_c == tok_h == B * S - 5, f"model {name} grads: {tok_c} / {tok_h} valid labels")
    check(abs(loss_c - loss_h) <= 1e-4,
          f"model {name} grads: loss card {loss_c} vs CPU {loss_h} beyond atol 1e-4")
    worst = worst_cpu = 0.0
    for i, ((path, a), (_, b)) in enumerate(zip(card, host)):
        scale = float(b.abs().max())
        check(bool(torch.isfinite(a).all()), f"model {name}: gradient {path} not finite on the card")
        check(float(a.abs().max()) > 0, f"model {name}: gradient {path} is zero on the card")
        if f64_reference:
            exact = runs["f64"][2][i][1]
            err, own = float((a - exact).abs().max()), float((b - exact).abs().max())
            rel = err / float(exact.abs().max())
            worst_cpu = max(worst_cpu, own / float(exact.abs().max()))
            check(err <= max(3 * own, 2e-3 * float(exact.abs().max())),
                  f"model {name}: gradient {path} card vs float64 max |err| {err:.3g}, beyond "
                  f"three times the CPU f32 gradient's {own:.3g}")
        else:
            rel = float((a - b).abs().max()) / scale
            check(bool(torch.allclose(a, b, atol=2e-3 * scale, rtol=1e-3)),
                  f"model {name}: gradient {path} card vs CPU max |err| {rel:.3g} of its "
                  "largest entry, beyond 2e-3 + rtol 1e-3")
        worst = max(worst, rel)
    against = (f"float64 CPU gradient, within 3x the CPU f32 gradient's own error; the CPU "
               f"f32 gradient's worst {worst_cpu:.3g}" if f64_reference else "tolerance 2e-3")
    print(f"[model] {name:6s} loss_fn + grads (remat): loss card {loss_c:.6f} CPU {loss_h:.6f}; "
          f"{len(card)} gradient leaves, all non-zero on the card, worst max|err| "
          f"{worst:.3g} of the leaf's largest entry ({against})", flush=True)


def _model_paged(torch, name, cfg, cpu_params, gpu_params):
    """The paged path, card vs CPU: ``prefill_ragged`` of two rows (lengths
    24 and 17), one graft into scattered pages, then 16 greedy
    ``paged_decode_step``s of a 4-slot batch whose other two slots are
    inactive (pos 0, all-trash tables)."""
    from repro_torch.models import transformer as T

    W, steps, NB, n_slots = 24, 16, 5, 4
    lengths = torch.tensor([24, 17], dtype=torch.int32)
    tables = torch.zeros((n_slots, NB), dtype=torch.int32)
    tables[0] = torch.tensor([3, 7, 1, 12, 5])
    tables[2] = torch.tensor([20, 2, 9, 14, 6])
    tokens = torch.randint(0, cfg.vocab_size, (2, W), generator=torch.Generator().manual_seed(2))
    runs = {}
    for device, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        with torch.inference_mode():
            pool = T.init_paged_cache(cfg, 1 + n_slots * NB, PAGE, device=device)
            dense, logits = T.prefill_ragged(cfg, params, {"tokens": tokens.to(device)},
                                             lengths.to(device), max_len=W)
            T.graft_prefill_batch(cfg, pool, dense, tables[[0, 2]].to(device), PAGE)
            tok = torch.zeros(n_slots, dtype=torch.long, device=device)
            pos = torch.zeros(n_slots, dtype=torch.int32, device=device)
            tok[[0, 2]] = logits.argmax(-1)
            pos[[0, 2]] = lengths.to(device)
            all_logits, toks = [logits.float().cpu()], []
            for _ in range(steps):
                toks.append(tok[[0, 2]].cpu())
                step_logits, _ = T.paged_decode_step(cfg, params, pool, tables.to(device),
                                                     tok, pos, PAGE)
                all_logits.append(step_logits[[0, 2]].float().cpu())
                tok = torch.where(pos > 0, step_logits.argmax(-1), 0)
                pos = torch.where(pos > 0, pos + 1, 0)
        runs[device] = (torch.stack(all_logits), torch.stack(toks))
    err = float((runs["cuda"][0] - runs["cpu"][0]).abs().max())
    check(bool(torch.allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-3, rtol=1e-3)),
          f"model {name} paged: card vs CPU logits max |err| {err:.3g} beyond atol 1e-3")
    check(bool(torch.equal(runs["cuda"][1], runs["cpu"][1])),
          f"model {name} paged: greedy tokens differ between card and CPU")
    print(f"[model] {name:6s} paged: prefill_ragged + graft + {steps} paged steps, card vs "
          f"CPU logits max|err| {err:.3g} (atol 1e-3), tokens equal", flush=True)


# ---------------------------------------------------------------------------
# Phase 5: serve at full width.
# ---------------------------------------------------------------------------
def phase_serve(torch, tier_l_layers, card):
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    full = get_config("qwen3-14b")
    tier_l = get_config("qwen3-14b", n_layers=tier_l_layers)
    if tier_l.n_layers != full.n_layers:
        print(f"[serve] CUT: tier-l depth {tier_l.n_layers} of {full.n_layers} layers "
              "(width unchanged)", flush=True)
    configs = [(n, tier_l if n == "tier-l" else c, q) for n, c, q in serve.tier_configs()]
    ops.reset_launch_counts()  # the main path starts here
    engine, results = _serve_engine(torch, "serve", configs, "tier-l", card)
    counts = ops.launch_counts()  # the main path ends here
    print(f"[serve] kernel launches during the serve phase: {counts}", flush=True)
    for name in DENSE_PATH_KERNELS:
        check(counts[name] > 0, f"serve: kernel {name} was never launched on the main path")
    return counts, results, engine


def _serve_engine(torch, label, configs, tier, card):
    """A dense-tier ``ServingEngine`` over ``configs`` (seeded weights on the
    card) with the measured hedge: ``measure_profiles``, then
    ``drain_trace`` of the Poisson trace under sync and async dispatch,
    with conservation and traffic on ``tier``; then one prefill of
    ``tier`` whose logits must be finite.  Returns (engine, results)."""
    import numpy as np
    from repro_torch.core.network import LognormalNetwork
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.observability.quantile import quantile
    from repro_torch.serving.loadgen import PoissonArrivals, make_trace
    from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig
    from repro_torch.tree import tree_leaves

    prompt, gen, sla = PROMPT, GEN, SLA_MS
    max_len = prompt + gen + 8
    t0 = time.perf_counter()
    engine = serve.build_engine(max_len=max_len, seed=0, measured_hedge=True,
                                dispatch="sync", device="cuda", configs=configs)
    torch.cuda.synchronize()
    v = engine.variants[tier]
    n_params = sum(p.numel() for p in tree_leaves(v.params))
    print(f"[{label}] engine built in {time.perf_counter() - t0:.1f}s; {tier} "
          f"{v.cfg.name} {v.cfg.n_layers} layers {n_params / 1e9:.2f}B params {v.cfg.dtype}, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB "
          "allocated", flush=True)
    registry = engine.measure_profiles(prompt_len=prompt, gen_tokens=gen, trials=3, seed=0)
    ondevice = engine.hedge_backend.measure_profile(prompt_len=prompt, gen_tokens=gen, trials=3)
    for p in list(registry) + [ondevice]:
        print(f"[{label}] profile {p.name:22s} mu_ms={p.mu_ms:.3f} sigma_ms={p.sigma_ms:.3f}",
              flush=True)

    n_req = REQUESTS
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, (n_req, prompt))
    results = {"profiles": {p.name: (p.mu_ms, p.sigma_ms) for p in list(registry) + [ondevice]}}
    for dispatch in ("sync", "async"):
        sched = MDInferenceScheduler(registry, ondevice, SchedulerConfig(t_sla_ms=sla, seed=0))
        loop = engine.make_loop(sched, dispatch=dispatch)
        trace = make_trace(n_req, PoissonArrivals(20.0), LognormalNetwork(300.0, 0.6), seed=0)
        t1 = time.perf_counter()
        completions, metrics = loop.drain_trace(
            trace, 200.0, tokens_for=lambda i: prompts[i], n_steps=gen)
        wall = time.perf_counter() - t1
        rejected = metrics.n_rejected if metrics is not None else 0
        check(len({c.rid for c in completions}) == len(completions) == n_req - rejected,
              f"{label} {dispatch}: {len(completions)} resolved + {rejected} rejected "
              f"!= {n_req} submitted")
        check(len(completions) == n_req, f"{label} {dispatch}: not every request resolved")
        for c in completions:
            check(c.tokens.shape == (gen,) and int(c.tokens.min()) >= 0,
                  f"{label} {dispatch}: request {c.rid} has bad tokens {c.tokens}")
        on_tier = sum(c.model_name == tier for c in completions)
        check(on_tier > 0, f"{label} {dispatch}: no request ran on {tier}")
        lats = [c.latency_ms for c in completions]
        races = {k: round(v, 4) for k, v in metrics.race_resolution.items()}
        results[dispatch] = dict(resolved=len(completions), rejected=rejected, cancelled=0,
                                 on_tier=on_tier, race_resolution=races,
                                 p50_ms=quantile(lats, 50), p99_ms=quantile(lats, 99),
                                 wall_s=wall)
        print(f"[{label}] dispatch={dispatch}: {len(completions)} resolved + {rejected} "
              f"rejected + 0 cancelled == {n_req} submitted; {on_tier} on {tier}; "
              f"race_resolution {races}; latency p50 {quantile(lats, 50):.1f} ms "
              f"p99 {quantile(lats, 99):.1f} ms; drain {wall:.1f}s; card {card}", flush=True)

    with torch.inference_mode():
        tokens = torch.as_tensor(prompts[:2], device="cuda")
        _, logits = T.prefill(v.cfg, v.params, {"tokens": tokens}, max_len)
    check(tuple(logits.shape) == (2, v.cfg.vocab_size), f"{tier} logits shape {logits.shape}")
    check(bool(torch.isfinite(logits).all()), f"{tier} logits are not finite")
    print(f"[{label}] {tier} logits finite, shape {tuple(logits.shape)}", flush=True)
    return engine, results


def phase_int8(torch, engine, card):
    """tier-l (the dense phase's weights) served with the int8 ring cache
    (``kv_cache_quant``): a ``JitBackend`` over the same weights, batch
    ``BATCH``, prompt ``PROMPT``, ``GEN`` greedy tokens, twice (tokens
    bitwise equal), then one prefill and ``GEN`` decode steps whose logits
    must be finite; the ring kernel's launches counted.  Then the cost of
    the dequantise pass a decode step makes over every layer's ring, device
    ms beside the ring kernel's at the same shape."""
    import dataclasses

    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    from repro_torch.serving.backend import JitBackend, Variant

    v = engine.variants["tier-l"]
    cfg = dataclasses.replace(v.cfg, kv_cache_quant=True)
    max_len = PROMPT + GEN + 8
    backend = JitBackend(max_len=max_len, device="cuda")
    backend.register(Variant("tier-l-int8", cfg, v.params, v.quality))
    prompts = np.random.default_rng(0).integers(0, 256, (BATCH, PROMPT))
    backend.generate("tier-l-int8", prompts, 1)  # warm-up
    ops.reset_launch_counts()  # the int8 path starts here
    (tok_a, wall_a), (tok_b, wall_b) = (backend.generate("tier-l-int8", prompts, GEN)
                                        for _ in range(2))
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device="cuda")
        cache, logits = T.prefill(cfg, v.params, {"tokens": tokens}, max_len)
        finite = bool(torch.isfinite(logits).all())
        tok = logits.argmax(-1)
        for i in range(GEN):
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32, device="cuda")
            logits, cache = T.decode_step(cfg, v.params, cache, tok, pos)
            finite &= bool(torch.isfinite(logits).all())
            tok = logits.argmax(-1)
    counts = ops.launch_counts()  # ... and ends here
    check(np.array_equal(tok_a, tok_b), "int8 tier-l: tokens differ between two runs")
    check(finite, "int8 tier-l: logits are not finite")
    want = 3 * GEN * cfg.n_layers
    check(counts["decode_attention_fwd"] == want,
          f"int8 tier-l: {counts['decode_attention_fwd']} ring-decode launches, expected {want}")
    for name in DENSE_PATH_KERNELS:
        check(counts[name] > 0, f"int8 tier-l: kernel {name} was never launched")

    # One layer's ring after the last step, dequantised as a decode step does.
    layer = {k: t[0] for k, t in cache["periods"][0].items()}
    dtype = getattr(torch, cfg.dtype)
    q = torch.randn((BATCH, 1, cfg.n_heads, cfg.head_dim), generator=torch.Generator()
                    .manual_seed(6)).to("cuda", dtype)
    pos = torch.full((BATCH,), PROMPT + GEN - 1, dtype=torch.int32, device="cuda")
    kd, vd = (T._kv_dequant(layer[k], layer[k + "_scale"], dtype) for k in ("k", "v"))

    def dequant():
        return (T._kv_dequant(layer["k"], layer["k_scale"], dtype),
                T._kv_dequant(layer["v"], layer["v_scale"], dtype))

    def ring():
        return attention.decode_attention(q, kd, vd, layer["slot_pos"], pos)

    dq_ms, ring_ms = time_ms(torch, dequant), time_ms(torch, ring)
    result = dict(tokens_equal=True, walls_ms=[wall_a, wall_b], launches=counts,
                  dequant_ms_per_layer=dq_ms, ring_ms_per_layer=ring_ms,
                  dequant_ms_per_step=dq_ms * cfg.n_layers,
                  ring_ms_per_step=ring_ms * cfg.n_layers)
    print(f"[int8] tier-l {cfg.name} {cfg.n_layers} layers {cfg.dtype} with the int8 ring cache, "
          f"batch {BATCH}, prompt {PROMPT}, {GEN} tokens: tokens bitwise equal over two runs "
          f"({wall_a:.1f} / {wall_b:.1f} ms), logits finite, launches {counts}", flush=True)
    print(f"[int8] dequantise pass of a decode step over a ring of {max_len} slots x "
          f"{cfg.n_kv_heads} kv heads x {cfg.head_dim}: {dq_ms:.4f} ms a layer, "
          f"{result['dequant_ms_per_step']:.3f} ms a step ({cfg.n_layers} layers), against the "
          f"ring-decode kernel's {ring_ms:.4f} ms a layer at the same shape; card {card}",
          flush=True)
    del backend, cache, layer, kd, vd
    return counts, result


# ---------------------------------------------------------------------------
# Phase 6: continuous serve at full width.
# ---------------------------------------------------------------------------
def phase_continuous(torch, engine, card):
    """The ``--continuous`` tier over the dense phase's ``Variant`` objects."""
    import numpy as np
    from repro_torch.configs.mdinference_zoo import ServingGeometry
    from repro_torch.core.duplication import HedgePolicy
    from repro_torch.core.network import LognormalNetwork
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.observability.quantile import quantile
    from repro_torch.serving.backend import ContinuousBatchingBackend
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.loadgen import PoissonArrivals, make_trace
    from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig

    geo = ServingGeometry(prompt_width=PROMPT, bs_ladder=(1, 2, 4, 8), n_slots=N_SLOTS,
                          page_size=PAGE, max_steps=GEN)
    ops.reset_launch_counts()  # the continuous path starts here
    t0 = time.perf_counter()
    backend = ContinuousBatchingBackend(geo, device="cuda")
    for v in engine.variants.values():  # the same weight tensors, no copy
        backend.register(v)
    cengine = ServingEngine(backend=backend, hedge_backend=engine.hedge_backend,
                            dispatch="stepped")
    backend.warmup()
    torch.cuda.synchronize()
    compiles = backend.compile_count
    print(f"[continuous] {geo.total_pages} pages x {geo.page_size} per pool, "
          f"{len(backend.variants)} variants warmed in {time.perf_counter() - t0:.1f}s, "
          f"{compiles} entry-point shapes; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    registry = cengine.measure_profiles(prompt_len=PROMPT, gen_tokens=GEN, trials=3, seed=0)
    ondevice = engine.hedge_backend.measure_profile(prompt_len=PROMPT, gen_tokens=GEN, trials=3)
    serve.prewarm_hedge(cengine, PROMPT, GEN, geo.n_slots)
    for p in list(registry) + [ondevice]:
        print(f"[continuous] profile {p.name:22s} mu_ms={p.mu_ms:.3f} sigma_ms={p.sigma_ms:.3f}",
              flush=True)

    n_req = REQUESTS
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, (n_req, PROMPT))
    results = {}
    for dispatch in ("stepped", "sync"):
        sched = MDInferenceScheduler(registry, ondevice, SchedulerConfig(t_sla_ms=SLA_MS, seed=0))
        loop = cengine.make_loop(sched, dispatch=dispatch)
        trace = make_trace(n_req, PoissonArrivals(20.0), LognormalNetwork(300.0, 0.6), seed=0)
        t1 = time.perf_counter()
        completions, metrics = loop.drain_trace(
            trace, 200.0, tokens_for=lambda i: prompts[i], n_steps=GEN)
        wall = time.perf_counter() - t1
        rejected = metrics.n_rejected if metrics is not None else 0
        check(len({c.rid for c in completions}) == len(completions) == n_req - rejected,
              f"continuous {dispatch}: {len(completions)} resolved + {rejected} rejected "
              f"!= {n_req} submitted")
        check(len(completions) == n_req, f"continuous {dispatch}: not every request resolved")
        for c in completions:
            check(c.tokens.shape == (GEN,) and int(c.tokens.min()) >= 0,
                  f"continuous {dispatch}: request {c.rid} has bad tokens {c.tokens}")
            check(c.ttft_ms is not None and c.ttft_ms > 0,
                  f"continuous {dispatch}: request {c.rid} has no TTFT")
        on_l = sum(c.model_name == "tier-l" for c in completions)
        check(on_l > 0, f"continuous {dispatch}: no request ran on tier-l")
        lats = [c.latency_ms for c in completions]
        ttfts = [c.ttft_ms for c in completions]
        races = {k: round(v, 4) for k, v in metrics.race_resolution.items()}
        results[dispatch] = dict(resolved=len(completions), rejected=rejected, cancelled=0,
                                 on_tier_l=on_l, race_resolution=races,
                                 p50_ms=quantile(lats, 50), p99_ms=quantile(lats, 99),
                                 ttft_p50_ms=quantile(ttfts, 50),
                                 ttft_p99_ms=quantile(ttfts, 99), wall_s=wall)
        print(f"[continuous] dispatch={dispatch}: {len(completions)} resolved + {rejected} "
              f"rejected + 0 cancelled == {n_req} submitted; {on_l} on tier-l; race_resolution "
              f"{races}; latency p50 {quantile(lats, 50):.1f} ms p99 {quantile(lats, 99):.1f} "
              f"ms; ttft p50 {quantile(ttfts, 50):.1f} ms p99 {quantile(ttfts, 99):.1f} ms; "
              f"drain {wall:.1f}s; card {card}", flush=True)

    # One request streamed token by token (no hedge, so the remote stream
    # runs to the end).
    sched = MDInferenceScheduler(registry, ondevice, SchedulerConfig(
        t_sla_ms=60_000.0, seed=0, hedge=HedgePolicy(always=False, deadline_headroom_ms=0.0)))
    chunks, done_at_yield, c = serve.stream_demo(cengine, sched, prompts[0], GEN, 60_000.0)
    check(len(chunks) == GEN and [ch.token for ch in chunks] == list(c.tokens),
          f"stream: {len(chunks)} chunks for {GEN} tokens {list(c.tokens)}")
    check(not any(done_at_yield[:-1]), "stream: the request resolved before its last chunk")
    results["stream"] = dict(model=c.model_name, chunks=len(chunks), ttft_ms=c.ttft_ms)

    growth = backend.compile_count - compiles
    check(growth == 0, f"continuous: compile_count grew by {growth} after warmup")
    backend.check_conservation()
    check(backend.joined_total == backend.recycled_total,
          f"continuous: joined {backend.joined_total} != recycled {backend.recycled_total}")
    v = backend.variants["tier-l"]
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts[:2], device="cuda")
        lengths = torch.full((2,), PROMPT, dtype=torch.int32, device="cuda")
        _, logits = T.prefill_ragged(v.cfg, v.params, {"tokens": tokens}, lengths, PROMPT)
    check(tuple(logits.shape) == (2, v.cfg.vocab_size), f"tier-l logits shape {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "tier-l logits are not finite")
    counts = ops.launch_counts()  # the continuous path ends here
    print(f"[continuous] {serve.continuous_summary(backend, [], compiles)}", flush=True)
    print(f"[continuous] tier-l logits finite; kernel launches during the continuous "
          f"phase: {counts}", flush=True)
    for name in PAGED_PATH_KERNELS:
        check(counts[name] > 0, f"continuous: kernel {name} was never launched on its path")
    results["joined"] = backend.joined_total
    results["recycled"] = backend.recycled_total
    return counts, results, backend


# ---------------------------------------------------------------------------
# Phase 5b: cluster serve — two in-process replicas over phase 5's weights.
# ---------------------------------------------------------------------------
def _probe(np):
    """The probe batch every replica and transport must answer bitwise alike."""
    return np.random.default_rng(11).integers(0, 256, (BATCH, PROMPT))


def _served_replicas(completions):
    return sorted({c.replica for c in completions if c.used_remote})


def phase_cluster(torch, engine, card):
    """A ``ClusterBackend`` of two inline-transport replicas sharing phase
    5's ``Variant`` objects: routing, a kill and a rejoin, conservation, and
    the probe batch bitwise equal across replicas and the plain backend."""
    import functools
    import threading

    import numpy as np
    from repro_torch.core.network import LognormalNetwork
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.observability.quantile import quantile
    from repro_torch.serving.cluster import ClusterBackend, parse_replica_specs
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.loadgen import PoissonArrivals, make_trace
    from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig
    from repro_torch.serving.transport import ProcessTransportBackend

    max_len = PROMPT + GEN + 8
    ops.reset_launch_counts()  # the cluster path starts here
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    factory = functools.partial(serve._jit_backend_factory, max_len, "cuda")
    cluster = ClusterBackend(
        [ProcessTransportBackend(factory, mode="inline", max_len=max_len) for _ in range(2)],
        router="power_of_two", seed=0, specs=parse_replica_specs(CLUSTER_SPEC, 2))
    cengine = ServingEngine(max_len=max_len, backend=cluster,
                            hedge_backend=engine.hedge_backend, dispatch="sync")
    for v in engine.variants.values():
        cengine.register(v)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    shared = all(r.backend._inner.variants[n] is v
                 for r in cluster.replicas for n, v in engine.variants.items())
    check(shared and grown == 0,
          f"cluster: the pool copied weights (shared Variants {shared}, {grown} bytes allocated)")
    print(f"[cluster] 2 replicas (inline transport, router power_of_two, spec {CLUSTER_SPEC}) "
          f"share phase 5's Variants: {grown} bytes allocated building the pool, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB in all", flush=True)
    registry = cengine.measure_profiles(prompt_len=PROMPT, gen_tokens=GEN, trials=3, seed=0)
    ondevice = engine.hedge_backend.measure_profile(prompt_len=PROMPT, gen_tokens=GEN, trials=3)
    for p in registry:
        print(f"[cluster] profile {p.name:8s} mu_ms={p.mu_ms:.3f} sigma_ms={p.sigma_ms:.3f}",
              flush=True)

    # The probe batch: replica 0, replica 1, both at once (two threads, two
    # streams), and phase 5's plain JitBackend — the same weights and shape.
    probe = _probe(np)
    r0, r1 = (r.backend for r in cluster.replicas)
    alone = [np.asarray(b.run_batch("tier-l", probe, GEN)[0]) for b in (r0, r1)]
    together = [None, None]

    def run(i, b):
        together[i] = np.asarray(b.run_batch("tier-l", probe, GEN)[0])

    threads = [threading.Thread(target=run, args=(i, b)) for i, b in enumerate((r0, r1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    plain = np.asarray(engine.backend.run_batch("tier-l", probe, GEN)[0])
    for what, got in (("replica 0", alone[0]), ("replica 1", alone[1]),
                      ("replica 0 concurrent", together[0]),
                      ("replica 1 concurrent", together[1])):
        check(np.array_equal(got, plain), f"cluster: probe tokens on {what} differ from the "
              "plain JitBackend's")
    print(f"[cluster] probe batch ({BATCH}, {PROMPT}) x {GEN} tier-l tokens bitwise equal on "
          "replica 0, replica 1, both concurrently and the plain JitBackend", flush=True)

    n_req = CLUSTER_REQUESTS
    prompts = np.random.default_rng(0).integers(0, 256, (n_req, PROMPT))
    results = {"probe_equal": True, "pool_bytes_allocated": grown}
    tier_l_on = set()
    for dispatch in ("sync", "async"):
        sched = MDInferenceScheduler(registry, ondevice, SchedulerConfig(t_sla_ms=SLA_MS, seed=0))
        loop = cengine.make_loop(sched, dispatch=dispatch)
        trace = make_trace(n_req, PoissonArrivals(20.0), LognormalNetwork(300.0, 0.6), seed=0)
        span = float(trace.arrival_ms[-1])
        kill_at, rejoin_at = span / 2, span * 3 / 4
        log = {"ticks": [], "kill": None, "rejoin": None}

        def on_tick(t_ms, res):
            log["ticks"].append((t_ms, dict(res.stats.replica_rows), res.stats.n_lost,
                                 res.stats.n_requeued))
            if log["kill"] is None and t_ms >= kill_at:
                cluster.kill_replica(0, reason="operator kill")
                r1.inject_failures(1)  # one lost batch on the survivor
                log["kill"] = (t_ms, cluster.replicas[0].dispatched_rows)
                print(f"[cluster] {dispatch}: t={t_ms:.0f} ms killed replica 0 "
                      "(and one injected fault on replica 1)", flush=True)
            elif log["kill"] is not None and log["rejoin"] is None and t_ms >= rejoin_at:
                log["rejoin"] = (t_ms, cluster.replicas[0].dispatched_rows)
                cluster.rejoin(0)
                print(f"[cluster] {dispatch}: t={t_ms:.0f} ms rejoined replica 0", flush=True)

        t1 = time.perf_counter()
        completions, metrics = loop.drain_trace(
            trace, 200.0, tokens_for=lambda i: prompts[i], n_steps=GEN, on_tick=on_tick)
        wall = time.perf_counter() - t1
        check(log["kill"] is not None and log["rejoin"] is not None,
              f"cluster {dispatch}: the kill / rejoin never landed")
        rejected = metrics.n_rejected if metrics is not None else 0
        check(len({c.rid for c in completions}) == len(completions) == n_req - rejected
              and rejected == 0, f"cluster {dispatch}: {len(completions)} resolved + {rejected} "
              f"rejected != {n_req} submitted")
        per_replica = {0: 0, 1: 0}
        for c in completions:
            if c.used_remote:
                per_replica[c.replica] += 1
                if c.model_name == "tier-l":
                    tier_l_on.add(c.replica)
        remote = sum(c.used_remote for c in completions)
        check(sum(per_replica.values()) == remote, f"cluster {dispatch}: per-replica "
              f"completions {per_replica} do not add up to {remote}")
        check(all(r.inflight_rows == 0 for r in cluster.replicas),
              f"cluster {dispatch}: rows left in flight")
        check(log["kill"][1] == log["rejoin"][1], f"cluster {dispatch}: replica 0 was handed "
              f"{log['rejoin'][1] - log['kill'][1]} rows between its kill and its rejoin")
        between = [t for t in log["ticks"] if log["kill"][0] < t[0] <= log["rejoin"][0]]
        check(all(0 not in rows for _, rows, _, _ in between),
              f"cluster {dispatch}: replica 0 served while killed")
        lost = sum(t[2] for t in log["ticks"])
        requeued = sum(t[3] for t in log["ticks"])
        failover = sum(c.race_resolution == "remote_failed" for c in completions)
        check(lost > 0 and lost == requeued + failover,
              f"cluster {dispatch}: {lost} lost rows, {requeued} requeued, {failover} failed over")
        for c in completions:
            check(c.tokens.shape == (GEN,) and int(c.tokens.min()) >= 0,
                  f"cluster {dispatch}: request {c.rid} has bad tokens {c.tokens}")
        lats = [c.latency_ms for c in completions]
        races = {k: round(v, 4) for k, v in metrics.race_resolution.items()}
        results[dispatch] = dict(resolved=len(completions), per_replica=per_replica, lost=lost,
                                 requeued=requeued, failover=failover, race_resolution=races,
                                 p50_ms=quantile(lats, 50), p99_ms=quantile(lats, 99),
                                 wall_s=wall, snapshot=[_snapshot_dict(s)
                                                        for s in cluster.snapshot()])
        print(f"[cluster] dispatch={dispatch}: {len(completions)} resolved + 0 rejected == "
              f"{n_req} submitted; remote rows per replica {per_replica} (sum {remote}); "
              f"{lost} rows lost = {requeued} requeued + {failover} failed over to the hedge; "
              f"replica 0 handed nothing between kill and rejoin; race_resolution {races}; "
              f"latency p50 {quantile(lats, 50):.1f} ms p99 {quantile(lats, 99):.1f} ms; "
              f"drain {wall:.1f}s; card {card}", flush=True)
    check(tier_l_on == {0, 1}, f"cluster: tier-l served by replicas {sorted(tier_l_on)} only")
    results["tracing"] = _tracing_cost(cengine, registry, ondevice, card)
    counts = ops.launch_counts()  # the cluster path ends here
    print(f"[cluster] both replicas served tier-l; kernel launches during the cluster phase: "
          f"{counts}", flush=True)
    for name in DENSE_PATH_KERNELS:
        check(counts[name] > 0, f"cluster: kernel {name} was never launched on its path")
    results["probe_tokens"] = plain.tolist()
    return counts, results


def _tracing_cost(cengine, registry, ondevice, card):
    """p99 with and without an ``Observability`` handle on the full-width
    pool: one seeded trace of ``TRACING_REQUESTS``, async dispatch, no
    faults, run off / on / on / off so drift falls on both sides."""
    import copy

    import numpy as np
    from repro_torch.core.network import LognormalNetwork
    from repro_torch.observability import Observability, request_conservation
    from repro_torch.observability.quantile import quantile
    from repro_torch.serving.loadgen import PoissonArrivals, make_trace
    from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig

    n_req = TRACING_REQUESTS
    prompts = np.random.default_rng(1).integers(0, 256, (n_req, PROMPT))
    trace = make_trace(n_req, PoissonArrivals(TRACING_RATE), LognormalNetwork(300.0, 0.6), seed=1)
    runs = {"on": [], "off": []}
    for traced in (False, True, True, False):
        obs = Observability() if traced else None
        sched = MDInferenceScheduler(copy.deepcopy(registry), ondevice,
                                     SchedulerConfig(t_sla_ms=SLA_MS, seed=0))
        loop = cengine.make_loop(sched, dispatch="async", observability=obs)
        t0 = time.perf_counter()
        completions, _ = loop.drain_trace(trace, 200.0, tokens_for=lambda i: prompts[i],
                                          n_steps=GEN)
        wall = time.perf_counter() - t0
        check(len({c.rid for c in completions}) == len(completions) == n_req,
              f"tracing cost: {len(completions)} of {n_req} resolved")
        lats = sorted(c.latency_ms for c in completions)
        run = dict(p50_ms=quantile(lats, 50), p95_ms=quantile(lats, 95),
                   p99_ms=quantile(lats, 99), max_ms=lats[-1],
                   at_sla=sum(x >= SLA_MS for x in lats),
                   on_tier_l=sum(c.model_name == "tier-l" for c in completions), wall_s=wall)
        if traced:
            loop.attach_observability(None)  # the handle stays on the pool otherwise
            audit = request_conservation(obs.tracer)
            check(audit["open"] == audit["extra_terminals"] == 0
                  and audit["submitted"] == audit["resolved"] == n_req,
                  f"tracing cost: request conservation {audit}")
            run["spans"] = len(obs.tracer)
        runs["on" if traced else "off"].append(run)
    # on / off per quantile, runs 2 / 1 and 3 / 4; a quantile is capped (the
    # SLA, not tracing, sets it) when more requests than lie above it ended
    # at the SLA.
    ratios = {q: [on[f"p{q}_ms"] / off[f"p{q}_ms"] for on, off in zip(runs["on"], runs["off"])]
              for q in (50, 95, 99)}
    order = runs["off"][:1] + runs["on"] + runs["off"][1:]
    capped = {q: any(r["at_sla"] > n_req * (100 - q) / 100 for r in order) for q in (50, 95, 99)}
    print(f"[cluster] tracing on / off, {n_req} requests at {TRACING_RATE:g} req/s, async, "
          f"run off, on, on, off: p50 {[r['p50_ms'] for r in order]} ms, p95 "
          f"{[r['p95_ms'] for r in order]} ms, p99 {[r['p99_ms'] for r in order]} ms, largest "
          f"{[r['max_ms'] for r in order]} ms, at the SLA {[r['at_sla'] for r in order]}, on "
          f"tier-l {[r['on_tier_l'] for r in order]}; on / off (runs 2 / 1, 3 / 4) "
          + "; ".join(f"p{q} {', '.join(f'{x:.4f}' for x in ratios[q])}"
                      + (" (capped by the SLA)" if capped[q] else "") for q in ratios)
          + f"; spans {[r['spans'] for r in runs['on']]}, conservation ok; card {card}",
          flush=True)
    return dict(requests=n_req, rate=TRACING_RATE, runs=runs, ratios=ratios, capped=capped)


def _snapshot_dict(obj):
    import dataclasses
    import math

    return {k: (None if isinstance(v, float) and math.isinf(v) else v)
            for k, v in dataclasses.asdict(obj).items()}


# ---------------------------------------------------------------------------
# Phase 6b: process transport — two spawned workers at full width.
# ---------------------------------------------------------------------------
def _rss_mib():
    """This process's peak resident set (MiB) and where the number is from."""
    from repro_torch.serving.transport_worker import peak_rss

    return peak_rss()


def _rss_line(registrations):
    """A worker's resident set around each of its registrations."""
    keys = ("entry_mib", "before_pieces_mib", "pieces_peak_mib", "after_pieces_mib")
    return ("RSS (MiB) per registration, at entry / before its first piece (staging buffer "
            "and CUDA context made) / largest while its pieces arrive / after its last piece: "
            + "; ".join(f"{name} " + " / ".join(f"{info['rss'][k]:.0f}" for k in keys)
                        for name, info in registrations.items()))


def _add_counts(total, counts):
    for k, v in (counts or {}).items():
        total[k] = total.get(k, 0) + v


def phase_process(torch, host_variants, plain_tokens, card):
    """Two spawned workers, each a ``JitBackend`` on its own CUDA context
    hosting the tiers with tier-l at full width, its weights sent as host
    bytes in pieces; a drain, a real kill mid-batch, a restart, and tokens
    equal to the in-process ``JitBackend``'s on the same weights."""
    import functools
    import os
    import threading

    import numpy as np
    from repro_torch.core.network import LognormalNetwork
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.observability.quantile import quantile
    from repro_torch.serving.backend import OnDeviceBackend
    from repro_torch.serving.cluster import ClusterBackend
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.loadgen import PoissonArrivals, make_trace
    from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig
    from repro_torch.serving.transport import PIECE_BYTES, ProcessTransportBackend, ReplicaDied

    max_len = PROMPT + GEN + 8
    probe = _probe(np)
    ops.reset_launch_counts()  # the process path starts here (workers count from 0)
    worker_counts = {}
    t0 = time.perf_counter()
    factory = functools.partial(serve._jit_backend_factory, max_len, "cuda")
    cluster = ClusterBackend(
        [ProcessTransportBackend(factory, mode="process", max_len=max_len) for _ in range(2)],
        router="least_inflight", seed=0)
    hedge = OnDeviceBackend.from_zoo(max_len=max_len, seed=0, device="cuda")
    pengine = ServingEngine(max_len=max_len, backend=cluster, hedge_backend=hedge,
                            dispatch="async")
    results = {"workers": []}
    try:
        for v in host_variants:
            print(f"[process] registering {v.name} on both workers", flush=True)
            pengine.register(v)  # each worker acknowledges before the next
        for r in cluster.replicas:
            b = r.backend
            reg = b.registrations["tier-l"]
            st = b.stats()
            row = dict(pid=b.pid, ready_s=b.ready_s, tier_l_register_s=reg["wall_s"],
                       tier_l_worker_s=reg["seconds"], tier_l_gb=reg["bytes"] / 1e9,
                       gb_per_s=reg["bytes"] / 1e9 / reg["wall_s"],
                       worker_peak_rss_mib=st["peak_rss_mib"], rss_source=st["rss_source"],
                       worker_device_gib=st.get("device_allocated_gib", float("nan")),
                       worker_device_peak_gib=st.get("device_peak_gib", float("nan")),
                       pieces=-(-reg["bytes"] // PIECE_BYTES),
                       rss_mib={name: info["rss"] for name, info in b.registrations.items()})
            results["workers"].append(row)
            check(not st["jax_loaded"], "process: a worker imported jax")
            print(f"[process] worker {r.replica_id} pid {b.pid}: tier-l "
                  f"{reg['bytes'] / 1e9:.2f} GB registered in {reg['wall_s']:.1f} s "
                  f"({reg['bytes'] / 1e9 / reg['wall_s']:.2f} GB/s, pieces of "
                  f"{PIECE_BYTES >> 20} MiB, checksums equal), spawn-to-ready "
                  f"{b.ready_s:.1f} s; worker peak RSS {st['peak_rss_mib']:.0f} MiB "
                  f"({st['rss_source']}; largest sampled VmRSS "
                  f"{st['sampled_peak_rss_mib']:.0f} MiB), "
                  f"device {row['worker_device_gib']:.1f} GiB allocated", flush=True)
            print(f"[process] worker {r.replica_id} {_rss_line(b.registrations)}", flush=True)
        results["parent_peak_rss_mib"], results["parent_rss_source"] = _rss_mib()
        free, total = torch.cuda.mem_get_info()
        results["card_free_gib_with_two_workers"] = free / 2**30
        print(f"[process] spawn + registration of both workers {time.perf_counter() - t0:.1f} s; "
              f"parent peak RSS {results['parent_peak_rss_mib']:.0f} MiB "
              f"({results['parent_rss_source']}; it holds the host copy); card "
              f"{free / 2**30:.1f} of {total / 2**30:.1f} GiB free", flush=True)

        # Tokens: each worker against phase 5's in-process JitBackend.
        for r in cluster.replicas:
            got = np.asarray(r.backend.run_batch("tier-l", probe, GEN)[0])
            check(np.array_equal(got, plain_tokens), f"process: worker {r.replica_id}'s probe "
                  "tokens differ from the in-process JitBackend's on the same weights")
        print("[process] probe tokens of both workers bitwise equal to the in-process "
              "JitBackend's (same weights, same batch shape)", flush=True)

        registry = pengine.measure_profiles(prompt_len=PROMPT, gen_tokens=GEN, trials=3, seed=0)
        ondevice = hedge.measure_profile(prompt_len=PROMPT, gen_tokens=GEN, trials=3)
        n_req = REQUESTS
        prompts = np.random.default_rng(0).integers(0, 256, (n_req, PROMPT))
        sched = MDInferenceScheduler(registry, ondevice, SchedulerConfig(t_sla_ms=SLA_MS, seed=0))
        loop = pengine.make_loop(sched, dispatch="async")
        trace = make_trace(n_req, PoissonArrivals(20.0), LognormalNetwork(300.0, 0.6), seed=0)
        victim = cluster.replicas[0].backend
        _add_counts(worker_counts, victim.stats().get("launch_counts"))  # dies with it
        kill, drained = {}, threading.Event()

        def killer():
            # Kill worker 0 while a batch is in flight on it: rows in flight
            # for 50 ms and still in flight (a tier-l batch is a prefill and
            # GEN decode steps).
            while not drained.is_set():
                if victim.inflight_rows > 0:
                    time.sleep(0.05)
                    if victim.inflight_rows > 0:
                        kill["inflight"] = victim.inflight_rows
                        kill["t"] = time.perf_counter()
                        cluster.kill_replica(0, reason="operator kill")
                        victim._proc.join(60.0)
                        kill["exit_s"] = time.perf_counter() - kill["t"]
                        return
                time.sleep(0.005)

        th = threading.Thread(target=killer, daemon=True)
        th.start()
        lost = []
        try:
            completions, metrics = loop.drain_trace(
                trace, 200.0, tokens_for=lambda i: prompts[i], n_steps=GEN,
                on_tick=lambda t, res: lost.append((t, res.stats.n_lost, res.stats.n_requeued,
                                                    _served_replicas(res.completions))))
        finally:
            drained.set()
        th.join(60.0)
        check("t" in kill, "process: the kill never landed on an in-flight batch")
        n_lost = sum(x[1] for x in lost)
        check(n_lost > 0, "process: the kill lost no in-flight rows")
        check(len(completions) == n_req and metrics.n_rejected == 0,
              f"process: {len(completions)} of {n_req} resolved")
        snap = cluster.snapshot()[0]
        check(snap.health == "open" and not victim.alive,
              f"process: worker 0's breaker is {snap.health} after the kill")
        lats = [c.latency_ms for c in completions]
        results["drain"] = dict(resolved=len(completions), lost=n_lost,
                                requeued=sum(x[2] for x in lost),
                                per_tick=lost, kill_inflight_rows=kill["inflight"],
                                worker_exit_s=kill["exit_s"],
                                p50_ms=quantile(lats, 50), p99_ms=quantile(lats, 99))
        print(f"[process] drain (async): {len(completions)} resolved == {n_req} submitted; "
              f"worker 0 killed with {kill['inflight']} rows in flight: {n_lost} rows lost "
              f"({results['drain']['requeued']} requeued, the rest failed over to the hedge), "
              f"breaker open, its process gone {kill['exit_s']:.2f} s after the SIGTERM; "
              f"replicas serving per tick {[x[3] for x in lost]}; latency p50 "
              f"{quantile(lats, 50):.1f} ms p99 {quantile(lats, 99):.1f} ms", flush=True)

        # Kill-to-ReplicaDied, measured on its own: a batch in flight on
        # worker 1 and the worker SIGKILLed from outside (a real death: the
        # parent learns of it from the pipe).
        survivor = cluster.replicas[1].backend
        _add_counts(worker_counts, survivor.stats().get("launch_counts"))
        for rows in (BATCH, 8 * BATCH, 32 * BATCH):  # until a batch is caught in flight
            batch = np.resize(probe, (rows, PROMPT))
            h = survivor.submit_batch("tier-l", batch, GEN, sync=False)
            time.sleep(0.05)
            if not h.poll():
                break
            h.wait()
        check(not h.poll(), "process: no tier-l batch stayed in flight for 50 ms")
        t_k = time.perf_counter()
        os.kill(survivor.pid, 9)
        try:
            h.wait(timeout=60.0)
        except ReplicaDied:
            died_s = time.perf_counter() - t_k
        else:
            fail("process: a SIGKILLed worker's batch completed")
        results["sigkill_to_replica_died_s"] = died_s
        print(f"[process] worker 1 SIGKILLed mid-batch: ReplicaDied after {died_s * 1e3:.1f} ms",
              flush=True)

        cluster.kill_replica(1, reason="SIGKILL")  # out of routing until it rejoins

        # Rejoin worker 0: the old process is reaped, a new one spawned and
        # the three tiers re-registered before it is routable again.
        t_r = time.perf_counter()
        cluster.rejoin(0)
        rejoin_ready = time.perf_counter() - t_r
        h = cluster.submit_batch("tier-l", probe, GEN, sync=True)
        got = np.asarray(h.wait()[0])
        rejoin_first = time.perf_counter() - t_r
        check(h.replica == 0, f"process: the batch after the rejoin ran on replica {h.replica}")
        check(np.array_equal(got, plain_tokens), "process: the rejoined worker's tokens differ")
        check(cluster.snapshot()[0].health == "closed", "process: rejoined breaker not closed")
        st = victim.stats()
        _add_counts(worker_counts, st.get("launch_counts"))
        results["rejoin"] = dict(ready_s=rejoin_ready, first_batch_s=rejoin_first,
                                 reap_s=victim.reap_s, spawn_to_ready_s=victim.ready_s,
                                 tier_l_register_s=victim.registrations["tier-l"]["wall_s"],
                                 rss_mib={name: info["rss"]
                                          for name, info in victim.registrations.items()},
                                 worker_peak_rss_mib=st["peak_rss_mib"], rss_source=st["rss_source"],
                                 worker_device_peak_gib=st.get("device_peak_gib", float("nan")))
        print(f"[process] rejoin of worker 0: old process reaped in {victim.reap_s:.2f} s, "
              f"respawned and re-registered in {rejoin_ready:.1f} s (spawn-to-ready "
              f"{victim.ready_s:.1f} s), first batch served by it {rejoin_first:.1f} s after the "
              f"rejoin, tokens equal; its peak RSS {st['peak_rss_mib']:.0f} MiB, device peak "
              f"{results['rejoin']['worker_device_peak_gib']:.1f} GiB; card {card}", flush=True)
        print(f"[process] rejoined worker 0 {_rss_line(victim.registrations)}", flush=True)
    finally:
        for r in cluster.replicas:
            r.backend.close()
    counts = ops.launch_counts()  # the process path ends here (the parent: the hedge)
    _add_counts(counts, worker_counts)
    print(f"[process] kernel launches during the process phase (parent + workers): {counts}",
          flush=True)
    for name in DENSE_PATH_KERNELS:
        check(counts[name] > 0, f"process: kernel {name} was never launched on its path")
    results["parent_peak_rss_mib"], results["parent_rss_source"] = _rss_mib()
    return counts, results


# ---------------------------------------------------------------------------
# Phase 6c: the serve command with controller, tenants, replicas and tracing.
# ---------------------------------------------------------------------------
def _serve_cli(argv):
    import contextlib
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    text = buf.getvalue()
    check(rc == 0, f"serve {' '.join(argv)} exited {rc}")
    m = re.search(r"p50/p99 latency\s*: ([\d.]+)/([\d.]+) ms", text)
    check(m is not None, "serve: no latency summary line")
    return text, float(m.group(2))


def phase_serve_cli(torch, card):
    """``python -m repro_torch.launch.serve`` with the new flags, in this
    process: exports validated by ``benchmarks/validate_obs.py``, request
    conservation, and the trace-on/off p99 ratio."""
    import importlib.util

    from repro_torch.kernels import ops

    out_dir = ROOT / "build" / "chip_smoke_obs"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = str(out_dir / "trace.json")
    argv = ["--device", "cuda", "--requests", "48", "--rate", "10", "--replicas", "2",
            "--transport", "inline", "--kill-replica-at", "300", "--rejoin-replica-at", "700",
            "--tenants", "interactive:4,batch:1:batch:32", "--controller", "--max-pending", "8",
            "--overload", "2", "--overload-policy", "shed"]
    ops.reset_launch_counts()  # the serve command's path starts here
    t0 = time.perf_counter()
    text_on, p99_on = _serve_cli(argv + ["--trace-out", trace, "--metrics-out", trace + ".prom"])
    counts = ops.launch_counts()  # ...and ends here
    seconds = time.perf_counter() - t0
    for line in text_on.splitlines():
        if not line.startswith("tick "):
            print(f"[serve-cli] {line}", flush=True)
    for want in ("!! killed replica 0", "!! rejoined replica 0", "controller        : retunes=",
                 "tenancy           : class p99", "cluster           : 2 replicas",
                 "(conservation ok)"):
        check(want in text_on, f"serve-cli: {want!r} missing from the summary")
    spec = importlib.util.spec_from_file_location("validate_obs",
                                                  ROOT / "benchmarks" / "validate_obs.py")
    validate_obs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(validate_obs)
    check(validate_obs.main([trace]) == 0, "serve-cli: validate_obs.py rejected the exports")
    for name in DENSE_PATH_KERNELS:
        check(counts[name] > 0, f"serve-cli: kernel {name} was never launched on its path")
    # The same command untraced, then untraced and traced once more (ABBA):
    # two on/off ratios from one call.
    p99s = {"on": [p99_on], "off": []}
    for traced in (False, False, True):
        extra = ["--trace-out", trace, "--metrics-out", trace + ".prom"] if traced else []
        p99s["on" if traced else "off"].append(_serve_cli(argv + extra)[1])
    ratios = [on / off for on, off in zip(p99s["on"], p99s["off"])]
    print(f"[serve-cli] exports pass benchmarks/validate_obs.py; request conservation ok; p99 "
          f"tracing on {p99s['on']} ms / off {p99s['off']} ms = "
          f"{', '.join(f'{r:.3f}x' for r in ratios)} (the JAX package held 1.05x on the CPU; "
          "here p99 of at most 48 requests lies between their two largest, capped by the "
          "SLA: tracing's cost is read in the cluster phase); "
          f"{seconds:.1f}s a run; card {card}", flush=True)
    print(f"[serve-cli] kernel launches during the traced serve command: {counts}", flush=True)
    return counts, dict(p99_on_ms=p99s["on"], p99_off_ms=p99s["off"], ratios=ratios,
                        seconds=seconds)


# ---------------------------------------------------------------------------
# Phase 7: hybrid serve at full width (recurrentgemma-2b).
# ---------------------------------------------------------------------------
def _expected_launches(cfg):
    """Launches per prefill and per decode step worked out from the layer
    kinds: a scan per recurrent layer and a flash launch per attention (or
    MoE) layer in prefill, a ring-decode launch per attention layer in
    decode (recurrent and xLSTM state is updated elementwise), two norms per
    block (one per xLSTM block), two more per attention layer with qk-norm,
    plus the final norm in both."""
    kinds = cfg.layer_kinds()
    n_rec = sum(k == "recurrent" for k in kinds)
    n_attn = sum(k in ("attn", "local", "moe") for k in kinds)
    norms = (sum(1 if k in ("mlstm", "slstm") else 2 for k in kinds) + 1
             + (2 * n_attn if cfg.qk_norm else 0))
    prefill = dict(rms_norm_fwd=norms, flash_attention_fwd=n_attn, rglru_scan_fwd=n_rec,
                   rglru_scan_bwd=0, decode_attention_fwd=0)
    decode = dict(rms_norm_fwd=norms, flash_attention_fwd=0, rglru_scan_fwd=0, rglru_scan_bwd=0,
                  decode_attention_fwd=n_attn)
    return prefill, decode


def phase_hybrid(torch, card):
    """Full-width recurrentgemma-2b served as tier-rg by a ``JitBackend``."""
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ops

    cfg = get_config(HYBRID_ARCH)
    ops.reset_launch_counts()  # the hybrid path starts here
    engine, results = _serve_engine(torch, "hybrid", [(HYBRID_TIER, cfg, HYBRID_QUALITY)],
                                    HYBRID_TIER, card)
    counts = ops.launch_counts()  # the hybrid path ends here
    print(f"[hybrid] kernel launches during the hybrid serve phase: {counts}", flush=True)
    for name in HYBRID_PATH_KERNELS:
        check(counts[name] > 0, f"hybrid: kernel {name} was never launched on its path")

    results.update(_step_launches(torch, "hybrid", engine.variants[HYBRID_TIER]))
    return counts, results, engine


def _step_launches(torch, label, v):
    """Launches of one prefill and one decode step of variant ``v``, counted
    on their own (the phase's counts are read before), against those
    worked out from the layer kinds."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    want_prefill, want_decode = _expected_launches(v.cfg)
    tokens = torch.randint(0, 256, (BATCH, PROMPT), device="cuda")
    with torch.inference_mode():
        ops.reset_launch_counts()
        cache, logits = T.prefill(v.cfg, v.params, {"tokens": tokens}, PROMPT + GEN + 8)
        got_prefill = ops.launch_counts()
        ops.reset_launch_counts()
        pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device="cuda")
        T.decode_step(v.cfg, v.params, cache, logits.argmax(-1), pos)
        got_decode = ops.launch_counts()
    for what, got, want in (("prefill", got_prefill, want_prefill),
                            ("decode step", got_decode, want_decode)):
        check({k: got[k] for k in want} == want,
              f"{label}: launches per {what} {got}, expected {want} from the layer kinds")
    print(f"[{label}] launches per prefill {want_prefill}, per decode step {want_decode}: "
          "as worked out from the layer kinds", flush=True)
    ops.reset_launch_counts()
    return dict(launches_per_prefill=want_prefill, launches_per_decode_step=want_decode)


# ---------------------------------------------------------------------------
# Phase 8b: the rest of the zoo — MoE and xLSTM at full width, Table III on
# the card, the simulator.
# ---------------------------------------------------------------------------
def phase_zoo(torch, card, measured):
    """olmoe-1b-7b (dense and continuous tiers), llama4-scout cut to
    ``SCOUT_LAYERS`` layers at full width and xlstm-350m, each released
    before the next; then the measured Table III beside the H100 roofline
    (``measured``: the earlier phases' ``{tier: (config, mu, sigma, note)}``)
    and the simulator on the card against the CPU.  Returns (launch counts
    of the zoo's serve paths, results)."""
    counts, results, table = {}, {}, dict(measured)
    for label, run in (("olmoe", _zoo_moe), ("scout", _zoo_scout), ("xlstm", _zoo_xlstm)):
        c, results[label], row = run(torch, card)
        _add_counts(counts, c)
        table.update(row)
        _release(torch, f"zoo {label}")
    print(f"[zoo] kernel launches during the zoo's serve paths: {counts}", flush=True)
    for name in ZOO_PATH_KERNELS:
        check(counts.get(name, 0) > 0, f"zoo: kernel {name} was never launched on its path")
    results["table3"] = _zoo_table3(table, card)
    results["simulator"] = _zoo_simulator(torch, card)
    return counts, results


def _zoo_moe(torch, card):
    """Full olmoe-1b-7b as tier-moe: the dense engine (measured hedge,
    sync / async drains), launches per step, greedy tokens bitwise the same
    over two runs, then its continuous tier."""
    import numpy as np

    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.profiles import QUALITY

    cfg = get_config(MOE_ARCH)
    ops.reset_launch_counts()  # the MoE dense path starts here
    engine, results = _serve_engine(torch, "zoo olmoe", [("tier-moe", cfg, QUALITY[MOE_ARCH])],
                                    "tier-moe", card)
    counts = ops.launch_counts()  # ... and ends here
    v = engine.variants["tier-moe"]
    results.update(_step_launches(torch, "zoo olmoe", v))
    ops.reset_launch_counts()
    prompts = _probe(np)
    a, _ = engine.backend.generate("tier-moe", prompts, GEN)
    b, _ = engine.backend.generate("tier-moe", prompts, GEN)
    _add_counts(counts, ops.launch_counts())
    check(np.array_equal(a, b), "zoo olmoe: greedy tokens differ between two runs of one batch")
    print(f"[zoo olmoe] greedy tokens of a {prompts.shape} batch bitwise the same over two "
          "runs (fixed-order combine)", flush=True)
    results["decode_cost"] = _moe_decode_cost(torch, v, card)
    ops.reset_launch_counts()  # the MoE continuous path starts here
    results["continuous"] = _zoo_continuous(torch, engine, "tier-moe", card)
    _add_counts(counts, ops.launch_counts())
    mu, sigma = results["profiles"]["tier-moe"]
    return counts, results, {"tier-moe": (cfg, mu, sigma, "")}


def _moe_decode_cost(torch, v, card):
    """Where an olmoe decode step's time goes, at batch ``BATCH``: the
    step's wall (host clock to a synchronize), one layer's MoE FFN eagerly
    (launch cost included) and, on the device alone, its dense expert
    product over the (E, capacity, D) buffer against the bytes of the
    expert weights it reads (every expert's, whatever the routing)."""
    import torch.nn.functional as F

    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    cfg = v.cfg
    layer = {k: t[0] for k, t in v.params["periods"][0]["moe"].items()}
    cap = moe.capacity(BATCH, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    buf = torch.randn(cfg.n_experts, cap, cfg.d_model, device="cuda").to(torch.bfloat16)
    x = torch.randn(BATCH, 1, cfg.d_model, device="cuda").to(torch.bfloat16)

    def experts():
        h = F.silu(torch.bmm(buf, layer["wi"])) * torch.bmm(buf, layer["wg"])
        return torch.bmm(h, layer["wo"])

    with torch.inference_mode():
        expert_ms = time_ms(torch, experts, launches=5)
        moe_ms = time_ms(torch, lambda: moe.moe_apply(cfg, layer, x), launches=5, graph=False)
        tokens = torch.randint(0, 256, (BATCH, PROMPT), device="cuda")
        cache, logits = T.prefill(cfg, v.params, {"tokens": tokens}, PROMPT + GEN + 8)
        tok = logits.argmax(-1)
        walls = []
        for i in range(GEN):
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = T.decode_step(cfg, v.params, cache, tok, pos)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            tok = logits.argmax(-1)
    nbytes = sum(layer[k].numel() * layer[k].element_size() for k in ("wi", "wg", "wo"))
    bound_ms = (nbytes + 2 * buf.numel() * buf.element_size()) / H100_BYTES_PER_S * 1e3
    step_ms = statistics.median(walls)
    n = cfg.n_layers
    print(f"[zoo olmoe] decode step at batch {BATCH}: wall {step_ms:.2f} ms (median of {GEN}); "
          f"per layer the MoE FFN eagerly {moe_ms:.3f} ms, its dense expert product over "
          f"{tuple(buf.shape)} {expert_ms:.4f} ms on the device against {bound_ms:.4f} ms for "
          f"the {nbytes / 1e6:.0f} MB of expert weights it reads; x {n} layers: {n * moe_ms:.2f} "
          f"/ {n * expert_ms:.2f} / {n * bound_ms:.2f} ms; card {card}", flush=True)
    return dict(step_ms=step_ms, moe_layer_ms=moe_ms, expert_ms=expert_ms,
                expert_bound_ms=bound_ms, expert_bytes=nbytes, layers=n)


def _zoo_continuous(torch, engine, tier, card):
    """``tier`` on a ``ContinuousBatchingBackend`` (ladder 1/2/4/8, 8 slots,
    page 8) over the dense engine's ``Variant``: warmup, one streamed
    request, slot and page conservation, no ``compile_count`` growth."""
    import numpy as np
    from repro_torch.configs.mdinference_zoo import ServingGeometry
    from repro_torch.core.duplication import HedgePolicy
    from repro_torch.launch import serve
    from repro_torch.serving.backend import ContinuousBatchingBackend
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig

    geo = ServingGeometry(prompt_width=PROMPT, bs_ladder=(1, 2, 4, 8), n_slots=N_SLOTS,
                          page_size=PAGE, max_steps=GEN)
    t0 = time.perf_counter()
    backend = ContinuousBatchingBackend(geo, device="cuda")
    backend.register(engine.variants[tier])  # the same weight tensors, no copy
    cengine = ServingEngine(backend=backend, hedge_backend=engine.hedge_backend,
                            dispatch="stepped")
    backend.warmup()
    compiles = backend.compile_count
    registry = cengine.measure_profiles(prompt_len=PROMPT, gen_tokens=GEN, trials=3, seed=0)
    ondevice = engine.hedge_backend.measure_profile(prompt_len=PROMPT, gen_tokens=GEN, trials=3)
    p = registry[registry.index_of(tier)]
    print(f"[zoo continuous] {tier} warmed in {time.perf_counter() - t0:.1f}s, {compiles} "
          f"entry-point shapes; profile mu_ms={p.mu_ms:.3f} sigma_ms={p.sigma_ms:.3f}",
          flush=True)
    sched = MDInferenceScheduler(registry, ondevice, SchedulerConfig(
        t_sla_ms=60_000.0, seed=0, hedge=HedgePolicy(always=False, deadline_headroom_ms=0.0)))
    prompt = np.random.default_rng(0).integers(0, 256, PROMPT)
    chunks, done_at_yield, c = serve.stream_demo(cengine, sched, prompt, GEN, 60_000.0)
    check(c.model_name == tier, f"zoo continuous: the stream resolved on {c.model_name}")
    check(len(chunks) == GEN and [ch.token for ch in chunks] == list(c.tokens),
          f"zoo continuous: {len(chunks)} chunks for {GEN} tokens {list(c.tokens)}")
    check(not any(done_at_yield[:-1]), "zoo continuous: the request resolved before its last chunk")
    growth = backend.compile_count - compiles
    check(growth == 0, f"zoo continuous: compile_count grew by {growth} after warmup")
    backend.check_conservation()
    check(backend.joined_total == backend.recycled_total,
          f"zoo continuous: joined {backend.joined_total} != recycled {backend.recycled_total}")
    print(f"[zoo continuous] {serve.continuous_summary(backend, [c], compiles)}; stream of "
          f"{len(chunks)} chunks, ttft {c.ttft_ms:.1f} ms; card {card}", flush=True)
    return dict(mu_ms=p.mu_ms, sigma_ms=p.sigma_ms, chunks=len(chunks), ttft_ms=c.ttft_ms,
                joined=backend.joined_total, recycled=backend.recycled_total)


def _zoo_scout(torch, card):
    """llama4-scout at full width, depth cut to ``SCOUT_LAYERS``: the
    sigmoid top-1 router and the shared expert through a ``JitBackend``;
    measured profile, finite logits, tokens bitwise the same over two runs."""
    import numpy as np

    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.backend import JitBackend, Variant
    from repro_torch.serving.profiles import QUALITY
    from repro_torch.tree import tree_leaves

    full = get_config(SCOUT_ARCH)
    cfg = get_config(SCOUT_ARCH, n_layers=SCOUT_LAYERS)
    print(f"[zoo scout] CUT: depth {cfg.n_layers} of {full.n_layers} layers (width unchanged; "
          f"the full model's {full.param_count() / 1e9:.1f} B parameters do not fit one card)",
          flush=True)
    ops.reset_launch_counts()  # the scout's path starts here
    t0 = time.perf_counter()
    backend = JitBackend(max_len=PROMPT + GEN + 8, device="cuda")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    backend.register(Variant("tier-scout", cfg, params, QUALITY[SCOUT_ARCH]))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[zoo scout] built in {time.perf_counter() - t0:.1f}s: {n_params / 1e9:.2f}B params "
          f"{cfg.dtype}, {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated", flush=True)
    prof = backend.measure_profile("tier-scout", PROMPT, GEN, trials=3)
    prompts = _probe(np)
    a, wall_a = backend.generate("tier-scout", prompts, GEN)
    b, wall_b = backend.generate("tier-scout", prompts, GEN)
    check(np.array_equal(a, b), "zoo scout: greedy tokens differ between two runs of one batch")
    with torch.inference_mode():
        _, logits = T.prefill(cfg, params, {"tokens": torch.as_tensor(prompts, device="cuda")},
                              PROMPT + GEN + 8)
    check(tuple(logits.shape) == (BATCH, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"zoo scout: logits {tuple(logits.shape)} not finite")
    counts = ops.launch_counts()  # ... and ends here
    print(f"[zoo scout] profile mu_ms={prof.mu_ms:.3f} sigma_ms={prof.sigma_ms:.3f}; {BATCH} "
          f"requests x {GEN} tokens in {wall_a:.1f} / {wall_b:.1f} ms, tokens bitwise the same, "
          f"logits finite; card {card}", flush=True)
    note = f" (depth {SCOUT_LAYERS} of {full.n_layers})"
    return counts, dict(mu_ms=prof.mu_ms, sigma_ms=prof.sigma_ms, walls_ms=[wall_a, wall_b]), {
        "tier-scout": (cfg, prof.mu_ms, prof.sigma_ms, note)}


def _zoo_xlstm(torch, card):
    """Full xlstm-350m as tier-xlstm: the dense engine and its launches per
    step; the continuous tier refuses it; the whole model card against CPU
    (:func:`_xlstm_card_vs_cpu`)."""
    from repro_torch.configs.archs import get_config
    from repro_torch.configs.mdinference_zoo import ServingGeometry
    from repro_torch.kernels import ops
    from repro_torch.serving.backend import ContinuousBatchingBackend
    from repro_torch.serving.profiles import QUALITY

    cfg = get_config(XLSTM_ARCH)
    ops.reset_launch_counts()  # the xLSTM path starts here
    engine, results = _serve_engine(torch, "zoo xlstm",
                                    [("tier-xlstm", cfg, QUALITY[XLSTM_ARCH])],
                                    "tier-xlstm", card)
    counts = ops.launch_counts()  # ... and ends here
    v = engine.variants["tier-xlstm"]
    results.update(_step_launches(torch, "zoo xlstm", v))
    geo = ServingGeometry(prompt_width=PROMPT, bs_ladder=(1, 2), n_slots=2, page_size=PAGE,
                          max_steps=GEN)
    try:
        ContinuousBatchingBackend(geo, device="cuda").register(v)
    except ValueError as e:
        print(f"[zoo xlstm] the continuous tier refuses it, as the JAX package's does: {e}",
              flush=True)
    else:
        fail("zoo xlstm: the continuous tier took an xLSTM stack")
    ops.reset_launch_counts()  # the comparison's launches are not the path's
    results["card_vs_cpu"] = _xlstm_card_vs_cpu(torch, cfg, v.params)
    ops.reset_launch_counts()
    mu, sigma = results["profiles"]["tier-xlstm"]
    return counts, results, {"tier-xlstm": (cfg, mu, sigma, "")}


def _f32_grid_norm(T, cfg, w, x):
    """A block's normed input for the float64 cell checks: the norm in f32,
    widened to float64.  On this f32 grid, with the bf16 weights, the
    cells' float64 input products round alike on the card and the CPU, so
    only the elementwise ops' last bits part the two, and the sLSTM's
    recurrence amplifies that to 5e-7 of a leaf (6.1e-7 in the vjps).  From
    full float64 inputs it amplifies the products' different summation
    orders to 1.7e-6 at block 7: beyond the 1e-6 that resolves an
    implementation fault (NVIDIA H100 80GB HBM3, 700.00 W)."""
    return T._norm(cfg, w.float(), x.float()).double()


def _xlstm_card_vs_cpu(torch, cfg, params, B=2, steps=16, forced_steps=2):
    """xlstm-350m's weights (the served bf16 values, exact in f32 and f64),
    card against CPU.

    At full depth the JAX init recipe makes f32 itself the limit: the
    residual stream grows to ~1e6 (no block rescales it), each block's f32
    output is ~1e-4 of its largest entry from float64, and the 24 layers
    amplify that until f32 prefill logits are O(1) from float64's on any
    device.  So the whole model in f32 is reported (prefill logits card vs
    CPU and each against float64 on the CPU, greedy steps until the tokens
    part), and the check is per block, in float64: each block's cell
    (mLSTM or sLSTM, the prefill of ``PROMPT`` tokens, then
    ``forced_steps`` decode steps), teacher-forced from the CPU float64
    run's input (normed in f32: :func:`_f32_grid_norm`) and state, on the
    card against the CPU, its output
    and every state leaf within 1e-6 of the leaf's largest entry (an
    implementation fault is off by the whole leaf; in float64 the mLSTM
    cells agree to ~1e-12 while the sLSTM's 128-step exponential-gate
    recurrence amplifies rounding to ~2e-8, measured on the card)."""
    import dataclasses

    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    def copy(dt, dev):
        return tree_map(lambda p: p.detach().to(dev, getattr(torch, dt)), params)

    c32, c64 = (dataclasses.replace(cfg, dtype=dt) for dt in ("float32", "float64"))
    tokens = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    whole = {name: _prefill_decode(torch, c, copy(c.dtype, dev), tokens.to(dev), steps)
             for name, c, dev in (("card", c32, "cuda"), ("cpu", c32, "cpu"),
                                  ("f64", c64, "cpu"))}
    err = {f"{a}_vs_{b}": float((whole[a][0][0].double() - whole[b][0][0].double()).abs().max())
           for a, b in (("card", "cpu"), ("card", "f64"), ("cpu", "f64"))}
    agree = int((whole["card"][1] == whole["cpu"][1]).all(dim=1).long().cumprod(0).sum())
    scale = float(whole["f64"][0][0].abs().max())
    for name in ("card", "cpu"):
        check(bool(torch.isfinite(whole[name][0]).all()), f"xlstm: {name} logits not finite")
    print(f"[zoo xlstm] whole model in f32, prefill of {PROMPT}: logits max|err| card vs CPU "
          f"{err['card_vs_cpu']:.3g}, card vs float64 {err['card_vs_f64']:.3g}, CPU vs float64 "
          f"{err['cpu_vs_f64']:.3g} (largest logit {scale:.3g}); greedy tokens of card and CPU "
          f"equal for {agree} of {steps} steps", flush=True)

    def blocks(p):
        n = c64.n_periods
        per_kind = [T._unstack(leaves, n) for leaves in p["periods"]]
        return ([(kind, per_kind[i][li]) for li in range(n) for i, kind in enumerate(c64.pattern)]
                + list(zip(c64.epilogue, p["epilogue"])))

    host, card = blocks(copy("float64", "cpu")), blocks(copy("float64", "cuda"))
    states = {dev: [T._block_cache(c64, kind, B, 0, torch.float64, dev) for kind, _ in host]
              for dev in ("cpu", "cuda")}
    p64 = copy("float64", "cpu")
    worst, n_checked = 0.0, 0
    with torch.inference_mode():
        x = T._embed_inputs(c64, p64, {"tokens": tokens})[0]
        for step in range(1 + forced_steps):
            ctx = T.SeqContext(positions=None, sin=None, cos=None, decode=step > 0)
            for j, ((kind, ph), (_, pc)) in enumerate(zip(host, card)):
                for key, t in states["cuda"][j].items():  # start from the host's state
                    t.copy_(states["cpu"][j][key])
                h = _f32_grid_norm(T, c64, ph["ln1"], x)
                y = T._xlstm_cell(c64, kind, ph["cell"], h, ctx, states["cpu"][j])
                yc = T._xlstm_cell(c64, kind, pc["cell"], h.to("cuda"), ctx, states["cuda"][j])
                for key, a, b in [("out", y, yc)] + [(k, states["cpu"][j][k], states["cuda"][j][k])
                                                     for k in states["cpu"][j]]:
                    e, big = float((b.cpu() - a).abs().max()), float(a.abs().max())
                    check(e <= 1e-6 * big, f"xlstm block {j} ({kind}) step {step} {key}: card vs "
                          f"CPU in float64 max|err| {e:.3g}, beyond 1e-6 of {big:.3g}")
                    worst = max(worst, e / max(big, 1e-300))
                    n_checked += 1
                x = x + y
            h = T._norm(c64, p64["final_norm"], x[:, -1:])
            tok = T._unembed(c64, p64, h)[:, 0].argmax(-1)
            x = T._embed_inputs(c64, p64, {"tokens": tok[:, None]})[0]
    print(f"[zoo xlstm] {len(host)} cells teacher-forced in float64, prefill + {forced_steps} "
          f"decode steps: {n_checked} outputs and state leaves, card vs CPU within "
          f"{worst:.3g} of their largest entry (bound 1e-6)", flush=True)
    return dict(err, steps_equal=agree, largest_logit=scale, float64_cells_worst=worst)


def _prefill_decode(torch, cfg, params, tokens, steps):
    """Prefill plus ``steps`` greedy decode steps: (logits (1 + steps, B, V)
    f32 on the CPU, tokens (steps, B))."""
    from repro_torch.models import transformer as T

    B, S = tokens.shape
    device = tokens.device
    with torch.inference_mode():
        cache, logits = T.prefill(cfg, params, {"tokens": tokens}, S + steps + 8)
        all_logits, toks = [logits.float().cpu()], []
        tok = logits.argmax(-1)
        for i in range(steps):
            toks.append(tok.cpu())
            pos = torch.full((B,), S + i, dtype=torch.int32, device=device)
            logits, cache = T.decode_step(cfg, params, cache, tok, pos)
            all_logits.append(logits.float().cpu())
            tok = logits.argmax(-1)
    return torch.stack(all_logits), torch.stack(toks)


def _zoo_table3(table, card):
    """Table III on the card: each tier's measured profile (batch 1, a
    prompt of ``PROMPT`` and ``GEN`` greedy tokens) beside the H100 roofline
    mu of ``lm_zoo_registry`` for the same request on one card (the
    published depth) and of the configuration as served (a depth cut)."""
    from repro_torch.serving.profiles import QUALITY, lm_zoo_registry, roofline_ms

    reg = lm_zoo_registry(prompt=PROMPT, gen_tokens=GEN, chips=1)
    roof = dict(zip(reg.names, reg.mu))
    rows = {}
    print(f"[zoo] Table III on {card}: measured mu / sigma (ms, batch 1, prompt {PROMPT}, "
          f"{GEN} tokens) beside the H100 roofline mu at chips=1 (lm_zoo_registry, published "
          "depth; and as served)", flush=True)
    for tier, (cfg, mu, sigma, note) in sorted(table.items(), key=lambda kv: kv[1][1]):
        served = roofline_ms(cfg, prompt=PROMPT, gen_tokens=GEN, chips=1)
        rows[tier] = dict(arch=cfg.name, mu_ms=mu, sigma_ms=sigma, roofline_mu_ms=roof[cfg.name],
                          served_roofline_mu_ms=served, quality=QUALITY[cfg.name],
                          note=note.strip())
        print(f"[zoo]   {tier:11s} {cfg.name:22s} quality {QUALITY[cfg.name]:4.1f}  measured "
              f"{mu:9.3f} +- {sigma:7.3f}  roofline {roof[cfg.name]:8.3f}  as served "
              f"{served:8.3f}  measured / served {mu / served:6.2f}{note}", flush=True)
    return rows


def _zoo_simulator(torch, card):
    """The paper's simulator with selection on the card and on the CPU:
    every algorithm, with and without duplication, over the paper zoo and
    the H100 LM zoo; ``model_index`` and the metrics must be identical."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.mdinference_zoo import paper_zoo
    from repro_torch.core.baselines import ALGORITHMS
    from repro_torch.core.network import FixedCVNetwork
    from repro_torch.core.simulator import SimConfig, run_simulation
    from repro_torch.serving.profiles import ONDEVICE_TIER, lm_zoo_registry

    out = {}
    for zoo, reg, extra in (("paper", paper_zoo(), {}),
                            ("lm", lm_zoo_registry(), {"ondevice": ONDEVICE_TIER})):
        for alg in ALGORITHMS:
            for dup in (False, True):
                cfg = SimConfig(registry=reg, algorithm=alg, t_sla_ms=SIM_SLA_MS,
                                n_requests=SIM_REQUESTS, network=FixedCVNetwork(100.0, 0.5),
                                duplication=dup, seed=0, **extra)
                t0 = time.perf_counter()
                a = run_simulation(cfg, device="cuda")
                t1 = time.perf_counter()
                b = run_simulation(cfg, device="cpu")
                t2 = time.perf_counter()
                same = (np.array_equal(a.model_index, b.model_index)
                        and dataclasses.asdict(a.metrics) == dataclasses.asdict(b.metrics))
                check(same, f"simulator {zoo} {alg} dup={dup}: the card and the CPU differ")
                m = a.metrics
                out[f"{zoo}/{alg}/{'dup' if dup else 'plain'}"] = dict(
                    accuracy=m.aggregate_accuracy, sla_attainment=m.sla_attainment,
                    card_s=t1 - t0, cpu_s=t2 - t1)
                print(f"[zoo simulator] {zoo:5s} {alg:16s} dup={int(dup)}: aggregate accuracy "
                      f"{m.aggregate_accuracy:.4f}, SLA attainment {m.sla_attainment:.4f}; "
                      f"model_index and metrics identical on the card and the CPU "
                      f"({t1 - t0:.3f} / {t2 - t1:.3f} s)", flush=True)
    print(f"[zoo simulator] {len(out)} runs of {SIM_REQUESTS} requests, SLA {SIM_SLA_MS:.0f} ms, "
          f"FixedCVNetwork(100, 0.5), seed 0: the card and the CPU choose the same models; "
          f"card {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The frontends: paligemma-3b served, hubert-xlarge's forward, both trained.
# ---------------------------------------------------------------------------
def plain_kernel_sites():
    """``(module, attribute, plain version)`` of every kernel wrapper the
    model calls through ``kernels.ops``: setting the attribute to the plain
    version runs the model on the same card tensors without the kernels.
    ``scripts/train_witness.py`` swaps through this table too."""
    from repro_torch.kernels import flash_attention_bwd as bk
    from repro_torch.kernels import ops, ref

    return [
        (ops._rmsnorm, "rms_norm_fwd",
         lambda x, w, eps, offset: ref.rms_norm_ref(x, w, eps=eps, offset=offset)),
        (ops._flash, "flash_attention_fwd", ref.flash_attention_ref),
        (bk, "flash_attention_bwd", ref.flash_attention_bwd_ref),
        (ops._decode, "decode_attention_fwd", ref.decode_attention_ref),
        (ops._rglru, "rglru_scan_fwd", ref.rglru_scan_ref),
        (ops._rglru, "rglru_scan_bwd", ref.rglru_scan_bwd_ref),
    ]


@contextlib.contextmanager
def plain_kernels(sites=None):
    """Within the block, each kernel of ``sites`` (default: every one of
    ``plain_kernel_sites()``) is its plain version; restored on exit."""
    sites = plain_kernel_sites() if sites is None else sites
    kernels = [getattr(mod, attr) for mod, attr, _ in sites]
    try:
        for mod, attr, plain in sites:
            setattr(mod, attr, plain)
        yield
    finally:
        for (mod, attr, _), kernel in zip(sites, kernels):
            setattr(mod, attr, kernel)


def _logits_gate(torch, label, cfg, params, run):
    """The kernels' bf16 logits ``run(cfg, params)`` against the plain
    versions on the same card tensors: the kernel run's relative Frobenius
    distance from the plain run in f32 (weights widened to f32) within
    REL_GATE times the plain bf16 run's, plus REL_FLOOR; and the share of
    rows whose argmax agrees with the f32 run.  Returns the readings."""
    import dataclasses

    from repro_torch.tree import tree_map

    got = run(cfg, params).float()
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    with plain_kernels():
        plain = run(cfg, params).float()
        exact = run(c32, p32)
    del p32
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits through the kernels")
    norm = float(exact.double().norm())
    dk, dp = (float((x.double() - exact.double()).norm()) / norm for x in (got, plain))
    agree = float((got.argmax(-1) == exact.argmax(-1)).float().mean())
    check(dk <= REL_GATE * dp + REL_FLOOR,
          f"{label}: the kernels' logits {dk:.4g} (relative) from the f32 plain run, beyond "
          f"{REL_GATE}x the bf16 plain run's {dp:.4g}")
    return dict(kernel_rel=dk, plain_rel=dp, argmax_agree=agree)


def _recorded_attention(torch, label, fn):
    """``fn()`` with every flash forward call recorded; then each call's
    kernel output held, on the same card tensors (the model's own q, k, v
    of every layer), to the plain version and to float64: its relative
    Frobenius error against float64 (``ref.flash_attention_ref`` on the
    inputs widened) within REL_GATE times the plain bf16 version's, plus
    REL_FLOOR, as ``_rel_gate`` holds the backward.  Unlike the logits, this
    does not wash out in the stack's chaos: a call that drops the prefix
    or the band is off by the whole of it.  Returns (fn's result,
    readings)."""
    from repro_torch.kernels import ops, ref

    kernel, calls = ops._flash.flash_attention_fwd, []

    def recording(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        calls.append((q, k, v, kw, out[0] if kw.get("return_lse") else out))
        return out

    ops._flash.flash_attention_fwd = recording
    try:
        result = fn()
    finally:
        ops._flash.flash_attention_fwd = kernel
    worst = dict(calls=len(calls), kernel_rel=0.0, plain_rel=0.0, ratio=0.0)
    with torch.inference_mode():
        for i, (q, k, v, kw, got) in enumerate(calls):
            kw = dict(kw, return_lse=False)
            exact = ref.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
            ke = _rel_err(torch, got, exact)[0]
            pe = _rel_err(torch, ref.flash_attention_ref(q, k, v, **kw), exact)[0]
            check(ke <= REL_GATE * pe + REL_FLOOR,
                  f"{label}: flash call {i} ({tuple(q.shape)}, prefix "
                  f"{kw.get('prefix_len') is not None}) relative error {ke:.4g} against float64, "
                  f"beyond {REL_GATE}x the plain bf16 version's {pe:.4g}")
            worst.update(kernel_rel=max(worst["kernel_rel"], ke),
                         plain_rel=max(worst["plain_rel"], pe),
                         ratio=max(worst["ratio"], ke / max(pe, REL_FLOOR)))
            del exact
    check(worst["calls"] > 0, f"{label}: no flash call was made")
    return result, worst


def phase_frontends(torch, card):
    """The audio and vision frontends at full width on the card.

    paligemma-3b (18 layers, d 2048, 8 q heads / 1 kv head x 256, vocab
    257,216), bf16, seeded weights: ``prefill`` of BATCH rows of 256 seeded
    patches (1152-d) before a PROMPT-token prompt, prefix-LM over the
    patches, then GEN greedy decode steps over the ring cache, run twice:
    tokens bitwise equal, one flash launch per layer per prefill and one
    ring-decode launch per layer per step; the prefill logits held to the
    plain versions on the same card tensors (``_logits_gate``), and each
    of its flash calls, on the model's own q, k, v and prefix, to float64
    (``_recorded_attention``).  hubert-xlarge (48 layers, d 1280, 16 heads
    x 80, bidirectional), bf16: a forward over TRAIN_BATCH x TRAIN_SEQ
    seeded frames (512-d), logits finite with the vocab's 504 classes,
    held the same two ways, one flash launch per layer.  Returns (launch
    counts, results)."""
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    results = {}
    counts = {}
    cfg = get_config(PALI_ARCH)
    P = cfg.num_prefix_tokens
    gen = torch.Generator().manual_seed(7)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    inputs = {"patches": torch.randn((BATCH, P, cfg.frontend_dim), generator=gen).cuda(),
              "tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen).cuda()}
    max_len = P + PROMPT + GEN

    def generate():
        with torch.inference_mode():
            cache, logits = T.prefill(cfg, params, inputs, max_len)
            tok, toks = logits.argmax(-1), []
            for i in range(GEN):
                toks.append(tok)
                pos = torch.full((BATCH,), P + PROMPT + i, dtype=torch.int32, device="cuda")
                logits, cache = T.decode_step(cfg, params, cache, tok, pos)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            return torch.stack(toks).cpu()

    ops.reset_launch_counts()  # the frontends' serving path starts here
    t0 = time.perf_counter()
    first = generate()
    t1 = time.perf_counter()
    second = generate()
    t2 = time.perf_counter()
    got = ops.launch_counts()  # and ends here
    _add_counts(counts, got)
    check(torch.equal(first, second), f"{PALI_ARCH}: greedy tokens differ between two runs")
    want = dict(flash_attention_fwd=2 * cfg.n_layers, decode_attention_fwd=2 * GEN * cfg.n_layers)
    check({k: got[k] for k in want} == want and got["rms_norm_fwd"] > 0,
          f"{PALI_ARCH}: launches {got}, expected {want} and norms")

    def prefill_logits(c, p):
        with torch.inference_mode():
            return T.prefill(c, p, inputs, max_len)[1]

    _, calls = _recorded_attention(torch, f"{PALI_ARCH} prefill",
                                   lambda: prefill_logits(cfg, params))
    gate = _logits_gate(torch, f"{PALI_ARCH} prefill", cfg, params, prefill_logits)
    results[PALI_ARCH] = dict(tokens_bitwise_equal=True, first_s=t1 - t0, second_s=t2 - t1,
                              launches=got, prefill_logits=gate, attention_calls=calls)
    print(f"[frontends] {PALI_ARCH} full width, bf16: prefill of {BATCH} x ({P} patches + "
          f"{PROMPT} tokens) + {GEN} greedy steps, twice: tokens bitwise equal, "
          f"{(t2 - t1) * 1e3:.1f} ms the second run ({(t1 - t0) * 1e3:.1f} ms the first); "
          f"launches {got}; prefill logits vs the plain versions on the card: relative "
          f"distance from f32 {gate['kernel_rel']:.4g} (plain bf16 {gate['plain_rel']:.4g}), "
          f"argmax agreeing with f32 on {gate['argmax_agree']:.3f} of rows (bf16 and f32 "
          f"runs part in the stack, the plain versions' too); each of the prefill's "
          f"{calls['calls']} flash calls on the model's own q, k, v and prefix against "
          f"float64: worst {calls['kernel_rel']:.4g} (plain bf16 {calls['plain_rel']:.4g}, "
          f"worst ratio {calls['ratio']:.3f}); card {card}", flush=True)
    del params, inputs
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_config(HUBERT_ARCH)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    frames = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.frontend_dim), generator=gen).cuda()

    def forward(c, p):
        with torch.inference_mode():
            x, _, _ = T.forward_hidden(c, p, {"frames": frames})
            return T._unembed(c, p, x)

    ops.reset_launch_counts()  # hubert's forward starts here
    t0 = time.perf_counter()
    logits = forward(cfg, params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = ops.launch_counts()  # and ends here
    _add_counts(counts, got)
    check(tuple(logits.shape) == (TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{HUBERT_ARCH}: logits {tuple(logits.shape)} not finite or not "
          f"({TRAIN_BATCH}, {TRAIN_SEQ}, {cfg.vocab_size})")
    check(got["flash_attention_fwd"] == cfg.n_layers and got["rms_norm_fwd"] > 0,
          f"{HUBERT_ARCH}: launches {got}, expected {cfg.n_layers} flash and norms")
    _, calls = _recorded_attention(torch, f"{HUBERT_ARCH} forward", lambda: forward(cfg, params))
    gate = _logits_gate(torch, f"{HUBERT_ARCH} forward", cfg, params, forward)
    results[HUBERT_ARCH] = dict(forward_s=t1 - t0, launches=got, logits=gate,
                                attention_calls=calls)
    print(f"[frontends] {HUBERT_ARCH} full width, bf16: forward over {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} frames in {(t1 - t0) * 1e3:.1f} ms (the first call), logits finite "
          f"{tuple(logits.shape)}; launches {got}; vs the plain versions on the card: relative "
          f"distance from f32 {gate['kernel_rel']:.4g} (plain bf16 {gate['plain_rel']:.4g}), "
          f"argmax agreeing with f32 on {gate['argmax_agree']:.3f} of frames; each of its "
          f"{calls['calls']} flash calls against float64: worst {calls['kernel_rel']:.4g} "
          f"(plain bf16 {calls['plain_rel']:.4g}, worst ratio {calls['ratio']:.3f}); "
          f"card {card}", flush=True)
    del params, frames, logits
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("rms_norm_fwd", "flash_attention_fwd", "decode_attention_fwd"):
        check(counts[name] > 0, f"frontends: kernel {name} was never launched on its path")
    return counts, results


def phase_frontend_train(torch, card):
    """The two train commands, ``python -m repro_torch.launch.train --arch
    A --full-config --batch TRAIN_BATCH --seq TRAIN_SEQ`` for paligemma-3b
    (2.51 B parameters, ~30 GB of state; its 256 patches before the text)
    and hubert-xlarge (0.95 B, ~11 GB), FRONTEND_TRAIN_STEPS steps each
    (``phase_train_cli``: exit 0, finite losses, the last below the first,
    the flash launches of the layer kinds), then each model's bf16
    ``loss_fn`` gradient at its full
    width, 2 layers, against the plain backward (``_model_bf16_grads``:
    every leaf non-zero, ``frontend.proj`` included)."""
    from repro_torch.configs.archs import get_config

    counts, results = {}, {}
    for arch in (PALI_ARCH, HUBERT_ARCH):
        c, results[arch] = phase_train_cli(torch, card, arch, FRONTEND_TRAIN_STEPS)
        _add_counts(counts, c)
        _model_bf16_grads(torch, get_config(arch, n_layers=2))
    return counts, results


def _train_launches(cfg):
    """Launches per train step worked out from the layer kinds, with remat
    on the periods only: the periods' blocks run their forward twice
    (forward and recompute), the epilogue's once, and every block its
    backward once."""
    n_p = cfg.n_periods

    def count(kinds):
        period = sum(k in kinds for k in cfg.pattern)
        epilogue = sum(k in kinds for k in cfg.epilogue)
        return 2 * n_p * period + epilogue, n_p * period + epilogue

    attn_fwd, attn_bwd = count(("attn", "local", "moe"))
    rec_fwd, rec_bwd = count(("recurrent",))
    # The scan's backward is the same kernel run in reverse, counted apart.
    return dict(flash_attention_fwd=attn_fwd, flash_attention_bwd=attn_bwd,
                rglru_scan_fwd=rec_fwd, rglru_scan_bwd=rec_bwd)


def train_setup(torch, cfg):
    """``(step_fn, pipe, state, held_out_loss)`` of the train phase: its
    optimizer settings, batch ``TRAIN_BATCH`` x ``TRAIN_SEQ`` of the seed-0
    pipeline, the state from seed 0 on the card, and the loss of a fixed
    batch the run never trains on (``held_out_loss(state)``)."""
    from repro_torch.models.transformer import loss_fn
    from repro_torch.training import (
        DataConfig, OptimizerConfig, TrainConfig, init_train_state, make_pipeline,
        make_train_step,
    )

    opt_cfg = OptimizerConfig(learning_rate=3e-4, warmup_steps=min(100, TRAIN_STEPS // 10 + 1),
                              total_steps=TRAIN_STEPS)
    step_fn = make_train_step(cfg, opt_cfg, TrainConfig())
    pipe = make_pipeline(DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0), cfg)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), TrainConfig(), device="cuda")
    held = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(HELD_OUT_BATCH).items()}

    def held_out_loss(st):
        with torch.no_grad():
            return float(loss_fn(cfg, st["params"], held)[0])

    return step_fn, pipe, state, held_out_loss


def _expert_loads(torch, cfg, params, batch):
    """Tokens routed to each expert of each MoE layer, (layers, experts),
    by one forward of ``batch`` without autograd (the layers in order)."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import loss_fn

    route, loads = moe._route, []

    def counting(c, router_w, x):
        top_idx, top_gate, aux = route(c, router_w, x)
        loads.append(torch.bincount(top_idx.flatten(), minlength=c.n_experts).cpu())
        return top_idx, top_gate, aux

    moe._route = counting
    try:
        with torch.no_grad():
            loss_fn(cfg, params, batch)
    finally:
        moe._route = route
    return torch.stack(loads)



# ---------------------------------------------------------------------------
# Phase 9: train full-width gemma-2b and recurrentgemma-2b.
# ---------------------------------------------------------------------------
def phase_train(torch, arch, card, profile: bool, layers=None, learn_check=True):
    """12 steps of ``make_train_step`` on full-width ``arch`` (the code path
    of ``python -m repro_torch.launch.train --arch ARCH --full-config``,
    with its optimizer settings), cut to ``layers`` when given (never its
    width).  ``learn_check``: whether the held-out batch must fall and the
    last train losses sit below the first (only for a model whose plain
    witness run learns, ``scripts/train_witness.py``)."""
    import numpy as np
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch) if layers is None else get_config(arch, n_layers=layers)
    moe = "moe" in cfg.layer_kinds()
    B, S, L = TRAIN_BATCH, TRAIN_SEQ, cfg.n_layers
    if L != get_config(arch).n_layers:
        print(f"[train] CUT: {arch} reduced: depth {L} of {get_config(arch).n_layers} layers "
              "(width unchanged)", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    step_fn, pipe, state, held_out_loss = train_setup(torch, cfg)
    torch.cuda.synchronize()
    t_state = time.perf_counter() - t0
    held_before = held_out_loss(state)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"[train] {cfg.name}: {L} layers {cfg.layer_kinds().count('recurrent')} recurrent "
          f"(lru width {cfg.lru_width}), {cfg.layer_kinds().count('moe')} MoE ({cfg.n_experts} "
          f"experts top-{cfg.top_k}, expert d_ff {cfg.expert_d_ff}), d {cfg.d_model}, "
          f"{cfg.n_heads} q / "
          f"{cfg.n_kv_heads} kv heads x {cfg.head_dim}, d_ff {cfg.d_ff} {cfg.mlp_type}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, remat={cfg.remat}; {n_params / 1e9:.3f}B params; "
          f"state built in {t_state:.1f}s, "
          f"{(torch.cuda.memory_allocated() - before) / 2**30:.1f} GiB; batch {B} x {S} "
          f"tokens, {TRAIN_STEPS} steps", flush=True)

    losses, auxes, step_ms = [], [], []
    loads = None
    if moe:  # which experts the first batch reaches, layer by layer
        first = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(0).items()}
        loads = _expert_loads(torch, cfg, state["params"], first)
        del first
    ops.reset_launch_counts()  # the train path starts here
    for step in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(step).items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
        auxes.append(float(metrics["aux"]))
        if step == 0:
            # mu = (1 - beta1) * clip * grad after the first update: each
            # leaf's gradient was finite and non-zero iff its mu is.
            for i, mu in enumerate(tree_leaves(state["opt"]["mu"])):
                check(bool(torch.isfinite(mu).all()) and float(mu.abs().max()) > 0,
                      f"train {arch}: leaf {i} {tuple(mu.shape)} got a zero or non-finite "
                      "gradient")
            if moe:  # and every expert that took tokens, layer by layer
                _check_expert_grads(torch, arch, state["opt"]["mu"], loads)
        print(f"[train] {arch} step {step:2d}  loss {loss:.4f}  "
              + (f"aux {auxes[-1]:.4f}  " if moe else "")
              + f"gnorm {gnorm:.3f}  lr {float(metrics['lr']):.2e}  {step_ms[-1]:.1f} ms",
              flush=True)
    counts = ops.launch_counts()  # the train path ends here
    peak = torch.cuda.max_memory_allocated()
    held_after = held_out_loss(state)
    print(f"[train] {arch} held-out batch {HELD_OUT_BATCH} (never trained on): loss "
          f"{held_before:.4f} before, {held_after:.4f} after {TRAIN_STEPS} steps", flush=True)
    want = _train_launches(cfg)
    # One more step under torch.profiler: the flash backward's share of it.
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(TRAIN_STEPS).items()}
    prof = _profile_step(torch, lambda: step_fn(state, batch), f"{arch} train step", card,
                         verbose=profile)
    bwd_ms = sum(ms for fam, ms in prof["families"].items() if fam.startswith("flash_bwd"))
    print(f"[train] {arch} profiled step: device busy {prof['device_busy_ms']:.1f} ms of "
          f"{prof['wall_ms']:.1f} ms wall; flash backward family {bwd_ms:.2f} ms "
          f"({100 * bwd_ms / prof['device_busy_ms']:.1f} % of busy, "
          f"{bwd_ms / want['flash_attention_bwd']:.3f} ms a call over "
          f"{want['flash_attention_bwd']} calls); card {card}", flush=True)

    steady = statistics.median(step_ms[1:])
    tokens = B * S
    # Model FLOPs (remat's recompute not counted): 6 per parameter and
    # token, plus attention's 12 * D per (q, k) pair in the causal window
    # and q head, over the attention layers.  A MoE token meets its top-k
    # experts only: the active parameters.
    active = cfg.param_count(active_only=True) if moe else n_params
    n_attn = sum(k in ("attn", "local", "moe") for k in cfg.layer_kinds())
    span = cfg.window if cfg.window else S
    pairs = sum(min(q + 1, span) for q in range(S))
    flops = 6 * active * tokens + 12 * n_attn * cfg.head_dim * B * cfg.n_heads * pairs
    result = dict(
        arch=cfg.name, params=n_params, active_params=active, layers=L, aux=auxes,
        batch=B, seq=S, steps=TRAIN_STEPS, losses=losses,
        held_out_loss=[held_before, held_after], profile=prof, flash_bwd_ms=bwd_ms,
        step_ms=step_ms, median_step_ms=steady, tokens_per_s=tokens / steady * 1e3,
        mfu=flops / (steady / 1e3) / H100_BF16_FLOPS, model_flops_per_step=flops,
        peak_gib=peak / 2**30, launches_per_step={k: v / TRAIN_STEPS for k, v in counts.items()},
    )
    print(f"[train] {arch} median step {steady:.1f} ms (steps 1-{TRAIN_STEPS - 1}; step 0 "
          f"{step_ms[0]:.1f} ms): {result['tokens_per_s']:.0f} tokens/s, MFU "
          f"{100 * result['mfu']:.2f} % of 989 TFLOP/s bf16 ({flops / 1e12:.1f} TFLOP model "
          f"FLOPs per step, {active / 1e9:.3f}B {'active ' if moe else ''}params); peak memory "
          f"{result['peak_gib']:.1f} GiB; loss {losses[0]:.4f} -> "
          f"{np.mean(losses[-3:]):.4f} (mean of last 3); card {card}", flush=True)
    print(f"[train] {arch} kernel launches per step: {result['launches_per_step']}", flush=True)
    check(all(np.isfinite(losses)), f"train {arch}: non-finite losses {losses}")
    check(all(np.isfinite(auxes)) and (min(auxes) > 0) == moe,
          f"train {arch}: load-balancing losses {auxes}")
    if learn_check:
        check(held_after < held_before, f"train {arch}: the held-out batch's loss "
              f"{held_after:.4f} after training is not below its {held_before:.4f} before")
        check(float(np.mean(losses[-3:])) < losses[0],
              f"train {arch}: mean of the last 3 losses {np.mean(losses[-3:]):.4f} not below "
              f"the first {losses[0]:.4f}")
    scan = ("rglru_scan_fwd", "rglru_scan_bwd") if want["rglru_scan_fwd"] else ()
    for name in TRAIN_PATH_KERNELS + scan:
        check(counts[name] > 0, f"train {arch}: kernel {name} was never launched on the "
              "train path")
    got = {k: counts[k] / TRAIN_STEPS for k in want}
    check(got == want, f"train {arch}: launches per step {got}, expected {want} (remat on "
          "the periods)")
    del state
    torch.cuda.empty_cache()
    return counts, result


def _check_expert_grads(torch, arch, mu, loads):
    """After the first update, each expert's slice of every expert weight
    (``wi``, ``wg``, ``wo``, stacked (layers, experts, ...)) has a finite,
    non-zero ``mu``, hence gradient, wherever ``loads`` (layers, experts)
    says the expert took tokens."""
    took = loads > 0
    for i, block in enumerate(mu["periods"]):
        for name, leaf in block["moe"].items():
            if leaf.dim() != 4:  # the router and shared experts are checked as leaves
                continue
            flat = leaf.flatten(2)
            nonzero = (flat.abs().amax(-1) > 0).cpu()
            check(bool(torch.isfinite(flat).all()),
                  f"train {arch}: expert weight {i}/{name} has a non-finite gradient")
            check(bool(nonzero[took].all()),
                  f"train {arch}: {int((took & ~nonzero).sum())} (layer, expert) slices of "
                  f"{name} took tokens but got a zero gradient")
    print(f"[train] {arch}: every expert slice of wi / wg / wo got a finite gradient, non-zero "
          f"for all {int(took.sum())} of {took.numel()} (layer, expert) pairs that took tokens "
          f"(tokens per expert {int(loads.min())}-{int(loads.max())})", flush=True)


# ---------------------------------------------------------------------------
# Phase 10: the distributed and analysis tooling on the card.
# ---------------------------------------------------------------------------
MB_GRAD_REL_BOUND = 0.05  # microbatched vs unsplit bf16 gradient, per leaf
MB_TRAIN_STEPS = 3
SHARDED_LAYERS = 2  # gemma-2b at full width for the world-1 sharded step


def _count(fn, prefix_len=None):
    """The :class:`CostCounter` of one call of ``fn`` (synchronised)."""
    import torch
    from repro_torch.kernels.cost import CostCounter

    with CostCounter(prefix_len=prefix_len) as c:
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return c


def _same_count(label, real, meta):
    """The card's count must equal the meta trace's, as integers: else the
    ops and kernels whose counts differ are printed and the run fails."""
    if real.totals() == meta.totals() and real.kernels == meta.kernels:
        top = sorted(real.by_op.items(), key=lambda kv: -kv[1][2])[:6]
        print(f"[counter] {label}: card == meta: {real.totals()}; kernel calls "
              f"{ {k: v[0] for k, v in real.kernels.items()} }; most bytes (calls, GB): "
              + ", ".join(f"{k} ({v[0]}, {v[2] / 1e9:.1f})" for k, v in top), flush=True)
        return
    for name in sorted(set(real.by_op) | set(meta.by_op)):
        if real.by_op.get(name) != meta.by_op.get(name):
            print(f"[counter] {label}: {name} card {real.by_op.get(name)} meta "
                  f"{meta.by_op.get(name)}", flush=True)
    for name in sorted(set(real.kernels) | set(meta.kernels)):
        if real.kernels.get(name) != meta.kernels.get(name):
            print(f"[counter] {label}: kernel {name} card {real.kernels.get(name)} meta "
                  f"{meta.kernels.get(name)}", flush=True)
    fail(f"{label}: the card's count {real.totals()} != the meta trace's {meta.totals()}")


def _step_roofline(label, c, ms, card):
    """The counted step's roofline at chips=1 beside its measured ms."""
    from repro_torch.launch import roofline as rf

    terms = rf.cost_terms({"flops": c.flops, "bytes": c.bytes, "coll_bytes": 0.0}, chips=1)
    bound_ms = 1e3 * max(terms.values())
    out = dict(flops=c.flops, bytes=c.bytes, f32_ops=c.f32_ops,
               compute_ms=1e3 * terms["compute_s"], memory_ms=1e3 * terms["memory_s"],
               measured_ms=ms, roofline_share=bound_ms / ms)
    print(f"[counter] {label} roofline at chips=1 (H100 data sheet): compute "
          f"{out['compute_ms']:.3f} ms ({c.flops / 1e12:.3f} TFLOP), memory "
          f"{out['memory_ms']:.3f} ms ({c.bytes / 1e9:.3f} GB); measured {ms:.3f} ms: "
          f"{100 * out['roofline_share']:.1f} % of the roofline; card {card}", flush=True)
    return out


def phase_decode_count(torch, engine, card):
    """tier-l's decode step at batch ``BATCH`` counted on the card (the
    kernels launched) and traced on meta tensors: FLOPs and bytes equal as
    integers.  The ring holds ``PROMPT + 1`` slots, all live at the counted
    step (a meta trace counts every slot), and the step's time is the
    median of 10 uncounted steps."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    v = next(v for v in engine.variants.values() if v.name == "tier-l")
    cfg, params, B, L = v.cfg, v.params, BATCH, PROMPT + 1
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen).cuda()
    with torch.inference_mode():
        cache, logits = T.prefill(cfg, params, {"tokens": prompt}, max_len=L)
        token = logits.argmax(-1)
        pos = torch.full((B,), PROMPT, dtype=torch.int32, device="cuda")

        def step():
            return T.decode_step(cfg, params, cache, token, pos)

        ms = []
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i >= 3:
                ms.append((time.perf_counter() - t0) * 1e3)
        before = ops.launch_counts()
        real = _count(step)
        launched = {k: ops.launch_counts()[k] - before[k] for k in before}
        check(launched["decode_attention_fwd"] == cfg.n_layers
              and launched["rms_norm_fwd"] > 0,
              f"decode count: the counted step launched {launched}")
        meta_p = T.init_params(cfg, device="meta")
        meta_c = T.init_cache(cfg, B, L, device="meta")
        meta = _count(lambda: T.decode_step(
            cfg, meta_p, meta_c, torch.empty(B, dtype=token.dtype, device="meta"),
            torch.empty(B, dtype=torch.int32, device="meta")))
    _same_count(f"tier-l decode step (batch {B}, ring {L} slots, {cfg.n_layers} layers)",
                real, meta)
    return _step_roofline("tier-l decode step", real, statistics.median(ms), card)


def phase_train_tools(torch, card, gemma_step_ms):
    """On full-width gemma-2b at the train phase's shape: step 0's
    gradient with ``microbatches=2`` against the unsplit one, leaf by leaf
    (relative Frobenius distance within ``MB_GRAD_REL_BOUND``), then
    ``MB_TRAIN_STEPS`` steps with ``microbatches=2`` and
    ``grad_compression`` (finite losses); one train step counted on the
    card against its meta trace (FLOPs and bytes equal as integers) and its
    roofline beside the train phase's median step; then
    :func:`_sharded_world1`."""
    import numpy as np
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import (
        DataConfig, OptimizerConfig, TrainConfig, init_train_state, make_grads_fn,
        make_pipeline, make_train_step,
    )
    from repro_torch.tree import named_leaves

    cfg = get_config(TRAIN_ARCHS[0])
    pipe = make_pipeline(DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0), cfg)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(0).items()}
    opt_cfg = OptimizerConfig(learning_rate=3e-4, warmup_steps=2, total_steps=MB_TRAIN_STEPS)
    out = {}

    # Step 0's gradient, unsplit and in two microbatches, on the same state.
    state = init_train_state(cfg, torch.Generator().manual_seed(0), TrainConfig(), device="cuda")
    _, _, whole = make_grads_fn(cfg, TrainConfig())(state["params"], batch)
    whole = {k: g.float() for k, g in named_leaves(whole)}
    _, _, split = make_grads_fn(cfg, TrainConfig(microbatches=2))(state["params"], batch)
    rel = {}
    for k, g in named_leaves(split):
        w = whole.pop(k)
        rel[k] = float((g.float() - w).norm() / w.norm().clamp_min(1e-30))
        del w
    del split, whole, state
    worst = max(rel, key=rel.get)
    print(f"[train tools] gemma-2b step 0 gradient, microbatches=2 vs unsplit (bf16, leaf by "
          f"leaf, relative Frobenius): worst {rel[worst]:.5f} at {worst}, median "
          f"{statistics.median(rel.values()):.5f} (bound {MB_GRAD_REL_BOUND})", flush=True)
    check(rel[worst] <= MB_GRAD_REL_BOUND,
          f"microbatched gradient {worst} {rel[worst]:.5f} from the unsplit one")
    out["microbatch_grad_rel"] = rel

    # Three steps with microbatches=2 and int8 compression with feedback.
    tc = TrainConfig(microbatches=2, grad_compression=True)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), tc, device="cuda")
    step_fn = make_train_step(cfg, opt_cfg, tc)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    ops.reset_launch_counts()
    for i in range(MB_TRAIN_STEPS):
        b = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[train tools] gemma-2b microbatches=2 grad_compression: losses {losses}, step ms "
          f"{[round(x, 1) for x in ms]}, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB, launches {ops.launch_counts()}; card {card}", flush=True)
    check(all(np.isfinite(losses)), f"microbatched compressed steps: losses {losses}")
    out.update(mb_compressed_losses=losses, mb_compressed_step_ms=ms)
    del state, step_fn

    # One step counted on the card and traced on meta.
    step_fn = make_train_step(cfg, opt_cfg, TrainConfig())
    state = init_train_state(cfg, torch.Generator().manual_seed(0), TrainConfig(), device="cuda")
    real = _count(lambda: step_fn(state, batch))
    meta_state = init_train_state(cfg, None, TrainConfig(), device="meta")
    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    meta = _count(lambda: step_fn(meta_state, meta_batch))
    del state
    torch.cuda.empty_cache()
    _same_count(f"gemma-2b train step ({TRAIN_BATCH} x {TRAIN_SEQ}, remat)", real, meta)
    out["train_step"] = _step_roofline("gemma-2b train step", real, gemma_step_ms, card)
    out.update(_sharded_world1(torch, card, cfg, opt_cfg, pipe))
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sharded_world1(torch, card, cfg, opt_cfg, pipe):
    """Over an NCCL process group of one rank: ``make_train_step`` on a
    (1, 1) mesh with ``make_rules`` (the state placed as DTensors) against
    the unsharded step, bitwise over two steps (losses, grad norms and every
    leaf of the state); the parameters saved and restored with
    ``shardings`` onto the mesh, bitwise; ``compressed_psum`` over the
    group, bitwise the requantize formula."""
    import dataclasses
    import tempfile

    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.compression import compressed_psum, quantize_int8
    from repro_torch.launch.mesh import make_mesh, make_rules
    from repro_torch.training import (
        TrainConfig, init_train_state, make_train_step, place_state, state_shardings,
    )
    from repro_torch.tree import named_leaves, tree_leaves

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        cfg = dataclasses.replace(cfg, n_layers=SHARDED_LAYERS)
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = make_rules(mesh)
        tc = TrainConfig()
        shardings = state_shardings(cfg, mesh, rules, tc)
        plain = init_train_state(cfg, torch.Generator().manual_seed(0), tc, device="cuda")
        sharded = place_state(
            init_train_state(cfg, torch.Generator().manual_seed(0), tc, device="cuda"), shardings)
        plain_step = make_train_step(cfg, opt_cfg, tc)
        sharded_step = make_train_step(cfg, opt_cfg, tc, mesh=mesh, rules=rules)
        for i in range(2):
            b = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(i).items()}
            plain, pm = plain_step(plain, b)
            sharded, sm = sharded_step(sharded, b)
            for key in ("loss", "grad_norm", "xent", "tokens"):
                check(torch.equal(pm[key], sm[key]),
                      f"sharded step {i}: {key} {float(sm[key])} != {float(pm[key])}")
        for (path, a), b in zip(named_leaves(plain), tree_leaves(sharded)):
            check(torch.equal(a, b.full_tensor()), f"sharded state after 2 steps: {path} differs")
        print(f"[sharded] gemma-2b at {SHARDED_LAYERS} layers, full width, on an NCCL world-1 "
              f"(1, 1) mesh: two steps bitwise the unsharded step (loss {float(pm['loss']):.4f},"
              f" grad norm {float(pm['grad_norm']):.4f}); card {card}", flush=True)

        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            mgr.save(2, plain["params"])
            restored, _ = mgr.restore(plain["params"], shardings=shardings["params"])
        for (path, a), b in zip(named_leaves(plain["params"]), tree_leaves(restored)):
            check(isinstance(b, torch.distributed.tensor.DTensor) and b.requires_grad
                  and torch.equal(a, b.full_tensor()),
                  f"restore with shardings: {path} differs")
        print("[sharded] restore(shardings=) onto the mesh: every parameter bitwise the saved "
              "one, a DTensor on its sharding", flush=True)

        gen = torch.Generator().manual_seed(11)
        x = torch.randn(4096, 1024, generator=gen).cuda()
        got = compressed_psum(x, mesh.get_group("data"))
        q, scale = quantize_int8(x)
        want = (q.to(torch.int32).float() * scale).to(x.dtype)
        check(torch.equal(got, want), "compressed_psum over one rank != the requantize formula")
        print("[sharded] compressed_psum over the world-1 group: bitwise the requantize "
              "formula", flush=True)
        del plain, sharded, restored
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"sharded_world1": "bitwise", "restore_shardings": "bitwise",
            "compressed_psum": "bitwise"}


# ---------------------------------------------------------------------------
# Phase 11: tensor-parallel training, four ranks on the one card.
# ---------------------------------------------------------------------------
TP_WORLD = 4
# (arch, (data, model) mesh, config overrides, rule table): full width, depth
# cut to SHARDED_LAYERS, or to one period where a period is longer
# (xlstm-350m's 7 mLSTM + 1 sLSTM blocks); olmoe's MoE groups split over its
# two data ranks; llama3-8b a second time under RULES_2D_SP, its residual
# stream split over the sequence (``distributed/tensor_parallel.py``).
TP_CASES = (("llama3-8b", (1, 4), {}, "RULES_2D"), ("gemma-2b", (1, 4), {}, "RULES_2D"),
            ("olmoe-1b-7b", (2, 2), {"moe_groups": 2}, "RULES_2D"),
            ("xlstm-350m", (1, 4), {}, "RULES_2D"), ("llama3-8b", (1, 4), {}, "RULES_2D_SP"))
# Each case's train batch: TRAIN_BATCH x TRAIN_SEQ, xlstm-350m at its train
# command's 8 x 128 (ROADMAP.md Queue C item 5: its bf16 gradient is not
# finite at 2048 tokens a row).
TP_TRAIN_SHAPES = {XLSTM_ARCH: (XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ)}
# The last step's collectives, result bytes on rank 0, within this share of
# the roofline's reckoning on a mesh with one data rank (there the
# reckoning's weight terms are nil; on (2, 2) it counts a weight gather per
# forward pass where the step gathers once, so olmoe's is printed only).
TP_BYTES_RTOL = 0.2
TP_STEPS = 2
TP_GRAD_BOUND = 3.0  # times the unsharded bf16 run's own error against float64
# Relative floor of the bf16 loss and xent checks (a mean over 4096 tokens
# whose rounding errors the two runs draw independently): a few times the
# measured noise (3e-4).
TP_METRIC_FLOOR = 2.0 ** -9
# The float64 runs (the plain kernels: the kernels have no float64 route)
# against each other.  At full width the JAX init's fan-in makes the stack
# chaotic: a rounding difference grows ~1e8-fold into a layer's gradients
# (the float64 runs differ by up to 6.5e-8 at one layer), so in bf16 and
# f32 most leaves' gradients are noise and only float64 can show a wrong
# sum.
TP_F64_LEAF_TOL = 1e-4  # relative Frobenius distance, each leaf
TP_F64_METRIC_RTOL = 1e-9  # the xent; the loss adds the MoE's f32 router loss:
TP_AUX_RTOL = 1e-5  # the router is f32 in every dtype, as in the JAX model
# The float64 runs' cut (the bf16 runs keep the model's vocab and depth):
# four ranks' float64 token tables and their gradients (4.2 GB each at
# llama3-8b's 128256 x 4096, whole on every rank) do not fit one card
# beside the rest, and gloo moves their float64 weights and gradients
# through host memory: one period (one layer; xlstm-350m's 8 blocks, so the
# sLSTM is held too), 8192 entries (still split over the ranks).
TP_F64_VOCAB = 8192
TP_RANK_TIMEOUT_S = 400.0
_SPAWNED = []  # rank processes, killed by the watchdog too


def _tp_cfg(arch, over):
    import dataclasses

    from repro_torch.configs.archs import get_config

    base = get_config(arch)
    return dataclasses.replace(base, n_layers=max(SHARDED_LAYERS, len(base.pattern)), **over)


def _tp_label(arch, table):
    """A tensor-parallel case's name in the readings and the printed lines."""
    return arch if not table.endswith("_SP") else f"{arch} {table}"


def _tp_heads(cfg, rank, size):
    """What rank ``rank`` of ``size`` computes: its attention heads, or its
    xLSTM heads."""
    import dataclasses

    from repro_torch.distributed import tensor_parallel as tpm

    if any(k in ("attn", "local", "moe") for k in cfg.layer_kinds()):
        return dataclasses.asdict(tpm.local_heads(cfg, rank, size))
    per = cfg.xlstm_heads // size
    return {"xlstm_heads": [rank * per, (rank + 1) * per]}


def _widen(torch, p, dtype):
    """``p`` trainable, widened to ``dtype`` where that is wider (exactly)."""
    return p.to(torch.promote_types(p.dtype, getattr(torch, dtype))).requires_grad_(True)


def _tp_params(torch, cfg, dtype):
    """Seed 0's parameters of the bf16 ``cfg`` on the card, each leaf
    widened to ``dtype`` where that is wider: every run of a case holds the
    same values, so one float64 run is every run's reference."""
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import tree_map

    return tree_map(lambda p: _widen(torch, p, dtype),
                    init_params(cfg, torch.Generator().manual_seed(0), "cuda"))


def _tp_state(torch, cfg, shardings, dtype):
    """:func:`_tp_params` placed on ``shardings`` leaf by leaf, with zero
    moments and step made on each rank's shards (no rank holds a whole
    widened model or a whole state's f32 moments)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.transformer import init_params
    from repro_torch.training import place_state
    from repro_torch.tree import tree_map

    params = tree_map(lambda p, s: place_state(_widen(torch, p, dtype), s),
                      init_params(cfg, torch.Generator().manual_seed(0), "cuda"),
                      shardings["params"])

    def zeros(p):
        return DTensor.from_local(torch.zeros(p.to_local().shape, dtype=torch.float32,
                                              device="cuda"),
                                  p.device_mesh, p.placements, run_check=False, shape=p.shape,
                                  stride=p.stride())

    step = place_state(torch.zeros((), dtype=torch.int32, device="cuda"),
                       shardings["opt"]["step"])
    return {"params": params, "opt": {"mu": tree_map(zeros, params),
                                      "nu": tree_map(zeros, params), "step": step}}


@contextlib.contextmanager
def _counting_collectives(dist, last=True, seconds=None):
    """Within the block (when ``last``), the result bytes on this rank of
    every all-reduce, all-gather and reduce-scatter, by kind (the
    convention of ``launch/roofline.py``), into the dict it yields; with
    a ``seconds`` dict, the host seconds spent in each call too, by kind
    (a blocking call's: the wait for the kernels before it included)."""
    traffic, names = {}, {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
                          "reduce_scatter_tensor": "reduce-scatter"}
    calls = {name: getattr(dist, name) for name in names}

    def counted(name):
        def call(out, *args, **kw):
            kind = names[name]
            traffic[kind] = traffic.get(kind, 0) + out.numel() * out.element_size()
            t0 = time.perf_counter()
            try:
                return calls[name](out, *args, **kw)
            finally:
                if seconds is not None:
                    seconds[kind] = seconds.get(kind, 0.0) + time.perf_counter() - t0
        return call

    try:
        for name in names:
            if last:
                setattr(dist, name, counted(name))
        yield traffic
    finally:
        for name, fn in calls.items():
            setattr(dist, name, fn)


def _tp_case(torch, rank, world, arch, shape, over, table):
    """One case on this rank.  In bf16: the tensor-parallel gradients and
    ``TP_STEPS`` train steps on the mesh (the kernels' launches, step ms,
    memory, the collectives' bytes of the last step, the flash calls'
    shapes); in float64 (the same weights widened, the plain kernels): the
    tensor-parallel gradients.  Then rank 0 alone, while the others wait,
    takes the unsharded gradients in float64 and bf16 on the same weights
    and batch; then every leaf is gathered and rank 0 measures the
    relative Frobenius distances: bf16, each run against float64; float64,
    the two runs against each other."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.distributed import api
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.training import (
        DataConfig, OptimizerConfig, TrainConfig, make_grads_fn, make_pipeline, make_train_step,
        state_shardings,
    )
    from repro_torch.tree import named_leaves

    cfg = _tp_cfg(arch, over)
    mesh = _tp_mesh(shape, world)
    rules = api.AxisRules(mesh, getattr(api, table))
    B, S = TP_TRAIN_SHAPES.get(arch, (TRAIN_BATCH, TRAIN_SEQ))
    pipe = make_pipeline(DataConfig(batch_size=B, seq_len=S, seed=0), cfg)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(i).items()}
               for i in range(TP_STEPS)]
    out = dict(arch=arch, mesh=list(shape), table=table,
               heads=_tp_heads(cfg, mesh.get_local_rank("model"), shape[1]))
    kernel, shapes = ops._flash.flash_attention_fwd, set()
    apply_block, residual = T.apply_block, set()

    def recording(q, k, v, **kw):
        shapes.add((str(q.dtype), tuple(q.shape), tuple(k.shape)))
        return kernel(q, k, v, **kw)

    def reading(cfg, kind, p, x, ctx, cache):  # the residual stream a block reads
        residual.add(tuple(x.shape))
        return apply_block(cfg, kind, p, x, ctx, cache)

    # The float64 runs: cut to TP_F64_VOCAB and one period, their own batch.
    cut = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, TP_F64_VOCAB),
                              n_layers=len(cfg.pattern))
    cut_batch = {k: torch.from_numpy(v).to("cuda") for k, v in make_pipeline(
        DataConfig(batch_size=B, seq_len=S, seed=0), cut).batch_at(0).items()}
    seconds, t_case = {}, time.perf_counter()

    def lap(name):  # where the case's time goes
        nonlocal t_case
        seconds[name] = round(time.perf_counter() - t_case, 1)
        t_case = time.perf_counter()

    # An xLSTM stack is chaotic at full width: its whole-model float64
    # gradient does not hold the split (it parts from the unsharded one by
    # more than its own size), so its cells are held instead (_tp_cells).
    chaotic = bool({"mlstm", "slstm"} & set(cfg.layer_kinds()))
    ops.reset_launch_counts()
    grads, tp_metrics = {}, {}
    runs = (("bfloat16", cfg, batches[0]),) + (() if chaotic else (("float64", cut, cut_batch),))
    for dtype, base, batch in runs:
        c = dataclasses.replace(base, dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        state = _tp_state(torch, base, state_shardings(c, mesh, rules), dtype)
        torch.cuda.synchronize()
        held_gib = torch.cuda.memory_allocated() / 2**30
        ops._flash.flash_attention_fwd, T.apply_block = recording, reading
        try:
            with plain_kernels() if dtype == "float64" else contextlib.nullcontext():
                loss, m, grads[dtype] = make_grads_fn(c, TrainConfig(), mesh=mesh, rules=rules)(
                    state["params"], batch)
            tp_metrics[dtype] = {"loss": float(loss), **{k: float(v) for k, v in m.items()}}
        finally:
            ops._flash.flash_attention_fwd, T.apply_block = kernel, apply_block
        if dtype == "bfloat16":  # the train steps
            step_fn = make_train_step(c, OptimizerConfig(learning_rate=3e-4, warmup_steps=1,
                                                         total_steps=TP_STEPS),
                                      mesh=mesh, rules=rules)
            ms, metrics = [], []
            for i, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with _counting_collectives(dist, last=i == len(batches) - 1) as traffic:
                    state, m = step_fn(state, b)
                metrics.append({k: float(v) for k, v in m.items()})
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            out.update(step_ms=ms, metrics=metrics, traffic=traffic, held_gib=held_gib,
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       launches=ops.launch_counts())
            del step_fn
        del state
        torch.cuda.empty_cache()
        lap(dtype)
    out.update(flash_shapes=sorted(shapes), tp_metrics=tp_metrics, residual=sorted(residual))
    if chaotic:
        out["cells"] = _tp_cells(torch, cfg, rules, B, S)
        lap("cells")

    def reference(base, dtype, batch):  # rank 0 alone, the others waiting
        ref = None
        if rank == 0:
            c = dataclasses.replace(base, dtype=dtype)
            with plain_kernels() if dtype == "float64" else contextlib.nullcontext():
                loss, m, g = make_grads_fn(c)(_tp_params(torch, base, dtype), batch)
            ref = ({"loss": float(loss), **{k: float(v) for k, v in m.items()}},
                   dict(named_leaves(g)))
            del g
            torch.cuda.empty_cache()
        dist.barrier()
        return ref

    def compare(dtype, fn):  # every leaf gathered; rank 0 reads it
        found = {}
        for path, g in named_leaves(grads.pop(dtype)):
            full = tpm.gather(g)
            if rank == 0:
                found[path] = fn(path, full)
            del full
        torch.cuda.empty_cache()
        return found

    exact64, ref64 = {}, None
    if not chaotic:
        ref = reference(cut, "float64", cut_batch)
        exact64 = compare("float64", lambda path, full: float((full - ref[1][path]).norm())
                          / float(ref[1][path].norm().clamp_min(1e-300)))
        ref64 = ref and ref[0]
        del ref
        torch.cuda.empty_cache()
        lap("float64 check")
    exact, plain = reference(cfg, "float64", batches[0]), reference(cfg, "bfloat16", batches[0])
    lap("references")

    def against(path, full):  # the tensor-parallel and unsharded runs, each vs float64
        w, p = exact[1][path], plain[1].pop(path)
        n = float(w.norm().clamp_min(1e-300))
        return (float((full.double() - w).norm()) / n, float((p.double() - w).norm()) / n,
                float(full.double().square().sum()), float((p.double() - w).square().sum()))

    bf16 = compare("bfloat16", against)
    lap("bf16 check")
    if rank == 0:
        out.update(bf16_leaves=bf16, f64_leaves=exact64, seconds=seconds,
                   ref_metrics={"bfloat16": plain[0], "float64": exact[0], "float64 cut": ref64},
                   f64_sq=sum(float(x.square().sum()) for x in exact[1].values()))
    del exact, plain
    torch.cuda.empty_cache()
    return out


# The xLSTM cells on the mesh, teacher-forced (``_tp_cells``): float64
# within this share of a leaf's largest entry of the unsharded cell's vjp,
# as ``xlstm_block_grads`` holds the card against the CPU (the sLSTM's
# recurrence amplifies the products' other summation order to ~5e-7).
TP_CELL_F64_TOL = 1e-6


def _tp_cells(torch, cfg, rules, B, S):
    """The xLSTM stack's cells on the mesh against the unsharded cells, one
    block at a time: at full width its forward is chaotic (a float64
    difference in the last bits grows to 1e-7 of the loss over one period
    at 8 x 128 tokens, and its gradient's leaves part by more than their
    own size), so the whole model's gradient cannot hold the split.  Each
    block's cell is teacher-forced: its input the unsharded float64 stack's
    at that block (seeded tokens, seed 0's weights), normed in f32
    (:func:`_f32_grid_norm`), and its vjp for a seeded cotangent is taken
    on the mesh (this rank's heads, ``local_params``' slices, the tensor
    axis of the rules) and unsharded, in float64 and in bf16.  Returns,
    per block and leaf (the input ``h`` and every cell parameter): the
    float64 split run's largest error over the leaf's largest entry, and
    the bf16 runs' Frobenius distances from the unsharded float64 vjp over
    its norm, split and unsharded (``bi`` of the sLSTM, whose exact
    gradient is 0 as a bias shared by c and n cancels in c / n, over the
    cell's largest entry and largest norm)."""
    import dataclasses

    from repro_torch.distributed import api
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import transformer as T
    from repro_torch.tree import named_leaves, tree_map

    c64 = dataclasses.replace(cfg, dtype="float64")
    base = T.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    host = tree_map(lambda t: t.detach().double(), base)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(7)).cuda()
    kinds = [(T._unstack(b, cfg.n_periods), T._unstack(w, cfg.n_periods))
             for b, w in zip(base["periods"], host["periods"])]
    blocks = [(kind, kinds[i][0][li]["cell"], kinds[i][1][li]) for li in range(cfg.n_periods)
              for i, kind in enumerate(cfg.pattern)]
    plain = T.SeqContext(positions=None, sin=None, cos=None)
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        x = T._embed_inputs(c64, host, {"tokens": tokens})[0]
    found = []
    for j, (kind, cell, p) in enumerate(blocks):
        with torch.no_grad():
            h = _f32_grid_norm(T, c64, p["ln1"], x)
        cot = torch.randn(x.shape, generator=gen, dtype=torch.float64).cuda()
        axes = T.block_axes(cfg, kind)["cell"]
        grads = {}
        for dtype in ("float64", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dtype)
            wide = p["cell"] if dtype == "float64" else cell  # the bf16 model's own leaves
            for split in (False, True):
                with api.axis_rules(rules if split else None):
                    tp = tpm.context() if split else None
                    whole = tpm.reads_whole(cfg, tp.size) if split else None
                    leaves = {k: (tpm.local_slice(t, axes[k], only=(tpm.TENSOR_AXIS,))
                                  if split and not whole(k, axes[k]) else t)
                              .detach().clone().requires_grad_(True) for k, t in wide.items()}
                    hin = h.to(getattr(torch, dtype)).requires_grad_(True)
                    ctx = dataclasses.replace(plain, tp=tp)
                    out = T._xlstm_cell(c, kind, leaves, hin, ctx, None)
                    named = [("h", hin)] + list(named_leaves(leaves))
                    got = torch.autograd.grad(out, [t for _, t in named], cot.to(out.dtype))
                    got = {name: (tpm.gather_axes(g, axes[name])
                                  if split and name != "h" and not whole(name, axes[name])
                                  else g).double()
                           for (name, _), g in zip(named, got)}
                grads[(dtype, split)] = got
                if dtype == "float64" and not split:
                    x = x + out.detach()
        exact = grads[("float64", False)]
        big = max(float(g.abs().max()) for g in exact.values())
        big_norm = max(float(g.norm()) for g in exact.values())
        for name, w in exact.items():
            zero = kind == "slstm" and name == "bi"  # 0 in exact arithmetic: the cell's scale
            scale = big if zero else float(w.abs().max())
            n = big_norm if zero else float(w.norm().clamp_min(1e-300))
            found.append(dict(
                block=j, kind=kind, leaf=name,
                f64=float((grads[("float64", True)][name] - w).abs().max()) / max(scale, 1e-300),
                bf16=float((grads[("bfloat16", True)][name] - w).norm()) / n,
                bf16_plain=float((grads[("bfloat16", False)][name] - w).norm()) / n,
                finite=bool(all(torch.isfinite(g[name]).all() for g in grads.values()))))
    return found


def _tp_mesh(shape, world):
    """The ("data", "model") mesh of ``shape`` over the ``world`` ranks, or,
    when it has fewer ranks, over this rank's replica of a ("rep", "data",
    "model") mesh (each replica runs the same case)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_mesh

    n = shape[0] * shape[1]
    if n == world:
        return make_mesh(shape, ("data", "model"))
    return init_device_mesh("cuda", (world // n, *shape),
                            mesh_dim_names=("rep", "data", "model"))["data", "model"]


def _tp_rank(torch, rank, world, store, out_dir):
    """One process of the tensor-parallel phases: a gloo group over a
    FileStore, every case of ``TP_CASES`` then of ``TPS_CASES`` in turn
    (one spawn: each spawn costs ~16 s of start-up); writes its readings,
    ``{"train": [...], "serve": [...]}``, to ``OUT_DIR/rank{rank}.json``."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        cases = {"train": [_tp_case(torch, rank, world, *case) for case in TP_CASES],
                 "serve": [_tps_case(torch, rank, world, *case) for case in TPS_CASES]}
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(cases))


def _tp_roofline(cfg, shape, table, tokens, train=True):
    """``launch/roofline.py``'s reckoning of one train step's (or, not
    ``train``, one prefill's) collectives per device on a (data, model)
    mesh of ``shape`` under ``table`` at ``tokens`` a step: bytes by kind
    (the dry-run's components: each block kind times its count, then the
    ends) and the collective term in ms."""
    import dataclasses

    import torch
    from repro_torch.distributed import api
    from repro_torch.distributed.tensor_parallel import VOCAB_SPLIT_MIN
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rf
    from repro_torch.launch.mesh import make_custom_mesh

    mesh = make_custom_mesh(*shape)
    rules = api.AxisRules(mesh, getattr(api, table))
    itemsize = getattr(torch, cfg.dtype).itemsize
    total = {}

    def add(weights, n, tied_vocab=False):
        coll, _ = rf.reckon_collectives(weights, rules, mesh, tokens=tokens, itemsize=itemsize,
                                        train=train, top_k=cfg.top_k or 1, tied_vocab=tied_vocab)
        for kind, b in coll.items():
            total[kind] = total.get(kind, 0) + b * n

    for kind in set(cfg.layer_kinds()):
        add(dryrun._weights(cfg, kind), cfg.layer_kinds().count(kind))
    cfg0 = dataclasses.replace(cfg, n_layers=0)
    add([w for w in dryrun._model_weights(cfg0) if w[0][0] not in ("periods", "epilogue")], 1,
        cfg.tie_embeddings and cfg.vocab_size >= VOCAB_SPLIT_MIN)
    return total, 1e3 * sum(total.values()) / rf.HW["link_bw"]


def _run_ranks(world, extra, label):
    """``world`` processes of this script (``--tp-rank``; ``extra`` more
    arguments) over a gloo group on a FileStore; fails with their logs if
    one fails or they outlast TP_RANK_TIMEOUT_S.  Returns (each rank's
    JSON readings, wall seconds with start-up)."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, PYTHONUNBUFFERED="1",
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        logs = [open(Path(d, f"rank{r}.log"), "w") for r in range(world)]
        t0 = time.perf_counter()
        for r in range(world):
            _SPAWNED.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--tp-rank", str(r),
                 "--tp-world", str(world), "--tp-store", str(Path(d, "store")), "--tp-out", d,
                 *extra],
                stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)))
        procs, failed = list(_SPAWNED), None
        while any(p.poll() is None for p in procs) and failed is None:
            time.sleep(0.5)
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if time.perf_counter() - t0 > TP_RANK_TIMEOUT_S:
                failed = "timeout"
        for p in procs:
            p.kill()
            p.wait()
        _SPAWNED.clear()
        for f in logs:
            f.close()
        wall = time.perf_counter() - t0
        texts = [Path(d, f"rank{r}.log").read_text() for r in range(world)]
        if failed is not None:
            fail(f"{label}: rank {failed} failed after {wall:.1f}s:\n"
                 + "\n".join(f"--- rank {r}\n{t[-3000:]}" for r, t in enumerate(texts)))
        return [json.loads(Path(d, f"rank{r}.json").read_text()) for r in range(world)], wall


def phase_tensor_parallel(torch, card):
    """The attention and MoE stacks trained tensor-parallel: ``TP_WORLD``
    processes of this script on the one card, a gloo group over a
    FileStore (NCCL refuses two ranks on one device), each case of
    ``TP_CASES`` on its mesh at full width, depth ``SHARDED_LAYERS``, batch
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` of the seed-0 pipeline: ``TP_STEPS``
    bf16 train steps through the kernels, whose launches on every rank
    must be the steps' (no plain version), and the gradient in bf16 and in
    float64 (the same weights widened; the plain kernels).  float64: every
    gathered leaf within ``TP_F64_LEAF_TOL`` (relative Frobenius) of the
    unsharded float64 gradient, loss and xent within
    ``TP_F64_METRIC_RTOL``.  bf16, against float64 (the phi3-mini rule,
    with the one-device run in the CPU's place): each leaf's relative
    error within ``TP_GRAD_BOUND`` times the unsharded bf16 run's plus
    REL_FLOOR, loss and xent the same way plus ``TP_METRIC_FLOOR``, the
    norm within ``TP_GRAD_BOUND`` times the unsharded gradient's whole
    distance from float64 (which bounds that run's norm error); step 0's
    loss and norm are the gradient's.  An xLSTM stack's whole-model
    gradient is chaotic at full width, so its per-leaf checks (float64 and
    bf16) are made on its cells instead, teacher-forced (``_tp_cells``):
    float64 within ``TP_CELL_F64_TOL`` of each leaf's largest entry, bf16
    by the rule above applied to each cell's root mean square of its
    leaves' errors.  Prints the per-rank kernel shapes,
    step ms, GiB held and peak, the residual stream's shape a block reads,
    and the bytes each rank's collectives returned in the last step beside
    ``launch/roofline.py``'s reckoning for that mesh and table, within
    ``TP_BYTES_RTOL`` of it on a mesh with one data rank; then each
    ``RULES_2D_SP`` case beside its ``RULES_2D`` twin.  The same rank
    processes run the serving cases next (``_tp_rank``).  Returns
    (launches summed over the ranks, readings, each rank's serving
    readings for :func:`phase_tensor_parallel_serve`)."""
    import numpy as np

    ranks, wall = _run_ranks(TP_WORLD, [], "tensor parallel")
    serving = [r["serve"] for r in ranks]
    ranks = [r["train"] for r in ranks]
    print(f"[tensor parallel] {TP_WORLD} ranks on one card over gloo (FileStore), "
          f"{wall:.1f}s with start-up; collectives: plain torch.distributed calls on the CUDA "
          "tensors, none staged through host memory by the port (gloo copies CUDA tensors "
          "through its own host buffers; no collective time here is NCCL's); card "
          f"{card}", flush=True)
    counts, readings = {}, {}
    for i, (arch, shape, over, table) in enumerate(TP_CASES):
        cfg, label = _tp_cfg(arch, over), _tp_label(arch, table)
        B, S = TP_TRAIN_SHAPES.get(arch, (TRAIN_BATCH, TRAIN_SEQ))
        per_rank = [r[i] for r in ranks]
        head = per_rank[0]
        want = {k: (TP_STEPS + 1) * v for k, v in _train_launches(cfg).items()
                if k.startswith("flash")}
        for c in per_rank:
            for k in TRAIN_PATH_KERNELS:
                counts[k] = counts.get(k, 0) + c["launches"][k]
        reckoned, coll_ms = _tp_roofline(cfg, shape, table, B * S)
        moved, reckon_all = sum(head["traffic"].values()), sum(reckoned.values())
        refs, tp = head["ref_metrics"], head["tp_metrics"]
        f64, m_tp = refs["float64"], head["metrics"][0]
        bf, exact, cells = head["bf16_leaves"], head["f64_leaves"], head.get("cells")
        ratio = {k: v[0] / max(v[1], REL_FLOOR) for k, v in bf.items()}
        worst = max(bf, key=ratio.get)
        # The bf16 norms: the gathered gradient's, and the unsharded run's
        # whole distance from float64, which bounds its norm's error.
        norm, norm64 = math.sqrt(sum(v[2] for v in bf.values())), math.sqrt(head["f64_sq"])
        dist_plain = math.sqrt(sum(v[3] for v in bf.values()))
        if cells is None:
            worst64 = max(exact, key=exact.get)
            print(f"[tensor parallel] {label} {tuple(shape)} float64 (plain kernels, vocab "
                  f"{min(cfg.vocab_size, TP_F64_VOCAB)}, one period, {len(cfg.pattern)} "
                  f"layer(s)): the tensor-parallel gradient against the unsharded one, "
                  f"{len(exact)} leaves, worst relative distance {exact[worst64]:.3g} at "
                  f"{worst64} (bound {TP_F64_LEAF_TOL}); loss {tp['float64']['loss']!r} vs "
                  f"{refs['float64 cut']['loss']!r}", flush=True)
        print(f"[tensor parallel] {label} {tuple(shape)} bf16 gradients against float64 "
              f"(relative Frobenius): worst ratio {ratio[worst]:.3f} at {worst} "
              f"({bf[worst][0]:.4g} vs the unsharded run's {bf[worst][1]:.4g}; bound "
              f"{TP_GRAD_BOUND}x + {REL_FLOOR}); median {statistics.median(v[0] for v in bf.values()):.4g}"
              f" / {statistics.median(v[1] for v in bf.values()):.4g}; norm {norm:.6f} vs "
              f"float64 {norm64:.6f} (the unsharded gradient {dist_plain:.4g} from it); loss "
              f"{tp['bfloat16']['loss']:.6f} / unsharded {refs['bfloat16']['loss']:.6f} / float64 "
              f"{f64['loss']:.6f}", flush=True)
        print(f"[tensor parallel] {label} on a (data, model) = {tuple(shape)} mesh, full width, "
              f"{cfg.n_layers} layers, {table}, bf16 steps, batch {B} x {S}: rank 0 heads "
              f"{head['heads']}; flash (dtype, q, kv) per rank {head['flash_shapes']}; step 0 "
              f"loss {m_tp['loss']:.6f}, grad norm {m_tp['grad_norm']:.6f}; step ms per rank "
              f"{[[round(x, 1) for x in c['step_ms']] for c in per_rank]}; GiB held per rank "
              f"{[round(c['held_gib'], 2) for c in per_rank]}, peak "
              f"{[round(c['peak_gib'], 2) for c in per_rank]}; rank 0's seconds "
              f"{head['seconds']}; a block reads the residual stream {head['residual']} on "
              f"rank 0; launches per rank "
              f"{[{k: c['launches'][k] for k in TRAIN_PATH_KERNELS} for c in per_rank]}; "
              f"last step's collectives, result bytes on rank 0 {head['traffic']} (all "
              f"{moved / 1e9:.3f} GB) vs the roofline's reckoning {reckoned} "
              f"({reckon_all / 1e9:.3f} GB, ratio {moved / reckon_all:.3f}, {coll_ms:.3f} ms at "
              f"450 GB/s NVLink); card {card}", flush=True)
        if shape[0] == 1:
            check(abs(moved - reckon_all) <= TP_BYTES_RTOL * reckon_all,
                  f"tensor parallel {label}: the last step's collectives returned {moved} bytes "
                  f"on rank 0, beyond {TP_BYTES_RTOL} of the reckoning's {reckon_all}")
        for r, c in enumerate(per_rank):
            check(all(c["launches"][k] == n for k, n in want.items())
                  and c["launches"]["rms_norm_fwd"] > 0,
                  f"tensor parallel {label}: rank {r} launched {c['launches']}, want {want} "
                  "and the norm")
            check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                      for m in c["metrics"]),
                  f"tensor parallel {label}: rank {r}'s steps {c['metrics']} not finite")
        if cells is not None:  # chaotic: the cells teacher-forced hold the split
            w64 = max(cells, key=lambda e: e["f64"])
            cell_ratio = {(e["block"], e["leaf"]): e["bf16"] / max(e["bf16_plain"], REL_FLOOR)
                          for e in cells}
            wbf = max(cell_ratio, key=cell_ratio.get)
            print(f"[tensor parallel] {label}: the whole model's gradient is chaotic at full "
                  f"width (its float64 split run is not held); its "
                  f"{len({e['block'] for e in cells})} "
                  f"cells' vjps teacher-forced ({B} x {S}, input normed in f32), {len(cells)} "
                  f"gradients, split vs unsharded: float64 worst {w64['f64']:.3g} of the leaf's "
                  f"largest entry at block {w64['block']} ({w64['kind']}) d{w64['leaf']} (bound "
                  f"{TP_CELL_F64_TOL}); bf16 against float64 worst leaf ratio "
                  f"{cell_ratio[wbf]:.3f} at block {wbf[0]} d{wbf[1]}, per cell the rms of its "
                  f"leaves' errors held to {TP_GRAD_BOUND}x the unsharded cell's + {REL_FLOOR}; "
                  f"card {card}", flush=True)
            for e in cells:
                tag = f"tensor parallel {label} block {e['block']} ({e['kind']}) d{e['leaf']}"
                check(e["finite"], f"{tag}: not finite")
                check(e["f64"] <= TP_CELL_F64_TOL, f"{tag}: float64 split vs unsharded "
                      f"{e['f64']:.3g} of the leaf's largest entry, beyond {TP_CELL_F64_TOL}")
            # bf16 per cell: the root mean square of its leaves' relative
            # errors (a leaf's alone is one sample of the recurrence's
            # amplified rounding; the split run's and the unsharded one's
            # part by up to 3x leaf by leaf at block 7, the sLSTM).
            for j in sorted({e["block"] for e in cells}):
                rms = [math.sqrt(statistics.fmean(e[k] ** 2 for e in cells if e["block"] == j))
                       for k in ("bf16", "bf16_plain")]
                check(rms[0] <= TP_GRAD_BOUND * rms[1] + REL_FLOOR,
                      f"tensor parallel {label} block {j}: bf16 cell error {rms[0]:.4g} (rms of "
                      f"its leaves' relative errors) beyond {TP_GRAD_BOUND}x the unsharded "
                      f"cell's {rms[1]:.4g}")
        for path, d in exact.items() if cells is None else ():
            check(d <= TP_F64_LEAF_TOL,
                  f"tensor parallel {label} {shape}: float64 gradient {path} {d:.3g} (relative) "
                  f"from the unsharded one, beyond {TP_F64_LEAF_TOL}")
        for k, tol in (("xent", TP_F64_METRIC_RTOL), ("aux", TP_AUX_RTOL)) if cells is None else ():
            cut = refs["float64 cut"][k]
            check(abs(tp["float64"][k] - cut) <= tol * abs(cut),
                  f"tensor parallel {label}: float64 {k} {tp['float64'][k]!r} vs the unsharded "
                  f"{cut!r}, beyond rtol {tol}")
        for k in ("loss", "xent"):
            check(abs(tp["bfloat16"][k] - f64[k]) <= TP_GRAD_BOUND * abs(refs["bfloat16"][k]
                                                                         - f64[k])
                  + TP_METRIC_FLOOR * abs(f64[k]),
                  f"tensor parallel {label}: bf16 {k} {tp['bfloat16'][k]} beyond {TP_GRAD_BOUND}x "
                  f"the unsharded run's distance from float64 {f64[k]}")
        for path, (ke, pe, *_) in bf.items() if cells is None else ():
            check(ke <= TP_GRAD_BOUND * pe + REL_FLOOR,
                  f"tensor parallel {label} {shape}: bf16 gradient {path} {ke:.4g} (relative) "
                  f"from float64, beyond {TP_GRAD_BOUND}x the unsharded run's {pe:.4g}")
        check(abs(norm - norm64) <= TP_GRAD_BOUND * dist_plain,
              f"tensor parallel {label}: bf16 gradient norm {norm} vs float64 {norm64}, beyond "
              f"{TP_GRAD_BOUND}x the unsharded gradient's distance {dist_plain}")
        check(abs(m_tp["grad_norm"] - norm) <= 1e-4 * norm
              and m_tp["loss"] == tp["bfloat16"]["loss"],
              f"tensor parallel {label}: step 0's loss {m_tp['loss']} and grad norm "
              f"{m_tp['grad_norm']} are not its gradient's {norm}")
        readings[label] = dict(mesh=list(shape), table=table, ranks=per_rank,
                               roofline_bytes=reckoned, roofline_collective_ms=coll_ms)
    for arch, _, _, table in TP_CASES:  # each sequence-parallel case beside its twin
        if table.endswith("_SP"):
            sp, base = readings[_tp_label(arch, table)], readings[arch]
            print(f"[tensor parallel] {arch} {table} vs RULES_2D, per rank: peak GiB "
                  f"{[round(c['peak_gib'], 3) for c in sp['ranks']]} vs "
                  f"{[round(c['peak_gib'], 3) for c in base['ranks']]}; GiB held "
                  f"{[round(c['held_gib'], 3) for c in sp['ranks']]} vs "
                  f"{[round(c['held_gib'], 3) for c in base['ranks']]}; residual stream "
                  f"{sp['ranks'][0]['residual']} vs {base['ranks'][0]['residual']}; the last "
                  f"step's collectives on rank 0 {sp['ranks'][0]['traffic']} vs "
                  f"{base['ranks'][0]['traffic']}; step ms rank 0 "
                  f"{[round(x, 1) for x in sp['ranks'][0]['step_ms']]} vs "
                  f"{[round(x, 1) for x in base['ranks'][0]['step_ms']]}; card {card}",
                  flush=True)
    return counts, readings, serving


# ---------------------------------------------------------------------------
# Phase 11b: tensor-parallel serving, the ranks on the one card.
# ---------------------------------------------------------------------------
# (arch, (data, model) mesh, rule table, layers): full width, depth cut as
# the training phase cuts it (recurrentgemma-2b and xlstm-350m keep one
# period of their pattern; recurrentgemma-2b's 10 heads split over 2 ranks,
# not 4).  olmoe-1b-7b's one MoE group is whole on both data ranks
# (RULES_2D_DEC leaves ``moe_groups`` unsplit).  llama3-8b a second time
# under RULES_2D_SP: its prefill's residual stream split over the sequence.
TPS_CASES = (("llama3-8b", (1, 4), "RULES_2D", SHARDED_LAYERS),
             ("gemma-2b", (1, 4), "RULES_2D", SHARDED_LAYERS),
             ("olmoe-1b-7b", (2, 2), "RULES_2D_DEC", SHARDED_LAYERS),
             ("xlstm-350m", (1, 4), "RULES_2D", 8),
             ("llama3-8b", (1, 4), "RULES_2D_SP", SHARDED_LAYERS),
             ("recurrentgemma-2b", (1, 2), "RULES_2D", 3))
# Batch, prompt, max_len (the ring: 2048 slots a rank at 4 ranks, so ranks
# 1-3 hold no valid slot while the prompt and the decoded tokens fill rank
# 0's), decode steps.
TPS_BATCH, TPS_PROMPT, TPS_MAX_LEN, TPS_STEPS = 4, 512, 8192, 16
TPS_LOGIT_BOUND = 3.0  # times the unsharded bf16 run's whole-run error against float64


def _tps_case(torch, rank, world, arch, shape, table, layers):
    """One serving case on this rank of a (data, model) = ``shape`` mesh
    under ``table``, the weights seed 0's bf16 ``init_params`` placed on
    their shardings (DTensors, ``param_axes``), the prompt seeded, greedy
    decoding teacher-forced where said:

    1. rank 0 alone, float64 (the weights widened, the plain kernels),
       unsharded: the reference tokens and logits;
    2. every rank, float64 on the mesh: its greedy tokens;
    3. every rank, bf16 on the mesh through the kernels, fed the reference
       tokens: the launches, the prefill and step ms, the collectives' bytes
       of the last decode step, the cache's GiB; then one more step whose
       first decode-attention call (this rank's slots, every head, with the
       LSE) is held to the plain version on the same inputs;
    4. rank 0 alone, bf16 unsharded through the kernels, fed the reference
       tokens; then each step's relative Frobenius distance of the logits
       from float64, both bf16 runs."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs.archs import get_config
    from repro_torch.distributed import api
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T
    from repro_torch.training import place_state
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    mesh = _tp_mesh(shape, world)
    rules = api.AxisRules(mesh, getattr(api, table))
    tp = shape[1]
    B = TPS_BATCH
    prompt = torch.randint(0, cfg.vocab_size, (B, TPS_PROMPT),
                           generator=torch.Generator().manual_seed(1)).to("cuda", torch.int32)
    base = init = None

    def weights(dtype, placed):
        nonlocal base
        if base is None:
            base = T.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        wide = (lambda p: p.to(torch.promote_types(p.dtype, getattr(torch, dtype))))
        if not placed:
            return tree_map(wide, base)
        return tree_map(lambda p, ax: place_state(wide(p), api.named_sharding(mesh, rules, ax)),
                        base, T.param_axes(cfg))

    def serve(dtype, params, tokens=None, sharded=True, timed=False):
        c = dataclasses.replace(cfg, dtype=dtype)
        ctx = api.axis_rules(rules) if sharded else contextlib.nullcontext()
        ms, traffic, coll_s = [], {}, {}
        with torch.no_grad(), ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _counting_collectives(dist, last=timed) as prefill_traffic:
                cache, logits = T.prefill(c, params, {"tokens": prompt}, TPS_MAX_LEN)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            outs, toks = [logits], []
            pos = torch.full((B,), TPS_PROMPT, dtype=torch.int32, device="cuda")
            for i in range(TPS_STEPS):
                toks.append(tokens[i] if tokens is not None
                            else logits.argmax(-1).to(torch.int32))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                last = timed and i == TPS_STEPS - 1
                with _counting_collectives(dist, last=last, seconds=coll_s) as t:
                    logits, cache = T.decode_step(c, params, cache, toks[-1], pos + i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                traffic.update(t)
                outs.append(logits)
        return dict(logits=torch.stack(outs), tokens=torch.stack(toks), cache=cache,
                    prefill_ms=prefill_ms, step_ms=ms, traffic=traffic,
                    prefill_traffic=prefill_traffic,
                    coll_ms={k: v * 1e3 for k, v in coll_s.items()})

    out = dict(arch=arch, mesh=list(shape), table=table, layers=layers,
               heads=_tp_heads(cfg, mesh.get_local_rank("model"), tp))
    seconds, t_case = {}, time.perf_counter()

    def lap(name):
        nonlocal t_case
        seconds[name] = round(time.perf_counter() - t_case, 1)
        t_case = time.perf_counter()

    # 1. The float64 reference, rank 0 alone.
    ref64 = torch.zeros((TPS_STEPS, B), dtype=torch.int32, device="cuda")
    if rank == 0:
        with plain_kernels():
            exact = serve("float64", weights("float64", False), sharded=False)
        ref64 = exact["tokens"]
        del exact["cache"]
        torch.cuda.empty_cache()
    ref64 = tpm.all_reduce(ref64, dist.group.WORLD)  # rank 0's tokens on every rank
    lap("float64 unsharded")
    # 2. float64 on the mesh, greedy.
    with plain_kernels():
        run = serve("float64", weights("float64", True))
    out["f64_tokens_equal"] = bool(torch.equal(run["tokens"], ref64))
    out["f64_tokens"] = run["tokens"].tolist() if rank == 0 else None
    del run
    torch.cuda.empty_cache()
    lap("float64 sharded")
    # 3. bf16 on the mesh through the kernels, teacher-forced.
    params = weights("bfloat16", True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    run = serve("bfloat16", params, tokens=ref64, timed=True)
    out["launches"] = ops.launch_counts()
    out.update(prefill_ms=run["prefill_ms"], step_ms=run["step_ms"], traffic=run["traffic"],
               prefill_traffic=run["prefill_traffic"], coll_ms=run["coll_ms"],
               cache_gib=sum(t.numel() * t.element_size() for t in tree_leaves(run["cache"]))
               / 2**30, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    calls, kernel = [], ops._decode.decode_attention_fwd

    def recording(*args, **kw):
        if not calls:
            calls.append(([a.clone() for a in args], dict(kw)))
        return kernel(*args, **kw)

    ops._decode.decode_attention_fwd = recording
    try:
        with torch.no_grad(), api.axis_rules(rules):
            T.decode_step(dataclasses.replace(cfg, dtype="bfloat16"), params, run["cache"],
                          ref64[-1], torch.full((B,), TPS_PROMPT + TPS_STEPS, dtype=torch.int32,
                                                device="cuda"))
    finally:
        ops._decode.decode_attention_fwd = kernel
    if calls:  # a stack with attention layers
        args, kw = calls[0]
        check(kw.get("return_lse") is True, f"{arch}: the mesh's decode call {kw} lacks the LSE")
        got, want = kernel(*args, **kw), ref.decode_attention_ref(*args, **kw)
        tag = f"tensor-parallel decode {arch} rank {rank} q {tuple(args[0].shape)}"
        # The LSE to the f32 dot products' rounding bound (D ulps of the
        # largest sum of |q||k| a row's scores take): the model's scores
        # reach magnitudes where an absolute 1e-4 is a few ulps.
        D = args[0].shape[-1]
        top = float(torch.einsum("bhgd,bhsd->bhgs", args[0].float().abs(),
                                 args[1].float().abs()).amax()) * D**-0.5
        lse_tol = 1e-4 + D * 2.0**-24 * top
        lse_err = float((got[1] - want[1]).abs().max())
        check(lse_err <= lse_tol, f"{tag}: LSE max |err| {lse_err:.3g} beyond {lse_tol:.3g}")
        out["decode_check"] = dict(
            q=list(args[0].shape), slots=args[1].shape[2],
            live_slots=int((args[3] >= 0).sum()) // B,
            out_err=_compare(torch, tag, got[0], want[0], torch.bfloat16),
            lse_err=lse_err, lse_tol=lse_tol, lse_min=float(got[1].min()),
            lse_max=float(got[1].max()))
    tp_logits = run["logits"]
    del run, params, calls
    torch.cuda.empty_cache()
    lap("bf16 sharded")
    # 4. bf16 unsharded, rank 0 alone; the logit errors.
    if rank == 0:
        plain = serve("bfloat16", weights("bfloat16", False), tokens=ref64, sharded=False)

        def rel(x):  # each step's, then the whole run's
            want = exact["logits"]
            return ([float((a.double() - b).norm() / b.norm()) for a, b in zip(x, want)],
                    float((x.double() - want).norm() / want.norm()))

        (err_tp, all_tp), (err_plain, all_plain) = rel(tp_logits), rel(plain["logits"])
        out.update(err_tp=err_tp, err_plain=err_plain, err_tp_run=all_tp,
                   err_plain_run=all_plain,
                   plain_prefill_ms=plain["prefill_ms"], plain_step_ms=plain["step_ms"],
                   argmax_agree=float((tp_logits.argmax(-1) == plain["logits"].argmax(-1))
                                      .float().mean()))
        del plain, exact
    del tp_logits, base
    torch.cuda.empty_cache()
    dist.barrier()
    lap("bf16 unsharded")
    out["seconds"] = seconds
    return out


def phase_tensor_parallel_serve(torch, card, ranks):
    """Serving on a split ``model`` axis: for each case of ``TPS_CASES``, the
    readings ``ranks`` of the ``TP_WORLD`` rank processes of
    :func:`phase_tensor_parallel` on the one card over gloo (``_tps_case``;
    a mesh of fewer ranks as replicas of it): prefill of ``TPS_BATCH`` x ``TPS_PROMPT`` tokens into a
    ``TPS_MAX_LEN`` ring split over the ranks' slots, then ``TPS_STEPS``
    decode steps, each rank's decode kernel over its slots for every head
    with the LSE, the rows folded across the ranks.  Checks: float64 tokens
    on the mesh equal to the unsharded float64 tokens; the bf16 logits of
    every step (teacher-forced by those tokens) within ``TPS_LOGIT_BOUND``
    times the unsharded bf16 run's relative Frobenius distance from
    float64 over the whole run, plus REL_FLOOR (per step, 4 rows, a MoE
    router's near-tie that one run's rounding flips and the other's does
    not moves a step's error 4x: olmoe-1b-7b's step 3, 0.254 against
    0.058; the steps are printed); each rank's launches the path's (a flash forward per
    attention layer and a scan per recurrent layer in the prefill, a decode
    per attention layer and step, norms) and no plain version; each rank's
    decode (out, lse) within tolerance of the plain version, ranks with no
    valid slot included (LSE -1e30).  Prints each rank's launches, step ms,
    cache GiB and the bytes its collectives returned in the prefill (beside
    ``launch/roofline.py``'s reckoning) and in a decode step; then each
    ``RULES_2D_SP`` case beside its ``RULES_2D`` twin.  Returns (launches
    summed over the ranks, readings)."""
    from repro_torch.configs.archs import get_config

    import dataclasses

    counts, readings = {}, {}
    for i, (arch, shape, table, layers) in enumerate(TPS_CASES):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        label = _tp_label(arch, table)
        kinds = cfg.layer_kinds()
        n_attn = sum(k in ("attn", "local", "moe") for k in kinds)
        n_rec = kinds.count("recurrent")
        want = dict(flash_attention_fwd=n_attn, decode_attention_fwd=n_attn * TPS_STEPS,
                    rglru_scan_fwd=n_rec, decode_attention_paged_fwd=0)
        per_rank = [r[i] for r in ranks]
        head = per_rank[0]
        for r, c in enumerate(per_rank):
            for k, n in c["launches"].items():
                counts[k] = counts.get(k, 0) + n
            check(all(c["launches"][k] == n for k, n in want.items())
                  and c["launches"]["rms_norm_fwd"] > 0,
                  f"tensor parallel serve {label}: rank {r} launched {c['launches']}, want "
                  f"{want} and the norm")
            check(c["f64_tokens_equal"], f"tensor parallel serve {label}: rank {r}'s float64 "
                  "tokens on the mesh differ from the unsharded float64 tokens")
        ratio = head["err_tp_run"] / max(head["err_plain_run"], REL_FLOOR)
        print(f"[tensor parallel serve] {label} on a (data, model) = {tuple(shape)} mesh, "
              f"{table}, full width, {layers} layers, batch {TPS_BATCH}, prompt {TPS_PROMPT}, "
              f"max_len {TPS_MAX_LEN}, {TPS_STEPS} decode steps: rank 0 heads "
              f"{head['heads']}; float64 tokens on the mesh == unsharded "
              f"({head['f64_tokens'][-1]} last); bf16 logits vs float64 (relative "
              f"Frobenius), the whole run sharded {head['err_tp_run']:.5f} vs unsharded "
              f"{head['err_plain_run']:.5f}, ratio {ratio:.3f} (bound {TPS_LOGIT_BOUND}x + "
              f"{REL_FLOOR}); per step sharded {[round(x, 5) for x in head['err_tp']]} vs "
              f"unsharded {[round(x, 5) for x in head['err_plain']]}; argmax agreement "
              f"{head['argmax_agree']:.4f}; card {card}", flush=True)
        print(f"[tensor parallel serve] {label}: launches per rank "
              f"{[{k: c['launches'][k] for k in HYBRID_PATH_KERNELS} for c in per_rank]}; "
              f"prefill ms per rank {[round(c['prefill_ms'], 1) for c in per_rank]} "
              f"(unsharded {head['plain_prefill_ms']:.1f}); decode step ms per rank, median "
              f"{[round(statistics.median(c['step_ms']), 2) for c in per_rank]} (unsharded "
              f"{statistics.median(head['plain_step_ms']):.2f}); cache GiB per rank "
              f"{[round(c['cache_gib'], 4) for c in per_rank]}, peak GiB "
              f"{[round(c['peak_gib'], 2) for c in per_rank]}; the prefill's collectives, "
              f"result bytes on rank 0 {head['prefill_traffic']} vs the roofline's reckoning "
              f"{_tp_roofline(cfg, shape, table, TPS_BATCH * TPS_PROMPT, train=False)[0]}; "
              f"a decode step's collectives, "
              f"result bytes per rank {[c['traffic'] for c in per_rank]}; host ms inside "
              f"collectives over the {TPS_STEPS} steps, rank 0 "
              f"{ {k: round(v, 1) for k, v in head['coll_ms'].items()} } of "
              f"{sum(head['step_ms']):.1f}; rank 0's seconds "
              f"{head['seconds']}; card {card}", flush=True)
        for r, c in enumerate(per_rank):
            d = c.get("decode_check")
            if d is not None:
                print(f"[tensor parallel serve] {label} rank {r}: decode kernel q {d['q']} over "
                      f"{d['slots']} slots ({d['live_slots']} live) with the LSE vs the plain "
                      f"version, out max|err| {d['out_err']:.3g}, lse {d['lse_err']:.3g} "
                      f"(bound {d['lse_tol']:.3g}), lse in [{d['lse_min']:.4g}, "
                      f"{d['lse_max']:.4g}]", flush=True)
        check(head["err_tp_run"] <= TPS_LOGIT_BOUND * head["err_plain_run"] + REL_FLOOR,
              f"tensor parallel serve {label}: bf16 logits {head['err_tp_run']} (relative, "
              f"the whole run) from float64, beyond {TPS_LOGIT_BOUND}x the unsharded run's "
              f"{head['err_plain_run']} + {REL_FLOOR}")
        readings[label] = dict(mesh=list(shape), table=table, ranks=per_rank)
    for arch, _, table, _ in TPS_CASES:  # each sequence-parallel case beside its twin
        if table.endswith("_SP"):
            sp, base = readings[_tp_label(arch, table)]["ranks"], readings[arch]["ranks"]
            print(f"[tensor parallel serve] {arch} {table} vs RULES_2D, per rank: prefill ms "
                  f"{[round(c['prefill_ms'], 1) for c in sp]} vs "
                  f"{[round(c['prefill_ms'], 1) for c in base]}; peak GiB "
                  f"{[round(c['peak_gib'], 3) for c in sp]} vs "
                  f"{[round(c['peak_gib'], 3) for c in base]}; the prefill's collectives on "
                  f"rank 0 {sp[0]['prefill_traffic']} vs {base[0]['prefill_traffic']}; decode step "
                  f"ms, median {[round(statistics.median(c['step_ms']), 2) for c in sp]} vs "
                  f"{[round(statistics.median(c['step_ms']), 2) for c in base]}; card {card}",
                  flush=True)
    print(f"[tensor parallel serve] the ranks of the tensor-parallel phase, on one card over "
          f"gloo (FileStore); collectives are plain torch.distributed calls on the CUDA "
          f"tensors (gloo stages them through host memory; none is NCCL's); card {card}",
          flush=True)
    return counts, readings


def phase_dryrun(torch, card, table3):
    """The dry-run over every arch x shape x both meshes into a temporary
    ``--out``: every row ``ok``, or ``skipped`` with exactly
    ``skip_reason``'s note; a line per cell; then ``lm_zoo_registry`` refined
    from that JSON, each text-generation arch's mu beside the analytic
    roofline mu and the zoo phase's measured ``mu_ms`` (``table3``)."""
    import tempfile

    from repro_torch.configs.archs import ARCH_IDS, get_config
    from repro_torch.configs.shapes import SHAPES, skip_reason
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rf
    from repro_torch.serving.profiles import QUALITY, lm_zoo_registry

    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "roofline_torch.json"
        t0 = time.perf_counter()
        rc = dryrun.main(["--arch", "all", "--shape", "all", "--mesh", "both",
                          "--out", str(out)])
        seconds = time.perf_counter() - t0
        cells = json.loads(out.read_text())["cells"]
        refined = lm_zoo_registry(prompt=PROMPT, gen_tokens=GEN, chips=1,
                                  roofline_json=str(out))
    check(rc == 0, f"dry-run exit {rc}")
    check(len(cells) == len(ARCH_IDS) * len(SHAPES) * 2, f"dry-run: {len(cells)} rows")
    for c in cells:
        want = skip_reason(get_config(c["arch"]), c["shape"])
        tag = f"{c['arch']} {c['shape']} {c['mesh']}"
        if want:
            check(c["status"] == "skipped" and c["note"] == want, f"dry-run {tag}: {c}")
            print(f"[dryrun] {tag}: skipped ({want})", flush=True)
            continue
        check(c["status"] == "ok", f"dry-run {tag}: {c['status']} {c.get('note')}")
        line = f"[dryrun] {tag}: {c['memory']['per_device_total'] / 2**30:.2f} GiB/device"
        if "terms_s" in c:
            t = c["terms_s"]
            line += (f", compute {1e3 * t['compute_s']:.3f} ms, memory "
                     f"{1e3 * t['memory_s']:.3f} ms, collective {1e3 * t['collective_s']:.3f} "
                     f"ms, {c['dominant']} dominant")
        else:  # the multi pod: terms are the single pod's in JAX's rows too
            f = c["full_step_cost_analysis"]
            line += (f", compute {1e3 * f['flops'] / rf.HW['peak_flops']:.3f} ms, memory "
                     f"{1e3 * f['bytes'] / rf.HW['hbm_bw']:.3f} ms, collectives by count "
                     f"{c['collective_census']}")
        print(line, flush=True)
    ok = sum(c["status"] == "ok" for c in cells)
    print(f"[dryrun] {ok} ok / {len(cells) - ok} skipped in {seconds:.1f}s (meta tensors, no "
          f"device); H100 data sheet", flush=True)
    analytic = lm_zoo_registry(prompt=PROMPT, gen_tokens=GEN, chips=1)
    measured = {row["arch"]: row["mu_ms"] for row in table3.values()}
    mu = dict(zip(refined.names, refined.mu))
    rows = {}
    for arch, roof in zip(analytic.names, analytic.mu):
        got = measured.get(arch)
        rows[arch] = dict(refined_mu_ms=mu[arch], roofline_mu_ms=roof, measured_mu_ms=got)
        print(f"[dryrun] lm_zoo_registry {arch:22s} quality {QUALITY[arch]:4.1f}: refined mu "
              f"{mu[arch]:9.3f} ms, analytic roofline mu {roof:9.3f} ms, measured mu_ms "
              + ("not measured" if got is None else f"{got:9.3f}") + f" (prompt {PROMPT}, "
              f"{GEN} tokens, chips=1); card {card}", flush=True)
    return dict(seconds=seconds, ok=ok, cells=len(cells), mu=rows)


def phase_train_cli(torch, card, arch=PHI3_ARCH, steps=PHI3_TRAIN_STEPS, learn_check=True,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """The user's command ``python -m repro_torch.launch.train --arch ARCH
    --full-config --batch B --seq S`` for ``steps`` steps, run in this
    process (``launch.train.main``) so its launches are counted.  phi3-mini:
    every attention call at head dim 96 (both flash kernels on ``wgmma``
    with 32-wide feature boxes); xlstm-350m: no attention, the norms the only
    kernel.  Checks exit 0, finite losses, with ``learn_check`` the last
    below the first, and the flash launches worked out from the layer
    kinds."""
    import contextlib
    import io

    import numpy as np
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    cfg = get_config(arch)
    argv = ["--arch", arch, "--full-config", "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--log-every", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    ops.reset_launch_counts()  # the train command's path starts here
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()  # and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in out.getvalue().splitlines():
        print(f"[train-cli] {line}", flush=True)
    losses = [float(x) for x in re.findall(r"step\s+\d+\s+loss (\S+)", out.getvalue())]
    check(rc == 0, f"train command {argv}: exit {rc}")
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"train command: losses {losses}")
    if learn_check:
        check(losses[-1] < losses[0], f"train command: loss {losses} does not fall")
    want = {k: v * steps for k, v in _train_launches(cfg).items()}
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        check(counts[name] == want[name],
              f"train command: {counts[name]} {name} launches, expected {want[name]}")
    check(counts["rms_norm_fwd"] > 0, "train command: the norm kernel was never launched")
    stamps = [float(x) for x in re.findall(r"step\s+\d+\s+loss .*?(\S+)s$", out.getvalue(),
                                           re.M)]
    step_s = float(np.median(np.diff(stamps))) if len(stamps) > 2 else None
    result = dict(argv=argv, losses=losses, seconds=seconds, peak_gib=peak,
                  launches=counts, step_s=step_s)
    print(f"[train-cli] python -m repro_torch.launch.train {' '.join(argv)}: exit 0, "
          f"{seconds:.1f}s with the state's build"
          + (f", {step_s:.2f} s a step after the first" if step_s is not None else "")
          + f", loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"peak memory {peak:.1f} GiB, launches {counts}; card {card}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, result


def xlstm_block_grads(torch, card, B=2, S=PROMPT):
    """xlstm-350m's gradient, block by block, card against CPU in float64.

    Its f32 forward is chaotic at full depth (the zoo phase), so the whole
    model's gradient cannot be held card against CPU.  Instead each of the
    24 blocks' cell (mLSTM or sLSTM) is teacher-forced: its input is the
    CPU float64 forward's input at that block, normed in f32
    (:func:`_f32_grid_norm`; ``B`` x ``S`` seeded tokens, the seed-0
    weights; the norm has no float64 kernel, and its backward is the same
    plain version on both devices), and its vjp for a
    fixed seeded cotangent is taken on the card and on the CPU, both in
    float64.  The input's and every cell parameter's gradient agree within
    1e-6 of the leaf's largest entry; the sLSTM input-gate bias ``bi``,
    whose gradient is zero in exact arithmetic (a bias shared by c and n
    cancels in c / n), is held to 1e-6 of the cell's largest gradient entry
    instead."""
    import dataclasses

    from repro_torch.configs.archs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import named_leaves, tree_map

    cfg = dataclasses.replace(get_config(XLSTM_ARCH), dtype="float64")
    host = tree_map(lambda p: p.detach().double(),
                    T.init_params(get_config(XLSTM_ARCH), torch.Generator().manual_seed(0), "cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(7))
    n = cfg.n_periods
    per_kind = [T._unstack(leaves, n) for leaves in host["periods"]]
    blocks = ([(kind, per_kind[i][li]) for li in range(n) for i, kind in enumerate(cfg.pattern)]
              + list(zip(cfg.epilogue, host["epilogue"])))
    ctx = T.SeqContext(positions=None, sin=None, cos=None)
    gen = torch.Generator().manual_seed(8)
    worst, n_leaves, t0 = 0.0, 0, time.perf_counter()
    with torch.no_grad():
        x = T._embed_inputs(cfg, host, {"tokens": tokens})[0]
    for j, (kind, p) in enumerate(blocks):
        with torch.no_grad():
            h = _f32_grid_norm(T, cfg, p["ln1"], x)
        cot = torch.randn(x.shape, generator=gen, dtype=torch.float64)
        grads = {}
        for device in ("cuda", "cpu"):
            leaves = tree_map(lambda t: t.to(device).requires_grad_(True), p["cell"])
            hin = h.to(device).requires_grad_(True)
            out = T._xlstm_cell(cfg, kind, leaves, hin, ctx, None)
            named = [("h", hin)] + list(named_leaves(leaves))
            got = torch.autograd.grad(out, [t for _, t in named], cot.to(device))
            grads[device] = [(name, g.cpu()) for (name, _), g in zip(named, got)]
            if device == "cpu":
                x = x + out.detach()
        big = max(float(g.abs().max()) for _, g in grads["cpu"])
        for (name, a), (_, b) in zip(grads["cuda"], grads["cpu"]):
            check(bool(torch.isfinite(a).all()), f"xlstm block {j} ({kind}) d{name} not finite")
            scale = float(b.abs().max()) if not (kind == "slstm" and name == "bi") else big
            err = float((a - b).abs().max())
            check(err <= 1e-6 * scale, f"xlstm block {j} ({kind}) d{name}: card vs CPU in "
                  f"float64 max|err| {err:.3g}, beyond 1e-6 of {scale:.3g}")
            worst = max(worst, err / max(scale, 1e-300))
            n_leaves += 1
    print(f"[train] {XLSTM_ARCH}: {len(blocks)} cells' vjps teacher-forced in float64 (batch "
          f"{B} x {S}): {n_leaves} gradients (input and every parameter), card vs CPU within "
          f"{worst:.3g} of their largest entry (bound 1e-6), {time.perf_counter() - t0:.1f}s; "
          f"card {card}", flush=True)
    return dict(blocks=len(blocks), gradients=n_leaves, worst=worst)


# ---------------------------------------------------------------------------
# Optional phase: where a request's time goes.
# ---------------------------------------------------------------------------
_PORT_KERNELS = ("rms_norm_kernel", "flash_fwd_wgmma_kernel", "flash_fwd_kernel",
                 "flash_bwd_wgmma_kernel", "flash_bwd_prep_kernel",
                 "flash_bwd_group_merge_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                 "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel",
                 "flash_bwd_group_sum_kernel", "decode_split_kernel", "rglru_scan_kernel")


def _families(prof):
    """(device ms by kernel name, by family, kernel count) of a profile."""
    import collections

    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    families = collections.Counter()
    for name, ms in by_name.items():
        fam = next((k for k in _PORT_KERNELS if k in name), None)
        if fam == "decode_split_kernel":  # its last template argument: PAGED
            fam += " (paged)" if ", true>" in name else " (ring)"
        if fam == "rglru_scan_kernel":  # its last template argument: REV
            fam += " (reverse)" if ", true>" in name else " (forward)"
        if fam is None:
            low = name.lower()
            fam = "matmul" if any(s in low for s in (
                "gemm", "gemv", "xmma", "cutlass", "nvjet")) else "other"
        families[fam] += ms
    return by_name, families, len(kernels)


def _profile_step(torch, fn, label, card, verbose=True):
    """torch.profiler over one call of ``fn``: wall, device busy share and
    device time by kernel family (printed unless ``verbose`` is False)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, families, n = _families(prof)
    busy = sum(by_name.values())
    if verbose:
        _print_profile(label, wall_ms, busy, n, families, by_name, card)
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_kernels=n,
                busy_share=busy / wall_ms, families=dict(families),
                top=by_name.most_common(8))


def _print_profile(label, wall_ms, busy, n, families, by_name, card):
    print(f"[profile] {label}: wall {wall_ms:.1f} ms (profiled), device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%), {n} kernels; card {card}", flush=True)
    for fam, ms in families.most_common():
        print(f"[profile]   {fam:22s} {ms:9.3f} ms ({100 * ms / busy:.1f}% of busy)", flush=True)
    for name, ms in by_name.most_common(8):
        print(f"[profile]   top {ms:9.3f} ms  {name[:90]}", flush=True)


def phase_profile(torch, runs, card):
    """torch.profiler over one timed ``generate`` per (label, backend, tier,
    batch size) of ``runs``: device busy share and device time by kernel
    family."""
    import numpy as np
    from repro_torch.kernels import ops

    out = {}
    for label, backend, tier, B in runs:
        tokens = np.random.default_rng(B).integers(0, 256, (B, PROMPT))
        backend.generate(tier, tokens, GEN)  # warm this shape
        ops.reset_launch_counts()
        row = _profile_step(torch, lambda: backend.generate(tier, tokens, GEN),
                            f"{label} {tier} B={B} prompt {PROMPT} gen {GEN}", card)
        row["launches"] = ops.launch_counts()
        print(f"[profile]   port kernel launches {row['launches']}", flush=True)
        out[f"{label} {tier} B={B}"] = row
    return out


def _watchdog(seconds: float) -> None:
    """Fail in time instead of hanging: if the run is still going after
    ``seconds``, print every thread's stack, kill the worker processes this
    run spawned and exit 1."""
    import faulthandler
    import multiprocessing
    import os
    import threading

    def fire():
        time.sleep(seconds)
        print(f"chip_smoke: FAIL: still running after {seconds:.0f}s; stacks follow",
              file=sys.stderr, flush=True)
        faulthandler.dump_traceback(all_threads=True)
        for child in multiprocessing.active_children() + _SPAWNED:
            child.kill()
        os._exit(1)

    threading.Thread(target=fire, name="watchdog", daemon=True).start()


def _live_cuda_bytes(torch):
    """(bytes, count) of the distinct CUDA storages that live tensors the
    garbage collector can reach hold."""
    seen = {}
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                st = obj.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        except Exception:  # noqa: BLE001 - objects that refuse inspection
            continue
    return sum(seen.values()), len(seen)


CUBLAS_WORKSPACE_BYTES = 32 * 2**20  # PyTorch's default per (handle, stream) on sm_90
# A quarter of the 5.06 GiB that a fresh stream per generate call left
# allocated after the serving drains, when every generate call made a stream.
RELEASE_BOUND_GIB = 5.06 / 4


def _release(torch, label, clear_workspaces=True):
    """Collect, empty the cache and say what stays allocated: the bytes of
    live CUDA tensors, the (cuBLAS handle, stream) pairs the serving
    backends' ``generate`` calls used (one per stream of the device's set,
    each served by one thread; the set grows to the most calls in flight at
    once) and their workspaces' bytes, and, unless
    ``clear_workspaces`` is False, what clearing PyTorch's cuBLAS
    workspaces (one per pair, from the caching allocator) gives back.
    Fails if a stream carries more than one pair.  Returns the bytes held
    before the clear, the number of streams in the set and the bytes that
    grow with it: a workspace and the decode kernels' ticket buffer (also
    kept per stream) for each stream."""
    from repro_torch.kernels import decode_attention
    from repro_torch.serving.backend import device_streams

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    live, n_live = _live_cuda_bytes(torch)
    streams = device_streams(torch.device("cuda"))
    bound = streams.size * CUBLAS_WORKSPACE_BYTES
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    after = None
    if clear is not None and clear_workspaces:
        clear()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated()
    print(f"[{label}] released: {held / 2**30:.2f} GiB still allocated, of which "
          f"{live / 2**30:.2f} GiB in {n_live} live CUDA tensor storages "
          f"(~{(held - live) / CUBLAS_WORKSPACE_BYTES:.1f} workspaces of 32 MiB); generate used "
          f"{len(streams.pairs)} (cuBLAS handle, stream) pairs on its {streams.size} streams, "
          f"at most {bound / 2**30:.2f} GiB of workspaces; "
          + (f"{after / 2**30:.2f} GiB after clearing the cuBLAS workspaces"
             if after is not None else "workspaces kept"),
          flush=True)
    check(len(streams.pairs) <= streams.size,
          f"{label}: {len(streams.pairs)} (cuBLAS handle, stream) pairs on {streams.size} streams")
    ours = {s.cuda_stream for s in streams.streams}
    tickets = sum(-(-t.untyped_storage().nbytes() // 512) * 512  # the allocator's rounding
                  for (_, st), t in decode_attention._TICKETS.items() if st in ours)
    return held, streams.size, streams.size * CUBLAS_WORKSPACE_BYTES + tickets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier-l-layers", type=int, default=TIER_L_LAYERS,
                    help=f"tier-l depth (qwen3-14b has 40; default {TIER_L_LAYERS}); width is "
                    "never cut")
    ap.add_argument("--profile", action="store_true",
                    help="profile one tier-l generate per backend and batch 1 / 4 after "
                    "the serve phases and one tier-rg generate at batch 4 after the hybrid "
                    "phase; print each train run's profiled step in full")
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v register use")
    ap.add_argument("--json-out", default=None, help="also write the results here")
    ap.add_argument("--tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-world", type=int, default=TP_WORLD, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the root of a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if args.tp_rank is not None:  # one rank of phase_tensor_parallel(_serve)
        _watchdog(TP_RANK_TIMEOUT_S)
        _tp_rank(torch, args.tp_rank, args.tp_world, args.tp_store, args.tp_out)
        return 0
    t_start = time.perf_counter()

    def mark(phase):  # where the run's time goes, phase by phase
        print(f"[time] {phase} starts at {time.perf_counter() - t_start:.1f}s", flush=True)
    _watchdog(WATCHDOG_S)
    card = phase_device(torch)
    phase_build(torch, args.ptxas)

    from repro_torch.configs.archs import get_config

    q14 = get_config("qwen3-14b")
    full = dict(batch=BATCH, prompt=PROMPT, d_model=q14.d_model,
                n_heads=q14.n_heads, n_kv_heads=q14.n_kv_heads, head_dim=q14.head_dim,
                max_len=PROMPT + GEN + 8, gen=GEN)
    mark("phase_kernels")
    entries = phase_kernels(torch, full)
    mark("phase_model")
    phase_model(torch)
    mark("phase_serve")
    dense_counts, serve_results, engine = phase_serve(torch, args.tier_l_layers, card)
    mark("phase_decode_count")
    tools = {"decode_step": phase_decode_count(torch, engine, card)}
    mark("phase_cluster")
    cluster_counts, serve_results["cluster"] = phase_cluster(torch, engine, card)
    mark("phase_continuous")
    paged_counts, serve_results["continuous"], cbackend = phase_continuous(torch, engine, card)
    mark("phase_int8")
    int8_counts, serve_results["int8"] = phase_int8(torch, engine, card)
    profile = (phase_profile(torch, [(label, backend, "tier-l", B)
                                     for label, backend in (("dense", engine.backend),
                                                            ("continuous", cbackend))
                                     for B in (1, 4)], card)
               if args.profile else {})
    # The process phase's workers get phase 5's weights, copied to the host,
    # and hold the plain JitBackend's probe tokens on the same weights.
    import dataclasses

    import numpy as np
    from repro_torch.models import transformer as T

    t_copy = time.perf_counter()
    host_variants = [dataclasses.replace(v, params=T.params_to(v.params, "cpu"))
                     for v in engine.variants.values()]
    print(f"[process] phase 5's weights copied to the host in "
          f"{time.perf_counter() - t_copy:.1f}s", flush=True)
    plain_tokens = np.asarray(serve_results["cluster"]["probe_tokens"])
    del engine, cbackend  # release tier-l's weights: the workers place their own copies
    # The cuBLAS workspaces stay until the hybrid phase's release, so these
    # lines show whether the serving phases' drains grow them.
    held = [_release(torch, "serve", clear_workspaces=False)]
    mark("phase_process")
    process_counts, serve_results["process"] = phase_process(torch, host_variants, plain_tokens,
                                                             card)
    del host_variants
    held.append(_release(torch, "process", clear_workspaces=False))
    mark("phase_serve_cli")
    cli_counts, serve_results["serve command"] = phase_serve_cli(torch, card)
    held.append(_release(torch, "serve command", clear_workspaces=False))
    mark("phase_hybrid")
    hybrid_counts, serve_results["hybrid"], hengine = phase_hybrid(torch, card)
    if args.profile:
        profile.update(phase_profile(torch, [("hybrid", hengine.backend, HYBRID_TIER, BATCH)],
                                     card))
    del hengine  # release tier-rg's weights before the zoo and training
    held.append(_release(torch, "hybrid"))
    # The stream set grows by a stream, with its workspace and ticket buffer,
    # whenever more calls are in flight at once than ever before; nothing
    # else may grow.
    rest = [b - per_stream for b, _, per_stream in held]
    serve_results["released_gib"] = [b / 2**30 for b, _, _ in held]
    serve_results["release_streams"] = [n for _, n, _ in held]
    print(f"[release] GiB held after each drain, before any clear: "
          f"{serve_results['released_gib']}, on {serve_results['release_streams']} streams; "
          f"bytes less each stream's workspace and tickets: {rest}", flush=True)
    check(max(rest) == rest[0] and max(b for b, _, _ in held) <= RELEASE_BOUND_GIB * 2**30,
          f"device memory held after the drains grew by more than the new streams' "
          f"workspaces or passed {RELEASE_BOUND_GIB} GiB: {serve_results['released_gib']} "
          f"on {serve_results['release_streams']} streams")
    measured = {tier: (cfg, *results["profiles"][tier], note) for tier, cfg, results, note in (
        ("tier-l", get_config("qwen3-14b", n_layers=args.tier_l_layers), serve_results,
         "" if args.tier_l_layers == q14.n_layers else
         f" (depth {args.tier_l_layers} of {q14.n_layers})"),
        (HYBRID_TIER, get_config(HYBRID_ARCH), serve_results["hybrid"], ""))}
    mark("phase_zoo")
    zoo_counts, serve_results["zoo"] = phase_zoo(torch, card, measured)
    mark("phase_dryrun")
    tools["dryrun"] = phase_dryrun(torch, card, serve_results["zoo"]["table3"])
    phase_counts = {"dense": dense_counts, "cluster": cluster_counts,
                    "continuous": paged_counts, "int8": int8_counts, "process": process_counts,
                    "serve command": cli_counts, "hybrid": hybrid_counts, "zoo": zoo_counts}
    train = {}
    # recurrentgemma-2b last: its train-loss check compares batch noise and
    # can fail (ROADMAP.md Queue C), so every other check runs before it.
    gemma, hybrid = TRAIN_ARCHS
    mark("phase_train")
    phase_counts[f"train {gemma}"], train[gemma] = phase_train(torch, gemma, card, args.profile)
    mark("phase_train_tools")
    tools.update(phase_train_tools(torch, card, train[gemma]["median_step_ms"]))
    mark("phase_tensor_parallel")
    phase_counts["tensor parallel"], tools["tensor_parallel"], tp_serve = phase_tensor_parallel(
        torch, card)
    mark("phase_tensor_parallel_serve")
    phase_counts["tensor parallel serve"], serve_results["tensor parallel"] = (
        phase_tensor_parallel_serve(torch, card, tp_serve))
    mark("phi3 command")
    phase_counts["train command phi3"], train["phi3 command"] = phase_train_cli(torch, card)
    mark(f"{MOE_ARCH} train")
    phase_counts[f"train {MOE_ARCH}"], train[MOE_ARCH] = phase_train(
        torch, MOE_ARCH, card, args.profile, layers=MOE_TRAIN_LAYERS, learn_check=MOE_LEARNS)
    mark("xlstm command")
    phase_counts["train command xlstm"], train["xlstm command"] = phase_train_cli(
        torch, card, XLSTM_ARCH, XLSTM_TRAIN_STEPS, learn_check=False, batch=XLSTM_TRAIN_BATCH,
        seq=XLSTM_TRAIN_SEQ)
    train["xlstm block grads"] = xlstm_block_grads(torch, card)
    mark("phase_frontends")
    phase_counts["frontends"], serve_results["frontends"] = phase_frontends(torch, card)
    mark("frontend train commands")
    phase_counts["train commands frontends"], train["frontends"] = phase_frontend_train(
        torch, card)
    mark(f"{hybrid} train")
    phase_counts[f"train {hybrid}"], train[hybrid] = phase_train(torch, hybrid, card,
                                                                 args.profile)
    counts = {k: sum(c.get(k, 0) for c in phase_counts.values()) for k in dense_counts}
    names = {e["name"] for e in entries}
    check(names == set(counts), f"kernels timed {sorted(names)} != kernels counted {sorted(counts)}")
    for e in entries:
        e["launches"] = counts[e["name"]]
        check(e["launches"] > 0,
              f"kernel {e['name']} was never launched by the serve and train phases")
    print(f"[launches] by phase: {phase_counts}", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = {"kernels": [{k: e[k] for k in keys} for e in entries]}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(
            dict(card=card, kernels=entries, serve=serve_results, train=train, tools=tools,
                 launches=counts, launches_by_phase=phase_counts, profile=profile,
                 seconds=time.perf_counter() - t_start), indent=1,
            default=lambda o: o.item() if hasattr(o, "item") else str(o)))
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(f"card: {card}")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
