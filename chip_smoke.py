#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with an sm_90 card:

    python3 chip_smoke.py

Phases (each passes or raises; any failure exits non-zero with no result):

1. device: CUDA present, capability >= 9.0; prints the card's name and
   power limit; TF32 off for f32 matmuls and convolutions.
2. build: compiles every CUDA kernel (one ``nvcc`` per source, in
   parallel) and JITs the Triton kernel; prints the seconds.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the kernel-test sweep shapes and at the full-width shapes of the main
   path, with f32 atol 1e-4 (summation order) and bf16 atol 2e-2 + rtol
   1e-2 (one bf16 rounding step); times (CUDA events over CUDA-graph
   replays, median) of the kernel, the plain version, one PyTorch call as
   a yardstick where one exists, and the bound, plus the kernel's eager
   time with its launch cost.  The flash forward, ring decode and flash
   backward sweeps include recurrentgemma's G = 10, D = 256 heads.  The
   paged decode kernel runs the sweep of tests/test_kernels.py (every
   ladder size, windows, masked rows bitwise inert, D 16..256, G=5) and a
   full-width row at the continuous serve phase's pool geometry.  The
   flash backward kernel runs the tests/test_kernels.py cases plus D 128 /
   256, G 5 / 8 / 10, ragged S, windowed and bidirectional, in f32, bf16
   and f16 (the forward kernel's LSE is checked too), and a full-width row
   at the train phase's gemma-2b shape, whose library time is the backward
   of ``F.scaled_dot_product_attention`` alone.  The RG-LRU scan kernel
   runs the tests/test_kernels.py sweep (f32 and bf16), the carry across
   blocks, ragged S and W with a non-zero h0, and its backward (the kernel
   over the reversed sequence) against the plain adjoint; full-width rows
   at the hybrid serve shape (4, 128, 2560) and the recurrentgemma train
   shape (2, 2048, 2560), f32 as the model runs it.  No single PyTorch call
   computes a linear recurrence, so its library time is null.  The norm and
   the flash forward and backward are also held against their plain
   versions at the shapes the recurrentgemma phases give them: the serve
   prefill (norm (4, 128, 2560), flash q (4, 10, 128, 256)) and the train
   step (norm (2, 2048, 2560), flash and its backward q (2, 10, 2048, 256)
   with window 2048), bf16, the norm with the ``(1 + w)`` offset.
4. model: the three reduced serving tiers, the hedge variant and reduced
   recurrentgemma (5 layers: one period and the epilogue), prefill plus
   16 greedy decode steps in f32, on the card through the kernels and on
   the CPU through the plain versions: logits allclose, tokens equal; then
   for the attention-only stacks the same on the paged path
   (``prefill_ragged`` + graft + 16 ``paged_decode_step``s, rows at
   different positions); then, for the three tiers and recurrentgemma,
   ``loss_fn`` and every parameter gradient (remat on), card against CPU:
   a gradient cut on the card would show here.
5. serve: a ``ServingEngine`` whose ``JitBackend`` hosts tier-s, tier-m
   (reduced as served) and tier-l at the full qwen3-14b configuration
   (bf16, seeded weights on the card), plus the zoo's measured hedge; then
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
   path's kernels were launched.
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
8. profile (only with ``--profile``): ``torch.profiler`` over one tier-l
   ``generate`` at batch 1 and 4 on the dense and on the continuous
   backend and one tier-rg ``generate`` at batch 4 — device busy share,
   device time by kernel family, port-kernel launches per generate.
9. train: once the serve phases have released their weights, full-width
   gemma-2b (all 18 layers, bf16, remat, tied 256k vocab; seeded weights),
   then full-width recurrentgemma-2b (all 26 layers) each train for 12
   steps of ``make_train_step`` (the code path of ``python -m
   repro_torch.launch.train --full-config``) on batch 2 x 2048 tokens of
   ``SyntheticTokens`` seed 0.  Prints loss, grad norm and ms per step,
   tokens/s, model FLOPs utilisation against 989 TFLOP/s, peak device
   memory and kernel launches per step.  Checks finite losses, the mean of
   the last 3 below the first, a finite non-zero gradient for every leaf
   at step 0, and the flash and scan launches per step worked out from the
   layer kinds (remat reruns the periods' forward, not the epilogue's).
   With ``--profile``, one more step of each under ``torch.profiler``.

Every run measures every column of the kernels line: each serve phase and
each train run set the launch counters to 0 just before they start and
read them just after, and a kernel's ``launches`` is the sum over those
phases of the same run.  The last lines are the card line, one
``{"kernels": [...]}`` JSON line and the ``{"ok": true, "device": ...}``
JSON line.
``--tier-l-layers`` cuts tier-l's depth (never its width) if a time limit
forces it.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores

# The serve phase's request shape and the batch of the full-width kernel
# timings.
REQUESTS = 16
PROMPT = 128
GEN = 16
BATCH = 4
SLA_MS = 2000.0
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


# The kernels each serve phase's path must launch (the hedge tier's dense
# decode may or may not run during the continuous phase).
DENSE_PATH_KERNELS = ("rms_norm_fwd", "flash_attention_fwd", "decode_attention_fwd")
PAGED_PATH_KERNELS = ("rms_norm_fwd", "flash_attention_fwd", "decode_attention_paged_fwd")
HYBRID_PATH_KERNELS = DENSE_PATH_KERNELS + ("rglru_scan_fwd",)
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
    built = cuda_build.build(ptxas_verbose=ptxas)
    for name, (seconds, stderr) in built.items():
        print(f"[build] nvcc {name}.cu: {seconds:.1f}s", flush=True)
        if ptxas:
            for line in stderr.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"[build]   {line.strip()}")
    x = torch.randn(2, 64, device="cuda")
    t1 = time.perf_counter()
    ops.rms_norm(x, torch.ones(64, device="cuda"))
    torch.cuda.synchronize()
    print(f"[build] CUDA libraries {t1 - t0:.1f}s (parallel), Triton first "
          f"launch {time.perf_counter() - t1:.1f}s", flush=True)
    ops.reset_launch_counts()


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


def time_ms(torch, fn, launches: int = 20, trials: int = 7, graph: bool = True) -> float:
    """Median over ``trials`` of (CUDA-event time of ``launches`` calls) / launches.

    With ``graph`` the calls are captured once into a CUDA graph and the
    graph is replayed, so the time is the device's alone (back-to-back
    kernels, no Python launch cost); without it the calls run eagerly and
    the time includes whatever the host adds between launches."""
    side = torch.cuda.Stream()
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
    f32, bf16 = torch.float32, torch.bfloat16
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
    ]
    for dtype in (f32, bf16):
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
        # recurrentgemma's local layers: G = 10 (two blocks of <= 8 q heads)
        (4, 1, 10, 152, 256, 0), (2, 1, 10, 300, 256, 128),
    ]
    for dtype in (f32, bf16):
        for B, NKV, G, S, D, window in decode_cases:
            q = _randn(torch, (B, NKV, G, D), dtype, gen)
            kc = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            vc = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            sp, pos = _ring(torch, B, S)
            _compare(torch, f"decode{(B, NKV, G, S, D)} window={window} {dtype}",
                     dk.decode_attention_fwd(q, kc, vc, sp, pos, window=window),
                     ref.decode_attention_ref(q, kc, vc, sp, pos, window=window), dtype)
            n += 1
    # Empty slots (only the first 10 valid) and a fully masked row.
    B, NKV, G, S, D = 2, 2, 2, 128, 32
    q = _randn(torch, (B, NKV, G, D), f32, gen)
    kc = _randn(torch, (B, NKV, S, D), f32, gen)
    vc = _randn(torch, (B, NKV, S, D), f32, gen)
    sp = torch.where(torch.arange(S) < 10, torch.arange(S), -1).to(torch.int32)
    sp = sp.expand(B, S).contiguous().cuda()
    for p in (9, -1):
        pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
        _compare(torch, f"decode empty slots pos={p}",
                 dk.decode_attention_fwd(q, kc, vc, sp, pos),
                 ref.decode_attention_ref(q, kc, vc, sp, pos), f32)
        n += 1
    n += _paged_sweep(torch, gen)
    n += _bwd_sweep(torch, gen)
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
    bwd = _full_width_bwd(torch, gen)
    _print_entry(bwd)
    print("[kernels] rglru_scan_fwd has no library yardstick: no single PyTorch call "
          "computes a linear recurrence (library_ms null)", flush=True)
    hybrid = get_config(HYBRID_ARCH)
    for B, S, label in ((full["batch"], full["prompt"], "hybrid serve prefill"),
                        (TRAIN_BATCH, TRAIN_SEQ, "recurrentgemma training")):
        scan = _full_width_rglru(torch, gen, B, S, hybrid.lru_width, label)
        _print_entry(scan)
    return entries + [paged, bwd, scan]


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


def _rglru_sweep(torch, gen) -> int:
    """The scan kernel against ``rglru_scan_ref``, then its backward (the
    kernel over the reversed sequence) against ``rglru_scan_bwd_ref``: the
    tests/test_kernels.py shapes, ragged S and W, a bf16 h0; f32 and bf16;
    and the carry across what were the Pallas kernel's sequence blocks."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rk

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, W, h0_dtype in ((2, 256, 128, None), (1, 512, 256, None), (3, 128, 64, None),
                                  (2, 300, 2500, None), (2, 77, 130, dtype), (1, 5, 7, None)):
            a, b, h0 = _rglru_case(torch, gen, B, S, W, dtype, h0_dtype)
            tag = f"rglru{(B, S, W)} {dtype} h0 {h0.dtype}"
            h = rk.rglru_scan_fwd(a, b, h0)
            _compare(torch, tag, h, ref.rglru_scan_ref(a, b, h0), dtype)
            dh = _randn(torch, (B, S, W), dtype, gen)
            for part, g, w in zip(("da", "db", "dh0"), rk.rglru_scan_bwd(a, h, h0, dh),
                                  ref.rglru_scan_bwd_ref(a, h, h0, dh)):
                check(g.dtype == w.dtype and g.shape == w.shape, f"{tag} bwd {part} dtype/shape")
                _compare(torch, f"{tag} bwd {part}", g, w, dtype)
            n += 2
    a = torch.full((1, 256, 64), 0.99, device="cuda")
    b = torch.full((1, 256, 64), 0.01, device="cuda")
    h = rk.rglru_scan_fwd(a, b, torch.zeros(1, 64, device="cuda"))
    _compare(torch, "rglru carry", h, ref.rglru_scan_ref(a, b, torch.zeros(1, 64, device="cuda")),
             torch.float32)
    check(float(h[0, -1, 0]) > float(h[0, 63, 0]) > float(h[0, 0, 0]),
          "rglru carry: the state did not accumulate across the sequence")
    return n + 1


def _full_width_rglru(torch, gen, B, S, W, label):
    """The scan kernel at a full-width recurrentgemma shape, f32 as the
    model feeds it (its gates are computed in f32)."""
    from repro_torch.kernels import ref
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
    # a and b read once, h written once, h0 read once; one multiply and one
    # add per element on the CUDA cores.
    nbytes = 3 * a.numel() * 4 + h0.numel() * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2 * a.numel() / H100_F32_FLOPS * 1e3
    # The plain version is a Python loop of S steps: few graph replays.
    return dict(
        name="rglru_scan_fwd", route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:59", max_abs_err=err,
        shape=f"a, b {(B, S, W)} f32 ({label}, {B * -(-W // 128)} blocks)",
        ms=time_ms(torch, lambda: rk.rglru_scan_fwd(a, b, h0)),
        eager_ms=time_ms(torch, lambda: rk.rglru_scan_fwd(a, b, h0), graph=False),
        plain_ms=time_ms(torch, lambda: ref.rglru_scan_ref(a, b, h0), launches=2, trials=3),
        library_ms=None,
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
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
        for D in (16, 64, 128, 256):  # head dims, G = 5
            args = _paged_case(torch, gen, 2, dtype, G=5, D=D, model_layout=True)
            _compare(torch, f"paged D={D} G=5 {dtype}", dk.decode_attention_paged_fwd(*args),
                     ref.decode_attention_paged_ref(*args), dtype)
            n += 1
    # Masked rows (pos 0, all-trash tables) of a padded 8-row batch are
    # inert: the real rows equal the same rows run alone, bitwise.
    for n_real in (1, 3, 5, 7):
        q, kp, vp, tables, pos = _paged_case(torch, gen, 8, f32)
        tables[n_real:] = 0
        pos[n_real:] = 0
        padded = dk.decode_attention_paged_fwd(q, kp, vp, tables, pos)
        check(not bool(torch.isnan(padded).any()), f"paged n_real={n_real}: NaN in padded rows")
        alone = dk.decode_attention_paged_fwd(q[:n_real], kp, vp, tables[:n_real], pos[:n_real])
        check(bool(torch.equal(padded[:n_real], alone)),
              f"paged n_real={n_real}: masked rows perturb the real rows")
        _compare(torch, f"paged n_real={n_real}", alone,
                 ref.decode_attention_paged_ref(q[:n_real], kp, vp, tables[:n_real],
                                                pos[:n_real]), f32)
        n += 1
    return n


def _bwd_sweep(torch, gen) -> int:
    """The flash backward kernel against ``flash_attention_bwd_ref``, both
    fed the forward kernel's output and LSE, on model-layout views: the
    tests/test_kernels.py cases, then D 128 / 256, G 5 / 8 / 10 (MQA), ragged S,
    windowed and bidirectional; f32 (the CUDA-core kernels), bf16 and f16
    (the tensor-core kernels)."""
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
    ]
    n = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for B, NQ, NKV, S, D, causal, window in cases:
            q = _randn(torch, (B, S, NQ, D), dtype, gen).transpose(1, 2)
            k = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            v = _randn(torch, (B, S, NKV, D), dtype, gen).transpose(1, 2)
            dout = _randn(torch, (B, S, NQ, D), dtype, gen).transpose(1, 2)
            out, lse = fk.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                              return_lse=True)
            got = bk.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window)
            want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                                               window=window)
            tag = f"flash bwd{(B, NQ, NKV, S, D)} causal={causal} window={window} {dtype}"
            for part, g, w in zip(("dq", "dk", "dv"), got, want):
                _compare(torch, f"{tag} {part}", g, w, dtype)
            n += 1
    return n


def _hybrid_shapes(torch, gen) -> int:
    """The norm, flash forward and flash backward kernels against their
    plain versions at the shapes the hybrid serve prefill and the
    recurrentgemma train step give them (bf16, the ``(1 + w)`` norm, the
    local layers' window); prints each with the kernel's and the plain
    version's times."""
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as bk
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
        reps = 5 if train else 20  # launches per timed replay
        got, want = fk.flash_attention_fwd(q, k, v, **kw), ref.flash_attention_ref(q, k, v, **kw)
        tag = f"flash q {tuple(q.shape)} window {window} bf16 ({label})"
        if train:
            err = _compare(torch, tag, got[0], want[0], bf16)
            _compare(torch, tag + " lse", got[1], want[1], torch.float32)
        else:
            err = _compare(torch, tag, got, want, bf16)
        kernel_ms = time_ms(torch, lambda: fk.flash_attention_fwd(q, k, v, **kw), reps)
        plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw), reps)
        print(f"[kernels] {label}: flash_attention_fwd q {tuple(q.shape)} bf16 window "
              f"{window}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"max|err| {err:.3g}", flush=True)
        n += 1
        if not train:
            continue
        out, lse = got
        dout = _randn(torch, (B, S, NQ, D), bf16, gen).transpose(1, 2)

        def kernel():
            return bk.flash_attention_bwd(q, k, v, out, dout, lse, window=window)

        def plain():
            return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, window=window)

        err = max(_compare(torch, f"flash bwd q {tuple(q.shape)} window {window} ({label}) "
                           f"{part}", g, w_, bf16)
                  for part, g, w_ in zip(("dq", "dk", "dv"), kernel(), plain()))
        print(f"[kernels] {label}: flash_attention_bwd q {tuple(q.shape)} bf16 window "
              f"{window}: kernel {time_ms(torch, kernel, launches=5):.4f} ms, plain "
              f"{time_ms(torch, plain, launches=5):.4f} ms, max|err| {err:.3g}", flush=True)
        n += 1
    return n


def _full_width_bwd(torch, gen):
    """The flash backward kernel at the train phase's gemma-2b shape: q
    (2, 8, 2048, 256), one kv head, bf16, causal."""
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as bk
    from repro_torch.kernels import ref

    cfg = get_config(TRAIN_ARCHS[0])
    bf16 = torch.bfloat16
    B, S, NQ, NKV, D = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _randn(torch, (B, S, NQ, D), bf16, gen).transpose(1, 2)
    k = _randn(torch, (B, S, NKV, D), bf16, gen).transpose(1, 2)
    v = _randn(torch, (B, S, NKV, D), bf16, gen).transpose(1, 2)
    dout = _randn(torch, (B, S, NQ, D), bf16, gen).transpose(1, 2)
    out, lse = fk.flash_attention_fwd(q, k, v, return_lse=True)

    def kernel():
        return bk.flash_attention_bwd(q, k, v, out, dout, lse)

    def plain():
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse)

    err = max(_compare(torch, f"flash bwd full width {part}", g, w, bf16)
              for part, g, w in zip(("dq", "dk", "dv"), kernel(), plain()))
    # The library yardstick: the backward of SDPA alone (its forward runs
    # once, outside the timing), through torch.autograd.grad.
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = _sdpa(torch, qq, kk, vv, is_causal=True)

    def library():
        return torch.autograd.grad(o, (qq, kk, vv), dout, retain_graph=True)

    # q, k, v, out, dout and the f32 LSE read once; dq, dk, dv written once.
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    # The function needs five S x S x D products over the causal (q, k)
    # pairs: s = q.k^T, dp = dout.v^T, dv = p^T.dout, dq = ds.k, dk = ds^T.q.
    # (This kernel's two-launch split recomputes s and dp, seven in all:
    # that is its own cost, not the bound's.)
    flops = 5 * 2 * D * B * NQ * (S * (S + 1) // 2)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    return dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention_bwd.py:161", max_abs_err=err,
        shape=f"q {tuple(q.shape)} kv heads {NKV} bf16 causal (gemma-2b training)",
        ms=time_ms(torch, kernel, launches=5),
        eager_ms=time_ms(torch, kernel, launches=5, graph=False),
        plain_ms=time_ms(torch, plain, launches=5),
        library_ms=time_ms(torch, library, launches=5, graph=False),
        library="SDPA backward (eager)",
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


def _full_width_paged(torch, full, gen):
    """The paged kernel at the continuous serve phase's tier-l shapes: one
    decode step of the full 8-slot batch at position 128 (the prompt plus
    the first token), each row's pages scattered over the 145-page pool."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref

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

    err = _compare(torch, "paged decode full width", kernel(), plain(), bf16)
    # The library yardstick: SDPA over the dense view gathered beforehand
    # (no single PyTorch call reads page tables); the gather is not timed.
    flat = (tables.long()[:, :, None] * PAGE + torch.arange(PAGE, device="cuda")).reshape(B, -1)
    kd = kp.transpose(1, 2).reshape(P * PAGE, NKV, D)[flat].transpose(1, 2)
    vd = vp.transpose(1, 2).reshape(P * PAGE, NKV, D)[flat].transpose(1, 2)
    mask = (torch.arange(NB * PAGE, device="cuda") <= pos[:, None])[:, None, None, :]
    qs = q.reshape(B, NQ, 1, D)
    # Live keys only: k and v of positions 0..pos once, q read, out written.
    nbytes = 2 * B * valid * NKV * D * 2 + 2 * q.numel() * 2 + tables.numel() * 4 + B * 4
    flops = 4 * B * NQ * D * valid
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    return dict(
        name="decode_attention_paged_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:207", max_abs_err=err,
        shape=f"q {tuple(q.shape)} pool {(P, PAGE, NKV, D)} {valid} live keys bf16 "
              f"({B * NKV} blocks)",
        ms=time_ms(torch, kernel), eager_ms=time_ms(torch, kernel, graph=False),
        plain_ms=time_ms(torch, plain),
        library_ms=time_ms(torch, lambda: _sdpa(torch, qs, kd, vd, attn_mask=mask)),
        library="SDPA on the pre-gathered dense view",
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
    )


def _full_width(torch, full, B, gen):
    """Kernel vs plain vs library vs bound at the serve phase's qwen3-14b shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rk

    bf16 = torch.bfloat16
    S, d = full["prompt"], full["d_model"]
    NQ, NKV, D, S_cache = full["n_heads"], full["n_kv_heads"], full["head_dim"], full["max_len"]
    entries = []

    x = _randn(torch, (B, S, d), bf16, gen)
    w = torch.ones(d, device="cuda")
    err = _compare(torch, "rms_norm full width", rk.rms_norm_fwd(x, w), ref.rms_norm_ref(x, w), bf16)
    nbytes = 2 * x.numel() * x.element_size() + w.numel() * 4
    entries.append(dict(
        name="rms_norm_fwd", route="triton", source="src/repro_torch/kernels/rmsnorm.py",
        replaces="src/repro/kernels/rmsnorm.py:43", max_abs_err=err,
        shape=f"x {tuple(x.shape)} bf16 (ln1/ln2 at prefill)",
        ms=time_ms(torch, lambda: rk.rms_norm_fwd(x, w)),
        eager_ms=time_ms(torch, lambda: rk.rms_norm_fwd(x, w), graph=False),
        plain_ms=time_ms(torch, lambda: ref.rms_norm_ref(x, w)),
        library_ms=time_ms(torch, lambda: F.rms_norm(x, (d,), w.to(bf16), 1e-6)),
        bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes",
    ))

    q = _randn(torch, (B, S, NQ, D), bf16, gen).transpose(1, 2)
    k = _randn(torch, (B, S, NKV, D), bf16, gen).transpose(1, 2)
    v = _randn(torch, (B, S, NKV, D), bf16, gen).transpose(1, 2)
    err = _compare(torch, "flash full width", fk.flash_attention_fwd(q, k, v),
                   ref.flash_attention_ref(q, k, v), bf16)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read; out written
    flops = 4 * B * NQ * D * (S * (S + 1) // 2)  # causal (q, k) pairs
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    entries.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:119", max_abs_err=err,
        shape=f"q {tuple(q.shape)} kv heads {NKV} bf16 causal (prefill)",
        ms=time_ms(torch, lambda: fk.flash_attention_fwd(q, k, v)),
        eager_ms=time_ms(torch, lambda: fk.flash_attention_fwd(q, k, v), graph=False),
        plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v)),
        library_ms=time_ms(torch, lambda: _sdpa(torch, q, k, v, is_causal=True)),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
    ))

    G = NQ // NKV
    qd = _randn(torch, (B, NKV, G, D), bf16, gen)
    kc = _randn(torch, (B, S_cache, NKV, D), bf16, gen).transpose(1, 2)
    vc = _randn(torch, (B, S_cache, NKV, D), bf16, gen).transpose(1, 2)
    valid = S + 1  # the prompt plus the first decoded token
    sp = torch.where(torch.arange(S_cache) < valid, torch.arange(S_cache), -1)
    sp = sp.to(torch.int32).expand(B, S_cache).contiguous().cuda()
    pos = torch.full((B,), valid - 1, dtype=torch.int32, device="cuda")
    err = _compare(torch, "decode full width", dk.decode_attention_fwd(qd, kc, vc, sp, pos),
                   ref.decode_attention_ref(qd, kc, vc, sp, pos), bf16)
    mask = (sp >= 0) & (sp <= pos[:, None])
    nbytes = (2 * qd.numel() * 2 + 2 * B * valid * NKV * D * 2 + sp.numel() * 4 + B * 4)
    flops = 4 * B * NQ * D * valid
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    entries.append(dict(
        name="decode_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:88", max_abs_err=err,
        shape=f"q {tuple(qd.shape)} cache {(B, S_cache, NKV, D)} {valid} live slots bf16 "
              f"({B * NKV} blocks)",
        ms=time_ms(torch, lambda: dk.decode_attention_fwd(qd, kc, vc, sp, pos)),
        eager_ms=time_ms(torch, lambda: dk.decode_attention_fwd(qd, kc, vc, sp, pos),
                         graph=False),
        plain_ms=time_ms(torch, lambda: ref.decode_attention_ref(qd, kc, vc, sp, pos)),
        library_ms=time_ms(torch, lambda: _sdpa(
            torch, qd.reshape(B, NQ, 1, D), kc, vc, attn_mask=mask[:, None, None, :])),
        bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
    ))
    return entries


# ---------------------------------------------------------------------------
# Phase 4: small models, card vs CPU.
# ---------------------------------------------------------------------------
def phase_model(torch):
    from repro_torch.configs.archs import reduced
    from repro_torch.configs.mdinference_zoo import ONDEVICE_HEDGE
    from repro_torch.launch.serve import tier_configs
    from repro_torch.models import transformer as T

    models = [(name, cfg) for name, cfg, _ in tier_configs()]
    models.append(("hedge", ONDEVICE_HEDGE.config()))
    # One period of (recurrent, recurrent, local) and the (recurrent,
    # recurrent) epilogue; window 32, so 16 decode steps wrap the ring.
    models.append(("hybrid", reduced(HYBRID_ARCH, n_layers=5)))
    B, S, steps, max_len = 2, 24, 16, 48
    for name, cfg in models:
        cpu_params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        gpu_params = T.params_to(cpu_params, "cuda")
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
        runs = {}
        for where, params in (("card", gpu_params), ("cpu", cpu_params)):
            device = "cuda" if where == "card" else "cpu"
            with torch.inference_mode():
                cache, logits = T.prefill(cfg, params, {"tokens": tokens.to(device)}, max_len)
                all_logits, toks = [logits.float().cpu()], []
                tok = logits.argmax(-1)
                for i in range(steps):
                    toks.append(tok.cpu())
                    pos = torch.full((B,), S + i, dtype=torch.int32, device=device)
                    logits, cache = T.decode_step(cfg, params, cache, tok, pos)
                    all_logits.append(logits.float().cpu())
                    tok = logits.argmax(-1)
            runs[where] = (torch.stack(all_logits), torch.stack(toks))
        err = float((runs["card"][0] - runs["cpu"][0]).abs().max())
        check(bool(torch.allclose(runs["card"][0], runs["cpu"][0], atol=1e-3, rtol=1e-3)),
              f"model {name}: card vs CPU logits max |err| {err:.3g} beyond atol 1e-3 rtol 1e-3")
        check(bool(torch.equal(runs["card"][1], runs["cpu"][1])),
              f"model {name}: greedy tokens differ between card and CPU")
        print(f"[model] {name:6s} {cfg.name}: prefill + {steps} greedy steps, card vs CPU "
              f"logits max|err| {err:.3g} (atol 1e-3), tokens equal", flush=True)
        if T.supports_paged_decode(cfg):  # recurrent state is not paged
            _model_paged(torch, name, cfg, cpu_params, gpu_params)
        if name != "hedge":
            _model_grads(torch, name, cfg, cpu_params)


def _model_grads(torch, name, cfg, cpu_params):
    """``loss_fn`` and every parameter gradient (remat on, labels < 0
    ignored), card against CPU, in f32.  Tolerance: the loss to atol 1e-4;
    each gradient leaf elementwise within 2e-3 of its own largest entry
    plus rtol 1e-3 — the reduced tiers' stacked weights are drawn with
    fan-in = period count, so activations grow through the stack and
    amplify summation-order differences; a gradient cut at a norm or an
    attention is off by the whole leaf.  Every leaf must be finite and
    non-zero on the card."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import named_leaves, tree_map

    B, S = 2, 64
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=torch.Generator().manual_seed(3))
    labels = toks[:, 1:].clone()
    labels[0, :5] = -1
    runs = {}
    for device in ("cuda", "cpu"):
        params = tree_map(lambda p: p.detach().to(device, copy=True).requires_grad_(True),
                          cpu_params)
        named = list(named_leaves(params))
        batch = {"tokens": toks[:, :-1].to(device), "labels": labels.to(device)}
        loss, metrics = T.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, [leaf for _, leaf in named])
        runs[device] = (float(loss.detach()), float(metrics["tokens"]),
                        [(path, g.float().cpu()) for (path, _), g in zip(named, grads)])
    (loss_c, tok_c, card), (loss_h, tok_h, host) = runs["cuda"], runs["cpu"]
    check(tok_c == tok_h == B * S - 5, f"model {name} grads: {tok_c} / {tok_h} valid labels")
    check(abs(loss_c - loss_h) <= 1e-4,
          f"model {name} grads: loss card {loss_c} vs CPU {loss_h} beyond atol 1e-4")
    worst = 0.0
    for (path, a), (_, b) in zip(card, host):
        scale = float(b.abs().max())
        check(bool(torch.isfinite(a).all()), f"model {name}: gradient {path} not finite on the card")
        check(float(a.abs().max()) > 0, f"model {name}: gradient {path} is zero on the card")
        rel = float((a - b).abs().max()) / scale
        check(bool(torch.allclose(a, b, atol=2e-3 * scale, rtol=1e-3)),
              f"model {name}: gradient {path} card vs CPU max |err| {rel:.3g} of its "
              "largest entry, beyond 2e-3 + rtol 1e-3")
        worst = max(worst, rel)
    print(f"[model] {name:6s} loss_fn + grads (remat): loss card {loss_c:.6f} CPU {loss_h:.6f}; "
          f"{len(card)} gradient leaves, all non-zero on the card, worst max|err| "
          f"{worst:.3g} of the leaf's largest entry (tolerance 2e-3)", flush=True)


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
    results = {}
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
# Phase 7: hybrid serve at full width (recurrentgemma-2b).
# ---------------------------------------------------------------------------
def _expected_launches(cfg):
    """Launches per prefill and per decode step worked out from the layer
    kinds: a scan per recurrent layer and a flash launch per attention layer
    in prefill, a ring-decode launch per attention layer in decode (the
    recurrent state is updated elementwise), two norms per block plus the
    final norm in both."""
    kinds = cfg.layer_kinds()
    n_rec = sum(k == "recurrent" for k in kinds)
    n_attn = sum(k in ("attn", "local") for k in kinds)
    norms = 2 * len(kinds) + 1 + (2 * n_attn if cfg.qk_norm else 0)
    prefill = dict(rms_norm_fwd=norms, flash_attention_fwd=n_attn, rglru_scan_fwd=n_rec,
                   decode_attention_fwd=0)
    decode = dict(rms_norm_fwd=norms, flash_attention_fwd=0, rglru_scan_fwd=0,
                  decode_attention_fwd=n_attn)
    return prefill, decode


def phase_hybrid(torch, card):
    """Full-width recurrentgemma-2b served as tier-rg by a ``JitBackend``."""
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = get_config(HYBRID_ARCH)
    ops.reset_launch_counts()  # the hybrid path starts here
    engine, results = _serve_engine(torch, "hybrid", [(HYBRID_TIER, cfg, HYBRID_QUALITY)],
                                    HYBRID_TIER, card)
    counts = ops.launch_counts()  # the hybrid path ends here
    print(f"[hybrid] kernel launches during the hybrid serve phase: {counts}", flush=True)
    for name in HYBRID_PATH_KERNELS:
        check(counts[name] > 0, f"hybrid: kernel {name} was never launched on its path")

    # Launches of one prefill and one decode step, counted on their own (the
    # phase's counts above are already read).
    v = engine.variants[HYBRID_TIER]
    want_prefill, want_decode = _expected_launches(cfg)
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
              f"hybrid: launches per {what} {got}, expected {want} from the layer kinds")
    print(f"[hybrid] launches per prefill {want_prefill}, per decode step {want_decode}: "
          "as worked out from the layer kinds", flush=True)
    ops.reset_launch_counts()
    results["launches_per_prefill"] = want_prefill
    results["launches_per_decode_step"] = want_decode
    return counts, results, engine


# ---------------------------------------------------------------------------
# Phase 9: train full-width gemma-2b and recurrentgemma-2b.
# ---------------------------------------------------------------------------
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

    attn_fwd, attn_bwd = count(("attn", "local"))
    rec_fwd, rec_bwd = count(("recurrent",))
    # The scan's backward is the same kernel over the reversed sequence.
    return dict(flash_attention_fwd=attn_fwd, flash_attention_bwd=attn_bwd,
                rglru_scan_fwd=rec_fwd + rec_bwd)


def phase_train(torch, arch, card, profile: bool):
    """12 steps of ``make_train_step`` on full-width ``arch`` (the code path
    of ``python -m repro_torch.launch.train --arch ARCH --full-config``,
    with its optimizer settings)."""
    import numpy as np
    from repro_torch.configs.archs import get_config
    from repro_torch.kernels import ops
    from repro_torch.training import (
        DataConfig, OptimizerConfig, TrainConfig, init_train_state, make_pipeline,
        make_train_step,
    )
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    B, S, L = TRAIN_BATCH, TRAIN_SEQ, cfg.n_layers
    opt_cfg = OptimizerConfig(learning_rate=3e-4, warmup_steps=min(100, TRAIN_STEPS // 10 + 1),
                              total_steps=TRAIN_STEPS)
    step_fn = make_train_step(cfg, opt_cfg, TrainConfig())
    pipe = make_pipeline(DataConfig(batch_size=B, seq_len=S, seed=0), cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()

    ops.reset_launch_counts()  # the train path starts here
    t0 = time.perf_counter()
    state = init_train_state(cfg, torch.Generator().manual_seed(0), TrainConfig(), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"[train] {cfg.name}: {L} layers {cfg.layer_kinds().count('recurrent')} recurrent "
          f"(lru width {cfg.lru_width}), d {cfg.d_model}, {cfg.n_heads} q / "
          f"{cfg.n_kv_heads} kv heads x {cfg.head_dim}, d_ff {cfg.d_ff} {cfg.mlp_type}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, remat={cfg.remat}; {n_params / 1e9:.3f}B params; "
          f"state built in {time.perf_counter() - t0:.1f}s, "
          f"{(torch.cuda.memory_allocated() - before) / 2**30:.1f} GiB; batch {B} x {S} "
          f"tokens, {TRAIN_STEPS} steps", flush=True)

    losses, step_ms = [], []
    for step in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(step).items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
        if step == 0:
            # mu = (1 - beta1) * clip * grad after the first update: each
            # leaf's gradient was finite and non-zero iff its mu is.
            for i, mu in enumerate(tree_leaves(state["opt"]["mu"])):
                check(bool(torch.isfinite(mu).all()) and float(mu.abs().max()) > 0,
                      f"train {arch}: leaf {i} {tuple(mu.shape)} got a zero or non-finite "
                      "gradient")
        print(f"[train] {arch} step {step:2d}  loss {loss:.4f}  gnorm {gnorm:.3f}  "
              f"lr {float(metrics['lr']):.2e}  {step_ms[-1]:.1f} ms", flush=True)
    counts = ops.launch_counts()  # the train path ends here
    peak = torch.cuda.max_memory_allocated()

    check(all(np.isfinite(losses)), f"train {arch}: non-finite losses {losses}")
    check(float(np.mean(losses[-3:])) < losses[0],
          f"train {arch}: mean of the last 3 losses {np.mean(losses[-3:]):.4f} not below the "
          f"first {losses[0]:.4f}")
    want = _train_launches(cfg)
    for name in TRAIN_PATH_KERNELS + (("rglru_scan_fwd",) if want["rglru_scan_fwd"] else ()):
        check(counts[name] > 0, f"train {arch}: kernel {name} was never launched on the "
              "train path")
    got = {k: counts[k] / TRAIN_STEPS for k in want}
    check(got == want, f"train {arch}: launches per step {got}, expected {want} (remat on "
          "the periods)")
    steady = statistics.median(step_ms[1:])
    tokens = B * S
    # Model FLOPs (remat's recompute not counted): 6 per parameter and
    # token, plus attention's 12 * D per (q, k) pair in the causal window
    # and q head, over the attention layers.
    n_attn = sum(k in ("attn", "local") for k in cfg.layer_kinds())
    span = cfg.window if cfg.window else S
    pairs = sum(min(q + 1, span) for q in range(S))
    flops = 6 * n_params * tokens + 12 * n_attn * cfg.head_dim * B * cfg.n_heads * pairs
    result = dict(
        arch=cfg.name, params=n_params, batch=B, seq=S, steps=TRAIN_STEPS, losses=losses,
        step_ms=step_ms, median_step_ms=steady, tokens_per_s=tokens / steady * 1e3,
        mfu=flops / (steady / 1e3) / H100_BF16_FLOPS, model_flops_per_step=flops,
        peak_gib=peak / 2**30, launches_per_step={k: v / TRAIN_STEPS for k, v in counts.items()},
    )
    print(f"[train] {arch} median step {steady:.1f} ms (steps 1-{TRAIN_STEPS - 1}; step 0 "
          f"{step_ms[0]:.1f} ms): {result['tokens_per_s']:.0f} tokens/s, MFU "
          f"{100 * result['mfu']:.2f} % of 989 TFLOP/s bf16 ({flops / 1e12:.1f} TFLOP model "
          f"FLOPs per step); peak memory {result['peak_gib']:.1f} GiB; loss {losses[0]:.4f} -> "
          f"{np.mean(losses[-3:]):.4f} (mean of last 3); card {card}", flush=True)
    print(f"[train] {arch} kernel launches per step: {result['launches_per_step']}", flush=True)
    if profile:
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(TRAIN_STEPS).items()}
        result["profile"] = _profile_step(torch, lambda: step_fn(state, batch),
                                          f"{arch} train step", card)
    del state
    torch.cuda.empty_cache()
    return counts, result


# ---------------------------------------------------------------------------
# Optional phase: where a request's time goes.
# ---------------------------------------------------------------------------
_PORT_KERNELS = ("rms_norm_kernel", "flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel",
                 "flash_bwd_group_sum_kernel", "decode_fwd_kernel", "decode_paged_fwd_kernel",
                 "rglru_scan_kernel")


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
        if fam is None:
            low = name.lower()
            fam = "matmul" if any(s in low for s in (
                "gemm", "gemv", "xmma", "cutlass", "nvjet")) else "other"
        families[fam] += ms
    return by_name, families, len(kernels)


def _profile_step(torch, fn, label, card):
    """torch.profiler over one call of ``fn``: wall, device busy share and
    device time by kernel family."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, families, n = _families(prof)
    busy = sum(by_name.values())
    print(f"[profile] {label}: wall {wall_ms:.1f} ms (profiled), device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%), {n} kernels; card {card}", flush=True)
    for fam, ms in families.most_common():
        print(f"[profile]   {fam:22s} {ms:9.3f} ms ({100 * ms / busy:.1f}% of busy)", flush=True)
    for name, ms in by_name.most_common(8):
        print(f"[profile]   top {ms:9.3f} ms  {name[:90]}", flush=True)
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_kernels=n,
                busy_share=busy / wall_ms, families=dict(families),
                top=by_name.most_common(8))


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


def _release(torch, label):
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{label}] released: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier-l-layers", type=int, default=40,
                    help="tier-l depth (qwen3-14b has 40); width is never cut")
    ap.add_argument("--profile", action="store_true",
                    help="profile one tier-l generate per backend and batch 1 / 4 after "
                    "the serve phases, one tier-rg generate at batch 4 after the hybrid "
                    "phase, and one step after each train run")
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v register use")
    ap.add_argument("--json-out", default=None, help="also write the results here")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the root of a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    t_start = time.perf_counter()
    card = phase_device(torch)
    phase_build(torch, args.ptxas)

    from repro_torch.configs.archs import get_config

    q14 = get_config("qwen3-14b")
    full = dict(batch=BATCH, prompt=PROMPT, d_model=q14.d_model,
                n_heads=q14.n_heads, n_kv_heads=q14.n_kv_heads, head_dim=q14.head_dim,
                max_len=PROMPT + GEN + 8, gen=GEN)
    entries = phase_kernels(torch, full)
    phase_model(torch)
    dense_counts, serve_results, engine = phase_serve(torch, args.tier_l_layers, card)
    paged_counts, serve_results["continuous"], cbackend = phase_continuous(torch, engine, card)
    profile = (phase_profile(torch, [(label, backend, "tier-l", B)
                                     for label, backend in (("dense", engine.backend),
                                                            ("continuous", cbackend))
                                     for B in (1, 4)], card)
               if args.profile else {})
    del engine, cbackend  # release tier-l's weights before the hybrid tier
    _release(torch, "serve")
    hybrid_counts, serve_results["hybrid"], hengine = phase_hybrid(torch, card)
    if args.profile:
        profile.update(phase_profile(torch, [("hybrid", hengine.backend, HYBRID_TIER, BATCH)],
                                     card))
    del hengine  # release tier-rg's weights before training
    _release(torch, "hybrid")
    phase_counts = {"dense": dense_counts, "continuous": paged_counts, "hybrid": hybrid_counts}
    train = {}
    for arch in TRAIN_ARCHS:
        phase_counts[f"train {arch}"], train[arch] = phase_train(torch, arch, card, args.profile)
    counts = {k: sum(c[k] for c in phase_counts.values()) for k in dense_counts}
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
            dict(card=card, kernels=entries, serve=serve_results, train=train,
                 launches=counts, launches_by_phase=phase_counts, profile=profile,
                 seconds=time.perf_counter() - t_start), indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(f"card: {card}")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
