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
   the kernel-test sweep shapes and at the full-width serving shapes, with
   f32 atol 1e-4 (summation order) and bf16 atol 2e-2 + rtol 1e-2 (one
   bf16 rounding step); times (CUDA events over CUDA-graph replays, median)
   of the kernel, the plain version, one PyTorch call as a yardstick, and
   the bound, plus the kernel's eager time with its launch cost.
   The paged decode kernel runs the sweep of tests/test_kernels.py (every
   ladder size, windows, masked rows bitwise inert, D 16..256, G=5) and a
   full-width row at the continuous serve phase's pool geometry.
4. model: the three reduced serving tiers and the hedge variant, prefill
   plus 16 greedy decode steps in f32, on the card through the kernels and
   on the CPU through the plain versions: logits allclose, tokens equal;
   then the same on the paged path (``prefill_ragged`` + graft + 16
   ``paged_decode_step``s, rows at different positions).
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
7. profile (only with ``--profile``): ``torch.profiler`` over one tier-l
   ``generate`` at batch 1 and 4 on the dense and on the continuous
   backend — device busy share, device time by kernel family, port-kernel
   launches per generate.

Every run measures every column of the kernels line: each serve phase
sets the launch counters to 0 just before it and reads them just after,
and a kernel's ``launches`` is the sum over the two serve phases of the
same run.  The last lines are the card line, one ``{"kernels": [...]}``
JSON line and the ``{"ok": true, "device": ...}`` JSON line.
``--tier-l-layers`` cuts tier-l's depth (never its width) if a time limit
forces it.
"""
from __future__ import annotations

import argparse
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


# The kernels each serve phase's path must launch (the hedge tier's dense
# decode may or may not run during the continuous phase).
DENSE_PATH_KERNELS = ("rms_norm_fwd", "flash_attention_fwd", "decode_attention_fwd")
PAGED_PATH_KERNELS = ("rms_norm_fwd", "flash_attention_fwd", "decode_attention_paged_fwd")


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
            if dtype == f32:
                _compare(torch, tag + " lse", lse, want_lse, f32)
            n += 1
    # -- Decode sweep: (B, NKV, G, S, D, window); ring slots as in the tests.
    decode_cases = [
        (2, 2, 2, 256, 64, 0), (1, 1, 8, 512, 128, 0), (2, 2, 1, 256, 64, 64),
        (1, 4, 2, 128, 32, 0), (2, 8, 5, 152, 128, 0), (2, 1, 2, 40, 16, 0),
        (1, 1, 10, 96, 256, 0), (3, 2, 4, 33, 64, 16),
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
    return entries + [paged]


def _print_entry(e):
    print(f"[kernels] {e['name']:26s} {e['shape']}: kernel {e['ms']:.4f} ms "
          f"(eager with launch cost {e['eager_ms']:.4f} ms), "
          f"plain {e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} ms, "
          f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
          f"max|err| {e['max_abs_err']:.3g}", flush=True)


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
    from repro_torch.configs.mdinference_zoo import ONDEVICE_HEDGE
    from repro_torch.launch.serve import tier_configs
    from repro_torch.models import transformer as T

    models = [(name, cfg) for name, cfg, _ in tier_configs()]
    models.append(("hedge", ONDEVICE_HEDGE.config()))
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
        _model_paged(torch, name, cfg, cpu_params, gpu_params)


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
    import numpy as np
    from repro_torch.configs.archs import get_config
    from repro_torch.core.network import LognormalNetwork
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.observability.quantile import quantile
    from repro_torch.serving.loadgen import PoissonArrivals, make_trace
    from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig

    full = get_config("qwen3-14b")
    tier_l = get_config("qwen3-14b", n_layers=tier_l_layers)
    if tier_l.n_layers != full.n_layers:
        print(f"[serve] CUT: tier-l depth {tier_l.n_layers} of {full.n_layers} layers "
              "(width unchanged)", flush=True)
    configs = [(n, tier_l if n == "tier-l" else c, q) for n, c, q in serve.tier_configs()]
    prompt, gen, sla = PROMPT, GEN, SLA_MS
    max_len = prompt + gen + 8

    ops.reset_launch_counts()  # the main path starts here
    t0 = time.perf_counter()
    engine = serve.build_engine(max_len=max_len, seed=0, measured_hedge=True,
                                dispatch="sync", device="cuda", configs=configs)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(engine.variants["tier-l"].params))
    print(f"[serve] engine built in {time.perf_counter() - t0:.1f}s; tier-l "
          f"{tier_l.name} {n_params / 1e9:.2f}B params bf16, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB "
          "allocated", flush=True)
    registry = engine.measure_profiles(prompt_len=prompt, gen_tokens=gen, trials=3, seed=0)
    ondevice = engine.hedge_backend.measure_profile(prompt_len=prompt, gen_tokens=gen, trials=3)
    for p in list(registry) + [ondevice]:
        print(f"[serve] profile {p.name:22s} mu_ms={p.mu_ms:.3f} sigma_ms={p.sigma_ms:.3f}",
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
              f"serve {dispatch}: {len(completions)} resolved + {rejected} rejected "
              f"!= {n_req} submitted")
        check(len(completions) == n_req, f"serve {dispatch}: not every request resolved")
        for c in completions:
            check(c.tokens.shape == (gen,) and int(c.tokens.min()) >= 0,
                  f"serve {dispatch}: request {c.rid} has bad tokens {c.tokens}")
        on_l = sum(c.model_name == "tier-l" for c in completions)
        check(on_l > 0, f"serve {dispatch}: no request ran on tier-l")
        lats = [c.latency_ms for c in completions]
        races = {k: round(v, 4) for k, v in metrics.race_resolution.items()}
        results[dispatch] = dict(resolved=len(completions), rejected=rejected, cancelled=0,
                                 on_tier_l=on_l, race_resolution=races,
                                 p50_ms=quantile(lats, 50), p99_ms=quantile(lats, 99),
                                 wall_s=wall)
        print(f"[serve] dispatch={dispatch}: {len(completions)} resolved + {rejected} "
              f"rejected + 0 cancelled == {n_req} submitted; {on_l} on tier-l; "
              f"race_resolution {races}; latency p50 {quantile(lats, 50):.1f} ms "
              f"p99 {quantile(lats, 99):.1f} ms; drain {wall:.1f}s; card {card}", flush=True)

    v = engine.variants["tier-l"]
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts[:2], device="cuda")
        _, logits = T.prefill(v.cfg, v.params, {"tokens": tokens}, max_len)
    check(tuple(logits.shape) == (2, v.cfg.vocab_size), f"tier-l logits shape {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "tier-l logits are not finite")
    counts = ops.launch_counts()  # the main path ends here
    print(f"[serve] tier-l logits finite, shape {tuple(logits.shape)}; kernel launches "
          f"during the serve phase: {counts}", flush=True)
    for name in DENSE_PATH_KERNELS:
        check(counts[name] > 0, f"serve: kernel {name} was never launched on the main path")
    return counts, results, engine


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
# Optional phase: where a tier-l request's time goes.
# ---------------------------------------------------------------------------
_PORT_KERNELS = ("rms_norm_kernel", "flash_fwd_kernel", "decode_fwd_kernel",
                 "decode_paged_fwd_kernel")


def phase_profile(torch, backends, card):
    """torch.profiler over one timed tier-l ``generate`` per backend and
    batch size: device busy share and device time by kernel family."""
    import collections

    import numpy as np
    from repro_torch.kernels import ops
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for (label, backend), B in ((lb, B) for lb in backends.items() for B in (1, 4)):
        tokens = np.random.default_rng(B).integers(0, 256, (B, PROMPT))
        backend.generate("tier-l", tokens, GEN)  # warm this shape
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_ms = backend.generate("tier-l", tokens, GEN)
        launches = ops.launch_counts()
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
        busy = sum(by_name.values())
        out[f"{label} B={B}"] = dict(
            wall_ms=wall_ms, device_busy_ms=busy, device_kernels=len(kernels),
            busy_share=busy / wall_ms, families=dict(families),
            top=by_name.most_common(8), launches=launches)
        print(f"[profile] {label} tier-l B={B} prompt {PROMPT} gen {GEN}: wall "
              f"{wall_ms:.1f} ms (profiled), device busy {busy:.1f} ms "
              f"({100 * busy / wall_ms:.1f}%), {len(kernels)} kernels, port kernel "
              f"launches {launches}; card {card}", flush=True)
        for fam, ms in families.most_common():
            print(f"[profile]   {fam:18s} {ms:9.3f} ms", flush=True)
        for name, ms in by_name.most_common(8):
            print(f"[profile]   top {ms:9.3f} ms  {name[:90]}", flush=True)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier-l-layers", type=int, default=40,
                    help="tier-l depth (qwen3-14b has 40); width is never cut")
    ap.add_argument("--profile", action="store_true",
                    help="after the serve phases, profile one tier-l generate per backend")
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
    profile = (phase_profile(torch, {"dense": engine.backend, "continuous": cbackend}, card)
               if args.profile else {})
    del engine, cbackend
    counts = {k: dense_counts[k] + paged_counts[k] for k in dense_counts}
    names = {e["name"] for e in entries}
    check(names == set(counts), f"kernels timed {sorted(names)} != kernels counted {sorted(counts)}")
    for e in entries:
        e["launches"] = counts[e["name"]]
        check(e["launches"] > 0, f"kernel {e['name']} was never launched by the serve phases")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = {"kernels": [{k: e[k] for k in keys} for e in entries]}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(
            dict(card=card, kernels=entries, serve=serve_results, launches=counts,
                 launches_dense=dense_counts, launches_continuous=paged_counts,
                 profile=profile,
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
