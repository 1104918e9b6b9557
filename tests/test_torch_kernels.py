"""The port's kernels: plain versions against the JAX oracles and the Pallas
kernels (interpret mode) on the CPU; hand-written kernels against their
plain versions on an sm_90 card (skipped elsewhere).

Inputs come from numpy with a fixed seed and go to both packages.
Tolerances: f32 atol 2e-5 (summation order), bf16 atol 2e-2 (the
``tests/test_kernels.py`` bound; the plain attention casts the softmax
weights to bf16 for P.V where the Pallas kernels stay in f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_fwd as pallas_decode  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_paged_fwd as pallas_paged,
)
from repro.models.attention import paged_decode_attention as j_paged_model  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd as pallas_flash  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_fwd as pallas_rglru  # noqa: E402
from repro.kernels.rmsnorm import rms_norm_fwd as pallas_rmsnorm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}

# The JAX oracles, compiled once per shape instead of dispatched op by op.
jref_rms_norm = jax.jit(jref.rms_norm_ref, static_argnames=("eps", "offset"))
jref_flash = jax.jit(jref.flash_attention_ref, static_argnames=("causal", "window", "scale"))
jref_decode = jax.jit(jref.decode_attention_ref, static_argnames=("window", "scale"))
jref_paged = jax.jit(jref.decode_attention_paged_ref, static_argnames=("window", "scale"))
jref_rglru = jax.jit(jref.rglru_scan_ref)
jpallas_rglru = jax.jit(pallas_rglru, static_argnames=("block_s", "block_w", "interpret"))


def _pair(rng, shape, dtype):
    """The same normal draw as a jnp array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


def _close(torch_out, jax_out, dtype):
    np.testing.assert_allclose(
        torch_out.float().numpy(), np.asarray(jnp.asarray(jax_out, jnp.float32)),
        atol=ATOL[dtype], rtol=0,
    )


def _ring_slots(B, S):
    """Ring-buffer positions as in tests/test_kernels.py: wrapped, all valid."""
    pos = np.full((B,), S + S // 2, np.int32)
    slot = (pos[:, None] - S + 1) + (np.arange(S) + S // 2) % S
    return slot.astype(np.int32), pos


# ---------------------------------------------------------------------------
# Plain versions against the JAX oracles and the Pallas kernels (CPU).
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("shape", [(3, 7, 512), (1, 1, 64), (2, 5, 16)])
def test_rmsnorm_plain_matches_jax(shape, offset, dtype):
    rng = np.random.default_rng(shape[-1])
    xj, xt = _pair(rng, shape, dtype)
    wj, wt = _pair(rng, shape[-1:], "float32")
    out = ops.rms_norm(xt, wt, offset=offset)
    assert out.dtype == xt.dtype
    _close(out, jref_rms_norm(xj, wj, offset=offset), dtype)
    _close(out, pallas_rmsnorm(xj, wj, offset=offset, block_rows=8, interpret=True), dtype)


FLASH_CASES = [
    # (B, NQ, NKV, S, D, causal, window)
    (2, 4, 2, 128, 32, True, 0),
    (1, 4, 1, 128, 64, True, 0),  # MQA
    (1, 10, 2, 64, 16, True, 0),  # G = 5
    (1, 4, 1, 128, 64, True, 32),  # window
    (2, 2, 2, 64, 32, False, 0),  # bidirectional
    (1, 10, 1, 64, 256, True, 16),  # recurrentgemma's G = 10, D = 256, windowed
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_plain_matches_jax(case, dtype):
    B, NQ, NKV, S, D, causal, window = case
    rng = np.random.default_rng(S + NQ + D)
    qj, qt = _pair(rng, (B, NQ, S, D), dtype)
    kj, kt = _pair(rng, (B, NKV, S, D), dtype)
    vj, vt = _pair(rng, (B, NKV, S, D), dtype)
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.shape == (B, NQ, S, D) and out.dtype == qt.dtype
    _close(out, jref_flash(qj, kj, vj, causal=causal, window=window), dtype)
    kernel = pallas_flash(qj, kj, vj, causal=causal, window=window, block_q=64,
                          block_k=64, interpret=True)
    _close(out, kernel, dtype)


def test_flash_plain_lse_matches_pallas():
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, (1, 2, 64, 32), "float32")
    kj, kt = _pair(rng, (1, 2, 64, 32), "float32")
    vj, vt = _pair(rng, (1, 2, 64, 32), "float32")
    _, lse = ops.flash_attention(qt, kt, vt, return_lse=True)
    _, want = pallas_flash(qj, kj, vj, block_q=32, block_k=32, interpret=True,
                           return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=2e-5)


DECODE_CASES = [
    # (B, NKV, G, S, D, window)
    (2, 2, 2, 128, 32, 0),
    (2, 2, 1, 128, 64, 64),  # windowed ring
    (1, 2, 5, 64, 16, 0),  # G = 5
    (1, 1, 10, 64, 256, 16),  # recurrentgemma's G = 10, D = 256, windowed ring
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_plain_matches_jax(case, dtype):
    B, NKV, G, S, D, window = case
    rng = np.random.default_rng(S + G)
    qj, qt = _pair(rng, (B, NKV, G, D), dtype)
    kj, kt = _pair(rng, (B, NKV, S, D), dtype)
    vj, vt = _pair(rng, (B, NKV, S, D), dtype)
    slot, pos = _ring_slots(B, S)
    out = ops.decode_attention(qt, kt, vt, torch.from_numpy(slot), torch.from_numpy(pos),
                               window=window)
    assert out.shape == (B, NKV, G, D) and out.dtype == qt.dtype
    sj, pj = jnp.asarray(slot), jnp.asarray(pos)
    _close(out, jref_decode(qj, kj, vj, sj, pj, window=window), dtype)
    _close(out, pallas_decode(qj, kj, vj, sj, pj, window=window, block_k=64,
                              interpret=True), dtype)


@pytest.mark.parametrize("pos_value", [9, -1], ids=["first10", "all_masked"])
def test_decode_plain_empty_slots(pos_value):
    rng = np.random.default_rng(3)
    B, NKV, G, S, D = 2, 2, 2, 64, 32
    qj, qt = _pair(rng, (B, NKV, G, D), "float32")
    kj, kt = _pair(rng, (B, NKV, S, D), "float32")
    vj, vt = _pair(rng, (B, NKV, S, D), "float32")
    slot = np.broadcast_to(np.where(np.arange(S) < 10, np.arange(S), -1), (B, S))
    slot = np.ascontiguousarray(slot, dtype=np.int32)
    pos = np.full((B,), pos_value, np.int32)
    out = ops.decode_attention(qt, kt, vt, torch.from_numpy(slot), torch.from_numpy(pos))
    want = pallas_decode(qj, kj, vj, jnp.asarray(slot), jnp.asarray(pos), block_k=32,
                         interpret=True)
    _close(out, want, "float32")
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# The ring kernel's split plan and merge (its chunk partials algebra, in
# plain torch) against the JAX oracle; the planner; the flash routing.
# ---------------------------------------------------------------------------
def _split_inputs(rng, kind, B=2, NKV=2, G=5, S=37, D=16):
    """Kernel-layout inputs: ``wrapped`` a wrapped ring, every slot valid;
    ``first10`` only slots 0..9 filled and valid (later chunks hold masked
    keys only); ``all_masked`` pos = -1 on every row; ``mixed`` one wrapped
    row and one fully masked row."""
    qj, qt = _pair(rng, (B, NKV, G, D), "float32")
    kj, kt = _pair(rng, (B, NKV, S, D), "float32")
    vj, vt = _pair(rng, (B, NKV, S, D), "float32")
    slot, pos = _ring_slots(B, S)
    if kind in ("first10", "all_masked"):
        slot = np.ascontiguousarray(np.broadcast_to(
            np.where(np.arange(S) < 10, np.arange(S), -1), (B, S)), dtype=np.int32)
        pos = np.full((B,), 9 if kind == "first10" else -1, np.int32)
    elif kind == "mixed":
        pos = pos.copy()
        pos[1] = -1
    return (qj, kj, vj), (qt, kt, vt), slot, pos


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("kind", ["wrapped", "first10", "all_masked", "mixed"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 37], ids=lambda n: f"split{n}")
def test_split_merge_model_matches_jax(n_split, kind, window):
    """Chunk partials (m, l, acc) merged in order equal the unsplit oracle,
    with chunks of masked keys only, wrapped rings and rows with no valid
    key (the uniform mean of v)."""
    S = 37
    rng = np.random.default_rng(n_split + len(kind))
    (qj, kj, vj), (qt, kt, vt), slot, pos = _split_inputs(rng, kind, S=S)
    chunk = -(-S // n_split)
    got = ref.decode_attention_split_ref(qt, kt, vt, torch.from_numpy(slot),
                                         torch.from_numpy(pos), chunk=chunk, window=window)
    want = jref_decode(qj, kj, vj, jnp.asarray(slot), jnp.asarray(pos), window=window)
    _close(got, want, "float32")
    if kind == "all_masked":
        np.testing.assert_allclose(got.numpy(), vt.mean(dim=2, keepdim=True).expand_as(got)
                                   .numpy(), atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape", [
    # (B, NKV, G, S): tier-l's and tier-rg's decode steps, then edges
    (4, 8, 5, 152), (4, 1, 10, 152), (1, 1, 1, 1), (1, 1, 1, 5), (2, 8, 5, 152),
    (8, 8, 5, 152), (1, 1, 8, 512), (2, 1, 40, 300), (1, 2, 16, 4096), (1, 1, 1, 65536),
], ids=str)
def test_split_plan_covers_the_slots(shape):
    from repro_torch.kernels.decode_attention import (
        HEADS_PER_BLOCK, MAX_CHUNK, MAX_SPLIT, split_plan)

    B, NKV, G, S = shape
    heads, n_split, chunk = split_plan(B, NKV, G, S, 132)
    assert heads in HEADS_PER_BLOCK and 1 <= chunk <= MAX_CHUNK and 1 <= n_split <= MAX_SPLIT
    bounds = [(c * chunk, min(S, (c + 1) * chunk)) for c in range(n_split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == S  # [0, S) exactly
    assert all(lo < hi for lo, hi in bounds)  # none empty
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))  # no gap, no overlap
    blocks = n_split * B * NKV * -(-G // heads)
    assert blocks >= min(132, S * B * NKV) or n_split == MAX_SPLIT


@pytest.mark.parametrize("shape, blocks_before", [((4, 8, 5, 152), 32), ((4, 1, 10, 152), 8)],
                         ids=["tier-l", "tier-rg"])
def test_split_plan_fills_one_wave_at_the_served_shapes(shape, blocks_before):
    """The first design's grid was (NKV, B, ceil(G / 8)): 32 and 8 blocks."""
    from repro_torch.kernels.decode_attention import split_plan

    B, NKV, G, S = shape
    assert NKV * B * -(-G // 8) == blocks_before
    heads, n_split, chunk = split_plan(B, NKV, G, S, 132)
    assert n_split * B * NKV * -(-G // heads) >= 132
    if G <= 8:
        assert heads >= G  # tier-l: every query head of a kv head in one block


def test_split_plan_refuses_what_the_kernel_cannot_take():
    """Empty shapes are refused; S has no cap (a block walks a long chunk in
    steps), so 65537 slots get a plan that covers them."""
    from repro_torch.kernels.decode_attention import MAX_SPLIT, split_plan

    heads, n_split, chunk = split_plan(1, 1, 1, 256 * 256 + 1, 132)
    assert n_split <= MAX_SPLIT and (n_split - 1) * chunk < 256 * 256 + 1 <= n_split * chunk
    with pytest.raises(ValueError):
        split_plan(1, 1, 0, 10, 132)
    with pytest.raises(ValueError):
        split_plan(1, 1, 1, 0, 132)


@pytest.mark.parametrize("dtype, D, route", [
    ("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"), ("bfloat16", 256, "wgmma"),
    ("float16", 64, "wgmma"), ("float16", 128, "wgmma"), ("float16", 256, "wgmma"),
    ("bfloat16", 16, "cuda_core"), ("bfloat16", 32, "cuda_core"), ("float16", 32, "cuda_core"),
    ("float32", 64, "cuda_core"), ("float32", 128, "cuda_core"), ("float32", 256, "cuda_core"),
])
def test_flash_route_by_dtype_and_head_dim(dtype, D, route):
    from repro_torch.kernels.flash_attention import flash_route

    assert flash_route(getattr(torch, dtype), D) == route


@pytest.mark.parametrize("what", ["flash_attention_fwd (TMA)", "decode_attention_fwd"])
def test_16_byte_check_refuses_misaligned_operands(what):
    """TMA (the tensor-core flash forward) and the ring decode's 16-byte
    loads take 16-byte-aligned bases and strides in 16-byte units; a size-1
    dim's stride is never used."""
    from repro_torch.kernels.flash_attention import check_16b

    x = torch.zeros(2, 12, 4, 128, dtype=torch.bfloat16)  # (B, S, N, D)
    check_16b(what, "q", x.transpose(1, 2))  # the model's view: strides (6144, 128, 512)
    check_16b(what, "q", x[:1, :, :1].transpose(1, 2))
    wide = torch.zeros(2, 12, 4, 132, dtype=torch.bfloat16)[..., :128]  # rows of 264 B
    with pytest.raises(ValueError, match="16-byte"):
        check_16b(what, "k", wide.transpose(1, 2))
    with pytest.raises(ValueError, match="16-byte"):
        check_16b(what, "v", torch.zeros(1 + 2 * 4 * 8 * 64, dtype=torch.bfloat16)[1:]
                  .view(2, 4, 8, 64))  # base off by 2 bytes


def _paged_case(rng, B, dtype, NKV=2, G=2, D=32, page=8, NB=3):
    """One pool + per-row page tables as in tests/test_kernels.py (page 0 is
    the trash page): jnp arrays and torch tensors of the same values."""
    P = 1 + B * NB
    qj, qt = _pair(rng, (B, NKV, G, D), dtype)
    kj, kt = _pair(rng, (P, NKV, page, D), dtype)
    vj, vt = _pair(rng, (P, NKV, page, D), dtype)
    tables = (1 + np.arange(B * NB, dtype=np.int32)).reshape(B, NB)
    pos = ((3 + 5 * np.arange(B)) % (NB * page)).astype(np.int32)
    return (qj, kj, vj), (qt, kt, vt), tables, pos


def _paged_check(jax_in, torch_in, tables, pos, dtype, window=0):
    """The port's paged plain version against the JAX oracle and the Pallas
    kernel in interpret mode; returns the port's output."""
    out = ops.decode_attention_paged(*torch_in, torch.from_numpy(tables),
                                     torch.from_numpy(pos), window=window)
    assert out.shape == torch_in[0].shape and out.dtype == torch_in[0].dtype
    tj, pj = jnp.asarray(tables), jnp.asarray(pos)
    _close(out, jref_paged(*jax_in, tj, pj, window=window), dtype)
    _close(out, pallas_paged(*jax_in, tj, pj, window=window, interpret=True), dtype)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_paged_plain_every_ladder_size(B, dtype):
    _paged_check(*_paged_case(np.random.default_rng(B), B, dtype), dtype)


@pytest.mark.parametrize("window", [0, 8])
def test_paged_plain_windowed(window):
    _paged_check(*_paged_case(np.random.default_rng(17), 4, "float32"), "float32",
                 window=window)


@pytest.mark.parametrize("n_real", [1, 3, 5, 7])
def test_paged_plain_masked_rows_inert(n_real):
    """Inactive rows (pos 0, all-trash tables) of a padded 8-row batch do
    not perturb the real rows (bitwise) and are not NaN."""
    jax_in, torch_in, tables, pos = _paged_case(np.random.default_rng(n_real), 8, "float32")
    tables[n_real:] = 0
    pos[n_real:] = 0
    padded = _paged_check(jax_in, torch_in, tables, pos, "float32")
    assert not torch.isnan(padded).any()
    alone = ops.decode_attention_paged(torch_in[0][:n_real], *torch_in[1:],
                                       torch.from_numpy(tables[:n_real]),
                                       torch.from_numpy(pos[:n_real]))
    assert torch.equal(padded[:n_real], alone)


def test_paged_model_layout_matches_jax():
    """The model-layout entry point over (P, page, NKV, HD) pools, G = 5."""
    from repro_torch.models.attention import paged_decode_attention

    rng = np.random.default_rng(23)
    B, NKV, G, D, page, NB = 3, 2, 5, 16, 8, 4
    P = 1 + B * NB
    qj, qt = _pair(rng, (B, 1, NKV * G, D), "float32")
    kj, kt = _pair(rng, (P, page, NKV, D), "float32")
    vj, vt = _pair(rng, (P, page, NKV, D), "float32")
    tables = rng.permutation(np.arange(1, P, dtype=np.int32)).reshape(B, NB)
    pos = np.array([31, 0, 17], np.int32)
    out = paged_decode_attention(qt, kt, vt, torch.from_numpy(tables), torch.from_numpy(pos))
    want = jax.jit(j_paged_model)(qj, kj, vj, jnp.asarray(tables), jnp.asarray(pos))
    _close(out, want, "float32")


def test_paged_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.decode_attention import decode_attention_paged_fwd

    x = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_paged_fwd(x, x, x, torch.zeros(1, 2, dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32))


def test_cpu_dispatch_never_launches_a_kernel():
    ops.reset_launch_counts()
    x = torch.randn(2, 3, 16)
    ops.rms_norm(x, torch.ones(16))
    q = torch.randn(1, 2, 8, 16)
    ops.flash_attention(q, q, q)
    assert ops.launch_counts() == {name: 0 for name in ops.COUNTERS}


def test_launch_counter_is_exact_across_threads():
    """Async dispatch launches from worker threads: no increment may be lost."""
    import sys
    import threading

    from repro_torch.kernels.counters import LaunchCounter

    counter = LaunchCounter("stress")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [counter.add() for _ in range(2000)])
                   for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert counter.count == 16 * 2000
    counter.reset()
    assert counter.count == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rmsnorm import rms_norm_fwd

    x = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        rms_norm_fwd(x, torch.ones(16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_fwd(x, x, x, torch.zeros(1, 8, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Hand-written kernels against the plain versions (an sm_90 card only).
# ---------------------------------------------------------------------------
@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gpu_close(got, want, dtype):
    tol = dict(atol=1e-4, rtol=0) if dtype == torch.float32 else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128, 256), (3, 7, 5120), (2, 5, 16)])
def test_rmsnorm_kernel_matches_plain(sm90, shape, dtype):
    from repro_torch.kernels.rmsnorm import rms_norm_fwd

    dt = getattr(torch, dtype)
    x = torch.randn(shape, device=sm90).to(dt)
    w = torch.randn(shape[-1], device=sm90)
    for offset in (False, True):
        _gpu_close(rms_norm_fwd(x, w, offset=offset), ref.rms_norm_ref(x, w, offset=offset), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FLASH_CASES + [
    (2, 40, 8, 100, 128, True, 0),
    # long, ragged S at D = 128 / 256 and window edges inside a 64-key tile
    (1, 4, 1, 1000, 128, True, 0), (1, 2, 1, 2047, 256, True, 0),
    (1, 2, 1, 2100, 256, True, 0), (1, 4, 1, 1000, 128, True, 100),
    (1, 2, 1, 517, 256, False, 130),
], ids=str)
def test_flash_kernel_matches_plain(sm90, case, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    B, NQ, NKV, S, D, causal, window = case
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, NQ, D, device=sm90).to(dt).transpose(1, 2)
    k = torch.randn(B, S, NKV, D, device=sm90).to(dt).transpose(1, 2)
    v = torch.randn(B, S, NKV, D, device=sm90).to(dt).transpose(1, 2)
    _gpu_close(flash_attention_fwd(q, k, v, causal=causal, window=window),
               ref.flash_attention_ref(q, k, v, causal=causal, window=window), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", DECODE_CASES + [
    (2, 8, 5, 152, 128, 0), (4, 1, 10, 152, 256, 0), (1, 1, 16, 300, 256, 0),
    (2, 1, 16, 64, 64, 8), (1, 2, 8, 7, 128, 0),
], ids=str)
def test_decode_kernel_matches_plain(sm90, case, dtype):
    from repro_torch.kernels.decode_attention import decode_attention_fwd

    B, NKV, G, S, D, window = case
    dt = getattr(torch, dtype)
    q = torch.randn(B, NKV, G, D, device=sm90).to(dt)
    kc = torch.randn(B, S, NKV, D, device=sm90).to(dt).transpose(1, 2)
    vc = torch.randn(B, S, NKV, D, device=sm90).to(dt).transpose(1, 2)
    slot, pos = (torch.from_numpy(a).to(sm90) for a in _ring_slots(B, S))
    _gpu_close(decode_attention_fwd(q, kc, vc, slot, pos, window=window),
               ref.decode_attention_ref(q, kc, vc, slot, pos, window=window), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("pos_value", [9, -1, 3], ids=["first10", "all_masked", "first4"])
def test_decode_kernel_masked_chunks_and_bitwise_stable(sm90, pos_value):
    """Only slots 0..9 filled: chunks of masked keys only, and a row with no
    valid key (the mean of v) under splitting; five calls, one output."""
    from repro_torch.kernels.decode_attention import decode_attention_fwd

    B, NKV, G, S, D = 4, 1, 10, 152, 256
    q = torch.randn(B, NKV, G, D, device=sm90).bfloat16()
    kc = torch.randn(B, NKV, S, D, device=sm90).bfloat16()
    vc = torch.randn(B, NKV, S, D, device=sm90).bfloat16()
    slot = torch.where(torch.arange(S) < 10, torch.arange(S), -1).to(torch.int32)
    slot = slot.expand(B, S).contiguous().to(sm90)
    pos = torch.full((B,), pos_value, dtype=torch.int32, device=sm90)
    got = decode_attention_fwd(q, kc, vc, slot, pos)
    _gpu_close(got, ref.decode_attention_ref(q, kc, vc, slot, pos), torch.bfloat16)
    assert all(torch.equal(got, decode_attention_fwd(q, kc, vc, slot, pos)) for _ in range(4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_paged_kernel_matches_plain(sm90, B, dtype):
    """Kernel-layout pools and the model's transposed (P, page, NKV, D)
    views; ladder sizes, a window, and G = 5 at D = 128."""
    from repro_torch.kernels.decode_attention import decode_attention_paged_fwd

    dt = getattr(torch, dtype)
    for NKV, G, D, window, model_layout in ((2, 2, 32, 0, False), (2, 2, 32, 8, True),
                                            (8, 5, 128, 0, True)):
        NB, page = 3, 8
        P = 1 + B * NB
        q = torch.randn(B, NKV, G, D, device=sm90).to(dt)
        if model_layout:
            kp = torch.randn(P, page, NKV, D, device=sm90).to(dt).transpose(1, 2)
            vp = torch.randn(P, page, NKV, D, device=sm90).to(dt).transpose(1, 2)
        else:
            kp = torch.randn(P, NKV, page, D, device=sm90).to(dt)
            vp = torch.randn(P, NKV, page, D, device=sm90).to(dt)
        tables = torch.randperm(P - 1, device=sm90).add(1).to(torch.int32)[:B * NB]
        tables = tables.reshape(B, NB)
        pos = ((3 + 5 * torch.arange(B, device=sm90)) % (NB * page)).to(torch.int32)
        _gpu_close(decode_attention_paged_fwd(q, kp, vp, tables, pos, window=window),
                   ref.decode_attention_paged_ref(q, kp, vp, tables, pos, window=window), dt)


# ---------------------------------------------------------------------------
# Flash-attention backward: the plain version against the Pallas backward
# (interpret mode, fed the Pallas forward's out and LSE) and jax.grad of the
# JAX oracle, at tests/test_kernels.py's atol 3e-5 in f32; the hand-written
# kernel against the plain version on an sm_90 card.
# ---------------------------------------------------------------------------
BWD_CASES = [
    # (B, NQ, NKV, S, D, block, causal, window): the tests/test_kernels.py
    # cases, plus a ragged S (one Pallas block of the whole sequence).
    (1, 2, 2, 128, 32, 64, True, 0),
    (1, 4, 2, 128, 32, 64, True, 0),  # GQA group sum
    (1, 4, 1, 128, 32, 32, True, 0),  # MQA
    (1, 2, 2, 128, 32, 64, False, 0),  # bidirectional
    (1, 2, 1, 128, 32, 32, True, 48),  # windowed
    (2, 6, 2, 100, 16, 100, True, 0),  # ragged S, G = 3
]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_bwd_plain_matches_jax(case):
    from repro.kernels.flash_attention_bwd import flash_attention_bwd as pallas_bwd

    B, NQ, NKV, S, D, blk, causal, window = case
    rng = np.random.default_rng(S + NQ + window)
    qj, qt = _pair(rng, (B, NQ, S, D), "float32")
    kj, kt = _pair(rng, (B, NKV, S, D), "float32")
    vj, vt = _pair(rng, (B, NKV, S, D), "float32")
    doj, dot = _pair(rng, (B, NQ, S, D), "float32")
    outj, lsej = pallas_flash(qj, kj, vj, causal=causal, window=window, block_q=blk,
                              block_k=blk, interpret=True, return_lse=True)
    want = pallas_bwd(qj, kj, vj, outj, doj, lsej, causal=causal, window=window,
                      block_q=blk, block_k=blk, interpret=True)
    got = ref.flash_attention_bwd_ref(
        qt, kt, vt, torch.from_numpy(np.array(outj)), dot,
        torch.from_numpy(np.array(lsej)), causal=causal, window=window)

    def loss(q, k, v):
        return jnp.sum(jref.flash_attention_ref(q, k, v, causal=causal, window=window) * doj)

    grads = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    for g, w, oracle in zip(got, want, grads):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(oracle), atol=3e-5, rtol=0)


def test_bwd_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    x = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(x, x, x, x, x, torch.zeros(1, 2, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", BWD_CASES + [(1, 8, 1, 200, 256, 0, True, 0),
                                              (2, 10, 2, 130, 128, 0, False, 40),
                                              (1, 10, 1, 200, 256, 0, True, 64)], ids=str)
def test_flash_bwd_kernel_matches_plain(sm90, case, dtype):
    """Model-layout views, D 16..256, G up to 10 (MQA), ragged S, windowed
    and bidirectional; the kernel's LSE feeds both."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    B, NQ, NKV, S, D, _, causal, window = case
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, NQ, D, device=sm90).to(dt).transpose(1, 2)
    k = torch.randn(B, S, NKV, D, device=sm90).to(dt).transpose(1, 2)
    v = torch.randn(B, S, NKV, D, device=sm90).to(dt).transpose(1, 2)
    dout = torch.randn(B, S, NQ, D, device=sm90).to(dt).transpose(1, 2)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dt
        _gpu_close(g, w, dt)


# ---------------------------------------------------------------------------
# RG-LRU scan: the plain version against the JAX oracle (an associative
# scan) and the Pallas kernel in interpret mode, at tests/test_kernels.py's
# shapes plus a ragged one; its gradient (the autograd Function's CPU path)
# against jax.grad of the oracle; the hand-written kernel and its backward
# against the plain versions on an sm_90 card.  Tolerances: f32 atol 2e-5
# (the associative scan sums in another order), bf16 atol 2e-2 (one bf16
# rounding of the f32 result).
# ---------------------------------------------------------------------------
RGLRU_CASES = [
    # (B, S, W, block_s, block_w): tests/test_kernels.py's, then ragged S
    # and W (one Pallas block each way)
    (2, 256, 128, 64, 64),
    (1, 512, 256, 128, 256),
    (3, 128, 64, 128, 64),
    (2, 300, 250, 300, 250),
]


def _rglru_inputs(rng, B, S, W, dtype):
    """Decays in (0, 1), small inputs and a non-zero h0 (the RG-LRU regime):
    jnp arrays and torch tensors of the same values."""
    a = 1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal((B, S, W)))).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, S, W))).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((B, W))).astype(np.float32)
    aj, bj = jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype)
    at, bt = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
              for x in (aj, bj))
    return (aj, bj, jnp.asarray(h0)), (at, bt, torch.from_numpy(h0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_rglru_plain_matches_jax(case, dtype):
    B, S, W, bs, bw = case
    jax_in, torch_in = _rglru_inputs(np.random.default_rng(S + W), B, S, W, dtype)
    out = ops.rglru_scan(*torch_in)
    assert out.shape == (B, S, W) and out.dtype == torch_in[0].dtype
    _close(out, jref_rglru(*jax_in), dtype)
    _close(out, jpallas_rglru(*jax_in, block_s=bs, block_w=bw, interpret=True), dtype)


def test_rglru_plain_carries_state_across_blocks():
    """A Pallas block boundary does not reset the recurrence; nor does the
    port's sequential walk."""
    B, S, W = 1, 256, 64
    a = np.full((B, S, W), 0.99, np.float32)
    b = np.full((B, S, W), 0.01, np.float32)
    h0 = np.zeros((B, W), np.float32)
    out = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(h0))
    want = jpallas_rglru(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), block_s=64,
                         block_w=64, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref_rglru(a, b, h0)), rtol=1e-5,
                               atol=1e-5)
    assert float(out[0, -1, 0]) > float(out[0, 0, 0])


@pytest.mark.parametrize("shape", [(2, 37, 24), (1, 64, 16), (3, 1, 8)], ids=str)
def test_rglru_grads_match_jax(shape):
    """``ops.RGLRUScan``'s gradients (the adjoint recurrence) against
    jax.grad of the JAX oracle, in a, b and h0."""
    B, S, W = shape
    rng = np.random.default_rng(S)
    (aj, bj, hj), (at, bt, ht) = _rglru_inputs(rng, B, S, W, "float32")
    dh = rng.standard_normal((B, S, W)).astype(np.float32)

    def jloss(a, b, h0):
        return jnp.sum(jref.rglru_scan_ref(a, b, h0) * dh)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(aj, bj, hj)
    leaves = [t.requires_grad_(True) for t in (at, bt, ht)]
    out = ops.rglru_scan(*leaves)
    assert type(out.grad_fn).__name__.startswith("RGLRUScan")
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dh))
    for g, w, like in zip(got, want, leaves):
        assert g.shape == like.shape and g.dtype == like.dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0)


def test_rglru_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd

    a = torch.rand(1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_fwd(a, a, torch.zeros(1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_bwd(a, a, torch.zeros(1, 16), a)
    ops.reset_launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (a, a, torch.zeros(1, 16))]
    ops.rglru_scan(*leaves).sum().backward()
    counts = ops.launch_counts()
    assert counts["rglru_scan_fwd"] == counts["rglru_scan_bwd"] == 0


# S across the planner's chunk and cluster boundaries: one chunk up to 128
# steps, then chunks of 16 / 32 / 64 / 128 with a cluster of 8 and one step
# more (a second group of one chunk), and the train shape.
RGLRU_CUDA_CASES = [(4, 128, 2560, 0, 0), (1, 5, 7, 0, 0), (2, 1, 130, 0, 0),
                    (2, 127, 64, 0, 0), (2, 129, 40, 0, 0), (1, 257, 160, 0, 0),
                    (1, 513, 96, 0, 0), (1, 1025, 64, 0, 0), (2, 2048, 2560, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_CASES + RGLRU_CUDA_CASES, ids=str)
def test_rglru_kernel_matches_plain(sm90, case, dtype):
    """The scan kernel, then its backward (the kernel run in reverse),
    against the plain versions; bf16 also with a bf16 h0.  Two launches on
    the same inputs are bitwise equal (the carry is folded in a fixed
    order), and one chunk in f32 is the sequential walk bit for bit."""
    from repro_torch.kernels.rglru_scan import launch_plan, rglru_scan_bwd, rglru_scan_fwd

    B, S, W, _, _ = case
    dt = getattr(torch, dtype)
    a = torch.sigmoid(2.0 * torch.randn(B, S, W, device=sm90)).to(dt)
    b = (0.1 * torch.randn(B, S, W, device=sm90)).to(dt)
    for h0_dtype in (torch.float32,) if dt == torch.float32 else (torch.float32, dt):
        h0 = (0.1 * torch.randn(B, W, device=sm90)).to(h0_dtype)
        h = rglru_scan_fwd(a, b, h0)
        assert h.dtype == dt
        want = ref.rglru_scan_ref(a, b, h0)
        _gpu_close(h, want, dt)
        assert torch.equal(h, rglru_scan_fwd(a, b, h0))
        if dt == torch.float32 and S <= launch_plan(a).chunk:
            assert torch.equal(h, want)
        dh = torch.randn(B, S, W, device=sm90).to(dt)
        got = rglru_scan_bwd(a, h, h0, dh)
        for g, w in zip(got, ref.rglru_scan_bwd_ref(a, h, h0, dh)):
            assert g.shape == w.shape and g.dtype == w.dtype
            _gpu_close(g, w, dt)
        assert all(torch.equal(x, y) for x, y in zip(got, rglru_scan_bwd(a, h, h0, dh)))
