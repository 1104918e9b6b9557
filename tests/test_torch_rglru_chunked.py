"""The RG-LRU scan kernel's chunked arithmetic and its planner, on the CPU.

* ``ref.rglru_scan_chunked_ref`` models ``csrc/rglru_scan.cu``: S cut into
  chunks, each folded into an affine summary, the summaries folded onto
  the carry in chunk order across a cluster of blocks, each chunk re-walked
  from its carry; in reverse, the adjoint with its epilogue (da, db, dh0).
  It is held against the JAX oracle ``repro.kernels.ref.rglru_scan_ref``
  (an associative scan) and the Pallas kernel in interpret mode, and the
  reverse mode against ``jax.grad`` of the oracle.  Tolerances: f32 atol
  1e-4, rtol 0 (the chip's tolerance for the kernel: the carry into each
  chunk rounds differently from a sequential walk); bf16 atol 2e-2 (one
  bf16 rounding of the f32 result, ``test_rglru_plain_matches_jax``'s).
  With S <= chunk the f32 result is bit-equal to the sequential
  ``ref.rglru_scan_ref`` / ``rglru_scan_bwd_ref``.
* The planner (``rglru_scan.scan_plan``): its blocks cover every (row,
  channel, step) exactly once, forward and reverse; the cluster size is
  min(8, n_chunks); it refuses B > 65535, an empty shape and a shape that
  fits no plan.  The load route (``load_route``) follows the operands'
  alignment.

Decays: the RG-LRU's own regime (``models/rglru.py``: ``b = sqrt(1 - a^2)
* x``, so h stays O(1)) with decays near 0, near 1 and spread between.
Inputs come from numpy with a fixed seed and go to both packages.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_fwd as pallas_rglru  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    CHUNKS,
    MAX_CLUSTER,
    SMEM_LIMIT,
    load_route,
    make_plan,
    scan_plan,
    smem_bytes,
)

ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
SEQS = [1, 5, 31, 32, 33, 300]
WIDTH = {1: 7, 5: 130, 31: 7, 32: 64, 33: 130, 300: 250}  # ragged W

jref_rglru = jax.jit(jref.rglru_scan_ref)
jpallas_rglru = jax.jit(pallas_rglru, static_argnames=("block_s", "block_w", "interpret"))


def _decays(rng, shape, regime):
    if regime == "near0":
        return rng.uniform(0.0, 0.05, shape)
    if regime == "near1":
        return 1.0 - rng.uniform(0.0, 1e-3, shape)
    return 1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal(shape)))


@functools.lru_cache(maxsize=None)
def _case(B, S, W, dtype, regime):
    """(numpy f32 a, b, h0 after a round trip through ``dtype``, the JAX
    oracle's h, the Pallas kernel's h), cached across chunk sizes."""
    rng = np.random.default_rng(S * 1000 + W)
    a = _decays(rng, (B, S, W), regime).astype(np.float32)
    b = (np.sqrt(1.0 - a.astype(np.float64) ** 2) * rng.standard_normal((B, S, W))
         ).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    aj, bj = jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype)
    hj = jnp.asarray(h0)
    want = np.asarray(jnp.asarray(jref_rglru(aj, bj, hj), jnp.float32))
    pallas = np.asarray(jnp.asarray(
        jpallas_rglru(aj, bj, hj, block_s=S, block_w=W, interpret=True), jnp.float32))
    return (np.array(aj.astype(jnp.float32)), np.array(bj.astype(jnp.float32)), h0,
            want, pallas)


def _torch(x, dtype):
    return torch.from_numpy(np.array(x)).to(getattr(torch, dtype))


@pytest.mark.parametrize("regime", ["spread", "near0", "near1"])
@pytest.mark.parametrize("chunk", ["1", "7", "32", "S", "S+1"])
@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_matches_jax(dtype, S, chunk, regime):
    """The kernel's arithmetic against the associative-scan oracle and the
    Pallas kernel (interpret mode), cluster of 8."""
    W = WIDTH[S]
    L = {"S": S, "S+1": S + 1}.get(chunk) or int(chunk)
    a, b, h0, want, pallas = _case(2, S, W, dtype, regime)
    out = ref.rglru_scan_chunked_ref(_torch(a, dtype), _torch(b, dtype), torch.from_numpy(h0),
                                     chunk=L, cluster=MAX_CLUSTER)
    assert out.shape == (2, S, W) and out.dtype == getattr(torch, dtype)
    for oracle in (want, pallas):
        np.testing.assert_allclose(out.float().numpy(), oracle, atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("cluster", [1, 3, 8])
@pytest.mark.parametrize("chunk", [1, 7, 32])
def test_chunked_cluster_sizes(chunk, cluster):
    """Any cluster size: groups of ``cluster`` chunks, each group's carry
    the fold of the one before (S = 300 is 300 / 43 / 10 chunks)."""
    a, b, h0, want, _ = _case(2, 300, 250, "float32", "near1")
    out = ref.rglru_scan_chunked_ref(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.from_numpy(h0), chunk=chunk, cluster=cluster)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("regime", ["spread", "near1"])
@pytest.mark.parametrize("S", SEQS)
def test_one_chunk_is_bitwise_sequential(S, regime):
    """S <= chunk: no carry is folded, so the f32 result is the plain
    sequential walk bit for bit, forward and reverse."""
    a, b, h0, _, _ = _case(2, S, WIDTH[S], "float32", regime)
    at, bt, ht = (torch.from_numpy(x) for x in (a, b, h0))
    h = ref.rglru_scan_ref(at, bt, ht)
    dh = torch.from_numpy(np.random.default_rng(S).standard_normal(a.shape).astype(np.float32))
    want = ref.rglru_scan_bwd_ref(at, h, ht, dh)
    for chunk in (S, S + 1, 2 * S + 7):
        assert torch.equal(ref.rglru_scan_chunked_ref(at, bt, ht, chunk=chunk, cluster=8), h)
        got = ref.rglru_scan_chunked_ref(at, dh, ht, chunk=chunk, cluster=8, reverse=True, h=h)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("regime", ["spread", "near0", "near1"])
@pytest.mark.parametrize("chunk,cluster", [(1, 8), (7, 8), (7, 3), (32, 8), (64, 1)])
@pytest.mark.parametrize("shape", [(2, 37, 24), (1, 300, 130), (3, 1, 8)], ids=str)
def test_reverse_matches_jax_grad(shape, chunk, cluster, regime):
    """The reverse mode's (da, db, dh0) against jax.grad of the JAX oracle,
    in a, b and h0, f32."""
    B, S, W = shape
    rng = np.random.default_rng(S + W)
    a = _decays(rng, shape, regime).astype(np.float32)
    b = (np.sqrt(1.0 - a.astype(np.float64) ** 2) * rng.standard_normal(shape)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)

    def jloss(a, b, h0):
        return jnp.sum(jref.rglru_scan_ref(a, b, h0) * dh)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(a), jnp.asarray(b),
                                                        jnp.asarray(h0))
    at, bt, ht = (torch.from_numpy(x) for x in (a, b, h0))
    h = ref.rglru_scan_chunked_ref(at, bt, ht, chunk=chunk, cluster=cluster)
    got = ref.rglru_scan_chunked_ref(at, torch.from_numpy(dh), ht, chunk=chunk, cluster=cluster,
                                     reverse=True, h=h)
    for g, w, like in zip(got, want, (at, at, ht)):
        assert g.shape == like.shape and g.dtype == like.dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_reverse_bf16_dtypes():
    """bf16 a with a bf16 h0: da and db in a's dtype, dh0 in h0's, within
    one bf16 rounding of the f32 adjoint."""
    rng = np.random.default_rng(3)
    a = _decays(rng, (2, 70, 40), "spread").astype(np.float32)
    dh = rng.standard_normal((2, 70, 40)).astype(np.float32)
    h0 = rng.standard_normal((2, 40)).astype(np.float32)
    ab, hb = torch.from_numpy(a).bfloat16(), torch.from_numpy(h0).bfloat16()
    h = ref.rglru_scan_ref(ab, ab, hb)
    got = ref.rglru_scan_chunked_ref(ab, torch.from_numpy(dh).bfloat16(), hb, chunk=8,
                                     cluster=8, reverse=True, h=h)
    want = ref.rglru_scan_bwd_ref(ab, h, hb, torch.from_numpy(dh).bfloat16())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), atol=2e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# The planner.
# ---------------------------------------------------------------------------
def block_span(plan, S, W, tile, rank, group, reverse):
    """``(channels, steps)`` that block ``rank`` of channel tile ``tile``
    writes in loop ``group``, by the kernel's index arithmetic
    (``csrc/rglru_scan.cu``: chunk ``group * cluster + rank``, walked from
    S - 1 down in reverse): ``range``s, the steps in walk order, empty past
    the last chunk."""
    channels = range(tile * plan.tile_w, min(W, (tile + 1) * plan.tile_w))
    c = group * plan.cluster + rank
    if c >= plan.n_chunks:
        return channels, range(0)
    lo, hi = c * plan.chunk, min(S, (c + 1) * plan.chunk)
    return channels, (range(S - 1 - lo, S - 1 - hi, -1) if reverse else range(lo, hi))


def _plenty(plan):
    return 10**6


PLAN_SHAPES = [(1, 1, 7), (2, 5, 130), (3, 63, 64), (2, 64, 33), (1, 65, 2500), (4, 128, 2560),
               (2, 300, 250), (2, 2048, 2560), (1, 8193, 64), (1, 65536, 64)]


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_each_element_once(shape, reverse):
    B, S, W = shape
    plan = scan_plan(B, S, W, 4, reverse, _plenty)
    assert plan.cluster == min(MAX_CLUSTER, plan.n_chunks)
    assert plan.n_chunks == -(-S // plan.chunk) and plan.chunk in CHUNKS
    assert plan.groups * plan.cluster >= plan.n_chunks > (plan.groups - 1) * plan.cluster
    assert plan.stages == (2 if plan.groups > 1 else 1)
    assert plan.smem == smem_bytes(4, reverse, plan.chunk, plan.tile_w, plan.stages) <= SMEM_LIMIT
    assert plan.blocks == plan.cluster * plan.n_tiles * B
    seen = np.zeros((S, W), np.int32)
    for tile in range(plan.n_tiles):
        for group in range(plan.groups):
            for rank in range(plan.cluster):
                channels, steps = block_span(plan, S, W, tile, rank, group, reverse)
                assert all(0 <= t < S for t in steps)
                if reverse:
                    assert list(steps) == sorted(steps, reverse=True)
                if len(steps):
                    lo, hi = min(steps), max(steps) + 1
                    seen[lo:hi, channels.start:channels.stop] += 1
    assert (seen == 1).all()  # the same for each of the B rows (grid y)


def test_plan_rule():
    # S <= 128: one chunk (the shortest of CHUNKS >= S), a cluster of one,
    # 32 channels a block
    assert [scan_plan(4, S, 2560, 4, False, _plenty)[:3] for S in (1, 8, 9, 33, 64, 100, 128)] \
        == [(8, 32, 1), (8, 32, 1), (16, 32, 1), (64, 32, 1), (64, 32, 1), (128, 32, 1),
            (128, 32, 1)]
    p = scan_plan(4, 128, 2560, 4, True, _plenty)
    assert (p.chunk, p.cluster, p.groups, p.stages, p.blocks) == (128, 1, 1, 1, 320)
    # one step past: chunks of 16, a full cluster and a second group of one
    p = scan_plan(4, 129, 2560, 4, False, _plenty)
    assert (p.chunk, p.tile_w, p.cluster, p.n_chunks, p.groups, p.stages) == \
        (16, 128, 8, 9, 2, 2)
    assert scan_plan(1, 129, 40, 4, False, _plenty).tile_w == 64

    # Occupancy by shared memory: the longest chunk whose clusters all fit.
    def by_smem(plan):
        return (132 * (SMEM_LIMIT // plan.smem)) // plan.cluster

    for reverse in (False, True):
        p = scan_plan(2, 2048, 2560, 4, reverse, by_smem)
        assert p.cluster == 8 and by_smem(p) >= 2 * p.n_tiles
        for L in CHUNKS:
            if L > p.chunk:
                q = make_plan(2, 2048, 2560, 4, reverse, L, 128)
                assert q.smem > SMEM_LIMIT or by_smem(q) < 2 * p.n_tiles
    # none resident for all: the shortest chunk that fits at all
    p = scan_plan(64, 2048, 2560, 4, True, lambda plan: 1)
    assert p.chunk == CHUNKS[-1]


@pytest.mark.parametrize("shape", [(0, 5, 7), (2, 0, 7), (2, 5, 0)], ids=str)
def test_plan_refuses_empty(shape):
    with pytest.raises(ValueError, match="empty"):
        scan_plan(*shape, 4, False, _plenty)


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="65535"):
        scan_plan(65536, 8, 64, 4, False, _plenty)
    with pytest.raises(ValueError, match="no plan fits"):
        scan_plan(2, 2048, 2560, 4, True, lambda plan: 0)


def test_load_route_follows_alignment():
    x = torch.zeros(2, 40, 256)
    assert load_route(x, x) == "tma"
    assert load_route(torch.zeros(2, 40, 256, dtype=torch.bfloat16)) == "tma"
    # steps padded to a 16-byte multiple: still TMA; a sliced channel dim
    # whose start is not 16-byte aligned, or 7 f32 channels: per-thread loads
    assert load_route(torch.zeros(2, 40, 260)[..., :256]) == "tma"
    assert load_route(torch.zeros(2, 40, 260)[..., 1:257]) == "ldg"
    assert load_route(torch.zeros(2, 40, 7)) == "ldg"
    assert load_route(x, torch.zeros(2, 41, 7)[:, 1:]) == "ldg"
    # a batch dim broadcast by stride 0 overlaps rows: per-thread loads
    assert load_route(torch.zeros(1, 40, 256).expand(3, 40, 256)) == "ldg"
    # the stride of a size-1 dim is not looked at
    assert load_route(torch.zeros(1, 40, 256)) == load_route(torch.zeros(3, 1, 256)) == "tma"
