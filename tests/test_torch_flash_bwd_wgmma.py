"""The flash-attention backward's tensor-core route (``bwd_route`` "wgmma").

On the CPU: the plain model of the kernels' arithmetic
(``ref.flash_attention_bwd_tiled_ref``: the 64 x 64 tile walk with band
skipping, per-group f32 partials of dk / dv merged in group order, ds
rounded and p split into a rounded part and its rounded remainder, as the
kernel does) against the Pallas backward in interpret
mode (fed the Pallas forward's out and LSE) and ``jax.grad`` of
``repro.kernels.ref.flash_attention_ref``, at the atol 3e-5 of
``tests/test_torch_kernels.py::test_flash_bwd_plain_matches_jax`` in f32;
in bf16 against ``ref.flash_attention_bwd_ref`` at ``chip_smoke.py``'s bf16
tolerance (atol 2e-2, rtol 1e-2: one bf16 rounding of p and ds).  The
pure-Python planner, block layout and route.

On an sm_90 card (``cuda``-marked, skipped elsewhere): the kernel against
the plain version, two launches bitwise equal, HGMMA in its SASS.

Inputs come from numpy with a fixed seed and go to both packages.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_fwd as pallas_flash  # noqa: E402
from repro.kernels.flash_attention_bwd import flash_attention_bwd as pallas_bwd  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as bk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SM_COUNT = 132  # the H100 SXM's
BF16_TOL = dict(atol=2e-2, rtol=1e-2)

# The JAX oracles, compiled once per shape instead of dispatched op by op.
_STATIC = ("causal", "window", "block_q", "block_k", "interpret")
jpallas_flash = jax.jit(pallas_flash, static_argnames=_STATIC + ("return_lse",))
jpallas_bwd = jax.jit(pallas_bwd, static_argnames=_STATIC)


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def jgrad_ref(q, k, v, dout, *, causal, window):
    def loss(q_, k_, v_):
        return jnp.sum(jref.flash_attention_ref(q_, k_, v_, causal=causal, window=window) * dout)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

# (B, NQ, NKV, S, D, causal, window): S 1 / 63 / 64 / 65 / 200, G 1 / 3 / 8
# / 10, causal, bidirectional and windowed with the window's edge inside a
# 64-key tile; D = 256 only at S <= 128; then D = 80 / 96 (hubert-xlarge's
# and phi3-mini's head dims, 16 / 32-wide feature boxes in the kernel):
# ragged S, G 3 / 5 with ragged groups, bidirectional, a window cut mid-tile.
MODEL_CASES = [
    (1, 2, 2, 1, 16, True, 0),
    (1, 3, 1, 63, 16, True, 0),
    (1, 8, 1, 64, 16, True, 0),
    (1, 10, 1, 65, 16, True, 0),
    (2, 6, 2, 200, 16, True, 0),
    (1, 3, 1, 200, 32, False, 0),
    (1, 8, 2, 200, 16, True, 37),
    (1, 10, 1, 130, 16, False, 70),
    (1, 2, 1, 128, 256, True, 0),
    (1, 2, 2, 65, 80, False, 0),
    (1, 5, 1, 130, 96, True, 0),
    (1, 3, 1, 63, 96, True, 0),
    (2, 6, 2, 200, 80, True, 37),
    (1, 5, 1, 150, 80, False, 70),
]


def _arrays(case, seed):
    B, NQ, NKV, S, D, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, NQ, S, D), (B, NKV, S, D), (B, NKV, S, D), (B, NQ, S, D))]


@functools.lru_cache(maxsize=None)
def _jax_oracles(case):
    """(q, k, v, dout, Pallas out, Pallas LSE, Pallas grads, jax.grad grads)
    as numpy, f32; one Pallas block of S where 64 does not divide S."""
    B, NQ, NKV, S, D, causal, window = case
    q, k, v, do = _arrays(case, seed=S + NQ + D + window)
    blk = 64 if S % 64 == 0 else S
    qj, kj, vj, doj = (jnp.asarray(x) for x in (q, k, v, do))
    outj, lsej = jpallas_flash(qj, kj, vj, causal=causal, window=window, block_q=blk,
                               block_k=blk, interpret=True, return_lse=True)
    pallas = jpallas_bwd(qj, kj, vj, outj, doj, lsej, causal=causal, window=window,
                         block_q=blk, block_k=blk, interpret=True)
    grads = jgrad_ref(qj, kj, vj, doj, causal=causal, window=window)
    return (q, k, v, do, np.array(outj), np.array(lsej),
            [np.array(g) for g in pallas], [np.array(g) for g in grads])


def _model_params():
    for case in MODEL_CASES:
        G = case[1] // case[2]
        for hpg in range(1, G + 1):
            yield pytest.param(case, hpg, id=f"{case}-hpg{hpg}")


@pytest.mark.parametrize("case,hpg", list(_model_params()))
def test_tiled_model_matches_pallas_and_jax_grad(case, hpg):
    """Every heads-per-group split 1..G (a ragged last group where hpg does
    not divide G) gives the Pallas backward's and jax.grad's gradients."""
    _, _, _, S, _, causal, window = case
    q, k, v, do, out, lse, pallas, grads = _jax_oracles(case)
    got = ref.flash_attention_bwd_tiled_ref(
        *(torch.from_numpy(x) for x in (q, k, v, out, do, lse)), causal=causal, window=window,
        heads_per_group=hpg)
    for part, g, w, oracle in zip(("dq", "dk", "dv"), got, pallas, grads):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=3e-5, rtol=0, err_msg=part)
        np.testing.assert_allclose(g.numpy(), oracle, atol=3e-5, rtol=0, err_msg=part)


@pytest.mark.parametrize("blocks", [(32, 16), (16, 64), (128, 64)], ids=str)
@pytest.mark.parametrize("case", [MODEL_CASES[4], MODEL_CASES[6], MODEL_CASES[7]], ids=str)
def test_tiled_model_other_tile_shapes(case, blocks):
    """The walk's skipping and ragged last tiles do not depend on 64 x 64."""
    _, NQ, NKV, _, _, causal, window = case
    q, k, v, do, out, lse, pallas, _ = _jax_oracles(case)
    got = ref.flash_attention_bwd_tiled_ref(
        *(torch.from_numpy(x) for x in (q, k, v, out, do, lse)), causal=causal, window=window,
        block_q=blocks[0], block_k=blocks[1], heads_per_group=max(1, NQ // NKV // 2))
    for g, w in zip(got, pallas):
        np.testing.assert_allclose(g.numpy(), w, atol=3e-5, rtol=0)


@pytest.mark.parametrize("case", [(1, 8, 1, 200, 64, True, 0), (2, 10, 2, 130, 128, False, 40),
                                  (1, 10, 1, 128, 256, True, 64), (1, 4, 4, 65, 64, True, 0),
                                  (1, 16, 16, 130, 80, False, 0), (1, 4, 4, 200, 96, True, 0),
                                  (1, 10, 2, 150, 96, True, 65)],
                         ids=str)
def test_tiled_model_bf16_matches_plain(case):
    """In bf16 the model rounds ds to bf16 before its products and takes p
    as two bf16 parts, as the kernel does; the plain version keeps them f32."""
    B, NQ, NKV, S, D, causal, window = case
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _arrays(case, seed=S + D + window))
    out, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal, window=window)
    _, hpg, _ = bk.bwd_plan(B, NQ, NKV, S, D, SM_COUNT)
    got = ref.flash_attention_bwd_tiled_ref(q, k, v, out, do, lse, causal=causal,
                                            window=window, heads_per_group=hpg)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **BF16_TOL)


# ---------------------------------------------------------------------------
# Pure-Python: the planner, the block layout, the route.
# ---------------------------------------------------------------------------
PLAN_SHAPES = [
    # (B, NQ, NKV, S, D)
    (2, 8, 1, 2048, 256),  # gemma-2b train
    (2, 10, 1, 2048, 256),  # recurrentgemma-2b train
    (1, 32, 32, 2048, 128),
    (4, 40, 8, 128, 128),
    (1, 10, 1, 65, 64),
    (3, 6, 2, 1, 256),
    (1, 16, 1, 4096, 64),
    (2, 16, 16, 2048, 80),  # hubert-xlarge train
    (2, 32, 32, 2048, 96),  # phi3-mini-3.8b train
    (1, 10, 2, 2100, 80),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_each_key_tile_and_head_once(shape):
    """Every (key tile, q head) pair in exactly one block; each group a run
    of consecutive q heads of one kv head; at most one group per q head."""
    B, NQ, NKV, S, D = shape
    rows, hpg, n_groups = bk.bwd_plan(B, NQ, NKV, S, D, SM_COUNT)
    G = NQ // NKV
    assert rows == bk.wgmma_rows(D) and 1 <= hpg <= G and 1 <= n_groups <= G
    seen = {}
    for kt in range(-(-S // rows)):
        for kvh in range(NKV):
            for g in range(n_groups):
                heads = list(range(kvh * G + g * hpg, kvh * G + min(G, (g + 1) * hpg)))
                assert heads and heads == list(range(heads[0], heads[-1] + 1))
                assert all(h // G == kvh for h in heads)
                for h in heads:
                    seen[(kt, h)] = seen.get((kt, h), 0) + 1
    assert seen == {(kt, h): 1 for kt in range(-(-S // rows)) for h in range(NQ)}


@pytest.mark.parametrize("shape", PLAN_SHAPES[:2], ids=str)
def test_plan_fills_one_wave_at_the_train_shapes(shape):
    """gemma-2b and recurrentgemma-2b: one kv head, so one group per kv head
    gives B * S / 64 = 64 blocks; the plan takes the fewest groups past 132."""
    B, NQ, NKV, S, D = shape
    rows, hpg, n_groups = bk.bwd_plan(B, NQ, NKV, S, D, SM_COUNT)
    blocks = B * NKV * (S // rows) * n_groups
    assert blocks >= SM_COUNT
    assert B * NKV * (S // rows) * (n_groups - 1) < SM_COUNT or hpg == 1
    assert (rows, hpg, n_groups) == ((64, 3, 3) if NQ == 8 else (64, 4, 3))


def test_plan_takes_one_group_when_the_grid_is_full():
    """Enough key tiles: no partials, dk / dv written directly."""
    assert bk.bwd_plan(1, 32, 32, 2048, 128, SM_COUNT)[1:] == (1, 1)
    assert bk.bwd_plan(4, 64, 8, 4096, 64, SM_COUNT)[1:] == (8, 1)


@pytest.mark.parametrize("bad", [
    dict(D=16), dict(D=48), dict(D=32), dict(NQ=6, NKV=4), dict(S=0), dict(B=0),
    dict(sm_count=0), dict(NKV=0),
], ids=str)
def test_plan_refuses_what_the_kernel_cannot_take(bad):
    args = dict(B=2, NQ=8, NKV=1, S=2048, D=256, sm_count=SM_COUNT)
    args.update(bad)
    with pytest.raises((ValueError, ZeroDivisionError)):
        bk.bwd_plan(**args)


def test_layout_refuses_other_head_dims():
    assert [bk.wgmma_rows(D) for D in (64, 80, 96, 128, 256)] == [128, 128, 128, 64, 64]
    for D in (16, 32, 48, 512):
        with pytest.raises(ValueError):
            bk.wgmma_rows(D)


@pytest.mark.parametrize("dtype,D,route", [
    ("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"), ("bfloat16", 256, "wgmma"),
    ("float16", 64, "wgmma"), ("float16", 128, "wgmma"), ("float16", 256, "wgmma"),
    ("bfloat16", 16, "wmma"), ("bfloat16", 32, "wmma"), ("bfloat16", 80, "wgmma"),
    ("bfloat16", 96, "wgmma"), ("float16", 96, "wgmma"), ("float16", 80, "wgmma"),
    ("float16", 32, "wmma"),
    ("float32", 64, "cuda_core"), ("float32", 96, "cuda_core"), ("float32", 256, "cuda_core"),
    ("float32", 80, "cuda_core"),
])
def test_bwd_route_by_dtype_and_head_dim(dtype, D, route):
    assert bk.bwd_route(getattr(torch, dtype), D) == route


# ---------------------------------------------------------------------------
# The kernel on an sm_90 card.
# ---------------------------------------------------------------------------
@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 card")
    return torch.device("cuda")


KERNEL_CASES = [
    # (B, NQ, NKV, S, D, causal, window): ragged S, G 8 / 10 with ragged
    # head groups, windows cut mid-tile, bidirectional
    (1, 8, 1, 63, 64, True, 0), (1, 10, 1, 65, 128, True, 0), (2, 8, 1, 1000, 256, True, 0),
    (1, 10, 1, 2047, 256, True, 2048), (1, 4, 2, 2100, 128, False, 0),
    (1, 10, 2, 517, 64, True, 130), (2, 4, 4, 130, 256, False, 40), (1, 2, 1, 1, 128, True, 0),
    # D = 80 / 96: 16 / 32-wide feature boxes, 128 fixed rows a block
    (1, 8, 1, 63, 80, True, 0), (1, 10, 1, 65, 96, True, 0), (2, 16, 16, 1000, 80, False, 0),
    (1, 10, 2, 2100, 80, True, 100), (1, 8, 8, 2047, 96, True, 0), (2, 4, 4, 517, 96, False, 65),
]


def _card_inputs(case, dt, device):
    B, NQ, NKV, S, D, _, _ = case
    gen = torch.Generator().manual_seed(S + D)
    return [torch.randn((B, S, n, D), generator=gen).to(device=device, dtype=dt).transpose(1, 2)
            for n in (NQ, NKV, NKV, NQ)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
def test_wgmma_kernel_matches_plain_and_is_bitwise_stable(sm90, case, dtype):
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    _, _, _, _, D, causal, window = case
    dt = getattr(torch, dtype)
    assert bk.bwd_route(dt, D) == "wgmma"
    q, k, v, do = _card_inputs(case, dt, sm90)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    got = bk.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    again = bk.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal, window=window)
    for g, g2, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == dt
        torch.testing.assert_close(g.float(), w.float(), **BF16_TOL)
        assert torch.equal(g, g2)


@pytest.mark.cuda
def test_wgmma_kernels_have_hgmma(sm90):
    from repro_torch.kernels import cuda_build

    cuda_build.build(["flash_attention_bwd"])
    sass = cuda_build.sass("flash_attention_bwd")
    if sass is None:
        pytest.skip("no cuobjdump in the toolkit")
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split(":")[-1].strip() if "flash_bwd_wgmma_kernel" in line else None
            if func:
                counts[func] = 0
        elif func and "HGMMA" in line:
            counts[func] += 1
    assert len(counts) == 10 and all(n > 0 for n in counts.values()), counts
