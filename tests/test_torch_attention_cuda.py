"""The four attention kernels at head dims 80 and 96, and the split decode
kernels at long spans and rings, against their plain versions on an sm_90
card (every test here is ``cuda``-marked and skips elsewhere).

No JAX here: the oracles are the plain versions in
``repro_torch.kernels.ref``, so these run on a card whose machine has only
PyTorch:  ``python -m pytest -q -m cuda tests/test_torch_attention_cuda.py``.
Tolerances as in ``tests/test_torch_kernels.py``: f32 atol 1e-4 (summation
order), bf16 / f16 atol 2e-2 + rtol 1e-2 (one rounding step).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda

DTYPES = ["float32", "bfloat16", "float16"]


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an sm_90 card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _rn(gen, shape, dtype):
    return torch.randn(shape, generator=gen).to("cuda", getattr(torch, dtype))


def _close(got, want, dtype):
    tol = dict(atol=1e-4, rtol=0) if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _ring(B, S):
    pos = torch.full((B,), S + S // 2, dtype=torch.int32)
    slot = (pos[:, None] - S + 1) + (torch.arange(S) + S // 2) % S
    return slot.to(torch.int32).cuda(), pos.cuda()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("case", [(2, 4, 2, 256, True, 0), (1, 4, 4, 300, True, 64),
                                  (1, 2, 1, 129, False, 0)], ids=str)
def test_flash_fwd_and_bwd_at_head_dims_80_96(sm90, case, D, dtype):
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import flash_attention_bwd as bk

    B, NQ, NKV, S, causal, window = case
    route = "cuda_core" if dtype == "float32" else "wgmma"  # 16 / 32-wide feature boxes
    assert fk.flash_route(getattr(torch, dtype), D) == route
    assert bk.bwd_route(getattr(torch, dtype), D) == route
    q, dout = (_rn(sm90, (B, S, NQ, D), dtype).transpose(1, 2) for _ in range(2))
    k, v = (_rn(sm90, (B, S, NKV, D), dtype).transpose(1, 2) for _ in range(2))
    out, lse = fk.flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                             return_lse=True)
    _close(out, want, dtype)
    _close(lse, want_lse, "float32")
    got = bk.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, window=window)
    for g, w in zip(got, ref.flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=causal,
                                                     window=window)):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [80, 96])
@pytest.mark.parametrize("case", [(2, 2, 5, 152, 0), (1, 4, 16, 300, 0), (2, 1, 10, 40, 16),
                                  (2, 32, 1, 2100, 0)], ids=str)
def test_ring_decode_at_head_dims_80_96(sm90, case, D, dtype):
    from repro_torch.kernels import decode_attention as dk

    B, NKV, G, S, window = case
    q = _rn(sm90, (B, NKV, G, D), dtype)
    kc, vc = (_rn(sm90, (B, S, NKV, D), dtype).transpose(1, 2) for _ in range(2))
    sp, pos = _ring(B, S)
    _close(dk.decode_attention_fwd(q, kc, vc, sp, pos, window=window),
           ref.decode_attention_ref(q, kc, vc, sp, pos, window=window), dtype)


def _pool(gen, B, NKV, G, D, page, NB, dtype):
    P = 1 + B * NB
    q = _rn(gen, (B, NKV, G, D), dtype)
    kp, vp = (_rn(gen, (P, page, NKV, D), dtype).transpose(1, 2) for _ in range(2))
    tables = (1 + torch.randperm(P - 1, generator=gen)).to(torch.int32).reshape(B, NB).cuda()
    return q, kp, vp, tables


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [80, 96, 128])
@pytest.mark.parametrize("window", [0, 5])
def test_paged_decode_split_at_head_dims(sm90, window, D, dtype):
    """Rows at every kind of span: the whole pool, pos < 0 (the mean of v),
    a span of 2 keys (shorter than the split), mid-page, past the pool."""
    from repro_torch.kernels import decode_attention as dk

    q, kp, vp, tables = _pool(sm90, 8, 8, 5, D, 8, 18, dtype)
    pos = torch.tensor([143, -1, 1, 77, 128, 150, 64, 9], dtype=torch.int32, device="cuda")
    got = dk.decode_attention_paged_fwd(q, kp, vp, tables, pos, window=window)
    _close(got, ref.decode_attention_paged_ref(q, kp, vp, tables, pos, window=window), dtype)
    assert all(torch.equal(got, dk.decode_attention_paged_fwd(q, kp, vp, tables, pos,
                                                              window=window))
               for _ in range(5))


@pytest.mark.parametrize("span, window", [(4096, 0), (9000, 0), (9000, 3000), (70000, 0)])
def test_paged_decode_split_long_spans(sm90, span, window):
    """Chunks longer than a step (256 keys) carry (m, l, acc) across steps."""
    from repro_torch.kernels import decode_attention as dk

    page = 16
    NB = -(-span // page) + 2
    q, kp, vp, tables = _pool(sm90, 2, 2, 5, 128, page, NB, "bfloat16")
    pos = torch.tensor([span - 1, span // 2 + 3], dtype=torch.int32, device="cuda")
    got = dk.decode_attention_paged_fwd(q, kp, vp, tables, pos, window=window)
    _close(got, ref.decode_attention_paged_ref(q, kp, vp, tables, pos, window=window),
           "bfloat16")
    assert torch.equal(got, dk.decode_attention_paged_fwd(q, kp, vp, tables, pos, window=window))


def test_paged_decode_trash_rows_inert(sm90):
    """All-trash padded rows (page 0, pos 0) leave the real rows bitwise
    unchanged."""
    from repro_torch.kernels import decode_attention as dk

    q, kp, vp, tables = _pool(sm90, 8, 2, 5, 96, 8, 6, "float32")
    pos = torch.tensor([40, 3, 17, 47, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
    tables[4:] = 0
    padded = dk.decode_attention_paged_fwd(q, kp, vp, tables, pos)
    real = q.clone()
    real[4:] = q[:4]
    alone = dk.decode_attention_paged_fwd(real, kp, vp, torch.cat([tables[:4]] * 2),
                                          torch.cat([pos[:4]] * 2))
    assert torch.equal(padded[:4], alone[:4])
    assert not bool(torch.isnan(padded).any())


@pytest.mark.parametrize("S", [70000, 1 << 20])
def test_ring_decode_past_65536_slots(sm90, S):
    from repro_torch.kernels import decode_attention as dk

    q = _rn(sm90, (1, 1, 4, 128), "bfloat16")
    kc, vc = (_rn(sm90, (1, 1, S, 128), "bfloat16") for _ in range(2))
    sp, pos = _ring(1, S)
    _close(dk.decode_attention_fwd(q, kc, vc, sp, pos),
           ref.decode_attention_ref(q, kc, vc, sp, pos), "bfloat16")
    sp = torch.where(torch.arange(S) < 10, torch.arange(S), -1).to(torch.int32)[None].cuda()
    for p in (9, -1):  # chunks of masked keys only; a row with no valid key
        pos = torch.full((1,), p, dtype=torch.int32, device="cuda")
        _close(dk.decode_attention_fwd(q, kc, vc, sp, pos),
               ref.decode_attention_ref(q, kc, vc, sp, pos), "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [(4, 8, 4, 2048, 128, 0, 528), (4, 8, 4, 2048, 128, 0, 0),
                                  (4, 1, 5, 1024, 256, 2048, 512), (2, 2, 2, 33, 80, 16, 20)],
                         ids=str)
def test_ring_decode_log_sum_exp(sm90, case, dtype):
    """``return_lse``: the out of the call without it, bitwise, and the rows'
    log-sum-exp within f32 tolerance of the plain version's; a slot slice
    with no valid slot (a tensor-parallel rank past the prompt) gives -1e30
    and the mean of v.  (B, NKV, G, S, D, window, live slots)."""
    from repro_torch.kernels import decode_attention as dk

    B, NKV, G, S, D, window, live = case
    q = _rn(sm90, (B, NKV, G, D), dtype)
    kc, vc = (_rn(sm90, (B, S, NKV, D), dtype).transpose(1, 2) for _ in range(2))
    sp = torch.where(torch.arange(S) < live, torch.arange(S), -1).to(torch.int32)
    sp = sp.expand(B, S).contiguous().cuda()
    pos = torch.full((B,), live - 1 if live else 527, dtype=torch.int32, device="cuda")
    out, lse = dk.decode_attention_fwd(q, kc, vc, sp, pos, window=window, return_lse=True)
    want, want_lse = ref.decode_attention_ref(q, kc, vc, sp, pos, window=window,
                                              return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, NKV, G)
    assert torch.equal(out, dk.decode_attention_fwd(q, kc, vc, sp, pos, window=window))
    _close(out, want, dtype)
    _close(lse, want_lse, "float32")
    if not live:
        assert bool((lse == -1e30).all())
