"""Head dims 96 and 80 through the whole model, port against JAX on the CPU,
and the build-time refusal of a head dim that no CUDA kernel has.

phi3-mini-3.8b has head dim 96, hubert 80.  A reduced phi3 (2 layers, head
dim 96, MHA) and a reduced qwen3 at head dim 80 (GQA, qk-norm) run on both
packages from the same weights (the JAX ``init_params`` tree through the
weight bridge), in f32: prefill logits within atol 1e-4 / rtol 1e-4 (the
JAX prefill sums attention in chunks, the port's plain path in one
softmax; the tolerance of ``tests/test_torch_model.py``), and the same for
the logits of every greedy decode step, whose tokens are equal, on the ring
path and on the paged path (``prefill_ragged`` + graft +
``paged_decode_step``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
import repro_torch.serving.backend as backend  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CONFIGS = {
    "phi3-d96": dict(arch="phi3-mini-3.8b", n_layers=2, head_dim=96),
    "qwen3-d80": dict(arch="qwen3-14b", n_layers=2, head_dim=80, n_heads=4, n_kv_heads=2),
}
PROMPT, STEPS, MAX_LEN, B = 12, 8, 32, 2
W, PAGE, NB, N_ROWS = 12, 8, 3, 3  # paged: prefill width, page size, pages per row, rows
LENGTHS = np.array([12, 5], np.int32)
TABLES = np.array([[3, 7, 1], [5, 2, 6]], np.int32)
N_PAGES = 8


def _twins(name):
    kw = dict(CONFIGS[name])
    arch = kw.pop("arch")
    jcfg, cfg = jarchs.reduced(arch, **kw), archs.reduced(arch, **kw)
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(0))
    params = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    """Prefill + greedy ring decode, and prefill_ragged + graft + paged decode
    (two live rows, one inactive all-trash row), on both packages."""
    jcfg, jparams, cfg, params = _twins(request.param)
    assert cfg.head_dim in (80, 96) and cfg.head_dim in HEAD_DIMS
    out = {"cfg": cfg}
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jpre = jax.jit(lambda p, t: JT.prefill(jcfg, p, {"tokens": t}, max_len=MAX_LEN))
    jdec = jax.jit(lambda p, cache, t, pos: JT.decode_step(jcfg, p, cache, t, pos))
    jcache, jl = jpre(jparams, jnp.asarray(tokens))
    with torch.inference_mode():
        cache, tl = T.prefill(cfg, params, {"tokens": torch.as_tensor(tokens)}, max_len=MAX_LEN)
    out["prefill"] = (tl.numpy().copy(), np.asarray(jl))
    jtok, tok = jnp.argmax(jl, -1).astype(jnp.int32), tl.argmax(-1)
    ring = []
    for i in range(STEPS):
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jcache = jdec(jparams, jcache, jtok, jnp.asarray(pos))
        with torch.inference_mode():
            tl, cache = T.decode_step(cfg, params, cache, tok, torch.as_tensor(pos))
        jtok, tok = jnp.argmax(jl, -1).astype(jnp.int32), tl.argmax(-1)
        ring.append((tok.numpy().copy(), np.asarray(jtok), tl.numpy().copy(), np.asarray(jl)))
    out["ring"] = ring

    ptoks = tokens[:, :W]
    jpre_r = jax.jit(lambda p, t, lens: JT.prefill_ragged(jcfg, p, {"tokens": t}, lens, W))
    jgraft = jax.jit(lambda pool, pc, tbl: JT.graft_prefill_batch(jcfg, pool, pc, tbl, PAGE))
    jpdec = jax.jit(lambda p, pool, tbl, t, pos: JT.paged_decode_step(
        jcfg, p, pool, tbl, t, pos, PAGE))
    jpc, jl = jpre_r(jparams, jnp.asarray(ptoks), jnp.asarray(LENGTHS))
    jpool = jgraft(JT.init_paged_cache(jcfg, N_PAGES, PAGE), jpc, jnp.asarray(TABLES))
    with torch.inference_mode():
        pc, tl = T.prefill_ragged(cfg, params, {"tokens": torch.as_tensor(ptoks)},
                                  torch.as_tensor(LENGTHS), W)
        pool = T.init_paged_cache(cfg, N_PAGES, PAGE, device="cpu")
        T.graft_prefill_batch(cfg, pool, pc, torch.as_tensor(TABLES), PAGE)
    out["prefill_ragged"] = (tl.numpy().copy(), np.asarray(jl))
    tables = np.zeros((N_ROWS, NB), np.int32)
    tables[:2] = TABLES
    pos = np.zeros(N_ROWS, np.int32)
    pos[:2] = LENGTHS
    tok0 = np.zeros(N_ROWS, np.int32)
    tok0[:2] = np.argmax(np.asarray(jl), -1)
    jtok, ttok = jnp.asarray(tok0), torch.as_tensor(tok0)
    paged = []
    for _ in range(STEPS):
        jl, jpool = jpdec(jparams, jpool, jnp.asarray(tables), jtok, jnp.asarray(pos))
        with torch.inference_mode():
            tl, pool = T.paged_decode_step(cfg, params, pool, torch.as_tensor(tables), ttok,
                                           torch.as_tensor(pos), PAGE)
        active = pos > 0
        jtok = jnp.where(jnp.asarray(active), jnp.argmax(jl, -1), 0).astype(jnp.int32)
        ttok = torch.where(torch.as_tensor(active), tl.argmax(-1), 0).to(torch.int32)
        pos = np.where(active, pos + 1, 0).astype(np.int32)
        paged.append((ttok.numpy().copy(), np.asarray(jtok), tl.numpy().copy(), np.asarray(jl)))
    out["paged"] = paged
    return out


def test_prefill_logits_match_jax(runs):
    for key in ("prefill", "prefill_ragged"):
        logits, jlogits = runs[key]
        np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=1e-4, err_msg=key)


def test_greedy_ring_decode_matches_jax(runs):
    for i, (tok, jtok, logits, jlogits) in enumerate(runs["ring"]):
        np.testing.assert_array_equal(tok, jtok, err_msg=f"step {i}")
        np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=1e-4, err_msg=f"step {i}")


def test_greedy_paged_decode_matches_jax(runs):
    for i, (tok, jtok, logits, jlogits) in enumerate(runs["paged"]):
        np.testing.assert_array_equal(tok, jtok, err_msg=f"step {i}")
        np.testing.assert_allclose(logits[:2], jlogits[:2], atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("head_dim", [24, 40, 200])
def test_cuda_build_refuses_a_head_dim_without_kernels(head_dim, monkeypatch):
    """On ``cuda`` a head dim outside HEAD_DIMS is refused with its reason by
    ``check_supported``, before a weight, cache or pool is allocated (the
    device check is stubbed so the refusal shows without a card); the same
    config still runs on the CPU."""
    cfg = archs.reduced("phi3-mini-3.8b", n_layers=2, head_dim=head_dim)
    with pytest.raises(NotImplementedError, match=f"head dim {head_dim} has no CUDA"):
        T.check_supported(cfg, "cuda")
    T.check_supported(cfg, "cpu")
    T.check_supported(cfg)

    def no_alloc(*args, **kwargs):
        raise AssertionError("allocated before the head dim was refused")

    for mod in (T, backend):
        monkeypatch.setattr(mod, "resolve_device", torch.device)
    monkeypatch.setattr(T.layers, "truncated_normal_init", no_alloc)
    monkeypatch.setattr(T.torch, "full", no_alloc)
    monkeypatch.setattr(T.torch, "zeros", no_alloc)
    for build in (lambda: T.init_params(cfg, torch.Generator().manual_seed(0), "cuda"),
                  lambda: T.init_cache(cfg, 2, 16, device="cuda"),
                  lambda: T.init_paged_cache(cfg, 9, 8, device="cuda"),
                  lambda: backend.JitBackend(device="cuda").register(
                      backend.Variant("d", cfg, {}, 50.0))):
        with pytest.raises(NotImplementedError, match=f"head dim {head_dim}"):
            build()
    monkeypatch.undo()

    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        cache, logits = T.prefill(cfg, params, {"tokens": tokens}, max_len=12)
        logits2, _ = T.decode_step(cfg, params, cache, logits.argmax(-1),
                                   torch.full((2,), 6, dtype=torch.int32))
    assert logits.shape == logits2.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits2).all())


def test_every_head_dim_of_the_configs_has_kernels():
    """Every attention config the port supports on the card has its head dim
    in HEAD_DIMS (phi3-mini's 96 and hubert's 80 included)."""
    assert {80, 96} <= set(HEAD_DIMS)
    for name, cfg in archs.ARCHS.items():
        try:
            T.check_supported(cfg)
        except NotImplementedError:
            continue  # not ported yet
        T.check_supported(cfg, "cuda")
        assert cfg.head_dim in HEAD_DIMS or not set(cfg.layer_kinds()) & {"attn", "local"}, name
