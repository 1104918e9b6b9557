"""The int8 ring KV cache (``kv_cache_quant``) against the JAX package, on
the CPU in f32.

* ``_kv_quant`` / ``_kv_dequant`` bitwise against the jitted JAX
  functions, as the JAX package's serving runs them (XLA turns the division
  by 127 into a product with its reciprocal), ties at .5 included (round
  half to even) and all-zero rows (the 1e-8 scale floor).
* reduced gemma-2b and llama3-8b, weights bridged from the JAX
  ``init_params``: a 12-token prompt into an 8-slot ring (the prefill's
  write wraps), then 16 greedy decode steps (each quantises its write and
  dequantises the whole ring).  The prefill's int8 codes equal JAX's except
  where a key or value lies within rounding of a code boundary (at most one
  code, on at most 0.5 % of the entries; the f32 projections differ in
  summation order), scales atol 1e-6 + rtol 1e-5, slot positions exactly;
  logits atol 1e-4 / rtol 1e-4 and greedy tokens equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import archs as jarchs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import archs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

PROMPT, RING, STEPS, B = 12, 8, 16, 2


def _quant_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    # One row whose scale is exactly 1 (max |x| = 127) with values at .5:
    # round half to even sends 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 126.5 -> 126.
    tie = np.zeros(16, np.float32)
    tie[:6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    x[0, 0, 0] = tie
    x[0, 0, 1] = 0.0  # all zero: the 1e-8 floor
    x[1, 2, 1] *= 1e-12  # tiny: the floor again, values round to 0
    return x


def test_kv_quant_bitwise_matches_jax():
    x = _quant_inputs()
    jq, js = jax.jit(JT._kv_quant)(jnp.asarray(x))
    q, s = T._kv_quant(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 0, 0, :6].tolist() == [127, 2, -4, 0, 0, 126]
    assert float(s[0, 0, 1]) == np.float32(1e-8)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = JT._kv_dequant(jq, js, jdtype)
        got = T._kv_dequant(q, s, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _cfgs(arch):
    jcfg = jarchs.reduced(arch, kv_cache_quant=True)
    cfg = archs.reduced(arch, kv_cache_quant=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@pytest.mark.parametrize("arch", ["gemma-2b", "llama3-8b"])
def test_wrapped_int8_ring_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    assert not T.supports_paged_decode(cfg)
    jparams = jax.jit(lambda key: JT.init_params(jcfg, key))(jax.random.key(4))
    params = T.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, PROMPT))
    jpre = jax.jit(lambda p, t: JT.prefill(jcfg, p, {"tokens": t}, max_len=RING))
    jdec = jax.jit(lambda p, cache, t, pos: JT.decode_step(jcfg, p, cache, t, pos))
    jcache, jl = jpre(jparams, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        cache, tl = T.prefill(cfg, params, {"tokens": torch.as_tensor(tokens)}, max_len=RING)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)

    off = total = 0
    for layer, jlayer in zip(cache["periods"], jcache["periods"]):
        assert set(layer) == set(jlayer) == {"k", "v", "slot_pos", "k_scale", "v_scale"}
        np.testing.assert_array_equal(layer["slot_pos"].numpy(), np.asarray(jlayer["slot_pos"]))
        # The ring holds prompt positions 4..11, the last 4 wrapped to slots 0..3.
        assert layer["slot_pos"][:, 0, :].tolist() == [[8, 9, 10, 11, 4, 5, 6, 7]] * B
        for key in ("k", "v"):
            assert layer[key].dtype == torch.int8
            diff = np.abs(layer[key].numpy().astype(int) - np.asarray(jlayer[key]).astype(int))
            assert diff.max() <= 1, key
            off += int((diff > 0).sum())
            total += diff.size
            np.testing.assert_allclose(layer[f"{key}_scale"].numpy(),
                                       np.asarray(jlayer[f"{key}_scale"]), atol=1e-6, rtol=1e-5)
    assert off <= total // 200, f"{off} of {total} int8 codes differ"

    tok, jtok = tl.argmax(-1), jnp.argmax(jl, -1).astype(jnp.int32)
    toks, jtoks = [], []
    for i in range(STEPS):
        toks.append(tok.numpy().copy())
        jtoks.append(np.asarray(jtok))
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jcache = jdec(jparams, jcache, jtok, jnp.asarray(pos))
        with torch.inference_mode():
            tl, cache = T.decode_step(cfg, params, cache, tok, torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4,
                                   err_msg=f"step {i}")
        tok, jtok = tl.argmax(-1), jnp.argmax(jl, -1).astype(jnp.int32)
    np.testing.assert_array_equal(np.stack(toks, 1), np.stack(jtoks, 1))
    for layer, jlayer in zip(cache["periods"], jcache["periods"]):
        np.testing.assert_array_equal(layer["slot_pos"].numpy(), np.asarray(jlayer["slot_pos"]))
