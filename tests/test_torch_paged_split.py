"""The split decode kernels' plans and partials algebra, on the CPU.

* The paged kernel's split: each row's live span cut into ``n_split``
  chunks on the device (``decode_attention.paged_chunks`` is the same
  arithmetic), each chunk walked in steps with (m, l, acc) carried, the
  chunks merged in order.  ``ref.decode_attention_paged_split_ref`` models
  that in plain torch; it is held against the JAX oracle
  ``decode_attention_paged_ref`` (f32, atol 2e-5: summation order).
* The paged planner: the chunks cover the span with no gap or overlap, and
  the grid fills one resident wave at the continuous tier's full-width
  shape.
* The ring planner past 65536 slots, and unchanged up to it.

Inputs come from numpy with a fixed seed and go to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    HEADS_PER_BLOCK,
    MAX_CHUNK,
    MAX_SPLIT,
    MIN_CHUNK,
    paged_chunks,
    paged_plan,
    split_plan,
)

jref_paged = jax.jit(jref.decode_attention_paged_ref, static_argnames=("window", "scale"))

B, NKV, G, D, PAGE, NB = 4, 2, 5, 16, 8, 4
S = NB * PAGE
# Row 0 the whole pool, row 1 no valid key, row 2 a span of 2 keys (shorter
# than n_split 3), row 3 mid-page; with window 5 row 0 starts mid-page and
# a position past the pool leaves row 1 an empty span.
POS = {"mixed": [31, -1, 1, 17], "past": [31, 40, 1, 17]}


def _paged_inputs(seed, kind):
    rng = np.random.default_rng(seed)
    P = 1 + B * NB
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, NKV, G, D), (P, NKV, PAGE, D), (P, NKV, PAGE, D))]
    tables = rng.permutation(np.arange(1, P, dtype=np.int32)).reshape(B, NB)
    pos = np.array(POS.get(kind, POS["mixed"]), np.int32)
    if kind == "trash":  # rows 2, 3 padded: all-trash tables, pos 0
        tables[2:] = 0
        pos[2:] = 0
    return arrays, tables, pos


@pytest.mark.parametrize("step", [MAX_CHUNK, 3], ids=["one_step", "step3"])
@pytest.mark.parametrize("kind", ["mixed", "past", "trash"])
@pytest.mark.parametrize("window", [0, 5], ids=["nowin", "win5"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 40], ids=lambda n: f"split{n}")
def test_paged_split_merge_model_matches_jax(n_split, window, kind, step):
    """Chunk partials (m, l, acc), carried across steps within a chunk and
    merged in order, equal the unsplit oracle: chunks past the span, spans
    shorter than ``n_split``, windows cut mid-page, rows with no valid key
    (the uniform mean of v) and trash-padded rows."""
    (q, kp, vp), tables, pos = _paged_inputs(n_split + 7 * window + len(kind), kind)
    got = ref.decode_attention_paged_split_ref(
        *(torch.from_numpy(a) for a in (q, kp, vp)), torch.from_numpy(tables),
        torch.from_numpy(pos), n_split=n_split, window=window, step=step)
    want = jref_paged(*(jnp.asarray(a) for a in (q, kp, vp)), jnp.asarray(tables),
                      jnp.asarray(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    if kind == "mixed":  # row 1 (pos -1): every entry masked, the mean of v
        mean = vp[tables[1]].transpose(1, 0, 2, 3).reshape(NKV, S, D).mean(axis=1)
        np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(mean[:, None], (NKV, G, D)),
                                   atol=2e-5, rtol=0)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 40, MAX_SPLIT])
@pytest.mark.parametrize("window", [0, 1, 5, 64])
def test_paged_chunks_cover_the_span(n_split, window):
    """The chunks tile the live span exactly: the used ones in order with no
    gap or overlap, every later one empty; an empty span takes every entry."""
    for S_ in (1, 8, 33, 144, 5000):
        for p in (-3, -1, 0, 1, S_ // 2, S_ - 1, S_, S_ + window + 2):
            chunks, masked = paged_chunks(p, window, S_, n_split)
            lo = max(0, p - window + 1) if window else 0
            hi = min(p + 1, S_)
            assert masked == (lo >= hi)
            if masked:
                lo, hi = 0, S_
            assert len(chunks) == n_split
            used = [(c0, n) for c0, n in chunks if n > 0]
            assert chunks[:len(used)] == used  # empty chunks only at the end
            assert used[0][0] == lo and used[-1][0] + used[-1][1] == hi
            assert all(a[0] + a[1] == b[0] for a, b in zip(used, used[1:]))
            cs = used[0][1]  # equal parts, the last one shorter
            assert all(n == cs for _, n in used[:-1]) and used[-1][1] <= cs


def test_paged_plan_fills_one_wave_at_the_continuous_shape():
    """The continuous tier's full-width decode step: 8 slots, qwen3-14b's 8
    kv heads x 5 query heads, 18 pages of 8.  The first design's grid was
    (NKV, B, ceil(G / 8)) = 64 blocks.  With one block per SM resident the
    plan is the ring planner's (3 chunks, 192 blocks); with 4 (the kernel's
    occupancy at bf16, D = 128, 8 heads a block on an H100) it takes the
    most chunks whose grid is resident at once: 8, 512 blocks."""
    Bc, NKVc, Gc, Sc = 8, 8, 5, 18 * 8
    assert NKVc * Bc * -(-Gc // 8) == 64
    for occupancy, n_want in ((1, 3), (4, 8)):
        heads, n_split = paged_plan(Bc, NKVc, Gc, Sc, 132, lambda h: occupancy)
        assert heads in HEADS_PER_BLOCK and heads >= Gc  # every query head of a kv head
        blocks = n_split * Bc * NKVc * -(-Gc // heads)
        assert n_split == n_want and blocks >= 132
    assert blocks == 512 <= 132 * 4
    assert paged_plan(Bc, NKVc, Gc, Sc, 132)[1] == split_plan(Bc, NKVc, Gc, Sc, 132)[1]
    chunks, masked = paged_chunks(128, 0, Sc, 8)  # 129 live keys
    assert not masked and sum(n for _, n in chunks if n > 0) == 129


@pytest.mark.parametrize("occupancy", [1, 2, 4, 7])
def test_paged_plan_stays_within_one_resident_wave(occupancy):
    """Never fewer chunks than the ring planner; more only while the grid
    stays resident at once and chunks keep MIN_CHUNK of the S keys."""
    rng = np.random.default_rng(occupancy)
    for _ in range(300):
        B_, NKV_, G_ = (int(x) for x in (rng.integers(1, 33), rng.integers(1, 9),
                                         rng.integers(1, 17)))
        S_ = int(rng.integers(1, 5000))
        heads, n_split = paged_plan(B_, NKV_, G_, S_, 132, lambda h: occupancy)
        ring_heads, ring_n, _ = split_plan(B_, NKV_, G_, S_, 132)
        assert heads == ring_heads and ring_n <= n_split <= MAX_SPLIT
        if n_split > ring_n:
            assert n_split * B_ * NKV_ * -(-G_ // heads) <= 132 * occupancy
            assert n_split <= -(-S_ // MIN_CHUNK)


@pytest.mark.parametrize("S_", [70000, 1 << 20])
def test_split_plan_covers_long_rings(S_):
    """Past 65536 slots the plan keeps MAX_SPLIT chunks and lengthens them
    (a block walks its chunk in steps of MAX_CHUNK)."""
    for B_, NKV_, G_ in ((1, 1, 1), (1, 8, 5), (4, 1, 10)):
        heads, n_split, chunk = split_plan(B_, NKV_, G_, S_, 132)
        assert heads in HEADS_PER_BLOCK and n_split == MAX_SPLIT and chunk > MAX_CHUNK
        assert (n_split - 1) * chunk < S_ <= n_split * chunk  # none empty, S covered


def _plan_up_to_65536(B_, NKV_, G_, S_, sm_count):
    """The ring planner as it was when S was capped at MAX_CHUNK * MAX_SPLIT."""
    def chunks(blocks):
        want = min(max(-(-sm_count // blocks), -(-S_ // MAX_CHUNK)), S_, MAX_SPLIT)
        chunk = -(-S_ // want)
        while chunk > 1 and -(-S_ // chunk) < want:
            chunk -= 1
        return -(-S_ // chunk), chunk

    widths = [h for h in HEADS_PER_BLOCK if h < 2 * G_] or [HEADS_PER_BLOCK[-1]]
    for heads in widths:
        n_split, chunk = chunks(B_ * NKV_ * -(-G_ // heads))
        if chunk >= MIN_CHUNK:
            break
    return heads, n_split, chunk


def test_split_plan_unchanged_up_to_65536_slots():
    """The served shapes launch the grids they did (160 / 132 blocks), and
    every plan up to 65536 slots is what it was."""
    assert split_plan(4, 8, 5, 152, 132) == (8, 5, 31)  # tier-l: 160 blocks
    assert split_plan(4, 1, 10, 152, 132) == (4, 11, 14)  # tier-rg: 132 blocks
    rng = np.random.default_rng(0)
    shapes = [(4, 8, 5, 152), (4, 1, 10, 152), (1, 1, 1, 65536), (2, 2, 16, 65535),
              (8, 8, 5, 144), (1, 1, 1, 1)]
    shapes += [tuple(int(x) for x in (rng.integers(1, 9), rng.integers(1, 9),
                                      rng.integers(1, 41), rng.integers(1, 65537)))
               for _ in range(400)]
    for shape in shapes:
        for sm in (132, 114, 1):
            assert split_plan(*shape, sm) == _plan_up_to_65536(*shape, sm), (shape, sm)
