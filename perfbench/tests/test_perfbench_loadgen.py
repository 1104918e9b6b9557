"""The traffic generator: reproducible from the seed, the same work on
every seed in an order of its own."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import loadgen

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIXES = sorted(p.stem for p in TRAFFIC.glob("*.json"))
SEED = 2**31 + 99  # larger than 32 signed bits hold


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_reproducible(name):
    a = loadgen.make_stream(_mix(name), 40.0, SEED)
    b = loadgen.make_stream(_mix(name), 40.0, SEED)
    assert np.array_equal(a.due_ms, b.due_ms) and np.array_equal(a.n_steps, b.n_steps)
    assert all(np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))


@pytest.mark.parametrize("name", MIXES)
def test_same_work_every_seed_in_its_own_order(name):
    a = loadgen.make_stream(_mix(name), 40.0, SEED)
    b = loadgen.make_stream(_mix(name), 40.0, SEED + 1)
    assert len(a) == len(b) == round(_mix(name)["arrivals"]["rate_rps"] * 40.0)
    assert np.allclose(np.sort(_gaps(a)), np.sort(_gaps(b)))
    assert np.array_equal(np.sort(a.n_steps), np.sort(b.n_steps))
    assert np.array_equal(np.sort(a.nw_ms), np.sort(b.nw_ms))
    assert sorted(map(len, a.prompts)) == sorted(map(len, b.prompts))
    # the order, the arrival pattern and the tokens are the seed's own
    assert not np.allclose(a.due_ms, b.due_ms)
    assert list(map(len, a.prompts)) != list(map(len, b.prompts))
    assert not np.array_equal(a.n_steps, b.n_steps)
    assert np.all(np.diff(a.due_ms) > 0) and 0 < a.due_ms[0] and a.due_ms[-1] < 40e3
    # on no grid: due times do not line up with the scheduling window
    assert np.std(a.due_ms % a.window_ms) > a.window_ms / 5


def _gaps(s):
    """The gaps the due times were cut from: each request sits halfway
    through its gap, so gap i = 2 * (due_i - end of gap i - 1)."""
    out, end = [], 0.0
    for d in s.due_ms:
        g = 2 * (d - end)
        out.append(g)
        end += g
    return np.asarray(out)


def test_rates_and_sizes():
    mix = _mix("classify-qwen3-14b")
    s = loadgen.make_stream(mix, 40.0, SEED)
    assert len(s) == round(mix["arrivals"]["rate_rps"] * 40.0)
    gaps = _gaps(s)
    assert np.isclose(gaps.sum(), 40e3)
    # exponential: the largest gap is several times the median one
    assert gaps.max() > 3 * np.median(gaps)
    lens = np.asarray([len(p) for p in s.prompts])
    assert lens.min() >= mix["prompt_tokens"]["min"] and lens.max() <= mix["prompt_tokens"]["max"]
    assert abs(np.median(lens) - mix["prompt_tokens"]["median"]) < 30
    assert set(s.n_steps) == set(range(1, 9))
    assert max(p.max() for p in s.prompts) < mix["token_ids_below"]


def test_residential_copy_matches_the_stack():
    from repro_torch.core.network import residential_trace

    assert np.array_equal(np.asarray(residential_trace().trace_ms), loadgen.residential_trace())
