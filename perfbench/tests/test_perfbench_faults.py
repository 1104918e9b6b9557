"""The check fails what it must: the control in the program's place, and
a run whose timed path is broken underneath (CPU, tiny cells)."""
import time

import pytest

from perfbench import run
from perfbench.reference import check
from perfbench.reference.model import Reference, Spec
from perfbench.tests.tiny import tiny_cell

SEED = 2**31 + 4242
TINY_LIMITS = {"remote_gap": 0.05, "hedge_gap": 0.01, "far_gap": 0.005}


def _run(cell, monkeypatch=None):
    return run.run_cell(cell, SEED, 1.2, False, "cpu", time.perf_counter(), limits=TINY_LIMITS)


CELLS = [("qwen3-14b", "classify-qwen3-14b"), ("olmoe-1b-7b", "classify-olmoe-1b-7b")]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_sound_run_is_correct(config, traffic):
    out = _run(tiny_cell(config, traffic))
    assert out["correct"], out["compared"]
    assert out["attempted"] > 10 and out["failed"] == 0


def _alter(monkeypatch, hedge: bool):
    """A token altered where it is produced: row 0's first token of every
    remote (or hedge) batch."""
    from repro_torch.serving import backend as B

    inner = B.JitBackend._generate

    def generate(self, v, tokens, n_steps, stream, t0):
        out, ms = inner(self, v, tokens, n_steps, stream, t0)
        if v.name.startswith("hedge") == hedge:
            out = out.copy()
            out[0, 0] = (out[0, 0] + 1) % v.cfg.vocab_size
        return out, ms

    monkeypatch.setattr(B.JitBackend, "_generate", generate)


@pytest.mark.parametrize("config,traffic", CELLS)
def test_remote_token_altered(config, traffic, monkeypatch):
    _alter(monkeypatch, hedge=False)
    out = _run(tiny_cell(config, traffic))
    assert not out["correct"]
    assert {c["name"]: c["value"] for c in out["compared"]}["remote_gap"] > 0.05


def test_hedge_token_altered(monkeypatch):
    _alter(monkeypatch, hedge=True)
    cell = tiny_cell(*CELLS[0])
    cell.mix["sla_ms"] = 60.0  # the remote tier misses: the hedge answers
    out = _run(cell)
    assert not out["correct"]
    assert {c["name"]: c["value"] for c in out["compared"]}["hedge_gap"] > 0.01


@pytest.mark.parametrize("config,traffic", CELLS)
def test_decode_state_unchanged(config, traffic, monkeypatch):
    """Each decode step hands back the cache as it found it."""
    from repro_torch.models import transformer as T

    inner = T.decode_step

    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(clone(v) for v in tree)
        return tree.clone()

    def decode_step(cfg, params, cache, token, pos):
        before = clone(cache)
        logits, _ = inner(cfg, params, cache, token, pos)
        return logits, before

    monkeypatch.setattr(T, "decode_step", decode_step)
    out = _run(tiny_cell(config, traffic))
    assert not out["correct"]


def test_answer_left_out(monkeypatch):
    """Half of a batch's rows never answered: the loop resolves no row."""
    from repro_torch.serving import backend as B

    inner = B.JitBackend._generate

    def generate(self, v, tokens, n_steps, stream, t0):
        out, ms = inner(self, v, tokens, n_steps, stream, t0)
        return out[:, : max(n_steps // 2, 1) if n_steps > 1 else 0], ms

    monkeypatch.setattr(B.JitBackend, "_generate", generate)
    out = _run(tiny_cell(*CELLS[0]))
    assert not out["correct"]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_control_reads_above_the_program(config, traffic):
    """The reference computed as an fp8 GEMM would, in the program's place:
    the number the configuration compares reads wider gaps than a bf16
    program's at the same prompts and tokens, and the check's own verdict
    at the limits the run was held to finds the control not correct."""
    cell = tiny_cell(config, traffic, dtype="bfloat16")
    name = next(k for k in cell.config["correct"] if k.startswith("remote_"))
    served = {}
    real = check.judge

    def keep(s, remote, hedge, seed, tokens, device, control=None, **kw):
        served.update(s=s, remote=remote, hedge=hedge)
        return real(s, remote, hedge, seed, tokens, device, control, **kw)

    check.judge = keep
    try:
        _run(cell)
    finally:
        check.judge = real
    far = TINY_LIMITS["far_gap"]
    program = real(served["s"], served["remote"], served["hedge"], SEED, 200, "cpu", far_gap=far)
    spec = Spec.from_dict(cell.config["model"])
    ctl = real(served["s"], served["remote"], served["hedge"], SEED, 200, "cpu",
               control={"remote": Reference(spec, served["remote"].p, "fp8")}, far_gap=far)
    assert ctl[name] > 3 * program[name], (name, ctl[name], program[name])
    limits = dict(cell.config["correct"], **TINY_LIMITS)
    assert check.verdict(program, limits)[0], check.verdict(program, limits)[1]
    assert not check.verdict(ctl, limits)[0], check.verdict(ctl, limits)[1]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_answers_to_each_prompt_alone_are_correct(config, traffic, monkeypatch):
    """A program that masks its padding (each row answered as its prompt
    alone asks) is correct too: the check reads each request alone."""
    import numpy as np

    from perfbench import loadgen
    from repro_torch.serving import backend as B

    cell = tiny_cell(config, traffic)
    lengths = {p.tobytes(): len(p) for p in loadgen.make_stream(cell.mix, 1.2, SEED).prompts}
    inner = B.JitBackend._generate

    def generate(self, v, tokens, n_steps, stream, t0):
        out = np.zeros((tokens.shape[0], n_steps), np.int32)
        for r, row in enumerate(tokens):
            n = next((k for k in range(len(row), 0, -1) if row[:k].tobytes() in lengths), 0)
            if n:
                out[r] = inner(self, v, row[None, :n], n_steps, stream, t0)[0][0]
        return out, 0.0

    monkeypatch.setattr(B.JitBackend, "_generate", generate)
    out = _run(cell)
    assert out["correct"], out["compared"]
