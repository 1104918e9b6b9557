"""The plain reference against the port's CPU path at a tiny size."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import weights, window
from perfbench.reference.model import Reference, Spec
from perfbench.tests.tiny import TINY_MODEL

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TIERS = Path(__file__).resolve().parents[1] / "tiers"


def _model(name):
    if name == "hedge-xs":
        return json.loads((TIERS / "hedge-xs.json").read_text())["model"]
    m = json.loads((CONFIGS / f"{name}.json").read_text())["model"]
    m.update(TINY_MODEL[name], dtype="float32")
    return m


@pytest.mark.parametrize("name", ["qwen3-14b", "olmoe-1b-7b", "hedge-xs"])
def test_batch_matches_prefill_and_decode(name):
    from repro_torch.models import transformer as T

    m = _model(name)
    cfg, spec = window.model_config(m), Spec.from_dict(m)
    params = weights.make_params(spec, "5:" + name, "cpu")
    B, W, n = 4, 12, 5
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, spec.vocab_size, (B, W), generator=g)
    prompt[2, 7:] = 0  # a right-padded row
    prompt[3] = 0  # a padding row
    with torch.inference_mode():
        cache, logits = T.prefill(cfg, params, {"tokens": prompt}, max_len=W + n)
        got, tok = [logits], logits.argmax(-1)
        for j in range(1, n):
            pos = torch.full((B,), W + j - 1, dtype=torch.int32)
            logits, cache = T.decode_step(cfg, params, cache, tok, pos)
            got.append(logits)
            tok = logits.argmax(-1)
    got = torch.stack(got, 1)
    forced = got.argmax(-1)
    forced[1] = -1  # the reference's own tokens for one row
    want = Reference(spec, params).batch_decode(prompt, forced)
    torch.testing.assert_close(want, got.float(), rtol=2e-4, atol=2e-4)
    if spec.pattern[0] != "moe":  # rows alone, teacher-forced
        for r in range(B):
            seq = torch.cat([prompt[r], got[r, :-1].argmax(-1)])
            (lg,) = Reference(spec, params).teacher_forced([seq], [(W - 1, W - 1 + n)])
            torch.testing.assert_close(lg, got[r].float(), rtol=2e-4, atol=2e-4)


def test_capacity_drops_follow_token_order():
    spec = Spec.from_dict(_model("olmoe-1b-7b"))
    ref = Reference(spec, weights.make_params(spec, 1, "cpu"))
    W = ref.layer(0)["ffn"]
    h = torch.randn(64, spec.d_model)
    h[32:] = h[0]  # 32 copies of one token: its experts overflow
    from repro_torch.models import moe

    cfg = window.model_config(_model("olmoe-1b-7b"))
    want, _ = moe.moe_apply(cfg, W, h[None])
    torch.testing.assert_close(ref.moe(W, h), want[0], rtol=1e-4, atol=1e-4)
