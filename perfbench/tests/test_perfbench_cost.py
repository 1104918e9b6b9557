"""The frozen work formulas agree with the port's counter."""
import pytest
import torch

from perfbench import yardstick
from repro_torch.kernels import cost, ops


@pytest.mark.parametrize("B,NQ,NKV,S,D", [(1, 40, 8, 512, 128), (4, 16, 16, 2048, 128),
                                           (2, 2, 1, 37, 16)])
def test_flash_fwd_matches_the_counter(B, NQ, NKV, S, D):
    pairs = cost.visible_pairs(S, causal=True) * B
    assert pairs == yardstick.causal_pairs(S) * B
    w = cost.flash_fwd_work(B, NQ, NKV, S, D, 2, pairs)
    assert yardstick.flash_fwd_work(B, NQ, NKV, S, D, 2, pairs) == (w.flops, w.bytes)
    # and the counter's own reading of a meta call
    q = torch.empty(B, NQ, S, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, NKV, S, D, dtype=torch.bfloat16, device="meta")
    with cost.CostCounter() as c:
        ops.flash_attention(q, k, k, causal=True)
    assert (c.flops, c.bytes) == yardstick.flash_fwd_work(B, NQ, NKV, S, D, 2, pairs)


@pytest.mark.parametrize("B,NQ,NKV,D,S,live",
                         [(1, 40, 8, 128, 2056, 513), (8, 16, 16, 128, 2056, 9000)])
def test_decode_matches_the_counter(B, NQ, NKV, D, S, live):
    w = cost.decode_work(B, NQ, NKV, D, S, 2, live)
    assert yardstick.decode_work(B, NQ, NKV, D, S, 2, live) == (w.flops, w.bytes)


def test_bound_uses_the_data_sheet():
    w = cost.flash_fwd_work(1, 40, 8, 512, 128, 2, yardstick.causal_pairs(512))
    assert yardstick.bound_s(w.flops, w.bytes) * 1e3 == pytest.approx(w.bound()[0])


@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b"])
def test_layer_params_match_the_config_count(arch):
    from repro_torch.configs.archs import ARCHS

    cfg = ARCHS[arch]
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    assert yardstick.layer_params(cfg) * cfg.n_layers == cfg.param_count(active_only=True) - emb
