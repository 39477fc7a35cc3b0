"""The yardstick's arithmetic against hand counts: visible pairs, model
FLOPs, the K2 and K1 bounds, and the traffic's sizes."""
import json
from pathlib import Path

import pytest

from portbench.harness import flops, traffic, weights, yardstick
from portbench.harness.core import Bench

ROOT = Path(__file__).resolve().parents[2]
MISTRAL = json.loads((ROOT / "portbench/configs/mistral_7b.json").read_text())
MIXTRAL = json.loads((ROOT / "portbench/configs/mixtral_8x7b.json").read_text())


@pytest.mark.parametrize("start,end,window", [
    (0, 1, None), (0, 50, None), (7, 50, None), (0, 50, 16), (3, 50, 16),
    (20, 50, 16), (0, 10, 16), (15, 17, 16)])
def test_visible_pairs_by_brute_force(start, end, window):
    want = sum(min(p + 1, window or p + 1) for p in range(start, end))
    assert flops.visible_pairs(start, end, window) == want


def test_mistral_at_8192():
    # 4096 positions see 1..4096 keys, the other 4096 see 4096 each
    assert flops.visible_pairs(0, 8192, 4096) == 4096 * 4097 // 2 + 4096 * 4096
    s = weights.Shape(MISTRAL)
    per_layer, attn = flops.layer_params(s)
    assert attn == 4096 * 4096 * 2 + 4096 * 1024 * 2
    assert per_layer == attn + 3 * 4096 * 14336 == 218_103_808
    fwd = (32 * 218_103_808 * 2 * 8192 + 2 * 4096 * 32000 * 8191
           + 32 * 4 * 32 * 128 * 25_167_872)
    assert flops.train_flops(s, 1, 8192) == 3 * fwd


def test_mixtral_active_parameters():
    s = weights.Shape(MIXTRAL)
    per_layer, attn = flops.layer_params(s)
    assert per_layer == attn + 2 * 3 * 4096 * 14336 + 4096 * 8
    # with the embedding's 131 M rows, Mixtral's 12.9 B active parameters
    assert 12.85e9 < 32 * per_layer + 2 * 4096 * 32000 < 12.95e9
    # a prompt of 3 and 2 new tokens: 4 fed positions, 2 heads
    want = (32 * per_layer * 2 * 4 + 2 * 4096 * 32000 * 2
            + 32 * 4 * 32 * 128 * (1 + 2 + 3 + 4))
    assert flops.serve_flops(s, [(3, 2)]) == want


def test_flash_attention_bound_by_hand():
    k2 = Bench(ROOT).kernel_classes()["flash_attention"]
    s = weights.Shape(MISTRAL)
    work = dict(kind="train_lm", attention="flash", shape=s, batch=1,
                seq_len=8192, steps=3)
    pairs = 25_167_872
    fwd = max((2 * 8192 * 32 * 128 * 2 + 2 * 8192 * 8 * 128 * 2
               + 32 * 8192 * 4) / 3.35e12, 4 * 32 * 128 * pairs / 989e12)
    bwd = max((4 * 8192 * 32 * 128 * 2 + 4 * 8192 * 8 * 128 * 2
               + 2 * 32 * 8192 * 4) / 3.35e12, 10 * 32 * 128 * pairs / 989e12)
    assert k2.bound(work) == pytest.approx(3 * 32 * (fwd + bwd), rel=1e-12)
    assert k2.bound(dict(work, kind="serve_lm")) is None


def test_paged_attention_bound_by_hand():
    k1 = Bench(ROOT).kernel_classes()["paged_attention"]
    s = weights.Shape(MIXTRAL)
    work = dict(kind="serve_lm", shape=s, requests=[(5, 3)], prefill_chunk=4)
    per_pos = 2 * 8 * 128 * 2
    qo = 2 * 32 * 128 * 2
    ops = 4 * 32 * 128
    seg1 = yardstick.bound_s(4 * per_pos + 4 * qo, ops * (1 + 2 + 3 + 4))
    seg2 = yardstick.bound_s(5 * per_pos + 1 * qo, ops * 5)
    # decode steps at positions 5 and 6 see 6 and 7 keys
    dec = yardstick.bound_s((6 + 7) * per_pos + 2 * qo, ops * 13)
    assert k1.bound(work) == pytest.approx(32 * (seg1 + seg2 + dec),
                                           rel=1e-12)


def test_sizes_are_the_quantiles_and_the_seed_draws_the_order():
    t = {"requests_per_call": 32,
         "prompt_tokens": {"dist": "lognormal", "median": 512, "sigma": 0.6,
                           "min": 128, "max": 2048},
         "new_tokens": {"dist": "uniform", "min": 32, "max": 64}}
    p = traffic.sizes(t["prompt_tokens"], 32)
    assert p == sorted(p) and 128 <= p[0] and p[-1] <= 2048
    assert p[15] <= 512 <= p[16]
    assert traffic.sizes(t["new_tokens"], 32) == [
        int(round(32 + (i + 0.5) / 32 * 32)) for i in range(32)]
    a_p, a_n = traffic.serve_call(t, 32000, seed=1, call=0)
    again_p, again_n = traffic.serve_call(t, 32000, seed=1, call=0)
    assert again_n == a_n and all((x == y).all()
                                  for x, y in zip(a_p, again_p))
    # another seed: the same sizes in another order, other tokens
    b_p, b_n = traffic.serve_call(t, 32000, seed=2 ** 40 + 3, call=0)
    assert sorted(map(len, b_p)) == sorted(map(len, a_p)) == p
    assert sorted(b_n) == sorted(a_n)
    assert [len(x) for x in b_p] != [len(x) for x in a_p]
    c_p, _ = traffic.serve_call(t, 32000, seed=1, call=1)
    assert sorted(map(len, c_p)) == p and list(map(len, c_p)) != \
        list(map(len, a_p))


def test_weights_draw_groups_again_alone():
    cfg = dict(MISTRAL, num_hidden_layers=2, hidden_size=64,
               intermediate_size=96, num_attention_heads=4,
               num_key_value_heads=2, vocab_size=100)
    whole = weights.draw_float(cfg, 2 ** 33 + 5, "cpu")
    again = {}
    for g in weights.iter_float_groups(cfg, 2 ** 33 + 5, "cpu"):
        again.update(g)
    assert set(whole) == set(again)
    assert all((whole[k] == again[k]).all() for k in whole)
    q = weights.draw_int8(dict(cfg, tie_word_embeddings=False,
                               num_local_experts=4, num_experts_per_tok=2),
                          9, "cpu")
    payload, scale = q["blocks.1.moe.wi"]
    assert payload.dtype.is_floating_point is False
    assert scale.shape == (4, 1, 192)
