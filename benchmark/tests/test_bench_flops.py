"""The yardstick's arithmetic against counts made by hand."""
import pytest

from benchmark import flops
from benchmark.kinds.guided_rollout import decode_cache_lens
from benchmark.kinds.ilql_train import n_actions
from benchmark.tests.tiny import tiny_cfg


def test_causal_pairs_by_enumeration():
    for Tq, S in [(1, 1), (4, 4), (3, 10), (160, 160), (1, 37)]:
        brute = sum(1 for i in range(Tq) for j in range(S) if j <= S - Tq + i)
        assert flops.causal_pairs(Tq, S) == brute


def test_trunk_body_params_gpt2_small():
    cfg = {"n_embd": 768, "n_inner": None, "n_layer": 12}
    # per layer: qkv 768x2304, out 768x768, fc 768x3072, proj 3072x768
    assert flops.trunk_body_params(cfg) == 12 * (768 * 2304 + 768 * 768 + 768 * 3072 + 3072 * 768)


def test_ilql_update_flops_by_hand():
    cfg = tiny_cfg("gpt2-small")  # D 64, L 2, vocab 320 padded, heads hidden 128
    B, T, nt, na = 2, 8, 4, 6
    N = 2 * (4 * 64 * 64 + 2 * 64 * 256)
    attn = lambda Tq: 4 * 64 * 2 * B * sum(range(1, Tq + 1))  # noqa: E731
    want = (6 * N * B * T + 2 * N * B * T + 2 * N * B * nt + 3 * attn(T) + attn(T) + attn(nt)
            + 2 * 6 * (64 * 128 + 128 * 320) * na + 6 * (64 * 128 + 128) * B * (T - 1) + 2 * (64 * 128 + 128) * B
            + 2 * 2 * (64 * 128 + 128) * na)
    assert flops.ilql_update_flops(cfg, B, T, nt, na) == want


def test_rollout_flops_by_hand():
    cfg = tiny_cfg("gpt2-small")
    N = 2 * (4 * 64 * 64 + 2 * 64 * 256)
    B, E, S = 3, 128, 30
    attn = 4 * 64 * 2 * B * E * (E + 1) // 2
    want = 2 * (2 * N * B * E + attn) + (2 * 64 * 320 + 2 * 2 * (64 * 128 + 128 * 320)) * B * S
    assert flops.rollout_flops(cfg, B, E, S) == want


def test_bwd_and_decode_work_by_hand():
    b, h, dh, T = 2, 3, 16, 5
    pairs = b * h * 15
    nb, f = flops.bwd_work(b, h, dh, T, T, "bfloat16", "dq", True)
    assert f == 6 * dh * pairs
    assert nb == 2 * (2 * b * h * T * dh + 2 * b * h * T * dh) + 8 * b * h * T + 4 * b * T + 2 * b * h * T * dh
    nb, f = flops.bwd_work(b, h, dh, T, T, "bfloat16", "dkv", False)
    assert f == 8 * dh * pairs
    assert nb == 2 * (4 * b * h * T * dh) + 8 * b * h * T + 2 * 2 * b * h * T * dh
    nb, f = flops.decode_work(4, 2, 8, 10, "bfloat16")
    assert (nb, f) == (2 * 4 * 2 * 8 * 22, 4 * 4 * 2 * 8 * 10)


def test_least_seconds_takes_the_binding_bound():
    assert flops.least_seconds(3.35e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert flops.least_seconds(0.0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert flops.least_seconds(3.35e12, 2 * 989e12, "bfloat16") == pytest.approx(2.0)


def test_rollout_decode_steps():
    lens = decode_cache_lens()
    # ten single-token steps a turn, six turns; the first reads the header and itself
    assert len(lens) == 60 and lens[0] == 9 and lens[9] == 18 and lens[10] == 29 and lens[-1] == 8 + 100 + 10
    cfg = tiny_cfg("gpt2-small")
    one = sum(flops.least_seconds(*flops.decode_work(5, 4, 16, n, "bfloat16"), "bfloat16") for n in lens)
    assert flops.rollout_decode_least_seconds(cfg, 5, lens) == pytest.approx(2 * 2 * one)


def test_action_count():
    assert n_actions({"batch": 32, "seq": 160, "action_every": 2}) == 32 * 79
    assert n_actions({"batch": 1, "seq": 5, "action_every": 1}) == 4
