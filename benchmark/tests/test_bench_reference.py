"""The plain reference against itself and against the definitions it
follows, at a tiny size on the CPU."""
import copy
import math

import pytest
import torch

from benchmark import weights
from benchmark.kinds import ilql_train
from benchmark.reference import gpt, ilql, wordle
from benchmark.tests.tiny import tiny_inputs

CPU = torch.device("cpu")


def params(cfg, groups, seed=3):
    spec = weights.model_spec(cfg, groups)
    return {g: dict(weights.draw(spec[g], weights.group_seed(seed, g), CPU, torch.float32)) for g in groups}


@pytest.mark.parametrize("config", ["gpt2-small", "gptj-6b-l6"])
def test_trunk_is_causal(config):
    cfg, _ = tiny_inputs("gpt2s-ilql-train" if config == "gpt2-small" else "gptj6b-ilql-train-l6")
    p = params(cfg, ("base",))["base"]
    toks = torch.randint(0, 250, (2, 12), generator=torch.Generator().manual_seed(0))
    later = toks.clone()
    later[:, 8:] = (later[:, 8:] + 1) % 250
    a, b = gpt.trunk_hidden(p, cfg, toks), gpt.trunk_hidden(p, cfg, later)
    assert torch.allclose(a[:, :8], b[:, :8], atol=1e-6) and not torch.allclose(a[:, 8:], b[:, 8:])


def test_rotary_is_a_rotation_by_position():
    x = torch.randn(1, 1, 6, 32, generator=torch.Generator().manual_seed(1))
    y = gpt._rotary(x, 16)
    assert torch.equal(y[..., 16:], x[..., 16:]) and torch.equal(y[0, 0, 0], x[0, 0, 0])
    assert torch.allclose(y[..., :16].pow(2).reshape(1, 1, 6, 8, 2).sum(-1),
                          x[..., :16].pow(2).reshape(1, 1, 6, 8, 2).sum(-1), atol=1e-5)


def test_ilql_loss_is_the_same_in_any_row_blocks():
    cfg, tr = tiny_inputs("gpt2s-ilql-train")
    batch = ilql_train.make_batches(cfg, tr, 4, CPU)[0]
    p = params(cfg, ilql.TRAINED)
    t = {g: copy.deepcopy(p[g]) for g in ("base", "q1", "q2")}
    hp = ilql_train.reference_hp(tr)
    whole = ilql.ilql_block_loss(p, t, cfg, batch, hp)
    parts = sum(ilql.ilql_block_loss(p, t, cfg, {k: v[i:i + 1] for k, v in batch.items()}, hp)
                for i in range(tr["batch"]))
    assert float(whole) == pytest.approx(float(parts), rel=1e-5)
    a = ilql.ilql_steps(lambda g: p[g].items(), cfg, [batch], hp, row_block=1)
    b = ilql.ilql_steps(lambda g: p[g].items(), cfg, [batch], hp, row_block=tr["batch"])
    assert a["losses"] == pytest.approx(b["losses"], rel=1e-5)
    assert all(a["grad_norms"][k] == pytest.approx(v, rel=1e-4, abs=1e-9) for k, v in b["grad_norms"].items())


def test_ilql_loss_by_hand_on_one_row():
    """One row, two actions: Bellman on both Q heads toward r + γ·V(next),
    the last bootstrapping from the next window; expectile V; CQL."""
    cfg, tr = tiny_inputs("gpt2s-ilql-train")
    hp = ilql_train.reference_hp(tr)
    p = params(cfg, ilql.TRAINED)
    t = {g: copy.deepcopy(p[g]) for g in ("base", "q1", "q2")}
    ids = torch.tensor([[5, 6, 7, 8, 9]])
    batch = {"input_ids": ids, "should_take_action": torch.tensor([[False, True, False, True]]),
             "rewards": torch.tensor([[0.0, -1.0, 0.0, 0.0]]), "dones": torch.tensor([False]),
             "next_token_ids": torch.tensor([[3, 4]]), "next_dones": torch.tensor([False])}
    h = gpt.trunk_hidden(p["base"], cfg, ids)[0]
    q = [gpt.mlp_head(p[g], h) for g in ("q1", "q2")]
    v = gpt.mlp_head(p["v"], h)[:, 0]
    v_fin = gpt.mlp_head(p["v"], gpt.trunk_hidden(p["base"], cfg, batch["next_token_ids"])[0, -1])[0]
    want = 0.0
    for j, (pos, nxt_v) in enumerate([(1, v[3]), (3, v_fin)]):
        tok = int(ids[0, pos + 1])
        target = float(batch["rewards"][0, pos]) + hp["gamma"] * float(nxt_v)
        want += sum(0.5 * (float(qq[pos, tok]) - target) ** 2 for qq in q)
        tq = min(float(qq[pos, tok]) for qq in q)  # targets are copies
        w = hp["tau"] if tq >= float(v[pos]) else 1 - hp["tau"]
        want += 0.5 * (float(v[pos]) - tq) ** 2 * w
        want += hp["cql_weight"] * sum(-float(torch.log_softmax(qq[pos], -1)[tok]) for qq in q)
    got = float(ilql.ilql_block_loss(p, t, cfg, batch, hp))
    assert got == pytest.approx(want, rel=1e-5)


def test_adamw_first_step_moves_by_the_learning_rate():
    p, g = torch.tensor([1.0, -2.0]), torch.tensor([0.5, -3.0])
    mu, nu = torch.zeros(2), torch.zeros(2)
    hp = {"b1": 0.9, "b2": 0.999, "eps": 0.0, "weight_decay": 0.0}
    ilql.adamw_(p, g, mu, nu, 1, 0.1, hp)
    assert torch.allclose(p, torch.tensor([0.9, -1.9]))


def test_guided_logits_and_served_gap():
    cfg, tr = tiny_inputs("gpt2s-guided-rollout")
    p = params(cfg, ("base", "pi_beta", "q1", "q2"))
    toks = torch.randint(97, 123, (1, 20), generator=torch.Generator().manual_seed(2))
    lg = wordle.guided_logits(p, cfg, toks, 32.0)
    pi = gpt.lm_logits(p["pi_beta"], cfg, gpt.trunk_hidden(p["pi_beta"], cfg, toks))
    h = gpt.trunk_hidden(p["base"], cfg, toks)
    q = torch.minimum(gpt.mlp_head(p["q1"], h), gpt.mlp_head(p["q2"], h))
    assert torch.allclose(lg[..., :259], (pi + 32 * q)[..., :259])
    assert (lg[..., 259:] == torch.finfo(torch.float32).min).all()


def test_replay_answers_on_a_known_game():
    words = ["crane", "slate", "crate"]
    noise = torch.zeros(6, 3)
    noise[:, 2] = 1.0  # the game's draw is always "crate" while it is consistent
    toks = list(b"Wordle:\n")
    for _ in range(6):
        toks += list(b"c r a n e\n") + list(b"g g g b g\n")
    assert wordle.replay_answers(toks, noise, words) == 0
    toks[8 + 10] = ord("y")
    assert wordle.replay_answers(toks, noise, words) == 1


def test_fp8_control_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = gpt.fp8_quant(x)
    assert 0 < float((y - x).detach().abs().max()) < 0.2
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(101))
