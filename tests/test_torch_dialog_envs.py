"""The port's dialog envs and task builders (`lmrl_gym_torch/envs/
{twenty_questions,guess_city,car_dealer}`, the dialog part of
`lmrl_gym_torch/cli/tasks.py`) against the JAX package's and against the
goldens made from the reference's own code (tests/goldens/*.json).

Everything here is host Python: the same seeds must give identical
chains, texts and rewards (exact equality), and the scripted oracles the
same answers."""
import json
import os
import random

import pytest

from lmrl_gym_torch.cli import tasks as ttasks
from lmrl_gym_torch.envs.car_dealer import data as tcd
from lmrl_gym_torch.envs.car_dealer import env as tcd_env
from lmrl_gym_torch.envs.guess_city import data as tgc
from lmrl_gym_torch.envs.guess_city import env as tgc_env
from lmrl_gym_torch.envs.twenty_questions import data as tq
from lmrl_gym_torch.envs.twenty_questions import env as tq_env
from lmrl_gym_torch.envs.twenty_questions import oracle as tq_oracle
from lmrl_gym_torch.text.frames import Text
from lmrl_gym_tpu.cli import tasks as jtasks
from lmrl_gym_tpu.envs.car_dealer import data as jcd
from lmrl_gym_tpu.envs.guess_city import data as jgc
from lmrl_gym_tpu.envs.guess_city import env as jgc_env
from lmrl_gym_tpu.envs.twenty_questions import data as jq
from lmrl_gym_tpu.envs.twenty_questions import oracle as jq_oracle

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return json.load(f)


def _flat(chain):
    """A chain as plain data: [(texts, is_action, rewards, done)] per window."""
    out = []
    while chain is not None:
        tt = chain.text_trajectory
        out.append(([t.text for t in tt.text_history], [t.is_action for t in tt.text_history],
                    list(tt.reward), bool(tt.done)))
        chain = chain.next
    return out


@pytest.mark.parametrize("task", ["twenty_questions", "guess_city", "car_dealer"])
def test_chains_match_jax(task):
    """The task's data-gen chains (scripted asker / seller against the
    scripted oracle / buyer) from the same seeds, window by window."""
    assert ttasks.TASKS[task].max_length == jtasks.TASKS[task].max_length == 1024
    for seed in (0, 3):
        got = [_flat(c) for c in ttasks.TASKS[task].generate_chains(6, seed)]
        want = [_flat(c) for c in jtasks.TASKS[task].generate_chains(6, seed)]
        assert got == want
        assert any(r != 0 for ch in got for w in ch for r in w[2])


def test_twenty_questions_goldens():
    G = _golden("twenty_questions.json")
    assert tq.INITIAL_STR == G["initial_str"] and tq.INVALID_QUESTION == G["invalid_question"]
    by_name = {w.words[0].lower(): w for w in tq.get_default_word_list()}
    for case in G["trajectories"]:
        history = tuple(Text(t, a) for t, a in case["history"])
        tt = tq.create_trajectory_from_history(by_name[case["word"]], history)
        assert [t.text for t in tt.text_history] == [h[0] for h in case["history"]]
        assert list(tt.reward) == case["reward"] and bool(tt.done) == case["done"]
    for q, expected in G["asker_postproc"].items():
        assert tq.asker_postproc(q) == expected == jq.asker_postproc(q)
    for r, expected in G["rtg_tokens"].items():
        assert tq.rtg_to_token_str(float(r)) == expected
        assert tq.token_str_to_rtg(expected) == jq.token_str_to_rtg(expected)


def test_twenty_questions_rules_match_jax():
    """Tagging, guess detection and the post-processors on every word
    against its own and other words' questions."""
    t_words, j_words = tq.get_default_word_list(), jq.get_default_word_list()
    assert [w.words for w in t_words] == [w.words for w in j_words] and len(t_words) == 158
    questions = ["Is it a cat?", "Is it a pair of shoes?", "Is it an animal?", "Is it a big red car?", "",
                 "Does it fly?", "Is it a computer keyboard.", "is it a plane etc.?", "Can you eat it?"]
    for tw, jw in zip(t_words, j_words):
        qs = questions + [f"Is it a {v.lower()}?" for v in tw.words]
        for q in qs:
            assert tq.is_done(tw, q) == jq.is_done(jw, q), (tw.words, q)
            assert tq.simple_pos_tag(q) == jq.simple_pos_tag(q)
        for fn in ("asker_postproc", "asker_postproc_simple", "asker_postproc_filter_repeats"):
            for q in qs:
                assert getattr(tq, fn)(q) == getattr(jq, fn)(q)
    t_or, j_or = tq_oracle.ScriptedOracle(), jq_oracle.ScriptedOracle()
    qs = questions + [tq.INVALID_QUESTION, "Is it alive?", "Is it a fruit?"]
    for q in qs:
        assert t_or.generate_answers(t_words, [q] * len(t_words), return_full=True) == \
            j_or.generate_answers(j_words, [q] * len(j_words), return_full=True)
    assert tq_oracle.oracle_prompt(t_words[3], "Is it a cat?") == jq_oracle.oracle_prompt(j_words[3], "Is it a cat?")
    raw = ["Yes.", " no way", "yes!", "maybe", ""]
    assert tq_oracle._normalize(raw, ["q"] * 4 + [tq.INVALID_QUESTION]) == \
        jq_oracle._normalize(raw, ["q"] * 4 + [jq.INVALID_QUESTION])


def test_batched_twenty_questions_env_matches_single():
    """One batched step answers every live slot as the single env would;
    done slots (None) stay None."""
    oracle, words = tq_oracle.ScriptedOracle(), tq.get_default_word_list()
    batched = tq_env.BatchedTwentyQuestionsEnv(oracle, words)
    seeds = [11, 12, 13]
    hist = batched.reset(seeds, [{"deterministic": True}] * 3)
    acted = [h + (Text("Is it an animal?\n", True),) for h in hist]
    acted[1] = None
    out = batched.step(acted)
    assert out[1] is None
    for i in (0, 2):
        single = tq_env.TwentyQuestionsEnv(oracle, words)
        h = single.reset(seeds[i], {"deterministic": True})
        assert single.step(h + (Text("Is it an animal?\n", True),)) == out[i]


def test_guess_city_goldens_and_oracle():
    G = _golden("guess_city.json")
    assert tgc.INITIAL_STR == G["initial_str"]
    for case in G["trajectories"]:
        tt = tgc.create_trajectory_from_history(case["word"], tuple(Text(t, a) for t, a in case["history"]))
        assert list(tt.reward) == case["reward"] and bool(tt.done) == case["done"]
    for q, expected in G["asker_postproc"].items():
        assert tgc.asker_postproc(q) == expected == jgc.asker_postproc(q)
    assert tgc.DEFAULT_CITIES == jgc.DEFAULT_CITIES
    t_or, j_or = tgc_env.ScriptedGuessCityOracle(), jgc_env.ScriptedGuessCityOracle()
    qs = ["Is it in Europe?", "Is it in Asia?", "Is it a capital?", "Is it Tokyo?", "Is it in Japan?",
          "Is it in Oceania?", "Is it in America?", "Is it in Africa?", "Is it big?"]
    for city in tgc.DEFAULT_CITIES:
        for q in qs + [f"Is it {tgc.city_name(city)}?"]:
            assert t_or.generate_answer(city, q, True) == j_or.generate_answer(city, q, True)
            assert tgc.is_done(city, q) == jgc.is_done(city, q)
    assert tgc_env.oracle_prompt("Paris,France", "Is it Paris?") == jgc_env.oracle_prompt("Paris,France", "Is it Paris?")


def test_car_dealer_goldens():
    G = _golden("car_dealer.json")
    assert tcd.create_buyer_info_str(G["buyer_info"]) == G["buyer_info_str"]
    for case in G["rewards"]:
        for mode in ("fancy", "revenue"):
            assert tcd.compute_reward(G["buyer_info"], case["output"], mode) == pytest.approx(case[mode])
            assert tcd.compute_reward(G["buyer_info"], case["output"], mode) == \
                jcd.compute_reward(G["buyer_info"], case["output"], mode)
    for case in G["extraction"]:
        out, extracted = tcd.extract_output_from_str(case["line"])
        assert out == case["output"] and extracted == case["extracted"]
    conversation = {
        "buyer_info": G["buyer_info"],
        "lines": [
            {"role": "seller", "text": "Welcome! Looking for anything special?"},
            {"role": "buyer", "text": "A Toyota SUV with a sunroof."},
            {"role": "seller", "text": "I have one at $38,000."},
            {"role": "buyer", "text": "Deal."},
        ],
        "output": {"car_bought": True, "msrp": 45000, "buy_price": 38000},
    }
    for role in (tcd.Role.SELLER, tcd.Role.BUYER):
        expected = G["trajectories"][str(role)]
        tt = tcd.create_trajectory_from_conversation(conversation, role)
        assert [[t.text, t.is_action] for t in tt.text_history] == expected["history"]
        assert list(tt.reward) == pytest.approx(expected["reward"]) and bool(tt.done) == expected["done"]
        jt = jcd.create_trajectory_from_conversation(conversation, jcd.Role(role.value))
        assert [(t.text, t.is_action) for t in tt.text_history] == [(t.text, t.is_action) for t in jt.text_history]
        assert list(tt.reward) == list(jt.reward)
    joined = tcd.join_consecutive_actions((Text("a\n", True), Text("b\n\n", True), Text("c", False), Text("d", True)))
    assert [(t.text, t.is_action) for t in joined] == [("a b\n", True), ("c", False), ("d\n", True)]


def test_car_dealer_env_episode_matches_jax():
    """Scripted seller against the scripted buyer, forced verdicts at a
    short max_conversation_length included: every step's history, reward
    and done."""
    from lmrl_gym_tpu.envs.car_dealer import env as jcd_env

    for max_len, patience in ((50, 4), (3, 9)):
        t_env = tcd_env.CarDealerEnv(lambda info: tcd_env.ScriptedBuyerPolicy(info, patience), max_len)
        j_env = jcd_env.CarDealerEnv(lambda info: jcd_env.ScriptedBuyerPolicy(info, patience), max_len)
        for seed in range(5):
            th, jh = t_env.reset(seed), j_env.reset(seed)
            assert t_env.buyer_info == j_env.buyer_info
            t_pol = ttasks.ScriptedSellerPolicy(random.Random(seed))
            j_pol = jtasks.ScriptedSellerPolicy(random.Random(seed))
            done = False
            while not done:
                th = t_pol.act(th)
                jh = j_pol.act(jh)
                th, r, done = t_env.step(th)
                jh, jr, jdone = j_env.step(jh)
                assert [(t.text, t.is_action) for t in th] == [(t.text, t.is_action) for t in jh]
                assert (r, done) == (jr, jdone)
            assert t_env.output == j_env.output
