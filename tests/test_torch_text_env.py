"""The port's host text layer against the JAX package's: text frames,
blocking, the TextEnv interfaces and interaction loop, the host Wordle game
and its text envs, the scripted policies and dataset generation.

Both sides are plain Python and numpy seeded alike (`random.Random`), so
transcripts, rewards, token arrays and dones must be identical.
"""
import random

import numpy as np
import pytest

from lmrl_gym_tpu.core import blocking as jblock
from lmrl_gym_tpu.envs import base as jbase
from lmrl_gym_tpu.envs.wordle import data as jdata
from lmrl_gym_tpu.envs.wordle import env as jenv
from lmrl_gym_tpu.envs.wordle import game as jgame
from lmrl_gym_tpu.envs.wordle import policies as jpol
from lmrl_gym_tpu.envs.wordle.vector import WordleVocab as JVocab
from lmrl_gym_tpu.text import frames as jframes
from lmrl_gym_tpu.text.tokenizer import ByteTokenizer as JTok
from lmrl_gym_torch.core import blocking as tblock
from lmrl_gym_torch.envs import base as tbase
from lmrl_gym_torch.envs.wordle import data as tdata
from lmrl_gym_torch.envs.wordle import env as tenv
from lmrl_gym_torch.envs.wordle import game as tgame
from lmrl_gym_torch.envs.wordle import policies as tpol
from lmrl_gym_torch.envs.wordle.vector import WordleVocab as TVocab
from lmrl_gym_torch.text import frames as tframes
from lmrl_gym_torch.text.tokenizer import ByteTokenizer as TTok


def _small_vocabs(n=120):
    """The first n official words: the OptimalPolicy's exact search grows
    with |vocab|², so its cases run on a cut list."""
    words = TVocab.from_file().words[:n]
    return JVocab.from_words(list(words)), TVocab.from_words(list(words))


def _plain(history):
    return [(t.text, t.is_action) for t in history]


def _policies(pkg, vocab, seed):
    """The same scripted policies in either package, each with its own rng."""
    r = lambda k: random.Random(seed * 100 + k)  # noqa: E731
    return {
        "random_mixture": pkg.RandomMixturePolicy(0.66, vocab, rng=r(0)),
        "repeat_mixture": pkg.MixturePolicy(
            0.7, pkg.RandomMixturePolicy(1.0, vocab, rng=r(1)),
            pkg.RepeatPolicy(pkg.StartWordPolicy(rng=r(2)), rng=r(3)), rng=r(4)),
        "wrong": pkg.WrongPolicy(vocab, rng=r(5)),
        "optimal": pkg.OptimalPolicy(vocab, start_word_policy=pkg.StartWordPolicy(rng=r(6)), rng=r(7)),
    }


@pytest.mark.parametrize("name", ["random_mixture", "repeat_mixture", "wrong", "optimal"])
def test_text_env_eval_transcripts_match(name):
    jv, tv = _small_vocabs() if name == "optimal" else (JVocab.from_file(), TVocab.from_file())
    jp, tp = _policies(jpol, jv, 1)[name], _policies(tpol, tv, 1)[name]
    kw = dict(n_rollouts=5, seed_generator=None, bsize=2)
    jinter, jsum = jbase.text_env_eval(jenv.WordleEnv(jv), jp, seed_generator=iter(range(100, 200)),
                                       **{k: v for k, v in kw.items() if k != "seed_generator"})
    tinter, tsum = tbase.text_env_eval(tenv.WordleEnv(tv), tp, seed_generator=iter(range(100, 200)),
                                       **{k: v for k, v in kw.items() if k != "seed_generator"})
    assert tsum == jsum
    assert len(tinter) == len(jinter) == 5
    for jr, tr in zip(jinter, tinter):
        assert len(tr) == len(jr)
        for jt, tt in zip(jr, tr):
            assert _plain(tt.post_transition_history) == _plain(jt.post_transition_history)
            assert (tt.reward, tt.done) == (jt.reward, jt.done)
        assert tr[-1].done and len(tr) <= 6


def test_reformat_env_round_trips_and_matches():
    jv, tv = JVocab.from_file(), TVocab.from_file()
    jp, tp = _policies(jpol, jv, 2)["random_mixture"], _policies(tpol, tv, 2)["random_mixture"]
    # the policies act on the raw protocol; the reformatted env sees "c r a n e\n"
    jrun = jbase.interact_environment(jenv.WordleEnv(jv), jp, env_seed=7)[0]
    trun = tbase.interact_environment(tenv.WordleEnv(tv), tp, env_seed=7)[0]
    raw = trun[-1].post_transition_history
    assert _plain(raw) == _plain(jrun[-1].post_transition_history)
    ref = tenv.reformat_history(raw)
    assert _plain(ref) == _plain(jenv.reformat_history(jrun[-1].post_transition_history))
    assert ref[0].text == "Wordle:\n" and all(len(t.text) == 10 for t in ref[1:])
    assert _plain(tenv.deformat_history(ref)) == _plain(raw)
    assert _plain(tenv.reformat_history(tenv.deformat_history(ref))) == _plain(ref)
    # stepping the reformatted env with the reformatted actions replays the game
    env = tenv.ReformatWordleEnv(tenv.WordleEnv(tv))
    h = env.reset(seed=7)
    assert _plain(h) == [("Wordle:\n", False)]
    for t, step in zip(ref[1::2], trun):
        h, reward, done = env.step(h + (t,))
        assert (reward, done) == (step.reward, step.done)
    assert _plain(h) == _plain(ref)
    # a malformed action costs a try and renders an empty feedback line
    h2, reward, done = env.step(env.reset(seed=1) + (tframes.Text("x y\n", True),))
    assert h2[-1].text == "\n" and reward == -1.0 and not done


@pytest.mark.parametrize("reformat", [False, True])
def test_generate_trajectories_with_optimal_policy_match(reformat):
    jv, tv = _small_vocabs()
    jp = jpol.OptimalPolicy(jv, start_word_policy=jpol.StartWordPolicy(rng=random.Random(0)), rng=random.Random(0))
    tp = tpol.OptimalPolicy(tv, start_word_policy=tpol.StartWordPolicy(rng=random.Random(0)), rng=random.Random(0))
    jt = jdata.generate_trajectories(4, jp, jv, seed=90_000, reformat=reformat)
    tt = tdata.generate_trajectories(4, tp, tv, seed=90_000, reformat=reformat)
    for a, b in zip(jt, tt):
        assert _plain(b.text_history) == _plain(a.text_history)
        assert (b.reward, b.done) == (a.reward, a.done)
    assert all(sum(t.reward) > -6 for t in tt)  # the bound policy wins these
    chains = tdata.trajectories_to_chains(tt)
    assert [c.to_list() for c in chains] == [[t] for t in tt]
    if not reformat:
        return
    # tokenized (the LM's protocol), each segment's reward on its last token
    tok_j, tok_t = JTok(), TTok()
    for a, b in zip(jt, tt):
        ja = jframes.TokenTrajectory.from_text_trajectory(a, tok_j)
        tb = tframes.TokenTrajectory.from_text_trajectory(b, tok_t)
        for f in ("tokens", "is_action", "reward", "done"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(ja, f), err_msg=f)
    jc = jframes.TokenTrajectoryChain.from_text_trajectory_chain(jdata.trajectories_to_chains(jt)[0], tok_j)
    tc = tframes.TokenTrajectoryChain.from_text_trajectory_chain(chains[0], tok_t)
    np.testing.assert_array_equal(tc.to_list()[0].tokens, jc.to_list()[0].tokens)


def test_host_game_matches():
    jv, tv = JVocab.from_file(), TVocab.from_file()
    rng = np.random.default_rng(0)
    know_j = np.full((26, 5), 1, np.int8)
    for _ in range(3):
        guess, target = (tv.words[i] for i in rng.integers(0, len(tv), 2))
        know_t = tgame.apply_guess(know_j, guess, target)
        np.testing.assert_array_equal(know_t, jgame.apply_guess(know_j, guess, target))
        assert tgame.feedback_string(know_t, guess) == jgame.feedback_string(know_t, guess)
        for w in tv.words[:50]:
            assert tgame.word_satisfies(know_t, w) == jgame.word_satisfies(know_t, w)
        know_j = know_t
    g_j, g_t = jgame.WordleGame(jv, rng=random.Random(3)), tgame.WordleGame(tv, rng=random.Random(3))
    for action in ("crane", "zzzzz", "slate", "moist"):
        g_j, *rj = g_j.next(action)
        g_t, *rt = g_t.next(action)
        assert rt == rj and g_t.filtered == g_j.filtered


def test_blocking_and_frames_match():
    for prompt, completion in (("ab", "abcd"), ("ab", "xbcd"), ("", "q")):
        assert tblock.strip_prompt_from_completion(prompt, completion) == \
            jblock.strip_prompt_from_completion(prompt, completion)
    hist = (tframes.Text("Wordle:\n", False), tframes.Text("c r a n e\n", True))
    assert tframes.text_history_to_str(hist) == "Wordle:\nc r a n e\n"
    th = tframes.TokenHistory.from_text_history(hist, TTok())
    jh = jframes.TokenHistory.from_text_history(
        tuple(jframes.Text(t.text, t.is_action) for t in hist), JTok())
    np.testing.assert_array_equal(th.tokens, jh.tokens)
    np.testing.assert_array_equal(th.is_action, jh.is_action)
    with pytest.raises(AssertionError):
        tframes.TextTrajectory(hist, (1.0, 0.0), True)  # reward on a non-action segment
