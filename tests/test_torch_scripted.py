"""The port's scripted behavior rollout and the rest of its vectorized Wordle
env against the JAX package.

The JAX draws are replayed, never matched by seed: per turn the rollout
splits its key into (consistent guess, random index, mixture uniform, env
target) keys, and the Gumbel, `randint` and `uniform` values they give are
handed to the port. Everything compared is integer or exact float state, so
the tolerance is zero: tokens, rewards, liveness, wins, turn counts and the
env state must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.envs.wordle import vector as jvec
from lmrl_gym_tpu.loops import actor as jactor
from lmrl_gym_torch.envs.wordle import vector as tvec
from lmrl_gym_torch.loops import actor as tactor

B = 64
STATE_FIELDS = ("knowledge", "guess_hist", "n_guesses", "last_invalid", "done", "reward")


@pytest.fixture(scope="module")
def envs():
    return (
        jvec.WordleVectorEnv(jvec.WordleVocab.from_file()),
        tvec.WordleVectorEnv(tvec.WordleVocab.from_file(), device="cpu"),
    )


def _np(x):
    return torch.from_numpy(np.array(x))


def _scripted_noise(key, V):
    """Replay rollout_wordle_scripted's per-turn key splits."""
    guess, idx, uni, env = [], [], [], []
    for tk in jax.random.split(key, jactor.N_TRIES):
        kg, kr, km, ke = jax.random.split(tk, 4)
        guess.append(_np(jax.random.gumbel(kg, (B, V), jnp.float32)))
        idx.append(_np(jax.random.randint(kr, (B,), 0, V)))
        uni.append(_np(jax.random.uniform(km, (B,))))
        env.append(_np(jax.random.gumbel(ke, (B, V), jnp.float32)))
    return tactor.ScriptedNoise(*(torch.stack(x) for x in (guess, idx, uni, env)))


def _assert_state_equal(ts, js):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("p_smart,p_repeat", [(1.0, 0.0), (0.66, 0.0), (0.66, 0.24)])
def test_rollout_wordle_scripted_matches_jax(envs, p_smart, p_repeat):
    jenv, tenv = envs
    key = jax.random.PRNGKey(11)
    ref = jactor.rollout_wordle_scripted(jenv, key, jnp.zeros((B,)), p_smart, p_repeat)
    out = tactor.rollout_wordle_scripted(tenv, B, p_smart, p_repeat, noise=_scripted_noise(key, len(tenv.vocab)))
    for f in ("tokens", "turn_reward", "turn_live", "win", "n_turns"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(out.token_rewards().numpy(), np.asarray(ref.token_rewards()))
    np.testing.assert_array_equal(out.token_action_mask().numpy(), np.asarray(ref.token_action_mask()))
    # every scripted guess is a vocab word
    words = set(tenv.vocab.words)
    for b in range(B):
        for t in range(int(out.n_turns[b])):
            off = len(tactor.HEADER) + t * tactor.TURN_LEN
            assert bytes(out.tokens[b, off:off + 10:2].tolist()).decode() in words


def test_rollout_wordle_scripted_draws_from_generator(envs):
    _, tenv = envs
    runs = [tactor.rollout_wordle_scripted(tenv, B, 0.66, 0.24, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)  # one seed, one stream
    other = tactor.rollout_wordle_scripted(tenv, B, 0.66, 0.24, generator=torch.Generator().manual_seed(4))
    assert not torch.equal(runs[0].tokens, other.tokens)


def test_rollout_wordle_scripted_rejects_mixture_above_one(envs):
    _, tenv = envs
    with pytest.raises(ValueError, match="at most 1"):
        tactor.rollout_wordle_scripted(tenv, 4, 0.8, 0.3)


def _random_state(jenv, tenv, seed):
    """A mid-game batch after four turns: consistent guesses on even rows
    (most of them won by then), random words on odd rows, some invalid."""
    rng = np.random.default_rng(seed)
    js, ts = jvec.initial_state(B), tvec.initial_state(B, "cpu")
    key = jax.random.PRNGKey(seed)
    V = len(jenv.vocab)
    even = (np.arange(B) % 2 == 0)[:, None]
    for _ in range(4):
        key, k, kg = jax.random.split(key, 3)
        smart = np.asarray(jenv.random_consistent_guess(js, kg))
        np.testing.assert_array_equal(
            tenv.random_consistent_guess(ts, gumbel=_np(jax.random.gumbel(kg, (B, V), jnp.float32))).numpy(), smart)
        guess = np.where(even, smart, jenv.vocab.chars[rng.integers(0, V, B)])
        valid = rng.random(B) > 0.1
        js, _ = jenv.step(js, jnp.asarray(guess), jnp.asarray(valid), k)
        ts, _ = tenv.step(ts, torch.from_numpy(guess), torch.from_numpy(valid),
                          gumbel=_np(jax.random.gumbel(k, (B, V), jnp.float32)))
    _assert_state_equal(ts, js)
    return js, ts


def test_auto_reset_matches_jax(envs):
    jenv, tenv = envs
    js, ts = _random_state(jenv, tenv, 0)
    assert 0 < int(ts.done.sum()) < B  # some games done, some live
    _assert_state_equal(tenv.auto_reset(ts), jenv.auto_reset(js))
    _assert_state_equal(tenv.reset(B), jenv.reset(B))


def test_rollout_episodes_matches_jax(envs):
    jenv, tenv = envs
    key = jax.random.PRNGKey(5)
    V = len(tenv.vocab)
    gg, eg = [], []
    for tk in jax.random.split(key, jvec.N_TRIES):
        gk, sk = jax.random.split(tk)
        gg.append(_np(jax.random.gumbel(gk, (B, V), jnp.float32)))
        eg.append(_np(jax.random.gumbel(sk, (B, V), jnp.float32)))
    jstate, jtotal, jwins = jenv.rollout_episodes(key, jvec.initial_state(B))
    tstate, ttotal, twins = tenv.rollout_episodes(B, guess_gumbel=torch.stack(gg), env_gumbel=torch.stack(eg))
    _assert_state_equal(tstate, jstate)
    np.testing.assert_array_equal(ttotal.numpy(), np.asarray(jtotal))
    np.testing.assert_array_equal(twins.numpy(), np.asarray(jwins))
    assert bool(twins.any())


def test_transition_knowledge_and_render_feedback_match_jax(envs):
    """Per game against the JAX single-env functions, and batched."""
    jenv, tenv = envs
    js, ts = _random_state(jenv, tenv, 1)
    rng = np.random.default_rng(2)
    V = len(jenv.vocab)
    guess = jenv.vocab.chars[rng.integers(0, V, B)].astype(np.int32)
    guess[:8] = rng.integers(0, 26, (8, 5))  # letters repeated within a guess
    target = jenv.vocab.chars[rng.integers(0, V, B)].astype(np.int32)
    jk = jax.vmap(jvec.transition_knowledge)(js.knowledge, jnp.asarray(guess), jnp.asarray(target))
    jf = jax.vmap(jvec.render_feedback)(jk, jnp.asarray(guess))
    tk = tvec.transition_knowledge(ts.knowledge, torch.from_numpy(guess), torch.from_numpy(target))
    tf = tvec.render_feedback(tk, torch.from_numpy(guess))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for b in range(4):  # one game, no batch dims
        k1 = tvec.transition_knowledge(ts.knowledge[b], torch.from_numpy(guess[b]), torch.from_numpy(target[b]))
        np.testing.assert_array_equal(k1.numpy(), np.asarray(jvec.transition_knowledge(
            js.knowledge[b], jnp.asarray(guess[b]), jnp.asarray(target[b]))))
        np.testing.assert_array_equal(tvec.render_feedback(k1, torch.from_numpy(guess[b])).numpy(), np.asarray(jf[b]))
    assert tvec.decode_word(tvec.encode_word("crane")) == jvec.decode_word(jvec.encode_word("crane")) == "crane"
