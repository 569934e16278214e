"""The port's vectorized Wordle env and fused actor against the JAX package.

Both sides get the same weights and the same random draws: the JAX
rollout's key splits (turn keys → (decode, env) keys → per-slot decode
keys) are replayed into Gumbel tensors that the port's samplers take
directly. Token streams, rewards, liveness, wins and turn counts must then
be identical; the env state must match exactly (integer state).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.envs.wordle import vector as jvec
from lmrl_gym_tpu.loops import actor as jactor
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtr
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_torch.envs.wordle import vector as tvec
from lmrl_gym_torch.loops import actor as tactor
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models import transformer as ttr
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

B = 4
STATE_FIELDS = ("knowledge", "guess_hist", "n_guesses", "last_invalid", "done", "reward")


@pytest.fixture(scope="module")
def envs():
    return (
        jvec.WordleVectorEnv(jvec.WordleVocab.from_file()),
        tvec.WordleVectorEnv(tvec.WordleVocab.from_file(), device="cpu"),
    )


def _gumbel(key, shape):
    return torch.from_numpy(np.array(jax.random.gumbel(key, shape, jnp.float32)))


def _assert_state_equal(ts, js):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)


def test_vocab_tables_match(envs):
    jenv, tenv = envs
    assert tenv.vocab.words == jenv.vocab.words
    np.testing.assert_array_equal(tenv.vocab_chars.numpy(), np.asarray(jenv.vocab_chars))
    np.testing.assert_array_equal(tenv.vocab_has.numpy(), np.asarray(jenv.vocab_has))


def test_env_step_and_consistent_mask_match(envs):
    """Seven steps of 16 games: random vocab words, invalid (valid=False)
    and out-of-vocab guesses; done games freeze."""
    jenv, tenv = envs
    n = 16
    rng = np.random.default_rng(0)
    js, ts = jvec.initial_state(n), tvec.initial_state(n, "cpu")
    key = jax.random.PRNGKey(3)
    V = len(jenv.vocab)
    for step in range(7):
        key, k = jax.random.split(key)
        guess = jenv.vocab.chars[rng.integers(0, V, n)].copy()
        oov = rng.random(n) < 0.2
        guess[oov] = rng.integers(0, 26, (int(oov.sum()), 5))
        valid = rng.random(n) > 0.15
        np.testing.assert_array_equal(
            tvec.consistent_mask(ts.knowledge, tenv.vocab_chars, tenv.vocab_has).numpy(),
            np.asarray(jvec.consistent_mask(js.knowledge, jenv.vocab_chars, jenv.vocab_has)),
        )
        js, jfb = jenv.step(js, jnp.asarray(guess), jnp.asarray(valid), k)
        ts, tfb = tenv.step(ts, torch.from_numpy(guess), torch.from_numpy(valid), gumbel=_gumbel(k, (n, V)))
        np.testing.assert_array_equal(tfb.numpy(), np.asarray(jfb))
        _assert_state_equal(ts, js)
    assert bool(ts.done.all())  # 7 > N_TRIES: every game froze at some point
    assert bool((ts.reward == 0).all())  # frozen games report no reward

    key, k = jax.random.split(key)
    fresh_j, fresh_t = jvec.initial_state(n), tvec.initial_state(n, "cpu")
    jg = jenv.random_consistent_guess(fresh_j, k)
    tg = tenv.random_consistent_guess(fresh_t, gumbel=_gumbel(k, (n, V)))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def _noise(key, V, V_words):
    """Replay rollout_wordle's key splits as Gumbel draws."""
    dec, env = [], []
    for turn_key in jax.random.split(key, jactor.N_TRIES):
        kd, ke = jax.random.split(turn_key)
        dec.append(torch.stack([_gumbel(k, (B, V)) for k in jax.random.split(kd, 2 * jactor.N_CHARS)]))
        env.append(_gumbel(ke, (B, V_words)))
    return tactor.WordleNoise(decode=torch.stack(dec), env=torch.stack(env))


def _trunk(cfg_j, cfg_t, seed):
    jp = jtr.init_params(cfg_j, jax.random.PRNGKey(seed))
    model = ttr.Transformer(cfg_t, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), cfg_t))
    return jp, model


def _head(cfg, seed):
    kw = dict(input_dim=cfg.hidden_size, hidden_dim=2 * cfg.hidden_size, output_dim=cfg.padded_vocab_size)
    jhead = jheads.MLPHead(jheads.MLPHeadConfig(**kw))
    jp = jheads.init_head_params(jhead, cfg.hidden_size, jax.random.PRNGKey(seed))
    head = theads.MLPHead(theads.MLPHeadConfig(**kw), device="cpu")
    head.load_state_dict(head_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jhead, jp, head


@pytest.mark.parametrize(
    "policy,constrain_vocab,greedy",
    [
        ("lm", False, True),
        ("lm", True, True),
        ("guided", False, True),
        ("guided", True, True),
        ("guided", True, False),  # sampled, on replayed noise
    ],
)
def test_rollout_wordle_matches_jax(envs, policy, constrain_vocab, greedy):
    jenv, tenv = envs
    cfg_j = jtiny(max_position_embeddings=jactor.EPISODE_LEN)
    cfg_t = ttiny(max_position_embeddings=tactor.EPISODE_LEN)
    jcore, tcore = JCore(cfg_j), TCore(cfg_t, device="cpu")
    jbase, tbase = _trunk(cfg_j, cfg_t, 0)
    if policy == "lm":
        jstep, jcarry = jactor.make_lm_step_fn(jcore, B)
        tstep, tcarry = tactor.make_lm_step_fn(tcore, B)
        jparams, tparams = jbase, tbase
    else:
        jpi, tpi = _trunk(cfg_j, cfg_t, 1)
        jhead, jq1, tq1 = _head(cfg_t, 2)
        _, jq2, tq2 = _head(cfg_t, 3)
        jstep, jcarry = jactor.make_value_guided_step_fn(jcore, jhead, B, two_trunks=True, twin_q=True, beta=8.0)
        tstep, tcarry = tactor.make_value_guided_step_fn(tcore, B, two_trunks=True, twin_q=True, beta=8.0)
        jparams = {"pi_beta": jpi, "base": jbase, "q1": jq1, "q2": jq2}
        tparams = {"pi_beta": tpi, "base": tbase, "q1": tq1, "q2": tq2}

    key = jax.random.PRNGKey(7)
    temperature = 1.0 if greedy else 2.0
    ref = jactor.rollout_wordle(
        jenv, jstep, jparams, jcarry, key, jnp.zeros((B,)), temperature, greedy, constrain_vocab=constrain_vocab
    )
    out = tactor.rollout_wordle(
        tenv, tstep, tparams, tcarry, B, temperature, greedy, constrain_vocab,
        noise=_noise(key, cfg_t.padded_vocab_size, len(tenv.vocab)),
    )
    for f in ("tokens", "turn_reward", "turn_live", "win", "n_turns"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(out.token_rewards().numpy(), np.asarray(ref.token_rewards()))
    np.testing.assert_array_equal(out.token_action_mask().numpy(), np.asarray(ref.token_action_mask()))
    if constrain_vocab:  # every decoded guess of a live turn is a vocab word
        words = set(tenv.vocab.words)
        for b in range(B):
            for t in range(int(out.n_turns[b])):
                off = len(tactor.HEADER) + t * tactor.TURN_LEN
                assert bytes(out.tokens[b, off:off + 10:2].tolist()).decode() in words


def test_layout_helpers_match():
    np.testing.assert_array_equal(tactor.episode_is_action_mask(), jactor.episode_is_action_mask())
    np.testing.assert_array_equal(tactor.action_end_positions(), jactor.action_end_positions())
    assert (tactor.HEADER, tactor.EPISODE_LEN, tactor.TURN_LEN) == (jactor.HEADER, jactor.EPISODE_LEN, jactor.TURN_LEN)
