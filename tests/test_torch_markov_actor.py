"""The port's Markov actor (`loops/actor.py::rollout_markov`), its ILQL
batch (`loops/online_device.py::markov_rollout_to_ilql_batch`) and the
segmented Wordle rollout against the JAX package's, at d64 L2 on the same
weights. The JAX rollouts' key splits (turn keys → (decode, env) keys →
per-slot decode keys) are replayed into the Gumbel tensors the port's
samplers take. Tokens, rewards, liveness, illegal flags, env states and
every ILQL batch tensor must be identical (tolerance 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.envs.chess import vector as jchess
from lmrl_gym_tpu.envs.maze import grids as jgrids
from lmrl_gym_tpu.envs.maze import vector as jmaze
from lmrl_gym_tpu.envs.wordle import vector as jwordle
from lmrl_gym_tpu.loops import actor as jactor
from lmrl_gym_tpu.loops import online_device as jod
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_torch.envs.chess import vector as tchess
from lmrl_gym_torch.envs.maze import vector as tmaze
from lmrl_gym_torch.envs.wordle import vector as twordle
from lmrl_gym_torch.loops import actor as tactor
from lmrl_gym_torch.loops import online_device as tod
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.interface import LMCore as TCore
from test_torch_actor import _head, _trunk
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

B, N_TURNS = 4, 3


def _np(x):
    return torch.from_numpy(np.array(x))


def markov_noise(key, n_turns, act_len, batch, vocab, env_shape=None):
    """rollout_markov's key splits as draws: per turn (decode, env) keys,
    per action slot a decode key; the env key's Gumbels of `env_shape`."""
    dec, env = [], []
    for turn_key in jax.random.split(key, n_turns):
        kd, ke = jax.random.split(turn_key)
        dec.append(torch.stack([_np(jax.random.gumbel(k, (batch, vocab), jnp.float32))
                                for k in jax.random.split(kd, act_len)]))
        if env_shape is not None:
            env.append(_np(jax.random.gumbel(ke, env_shape, jnp.float32)))
    return tactor.MarkovNoise(torch.stack(dec), torch.stack(env) if env_shape is not None else None)


def maze_reset_draws(env_j, key, batch):
    goal_key, pos_key = jax.random.split(key)
    return tmaze.MazeResetDraws(_np(jax.random.randint(goal_key, (batch,), 0, env_j.valid_goals.shape[0])),
                                _np(jax.random.gumbel(pos_key, (batch, env_j.open_cells.shape[0]), jnp.float32)))


def make_envs(name):
    """(JAX env, port env, the port's reset draws for a key, env-noise shape)."""
    if name == "maze":
        kw = dict(maze=jgrids.double_t_maze(), valid_goals=np.asarray([jgrids.DOUBLE_T_GOAL]), max_steps=8)
        jenv = jmaze.MazeTokenVecEnv(jmaze.MazeVectorEnv(**kw))
        tenv = tmaze.MazeTokenVecEnv(tmaze.MazeVectorEnv(**kw, device="cpu"))
        return jenv, tenv, lambda key, b: maze_reset_draws(jenv.inner, key, b), None
    mode = name.split("_")[1]
    jenv = jchess.ChessEndgameVectorEnv(max_steps=8, obs_mode=mode)
    tenv = tchess.ChessEndgameVectorEnv(max_steps=8, obs_mode=mode, device="cpu")
    return jenv, tenv, lambda key, b: _np(jax.random.randint(key, (3, 8, b), 0, 64)), (B, 8)


def step_fns(tenv, policy, batch=B):
    """JAX and port step functions and parameters on the same weights."""
    W = tenv.OBS_LEN + tenv.ACT_LEN
    cfg_j, cfg_t = jtiny(max_position_embeddings=W), ttiny(max_position_embeddings=W)
    jcore, tcore = JCore(cfg_j), TCore(cfg_t, device="cpu")
    jbase, tbase = _trunk(cfg_j, cfg_t, 0)
    if policy == "lm":
        jstep, jcarry = jactor.make_lm_step_fn(jcore, batch, total_len=W)
        tstep, tcarry = tactor.make_lm_step_fn(tcore, batch, total_len=W)
        return (jstep, jcarry, jbase), (tstep, tcarry, tbase), cfg_t
    jpi, tpi = _trunk(cfg_j, cfg_t, 1)
    jhead, jq1, tq1 = _head(cfg_t, 2)
    _, jq2, tq2 = _head(cfg_t, 3)
    jstep, jcarry = jactor.make_value_guided_step_fn(jcore, jhead, batch, two_trunks=True, twin_q=True, beta=4.0,
                                                      total_len=W)
    tstep, tcarry = tactor.make_value_guided_step_fn(tcore, batch, two_trunks=True, twin_q=True, beta=4.0,
                                                      total_len=W)
    return ((jstep, jcarry, {"pi_beta": jpi, "base": jbase, "q1": jq1, "q2": jq2}),
            (tstep, tcarry, {"pi_beta": tpi, "base": tbase, "q1": tq1, "q2": tq2}), cfg_t)


@pytest.mark.parametrize("env_name,policy,greedy", [
    ("maze", "lm", False),
    ("maze", "guided", True),
    ("chess_fen", "lm", False),
    ("chess_fen", "guided", True),
    ("chess_grid", "guided", False),
])
def test_rollout_markov_and_ilql_batch_match_jax(env_name, policy, greedy):
    jenv, tenv, reset_draws, env_shape = make_envs(env_name)
    (jstep, jcarry, jparams), (tstep, tcarry, tparams), cfg = step_fns(tenv, policy)
    rk, key = jax.random.split(jax.random.PRNGKey(5))
    state_j = jenv.reset(rk, B)
    state_t = tenv.reset(B, None, reset_draws(rk, B))
    temperature = 1.0 if greedy else 3.0
    ref, jfinal = jactor.rollout_markov(jenv, N_TURNS, jstep, jparams, jcarry, state_j, key, temperature, greedy)
    noise = markov_noise(key, N_TURNS, tenv.ACT_LEN, B, cfg.padded_vocab_size, env_shape)
    out, tfinal = tactor.rollout_markov(tenv, N_TURNS, tstep, tparams, tcarry, state_t, temperature, greedy,
                                        noise=noise)
    for f in tactor.MarkovRollout._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for f in type(tfinal)._fields:
        np.testing.assert_array_equal(getattr(tfinal, f).numpy(), np.asarray(getattr(jfinal, f)), err_msg=f)
    live = out.turn_live.numpy()
    assert (live[:, :-1] >= live[:, 1:]).all()
    rewards = {-1.0, 0.0, 1.0} if env_name.startswith("chess") else {0.0, -1.0, -4.0}
    assert set(np.unique(out.turn_reward.numpy()[live])) <= rewards

    jb, tb = jod.markov_rollout_to_ilql_batch(ref), tod.markov_rollout_to_ilql_batch(out)
    for f in ("input_ids", "should_take_action", "rewards", "dones", "next_token_ids", "next_dones"):
        got = getattr(tb, f)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jb, f)), err_msg=f)
        assert not got.is_inference(), f  # autograd may save it


def test_rollout_markov_cache_restarts_each_turn():
    """A turn's decode does not depend on earlier turns' cache contents:
    the second turn of a rollout equals a one-turn rollout from the state
    after the first."""
    _, tenv, _, _ = make_envs("chess_fen")
    _, (tstep, tcarry, tparams), cfg = step_fns(tenv, "lm")
    gen = torch.Generator().manual_seed(0)
    state = tenv.reset(B, gen)
    noise = tactor.MarkovNoise(torch.zeros((2, tenv.ACT_LEN, B, cfg.padded_vocab_size)), torch.rand((2, B, 8),
                                                                                                      generator=gen))
    out, _ = tactor.rollout_markov(tenv, 2, tstep, tparams, tcarry, state, 3.0, noise=noise)
    after = tenv.step(state, out.act_tokens[:, 0], noise=noise.env[0])
    one, _ = tactor.rollout_markov(tenv, 1, tstep, tparams, tcarry, after, 3.0,
                                   noise=tactor.MarkovNoise(noise.decode[1:], noise.env[1:]))
    assert torch.equal(one.obs_tokens[:, 0], out.obs_tokens[:, 1])
    assert torch.equal(one.act_tokens[:, 0], out.act_tokens[:, 1])


@pytest.mark.parametrize("policy", ["lm", "guided"])
def test_rollout_wordle_segmented_matches(policy):
    """The segmented Wordle rollout equals the JAX package's segmented
    rollout and the port's `rollout_wordle` on the same draws."""
    jenv = jwordle.WordleVectorEnv(jwordle.WordleVocab.from_file())
    tenv = twordle.WordleVectorEnv(twordle.WordleVocab.from_file(), device="cpu")
    cfg_j = jtiny(max_position_embeddings=jactor.EPISODE_LEN)
    cfg_t = ttiny(max_position_embeddings=tactor.EPISODE_LEN)
    jcore, tcore = JCore(cfg_j), TCore(cfg_t, device="cpu")
    jbase, tbase = _trunk(cfg_j, cfg_t, 0)
    if policy == "lm":
        jstep, jcarry = jactor.make_lm_step_fn(jcore, B)
        tstep, tcarry = tactor.make_lm_step_fn(tcore, B)
        jparams, tparams = jbase, tbase
    else:  # one trunk: the carry's two caches are one object
        jhead, jq1, tq1 = _head(cfg_t, 2)
        _, jq2, tq2 = _head(cfg_t, 3)
        jstep, jcarry = jactor.make_value_guided_step_fn(jcore, jhead, B, two_trunks=False, twin_q=True, beta=8.0)
        tstep, tcarry = tactor.make_value_guided_step_fn(tcore, B, two_trunks=False, twin_q=True, beta=8.0)
        jparams, tparams = {"base": jbase, "q1": jq1, "q2": jq2}, {"base": tbase, "q1": tq1, "q2": tq2}
    key = jax.random.PRNGKey(5)
    ref = jactor.rollout_wordle_segmented(jenv, jstep, jparams, jcarry, key, jnp.zeros((B,)), 2.0, False)
    dec, envn = [], []
    for turn_key in jax.random.split(key, jactor.N_TRIES):
        kd, ke = jax.random.split(turn_key)
        dec.append(torch.stack([_np(jax.random.gumbel(k, (B, cfg_t.padded_vocab_size), jnp.float32))
                                for k in jax.random.split(kd, 2 * jactor.N_CHARS)]))
        envn.append(_np(jax.random.gumbel(ke, (B, len(tenv.vocab)), jnp.float32)))
    noise = tactor.WordleNoise(torch.stack(dec), torch.stack(envn))
    seg = tactor.rollout_wordle_segmented(tenv, tstep, tparams, tcarry, B, 2.0, noise=noise)
    full = tactor.rollout_wordle(tenv, tstep, tparams, tcarry, B, 2.0, noise=noise)
    for f in ("tokens", "turn_reward", "turn_live", "win", "n_turns"):
        np.testing.assert_array_equal(getattr(seg, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(seg, f).numpy(), getattr(full, f).numpy(), err_msg=f)
