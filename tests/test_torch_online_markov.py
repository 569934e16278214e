"""The port's on-device online ILQL over Markov envs
(`loops/online_device.py::online_ilql_markov`) against the JAX package's,
one round on the maze (one trunk; episodes end before the last turn, so
the minibatch count is capped at the live prefix) and one on chess (FEN
observations, a frozen π_β: two trunks).

Both loops start from one ILQL state (`test_torch_online_device.py`'s
`_setup`, d64 L2). The JAX loop's draws are replayed: per round the key
splits into (reset, rollout, train) keys; the reset's draws, the
rollout's Gumbel noise and each epoch's `jax.random.permutation` are
handed to the port. The round metrics other than the loss must be
identical; the loss is held to test_torch_ilql.py's 1e-5 and the
parameters to 2e-6 abs + 1e-4 rel per element, where an element apart must
have a noise-level gradient on the round's first minibatch."""
import copy

import jax
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.loops import online_device as jod
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_torch.algos import ilql as tilql
from lmrl_gym_torch.loops import actor as tactor
from lmrl_gym_torch.loops import online_device as tod
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from test_torch_markov_actor import _trunk, make_envs, markov_noise, maze_reset_draws
from test_torch_online_device import LOSS_TOL, NOISE, PAD, _assert_params_close, _setup
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

ROLLOUT_B, TRAIN_B, N_TURNS = 4, 4, 3


def _replay(key, config, reset_draws, act_len, vocab, env_shape):
    """The JAX loop's per-round draws: its key splits, followed exactly."""
    rounds = []
    n_windows = config.rollout_batch * N_TURNS
    for _ in range(config.n_rounds):
        key, k_reset, k_roll, k_train = jax.random.split(key, 4)
        perms = []
        for _ in range(config.epochs_per_round):
            k_train, k_perm = jax.random.split(k_train)
            perms.append(torch.from_numpy(np.array(jax.random.permutation(k_perm, n_windows))))
        noise = markov_noise(k_roll, N_TURNS, act_len, config.rollout_batch, vocab, env_shape)
        rounds.append(tod.MarkovRoundReplay(reset_draws(k_reset, config.rollout_batch), noise, perms))
    return rounds


@pytest.mark.parametrize("env_name", ["maze", "chess_fen"])
def test_online_ilql_markov_one_round_matches_jax(env_name):
    jenv, tenv, reset_draws, _ = make_envs(env_name)
    if env_name == "maze":  # episodes time out on their second turn: the third is dead
        from lmrl_gym_tpu.envs.maze import vector as jmaze
        from lmrl_gym_torch.envs.maze import vector as tmaze

        kw = dict(maze=np.asarray(jenv.inner.maze), valid_goals=np.asarray(jenv.inner.valid_goals), max_steps=1)
        jenv = jmaze.MazeTokenVecEnv(jmaze.MazeVectorEnv(**kw))
        tenv = tmaze.MazeTokenVecEnv(tmaze.MazeVectorEnv(**kw, device="cpu"))
        reset_draws = lambda key, b: maze_reset_draws(jenv.inner, key, b)  # noqa: E731
    env_shape = None if env_name == "maze" else (ROLLOUT_B, 8)
    (jcfg, jconf, jq, jv, jstate), (tcfg, tconf, tstate) = _setup(dict(beta=4.0, polyak_alpha=0.1))
    kw = dict(n_rounds=1, rollout_batch=ROLLOUT_B, train_bsize=TRAIN_B, epochs_per_round=1, pad_token_id=PAD)
    jconfig, tconfig = jod.OnlineDeviceConfig(**kw), tod.OnlineDeviceConfig(**kw)
    jpi, tpi = (None, None) if env_name == "maze" else _trunk(jcfg, tcfg, 7)
    key = jax.random.PRNGKey(3)
    replay = _replay(key, jconfig, reset_draws, tenv.ACT_LEN, tcfg.padded_vocab_size, env_shape)
    tcore = TCore(tcfg, device="cpu")
    masks = _noise_masks(tcore, tconf, tstate, tenv, tconfig, replay[0], tpi)
    base0 = {k: v.clone() for k, v in tstate.base.params.state_dict().items()}

    jstate, jhist = jod.online_ilql_markov(JCore(jcfg), jq, jv, jstate, jenv, N_TURNS, jconf, jconfig, key,
                                           pi_beta_params=jpi)
    tstate, thist = tod.online_ilql_markov(tcore, tstate, tenv, N_TURNS, tconf, tconfig, pi_beta=tpi, replay=replay)

    assert len(thist) == len(jhist) == 1
    (jm,), (tm,) = jhist, thist
    assert set(tm) == set(jm)
    for k in ("round", "mean_episode_reward", "mean_turns", "illegal_rate"):
        assert tm[k] == jm[k], (k, tm, jm)
    np.testing.assert_allclose(tm["loss"], jm["loss"], **LOSS_TOL)
    n_steps = int(jstate.base.step)
    assert tstate.base.step == n_steps == (2 if env_name == "maze" else 3)  # maze: capped at the live prefix
    assert any(not torch.equal(base0[k], v) for k, v in tstate.base.params.state_dict().items())

    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    _assert_params_close("base", tstate.base.params, params_from_jax(np_tree(jstate.base.params), tcfg), masks["base"])
    _assert_params_close("target_base", tstate.target_base_params,
                         params_from_jax(np_tree(jstate.target_base_params), tcfg), masks["base"])
    for name, group in (("q1_head", "q1"), ("q2_head", "q2"), ("v_head", "v")):
        _assert_params_close(name, getattr(tstate, name).params,
                             head_params_from_jax(np_tree(getattr(jstate, name).params)), masks[group])


def _noise_masks(tcore, tconf, tstate, tenv, config, rep, pi_beta):
    """Per parameter group, the elements whose gradient on the round's first
    minibatch (from a copy of the initial state) is at noise level."""
    state = copy.deepcopy(tstate)
    step_fn, carry = tactor.make_value_guided_step_fn(tcore, config.rollout_batch, two_trunks=pi_beta is not None,
                                                      twin_q=True, beta=tconf.beta,
                                                      total_len=tenv.OBS_LEN + tenv.ACT_LEN)
    policy = {"base": state.base.params, "q1": state.q1_head.params, "q2": state.q2_head.params}
    if pi_beta is not None:
        policy["pi_beta"] = pi_beta
    state0 = tenv.reset(config.rollout_batch, None, rep.reset)
    out, _ = tactor.rollout_markov(tenv, N_TURNS, step_fn, policy, carry, state0, config.temperature, noise=rep.noise)
    batch = tod.markov_rollout_to_ilql_batch(out)
    live = out.turn_live.reshape(-1)
    perm = rep.perms[0][torch.argsort((~live[rep.perms[0]]).to(torch.int8), stable=True)]
    sub = tilql.ILQLBatch(*(x[perm[: config.train_bsize]] for x in batch))
    _, _, grads = tilql.ilql_loss_and_grads(tcore, state, sub, tconf, PAD)
    return {name: {k: g.abs() <= NOISE * g.abs().max() for k, g in group.items()}
            for name, group in zip(("base", "q1", "q2", "v"), grads)}
