"""The port's on-device online ILQL loop on Wordle against the JAX package's.

Both packages start from one ILQL state (the JAX `init_ilql_state` carried
into the port with `models/convert.py::ilql_state_from_jax`) on
`tiny_test_config`. The JAX loop's draws are replayed: per round the key
splits into (rollout, train) keys; the rollout's Gumbel noise and each
epoch's `jax.random.permutation` are handed to the port.

- The rollout → ILQL batch conversion must be exact.
- Two rounds: the round metrics other than the loss (mean episode return,
  win rate, mean turns) must be identical, so the second round's rollout,
  which decodes with the weights the first round trained, gives the same
  token stream. The loss is held to test_torch_ilql.py's loss tolerance
  (1e-5 abs/rel) and the parameters after both rounds to its parameter
  tolerance (2e-6 abs + 1e-4 rel per element, where an element apart must
  have a noise-level first-step gradient: Adam steps such an element by
  about ±lr in either direction).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lmrl_gym_tpu.algos import ilql as jilql
from lmrl_gym_tpu.envs.wordle import vector as jvec
from lmrl_gym_tpu.loops import actor as jactor
from lmrl_gym_tpu.loops import online_device as jod
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_torch.algos import ilql as tilql
from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.envs.wordle import vector as tvec
from lmrl_gym_torch.loops import actor as tactor
from lmrl_gym_torch.loops import online_device as tod
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import head_params_from_jax, ilql_state_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.models.transformer import Transformer

PAD = 256
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL, PARAM_RTOL = 2e-6, 1e-4
NOISE = 1e-5  # a gradient element below this share of its tensor's largest is noise
ROLLOUT_B, TRAIN_B, ROUNDS = 8, 4, 2


def _np(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def envs():
    return (
        jvec.WordleVectorEnv(jvec.WordleVocab.from_file()),
        tvec.WordleVectorEnv(tvec.WordleVocab.from_file(), device="cpu"),
    )


def test_wordle_rollout_to_ilql_batch_exact(envs):
    jenv, tenv = envs
    B, V = 16, len(tenv.vocab)
    key = jax.random.PRNGKey(4)
    guess, idx, uni, env = [], [], [], []
    for tk in jax.random.split(key, jactor.N_TRIES):
        kg, kr, km, ke = jax.random.split(tk, 4)
        guess.append(_np(jax.random.gumbel(kg, (B, V), jnp.float32)))
        idx.append(_np(jax.random.randint(kr, (B,), 0, V)))
        uni.append(_np(jax.random.uniform(km, (B,))))
        env.append(_np(jax.random.gumbel(ke, (B, V), jnp.float32)))
    noise = tactor.ScriptedNoise(*(torch.stack(x) for x in (guess, idx, uni, env)))
    ref = jod.wordle_rollout_to_ilql_batch(jactor.rollout_wordle_scripted(jenv, key, jnp.zeros((B,)), 0.66, 0.0))
    out = tod.wordle_rollout_to_ilql_batch(tactor.rollout_wordle_scripted(tenv, B, 0.66, 0.0, noise=noise))
    for f in ("input_ids", "should_take_action", "rewards", "dones"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
        assert not getattr(out, f).is_inference(), f  # autograd may save it
    assert out.next_token_ids is None and out.next_dones is None


def _rollout_noise(key, B, V, V_words):
    """Replay rollout_wordle's key splits (unconstrained decode) as Gumbel draws."""
    dec, env = [], []
    for turn_key in jax.random.split(key, jactor.N_TRIES):
        kd, ke = jax.random.split(turn_key)
        dec.append(torch.stack([_np(jax.random.gumbel(k, (B, V), jnp.float32))
                                for k in jax.random.split(kd, 2 * jactor.N_CHARS)]))
        env.append(_np(jax.random.gumbel(ke, (B, V_words), jnp.float32)))
    return tactor.WordleNoise(decode=torch.stack(dec), env=torch.stack(env))


def _replay(key, config, V, V_words):
    """The JAX loop's per-round draws: its key splits, followed exactly."""
    rounds = []
    n = config.rollout_batch // config.train_bsize
    for _ in range(config.n_rounds):
        key, k_roll, k_train = jax.random.split(key, 3)
        perms = []
        for _ in range(config.epochs_per_round):
            k_train, k_perm = jax.random.split(k_train)
            perms.append(_np(jax.random.permutation(k_perm, config.rollout_batch)))
            for _ in range(n):
                k_train, _ = jax.random.split(k_train)
        rounds.append(tod.RoundReplay(_rollout_noise(k_roll, config.rollout_batch, V, V_words), perms))
    return rounds


def _setup(ilql_kw):
    jcfg, tcfg = jtiny(), ttiny()
    jconf, tconf = jilql.ILQLConfig(**ilql_kw), tilql.ILQLConfig(**ilql_kw)
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 4)
    qkw = dict(input_dim=jcfg.hidden_size, hidden_dim=2 * jcfg.hidden_size, output_dim=jcfg.padded_vocab_size)
    vkw = dict(qkw, output_dim=1)
    jq, jv = jheads.MLPHead(jheads.MLPHeadConfig(**qkw)), jheads.MLPHead(jheads.MLPHeadConfig(**vkw))
    jstate = jilql.init_ilql_state(
        init_params(jcfg, key),
        jheads.init_head_params(jq, jcfg.hidden_size, ks[0]),
        jheads.init_head_params(jq, jcfg.hidden_size, ks[1]),
        jheads.init_head_params(jv, jcfg.hidden_size, ks[2]),
        optax.adam(1e-4), optax.adam(1e-3), jconf,
    )
    tq, tv = theads.MLPHeadConfig(**qkw), theads.MLPHeadConfig(**vkw)
    tstate = tilql.init_ilql_state(
        Transformer(tcfg, device="cpu"),
        theads.MLPHead(tq, device="cpu"), theads.MLPHead(tq, device="cpu"), theads.MLPHead(tv, device="cpu"),
        topt.adam(1e-4), topt.adam(1e-3), tconf,
    )
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    ilql_state_from_jax(
        tstate, tcfg, np_tree(jstate.base.params), np_tree(jstate.target_base_params),
        np_tree(jstate.q1_head.params), np_tree(jstate.q2_head.params), np_tree(jstate.v_head.params),
        np_tree(jstate.q1_target_params), np_tree(jstate.q2_target_params),
    )
    return (jcfg, jconf, jq, jv, jstate), (tcfg, tconf, tstate)


def _noise_masks(tcore, tconf, tstate, tenv, config, replay0):
    """Per parameter group, the elements whose first-step gradient is at
    noise level (from a copy of the initial state on round 1's first
    minibatch)."""
    state = copy.deepcopy(tstate)
    step_fn, carry = tactor.make_value_guided_step_fn(tcore, config.rollout_batch, two_trunks=False, twin_q=True,
                                                      beta=tconf.beta)
    policy = {"base": state.base.params, "q1": state.q1_head.params, "q2": state.q2_head.params}
    out = tactor.rollout_wordle(tenv, step_fn, policy, carry, config.rollout_batch, config.temperature,
                                noise=replay0.noise)
    batch = tod.wordle_rollout_to_ilql_batch(out)
    idx = replay0.perms[0][: config.train_bsize]
    sub = tilql.ILQLBatch(*(None if x is None else x[idx] for x in batch))
    _, _, grads = tilql.ilql_loss_and_grads(tcore, state, sub, tconf, PAD)
    return {name: {k: g.abs() <= NOISE * g.abs().max() for k, g in group.items()}
            for name, group in zip(("base", "q1", "q2", "v"), grads)}


def _assert_params_close(name, got: torch.nn.Module, ref: dict, noise: dict):
    for k, t in got.state_dict().items():
        a, b = t.numpy(), ref[k].numpy()
        apart = np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b)
        if apart.any():
            print(f"{name}.{k}: {int(apart.sum())} of {apart.size} elements apart, max {np.abs(a - b).max():.3e}")
        assert not (apart & ~noise[k].numpy()).any(), f"{name}.{k}: elements apart where the gradient is not noise"


def test_online_ilql_wordle_two_rounds_match_jax(envs):
    jenv, tenv = envs
    (jcfg, jconf, jq, jv, jstate), (tcfg, tconf, tstate) = _setup(dict(beta=8.0, polyak_alpha=0.1))
    kw = dict(n_rounds=ROUNDS, rollout_batch=ROLLOUT_B, train_bsize=TRAIN_B, epochs_per_round=1, pad_token_id=PAD)
    jconfig, tconfig = jod.OnlineDeviceConfig(**kw), tod.OnlineDeviceConfig(**kw)
    key = jax.random.PRNGKey(9)
    replay = _replay(key, jconfig, tcfg.padded_vocab_size, len(tenv.vocab))
    tcore = TCore(tcfg, device="cpu")
    noise = _noise_masks(tcore, tconf, tstate, tenv, tconfig, replay[0])
    base0 = {k: v.clone() for k, v in tstate.base.params.state_dict().items()}

    jstate, jhist = jod.online_ilql_wordle(JCore(jcfg), jq, jv, jstate, jenv, jconf, jconfig, key)
    tstate, thist = tod.online_ilql_wordle(tcore, tstate, tenv, tconf, tconfig, replay=replay)

    assert len(thist) == len(jhist) == ROUNDS
    for jm, tm in zip(jhist, thist):
        assert set(tm) == set(jm)
        for k in ("round", "mean_episode_reward", "win_rate", "mean_turns"):
            assert tm[k] == jm[k], (k, tm, jm)
        np.testing.assert_allclose(tm["loss"], jm["loss"], **LOSS_TOL)
        assert np.isfinite(tm["loss"])
    assert tstate.base.step == int(jstate.base.step) == ROUNDS * ROLLOUT_B // TRAIN_B
    assert any(not torch.equal(base0[k], v) for k, v in tstate.base.params.state_dict().items())

    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    _assert_params_close("base", tstate.base.params, params_from_jax(np_tree(jstate.base.params), tcfg),
                         noise["base"])
    _assert_params_close("target_base", tstate.target_base_params,
                         params_from_jax(np_tree(jstate.target_base_params), tcfg), noise["base"])
    for name, group in (("q1_head", "q1"), ("q2_head", "q2"), ("v_head", "v")):
        _assert_params_close(name, getattr(tstate, name).params,
                             head_params_from_jax(np_tree(getattr(jstate, name).params)), noise[group])
    for name, group in (("q1_target_params", "q1"), ("q2_target_params", "q2")):
        _assert_params_close(name, getattr(tstate, name), head_params_from_jax(np_tree(getattr(jstate, name))),
                             noise[group])


def test_online_ilql_wordle_draws_from_generator(envs):
    """Without replay the loop draws from the generator it is given; one
    round on a fresh state, finite loss, the trunk trained in place."""
    _, tenv = envs
    _, (tcfg, tconf, tstate) = _setup(dict(beta=8.0))
    base = tstate.base.params
    w0 = base.wte.weight.clone()
    config = tod.OnlineDeviceConfig(n_rounds=1, rollout_batch=4, train_bsize=4, pad_token_id=PAD)
    state, hist = tod.online_ilql_wordle(TCore(tcfg, device="cpu"), tstate, tenv, tconf, config,
                                         generator=torch.Generator().manual_seed(0))
    assert state.base.params is base and not torch.equal(base.wte.weight, w0)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"]) and -6.0 <= hist[0]["mean_episode_reward"] <= 0.0
