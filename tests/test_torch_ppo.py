"""The port's PPO (`algos/ppo.py`) against the JAX package's, on the CPU:
the KL controllers, `ppo_forward`, the train step with and without the BC
term, and the data path (`make_ppo_forward_fn` → `get_ppo_data_from_chains`
→ `block_ppo_data`) on the same maze chains.

Both packages start from one state (`models/convert.py::
ppo_state_from_jax`). Tolerances are `test_torch_ilql.py`'s: forwards,
losses and log terms within 1e-5; after 3 steps every parameter within
2e-6 abs + 1e-4 rel (elements apart must have a noise-level step-1 JAX
gradient). The data path: tokens, masks and window layout equal exactly;
logprobs, values, advantages, returns and KLs within 1e-4 abs/rel (whitened
advantages divide by a batch std, so the forwards' 1e-6 grows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as JTrainState

from lmrl_gym_tpu.algos import ppo as jppo
from lmrl_gym_tpu.cli.tasks import generate_maze_chains
from lmrl_gym_tpu.core.blocking import BlockingStrategy as JStrategy, Padding as JPad, Truncation as JTrunc
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore, initialize_attn_mask_pos_ids as jmask
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_tpu.text.frames import TokenTrajectoryChain as JTokenChain
from lmrl_gym_torch.algos import ppo as tppo
from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.core.blocking import BlockingStrategy as TStrategy, Padding as TPad, Truncation as TTrunc
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax, ppo_state_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore, initialize_attn_mask_pos_ids as tmask
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.text.frames import TokenTrajectoryChain as TTokenChain
from lmrl_gym_torch.text.tokenizer import ByteTokenizer
from test_torch_ilql import LOSS_TOL, PAD, STEPS, _assert_params_close, _flat
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

TOK = ByteTokenizer()
DATA_TOL = dict(atol=1e-4, rtol=1e-4)
np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731


def _setup(max_pos=128):
    jcfg, tcfg = jtiny(max_position_embeddings=max_pos), ttiny(max_position_embeddings=max_pos)
    vkw = dict(input_dim=jcfg.hidden_size, output_dim=1, bias_init=-1.0)
    jvh = jheads.LinearHead(jheads.LinearHeadConfig(**vkw))
    key = jax.random.PRNGKey(0)
    jstate = jppo.PPOTrainState(
        policy=JTrainState.create(apply_fn=None, params=init_params(jcfg, key), tx=optax.adam(1e-4)),
        value_head=JTrainState.create(apply_fn=None, params=jheads.init_head_params(jvh, jcfg.hidden_size,
                                                                                    jax.random.PRNGKey(1)),
                                      tx=optax.adam(1e-3)),
    )
    tstate = tppo.PPOTrainState(
        policy=topt.TrainState(Transformer(tcfg, device="cpu"), topt.adam(1e-4)),
        value_head=topt.TrainState(theads.LinearHead(theads.LinearHeadConfig(**vkw), device="cpu"), topt.adam(1e-3)),
    )
    ppo_state_from_jax(tstate, tcfg, np_tree(jstate.policy.params), np_tree(jstate.value_head.params))
    return (jcfg, jvh, jstate), (tcfg, tstate)


def test_kl_controllers_match():
    j, t = jppo.AdaptiveKLController(0.2, 6.0, 10000), tppo.AdaptiveKLController(0.2, 6.0, 10000)
    for kl, n in [(1.0, 64), (12.0, 64), (6.5, 128), (0.0, 32), (100.0, 1000)]:
        j.update(kl, n)
        t.update(kl, n)
        assert t.value == j.value
    f = tppo.FixedKLController(0.3)
    f.update(5.0, 10)
    assert f.value == 0.3


def _ppo_batch(b=4, t=12, seed=3, bc=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (b, t)).astype(np.int32)
    ids[1, t - 3:] = PAD
    sta = rng.random((b, t - 1)) < 0.5
    sta[:, 0] = True
    f = lambda s=1.0: (s * rng.standard_normal((b, t - 1))).astype(np.float32)  # noqa: E731
    arrays = dict(input_ids=ids, should_take_action=sta, old_logprobs=f() - 5.5, old_values=f() - 1.0,
                  old_advantages=f(), old_returns=f() - 1.0)
    if bc:
        bids = rng.integers(1, 256, (3, 9)).astype(np.int32)
        bids[0, 6:] = PAD
        arrays.update(bc_input_ids=bids, bc_training_mask=(rng.random((3, 9)) < 0.6).astype(np.float32))
    return (jppo.PPOBatch(**{k: jnp.asarray(a) for k, a in arrays.items()}),
            tppo.PPOBatch(**{k: torch.from_numpy(a) for k, a in arrays.items()}))


def test_ppo_forward_matches():
    (jcfg, jvh, jstate), (tcfg, tstate) = _setup()
    jb, tb = _ppo_batch()
    jm, jp = jmask(jb.input_ids, PAD)
    tm, tp = tmask(tb.input_ids, PAD)
    jl, jv = jppo.ppo_forward(JCore(jcfg), jvh, jstate.policy.params, jstate.value_head.params, jb.input_ids, jm, jp)
    with torch.no_grad():
        tl, tv = tppo.ppo_forward(TCore(tcfg, device="cpu"), tstate.policy.params, tstate.value_head.params,
                                  tb.input_ids, tm, tp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOSS_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **LOSS_TOL)
    np.testing.assert_allclose(tppo.token_logprobs_from_logits(tl, tb.input_ids).numpy(),
                               np.asarray(jppo.token_logprobs_from_logits(jl, jb.input_ids)), **LOSS_TOL)


@pytest.mark.parametrize("bc_weight", [0.0, 0.5])
def test_ppo_step_matches_jax(bc_weight):
    (jcfg, jvh, jstate), (tcfg, tstate) = _setup()
    jb, tb = _ppo_batch(bc=bc_weight > 0)
    jcore, tcore = JCore(jcfg), TCore(tcfg, device="cpu")
    jconf, tconf = jppo.PPOConfig(bc_loss_weight=bc_weight), tppo.PPOConfig(bc_loss_weight=bc_weight)
    jstep = jppo.make_ppo_train_step(jcore, jvh, jconf, PAD)
    tstep = tppo.make_ppo_train_step(tcore, tconf, PAD)

    # step-1 gradients of the JAX loss mark the noise-level elements
    noise_src = jax.grad(lambda p, v: _jax_loss(jcore, jvh, jconf, p, v, jb), argnums=(0, 1))(
        jstate.policy.params, jstate.value_head.params)
    refs = [params_from_jax(np_tree(noise_src[0]), tcfg), head_params_from_jax(np_tree(noise_src[1]))]
    noise = [{k: np.abs(g.numpy()) <= 1e-5 * np.abs(g.numpy()).max() for k, g in ref.items()} for ref in refs]

    for i in range(STEPS):
        jstate, jl, jlogs = jstep(jstate, jb, None)
        tstate, tl, tlogs = tstep(tstate, tb)
        if i == 0:
            np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
            jflat, tflat = _flat(jlogs), _flat(tlogs)
            assert set(jflat) == set(tflat) and (("bc_loss" in tflat) == (bc_weight > 0))
            for k in jflat:
                np.testing.assert_allclose(tflat[k], jflat[k], err_msg=k, **LOSS_TOL)
    _assert_params_close("policy", tstate.policy.params, params_from_jax(np_tree(jstate.policy.params), tcfg), noise[0])
    _assert_params_close("value_head", tstate.value_head.params,
                         head_params_from_jax(np_tree(jstate.value_head.params)), noise[1])


def _jax_loss(jcore, jvh, jconf, policy, vparams, jb):
    m, p = jmask(jb.input_ids, PAD)
    logits, values = jppo.ppo_forward(jcore, jvh, policy, vparams, jb.input_ids, m, p, train=True)
    loss, _ = jppo.ppo_loss(
        attention_mask=m[:, 1:].astype(jnp.float32), logprobs=jppo.token_logprobs_from_logits(logits, jb.input_ids),
        values=values[:, :-1], should_take_action=jb.should_take_action, old_logprobs=jb.old_logprobs,
        old_values=jb.old_values, old_advantages=jb.old_advantages, old_returns=jb.old_returns,
        cliprange_value=jconf.cliprange_value, cliprange=jconf.cliprange, value_loss_coef=jconf.value_loss_coef,
    )
    if jb.bc_input_ids is not None and jconf.bc_loss_weight != 0.0:
        from lmrl_gym_tpu.algos.losses import masked_lm_loss

        bm, bp = jmask(jb.bc_input_ids, PAD)
        bl, _ = jcore.forward(policy, jb.bc_input_ids, bm, bp, train=True)
        bc, _ = masked_lm_loss(bl[:, :-1], jb.bc_input_ids[:, 1:], bm[:, 1:].astype(jnp.float32),
                               jb.bc_training_mask[:, 1:])
        loss = loss + jconf.bc_loss_weight * bc
    return loss


@pytest.mark.parametrize("whiten,kl_weight,max_length", [(True, 0.1, 160), (False, 0.0, 160), (True, 0.05, None)])
def test_ppo_data_path_matches(whiten, kl_weight, max_length):
    (jcfg, jvh, jstate), (tcfg, tstate) = _setup(max_pos=256)
    text_chains = generate_maze_chains(4, seed=2, p_optimal=0.5)
    jchains = [JTokenChain.from_text_trajectory_chain(c, TOK) for c in text_chains]
    tchains = [TTokenChain.from_text_trajectory_chain(c, TOK) for c in text_chains]
    # the initial policy differs from the current one, so the KL terms are live
    jinit = jax.tree.map(lambda x: x * 1.01, jstate.policy.params)
    tinit = Transformer(tcfg, device="cpu")
    tinit.load_state_dict(params_from_jax(np_tree(jinit), tcfg))
    jfwd = jppo.make_ppo_forward_fn(JCore(jcfg), jvh, jinit, jstate.policy.params, jstate.value_head.params, PAD)
    tfwd = tppo.make_ppo_forward_fn(TCore(tcfg, device="cpu"), tinit, tstate.policy.params,
                                    tstate.value_head.params, PAD)
    kw = dict(gamma=0.99, lam=0.95, kl_weight=kl_weight, use_advantage_whitening=whiten)
    jd, jk = jppo.get_ppo_data_from_chains(jfwd, TOK, jchains, 8, max_length, **kw)
    td, tk = tppo.get_ppo_data_from_chains(tfwd, TOK, tchains, 8, max_length, **kw)
    assert len(jd) == len(td) > 8
    np.testing.assert_allclose(tk, jk, **DATA_TOL)
    assert tk.dtype == jk.dtype
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b.input_ids, a.input_ids)
        np.testing.assert_array_equal(b.should_take_action, a.should_take_action)
        for f in ("old_logprobs", "old_values", "old_advantages", "old_returns"):
            assert getattr(b, f).dtype == getattr(a, f).dtype, f
            np.testing.assert_allclose(getattr(b, f), getattr(a, f), err_msg=f, **DATA_TOL)
    L = max_length or max(len(d.input_ids) for d in jd)
    jblk = jppo.block_ppo_data(jd, JStrategy(JPad.RIGHT, JTrunc.RIGHT, L), PAD)
    tblk = tppo.block_ppo_data(td, TStrategy(TPad.RIGHT, TTrunc.RIGHT, L), PAD)
    assert set(jblk) == set(tblk)
    for k in jblk:
        assert tblk[k].dtype == jblk[k].dtype and tblk[k].shape == jblk[k].shape, k
        np.testing.assert_allclose(tblk[k], jblk[k], err_msg=k, **DATA_TOL)


def test_fold_and_combined_chain_match():
    from lmrl_gym_tpu.text.frames import Text, TextTrajectory

    hist = (Text("obs one\n", False), Text("move up\n", True), Text("obs two is long\n", False),
            Text("move left\n", True), Text("obs three\n", False), Text("move down\n", True))
    traj = TextTrajectory(hist, (0.0, -1.0, 0.0, -1.0, 0.0, -4.0), True)
    for max_length in (200, 30, 10):
        j = jppo.fold_trajectory_to_length(traj, TOK, max_length, gamma=0.9)
        t = tppo.fold_trajectory_to_length(traj, TOK, max_length, gamma=0.9)
        assert [(x.text, x.is_action) for x in t.text_history] == [(x.text, x.is_action) for x in j.text_history]
        assert t.reward == j.reward and t.done == j.done
    chain = generate_maze_chains(1, seed=4)[0]
    jc = jppo.CombinedChain.from_chain(JTokenChain.from_text_trajectory_chain(chain, TOK))
    tc = tppo.CombinedChain.from_chain(TTokenChain.from_text_trajectory_chain(chain, TOK))
    for f in ("input_tokens", "output_tokens", "rewards", "should_take_action", "done"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert tc.chunk_lens == jc.chunk_lens
    for x, y in zip(jppo.action_state_next_state_idxs(jc.should_take_action),
                    tppo.action_state_next_state_idxs(tc.should_take_action)):
        np.testing.assert_array_equal(y, x)
