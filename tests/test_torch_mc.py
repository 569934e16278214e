"""The port's MC-returns train step against the JAX package's, on the CPU.

Both packages start from one state (JAX parameters carried over with
`models/convert.py::mc_state_from_jax`). Batches are `test_torch_ilql.py`'s
windows with a reward-to-go on each action token. Tolerances are
`test_torch_ilql.py`'s: step 1's loss and log terms within 1e-5, gradients
within 1e-4 abs/rel; after 3 steps every parameter within 2e-6 abs + 1e-4
rel (elements apart must have a noise-level step-1 JAX gradient).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as JTrainState

import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_tpu.algos import mc as jmc
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_torch.algos import mc as tmc
from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.core.logs import detach_logs
from lmrl_gym_torch.core.optimizer import value_and_grads
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import head_params_from_jax, mc_state_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.models.transformer import Transformer
from test_torch_ilql import GRAD_TOL, LOSS_TOL, PAD, STEPS, _assert_params_close, _flat, _txs
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
CASES = {"default": dict(), "grad_accum_2": dict(grad_accum=2), "cql_weight_0": dict(cql_weight=0.0)}


def _setup(grad_accum=1, cql_weight=0.01):
    jcfg, tcfg = jtiny(), ttiny()
    jconf, tconf = jmc.MCConfig(cql_weight=cql_weight), tmc.MCConfig(cql_weight=cql_weight)
    key = jax.random.PRNGKey(0)
    qkw = dict(input_dim=jcfg.hidden_size, hidden_dim=2 * jcfg.hidden_size, output_dim=jcfg.padded_vocab_size)
    jq = jheads.MLPHead(jheads.MLPHeadConfig(**qkw))
    jbase_tx, jhead_tx = _txs(optax, "adam", grad_accum)
    jstate = jmc.MCTrainState(
        base=JTrainState.create(apply_fn=None, params=init_params(jcfg, key), tx=jbase_tx),
        q_head=JTrainState.create(apply_fn=None, params=jheads.init_head_params(jq, jcfg.hidden_size,
                                                                                jax.random.PRNGKey(1)), tx=jhead_tx),
    )
    tbase_tx, thead_tx = _txs(topt, "adam", grad_accum)
    tstate = tmc.MCTrainState(
        base=topt.TrainState(Transformer(tcfg, device="cpu"), tbase_tx),
        q_head=topt.TrainState(theads.MLPHead(theads.MLPHeadConfig(**qkw), device="cpu"), thead_tx),
    )
    mc_state_from_jax(tstate, tcfg, np_tree(jstate.base.params), np_tree(jstate.q_head.params))
    return (jcfg, jconf, jq, jstate), (tcfg, tconf, tstate)


def _batch(b=4, t=12, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (b, t)).astype(np.int32)
    ids[1, t - 3:] = PAD
    sta = rng.random((b, t - 1)) < 0.4
    sta[:, 0] = True
    returns = np.where(sta, -rng.uniform(0.0, 5.0, sta.shape), 0.0).astype(np.float32)
    arrays = dict(input_ids=ids, should_take_action=sta, returns=returns)
    return (jmc.MCBatch(**{k: jnp.asarray(a) for k, a in arrays.items()}),
            tmc.MCBatch(**{k: torch.from_numpy(a) for k, a in arrays.items()}))


def _run_case(case, T=12):
    (jcfg, jconf, jq, jstate), (tcfg, tconf, tstate) = _setup(**CASES[case])
    jbatch, tbatch = _batch(t=T)
    jcore, tcore = JCore(jcfg), TCore(tcfg, device="cpu")

    def loss_fn(b, q):
        return jmc.mc_loss_from_params(jcore, jq, b, q, jbatch, jconf, PAD, train=True, rng=None)

    (jloss, jlogs), jgrads = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        jstate.base.params, jstate.q_head.params)
    tloss, tlogs = tmc.mc_loss_from_params(tcore, tstate.base.params, tstate.q_head.params, tbatch, tconf, PAD,
                                           train=True)
    tgrads = value_and_grads(tloss, (tstate.base.params, tstate.q_head.params))
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    jflat, tflat = _flat(jlogs), _flat(detach_logs(tlogs))
    assert set(jflat) == set(tflat)
    for name in jflat:
        np.testing.assert_allclose(tflat[name], jflat[name], err_msg=name, **LOSS_TOL)
    refs = [params_from_jax(np_tree(jgrads[0]), tcfg), head_params_from_jax(np_tree(jgrads[1]))]
    for group, got, ref in zip(("base", "q"), tgrads, refs):
        assert set(got) == set(ref), group
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), err_msg=f"{group}.{k}", **GRAD_TOL)
    noise = [{k: np.abs(g.numpy()) <= 1e-5 * np.abs(g.numpy()).max() for k, g in ref.items()} for ref in refs]

    jstep = jmc.make_mc_train_step(jcore, jq, jconf, PAD)
    tstep = tmc.make_mc_train_step(tcore, tconf, PAD)
    for _ in range(STEPS):
        jstate, jl, _ = jstep(jstate, jbatch, None)
        tstate, tl, _ = tstep(tstate, tbatch)
        assert np.isfinite(float(jl)) and np.isfinite(tl.item())
    assert tstate.base.step == int(jstate.base.step) == STEPS
    _assert_params_close("base", tstate.base.params, params_from_jax(np_tree(jstate.base.params), tcfg), noise[0])
    _assert_params_close("q_head", tstate.q_head.params, head_params_from_jax(np_tree(jstate.q_head.params)),
                         noise[1])
    # the eval loss is the training loss without the update
    eval_loss, _ = tmc.make_mc_eval_loss(tcore, tconf, PAD)(tstate, tbatch)
    jeval, _ = jmc.make_mc_eval_loss(jcore, jq, jconf, PAD)(jstate, jbatch)
    np.testing.assert_allclose(eval_loss.item(), float(jeval), **LOSS_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_mc_step_matches_jax(case):
    _run_case(case)


def test_mc_step_at_t128_runs_jax_pallas_kernels(monkeypatch):
    """T = 128: the JAX trunk takes its Pallas flash kernels (interpret mode)."""
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    assert jfa.supports_flash((4, 4, 128, 16), 128)
    _run_case("default", T=128)
