"""The port's CQL train step against the JAX package's, on the CPU.

Both packages start from one state: the JAX `init_cql_state` is built first
and carried into the port's with `models/convert.py::cql_state_from_jax`.
Batches, tolerances and the noise-gradient rule are `test_torch_ilql.py`'s:
step 1's loss and log terms within 1e-5, gradients within 1e-4 abs/rel;
after 3 steps every online and target parameter within 2e-6 abs + 1e-4 rel
(elements apart must have a noise-level step-1 JAX gradient).
"""
import jax
import numpy as np
import optax
import pytest

import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_tpu.algos import cql as jcql
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_torch.algos import cql as tcql
from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.core.logs import detach_logs
from lmrl_gym_torch.core.optimizer import value_and_grads
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import cql_state_from_jax, head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.models.transformer import Transformer
from test_torch_ilql import GRAD_TOL, LOSS_TOL, PAD, STEPS, _assert_params_close, _batch, _flat, _txs
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

CASES = {
    "default": dict(),
    "no_next_window": dict(next_window=False),
    "no_target_base": dict(config=dict(use_separate_target_base=False)),
    "no_target_base_no_next_window": dict(config=dict(use_separate_target_base=False), next_window=False),
    "hard_update_every_2": dict(config=dict(hard_update_every=2)),
    "grad_accum_2": dict(grad_accum=2),
}
np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731


def _setup(config=None, grad_accum=1):
    jcfg, tcfg = jtiny(), ttiny()
    config = dict(polyak_alpha=0.1, **(config or {}))
    jconf, tconf = jcql.CQLConfig(**config), tcql.CQLConfig(**config)
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 3)
    qkw = dict(input_dim=jcfg.hidden_size, hidden_dim=2 * jcfg.hidden_size, output_dim=jcfg.padded_vocab_size)
    jq = jheads.MLPHead(jheads.MLPHeadConfig(**qkw))
    jstate = jcql.init_cql_state(
        init_params(jcfg, key),
        jheads.init_head_params(jq, jcfg.hidden_size, ks[0]),
        jheads.init_head_params(jq, jcfg.hidden_size, ks[1]),
        *_txs(optax, "adam", grad_accum), jconf,
    )
    tq = theads.MLPHeadConfig(**qkw)
    tstate = tcql.init_cql_state(
        Transformer(tcfg, device="cpu"), theads.MLPHead(tq, device="cpu"), theads.MLPHead(tq, device="cpu"),
        *_txs(topt, "adam", grad_accum), tconf,
    )
    cql_state_from_jax(
        tstate, tcfg, np_tree(jstate.base.params),
        None if jstate.target_base_params is None else np_tree(jstate.target_base_params),
        np_tree(jstate.q1_head.params), np_tree(jstate.q2_head.params),
        np_tree(jstate.q1_target_params), np_tree(jstate.q2_target_params),
    )
    return (jcfg, jconf, jq, jstate), (tcfg, tconf, tstate)


def _run_case(case, T=12):
    kw = dict(CASES[case])
    next_window = kw.pop("next_window", True)
    (jcfg, jconf, jq, jstate), (tcfg, tconf, tstate) = _setup(**kw)
    jbatch, tbatch = _batch(t=T, next_window=next_window)
    jcore, tcore = JCore(jcfg), TCore(tcfg, device="cpu")

    # ---- step 1: loss, every log term, gradients ----
    def loss_fn(b, q1, q2):
        return jcql.cql_forward(jcore, jq, b, jstate.target_base_params, q1, q2, jstate.q1_target_params,
                                jstate.q2_target_params, jbatch, jconf, PAD, train=True, rng=None)

    (jloss, jlogs), jgrads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2), has_aux=True)(
        jstate.base.params, jstate.q1_head.params, jstate.q2_head.params)
    tloss, tlogs = tcql.cql_forward(tcore, tstate.base.params, tstate.target_base_params, tstate.q1_head.params,
                                    tstate.q2_head.params, tstate.q1_target_params, tstate.q2_target_params,
                                    tbatch, tconf, PAD, train=True)
    tgrads = value_and_grads(tloss, (tstate.base.params, tstate.q1_head.params, tstate.q2_head.params))
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    jflat, tflat = _flat(jlogs), _flat(detach_logs(tlogs))
    assert set(jflat) == set(tflat)
    for name in jflat:
        np.testing.assert_allclose(tflat[name], jflat[name], err_msg=name, **LOSS_TOL)
    refs = [params_from_jax(np_tree(jgrads[0]), tcfg)] + [head_params_from_jax(np_tree(g)) for g in jgrads[1:]]
    for group, got, ref in zip(("base", "q1", "q2"), tgrads, refs):
        assert set(got) == set(ref), group
        for k in ref:
            np.testing.assert_allclose(got[k].detach().numpy(), ref[k].numpy(), err_msg=f"{group}.{k}", **GRAD_TOL)
    noise = {group: {k: np.abs(g.numpy()) <= 1e-5 * np.abs(g.numpy()).max() for k, g in ref.items()}
             for group, ref in zip(("base", "q1", "q2"), refs)}

    # ---- STEPS full train steps: online and target parameters ----
    jstep = jcql.make_cql_train_step(jcore, jq, jconf, PAD)
    tstep = tcql.make_cql_train_step(tcore, tconf, PAD)
    for _ in range(STEPS):
        jstate, jl, _ = jstep(jstate, jbatch, None)
        tstate, tl, _ = tstep(tstate, tbatch)
        assert np.isfinite(float(jl)) and np.isfinite(tl.item())
    assert tstate.base.step == int(jstate.base.step) == STEPS
    _assert_params_close("base", tstate.base.params, params_from_jax(np_tree(jstate.base.params), tcfg), noise["base"])
    if jstate.target_base_params is not None:
        _assert_params_close("target_base", tstate.target_base_params,
                             params_from_jax(np_tree(jstate.target_base_params), tcfg), noise["base"])
    for name, group in (("q1_head", "q1"), ("q2_head", "q2")):
        _assert_params_close(name, getattr(tstate, name).params,
                             head_params_from_jax(np_tree(getattr(jstate, name).params)), noise[group])
    for name, group in (("q1_target_params", "q1"), ("q2_target_params", "q2")):
        _assert_params_close(name, getattr(tstate, name), head_params_from_jax(np_tree(getattr(jstate, name))),
                             noise[group])


@pytest.mark.parametrize("case", list(CASES))
def test_cql_step_matches_jax(case):
    _run_case(case)


def test_cql_step_at_t128_runs_jax_pallas_kernels(monkeypatch):
    """T = 128: the JAX trunk takes its Pallas flash kernels (interpret
    mode) for the trained, the target and the next-window forward."""
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    assert jfa.supports_flash((4, 4, 128, 16), 128)
    _run_case("default", T=128)
