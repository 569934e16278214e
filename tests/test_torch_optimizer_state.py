"""Optimizer state across the packages (`lmrl_gym_torch/loops/
checkpoints.py`): a train_state.msgpack resumes with its Adam moments,
schedule counts, gradient accumulators and step, both ways.

A tiny trunk's `TrainState` under each package's `make_optimizer` (the
CLI's recipe: clipping, AdamW, a schedule, MultiSteps) takes three steps
of the same numpy gradients in one package and is written with
`dump_modules(..., save_train_state=True)`; the other package restores it
(the port with `restore_module`, JAX with `load_pytree` against optax's
state) and both take the next step on one more gradient. The restored
moments equal the saved ones bit for bit, and the next updates agree as
tests/test_torch_optimizer.py holds them: 1e-6 relative, with a floor of
1e-6 of the tensor's largest update.
"""
import jax
import numpy as np
import pytest
import torch
from flax.training.train_state import TrainState as JTrainState

from lmrl_gym_tpu.core import optimizer as jopt
from lmrl_gym_tpu.core.checkpointing import load_pytree as jload
from lmrl_gym_tpu.loops.checkpoints import dump_modules as jdump
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.loops.checkpoints import dump_modules, restore_module
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import params_from_jax
from lmrl_gym_torch.models.transformer import Transformer

CONFIGS = {
    "clip_adam": dict(lr=1e-3),
    "adamw_cosine": dict(lr=1e-3, weight_decay=0.01, warmup_steps=2, total_steps=10),
    "accum2_warmup": dict(lr=1e-3, grad_clip=None, warmup_steps=3, grad_accum_steps=2),
}
STEPS = 3


def _np(t):
    return jax.tree.map(np.asarray, t)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.1, _np(params))


def _setup(name):
    cfg = CONFIGS[name]
    jparams = _np(init_params(jtiny(), jax.random.PRNGKey(0)))
    jstate = JTrainState.create(apply_fn=None, params=jparams, tx=jopt.make_optimizer(jopt.OptimizerConfig(**cfg),
                                                                                     jparams))
    module = Transformer(ttiny(), "cpu")
    module.load_state_dict(params_from_jax(jparams, ttiny()))
    tstate = topt.TrainState(module, topt.make_optimizer(topt.OptimizerConfig(**cfg), module))
    return jparams, jstate, tstate


def _port_grads(g):
    return params_from_jax(g, ttiny())


def _assert_next_step_agrees(jstate, tstate, seed):
    """The next update (optax's `tx.update` and the port's, on the resumed
    states; not the parameters, whose rounding of p + u hides the update's
    low bits) elementwise."""
    g = _grads(jstate.params, seed)
    jupd, _ = jstate.tx.update(g, jstate.opt_state, jstate.params)
    tupd, _ = tstate.tx.update(_port_grads(g), tstate.opt_state, topt.named_params(tstate.params))
    jupd = params_from_jax(_np(jupd), ttiny())
    for k, t in tupd.items():
        ju = jupd[k].numpy()
        np.testing.assert_allclose(t.detach().numpy(), ju, rtol=1e-6, atol=1e-6 * np.abs(ju).max(), err_msg=k)


def _moments(opt_state):
    """Every per-parameter dict of a port optimizer state, in order."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            out.append(node)
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)

    walk(opt_state)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_train_state_resumes_in_port(tmp_path, name):
    _, jstate, tstate = _setup(name)
    for i in range(STEPS):
        jstate = jstate.apply_gradients(grads=_grads(jstate.params, i))
    jdump(str(tmp_path), {"base": jstate}, save_train_state=True)
    restore_module(str(tmp_path), "base", tstate)
    assert tstate.step == STEPS
    jmoments = [params_from_jax(_np(m), ttiny()) for m in jax.tree.leaves(
        jstate.opt_state, is_leaf=lambda x: isinstance(x, dict) and "wte" in x) if isinstance(m, dict)]
    tmoments = _moments(tstate.opt_state)
    assert len(tmoments) == len(jmoments) > 0
    for tm, jm in zip(tmoments, jmoments):
        for k in jm:
            np.testing.assert_array_equal(tm[k].numpy(), jm[k].numpy(), err_msg=k)
    _assert_next_step_agrees(jstate, tstate, seed=99)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_train_state_resumes_in_jax(tmp_path, name):
    jparams, jstate, tstate = _setup(name)
    for i in range(STEPS):
        tstate.apply_gradients(_port_grads(_grads(jparams, i)))
    dump_modules(str(tmp_path), {"base": tstate}, save_train_state=True)
    tree = jload(str(tmp_path / "base" / "train_state.msgpack"),
                 target={"params": jparams, "opt_state": jstate.opt_state, "step": 0})
    jstate = jstate.replace(params=tree["params"], opt_state=tree["opt_state"], step=int(tree["step"]))
    assert int(jstate.step) == STEPS
    _assert_next_step_agrees(jstate, tstate, seed=99)
