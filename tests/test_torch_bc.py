"""The port's BC train step against the JAX package's, on the CPU.

One tiny trunk carried over with `models/convert.py`; batches made with
numpy from a seed (right-padded rows, a training mask on about half the
tokens). The loss and its gradient on the first batch: 1e-5 and 1e-4
abs/rel (f32, different summation orders). After 3 AdamW steps (optax's
defaults, weight decay 1e-4 on every parameter) the parameters: 2e-6 abs +
1e-4 rel. Adam divides each gradient by its own running magnitude, so an
element whose gradient is rounding noise moves by up to ±lr on either side
whatever the noise: the key part of the qkv bias is such a group (softmax
does not change when every score of a query shifts by q·b_k, so its
gradient is exactly zero in exact arithmetic). Elements apart are counted
and printed, and each must have a first-batch gradient at noise level
(below 1e-5 of its tensor's largest); any other element apart fails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as JTrainState

from lmrl_gym_tpu.algos import bc as jbc
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_torch.algos import bc as tbc
from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.text.tokenizer import ByteTokenizer

PAD = ByteTokenizer().pad_token_id
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
PARAM_ATOL, PARAM_RTOL, NOISE = 2e-6, 1e-4, 1e-5


def _pair(non_action_weight, **cfg_kw):
    jcfg, tcfg = jtiny(**cfg_kw), ttiny(**cfg_kw)
    jparams = init_params(jcfg, jax.random.PRNGKey(1))
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    jstate = jbc.BCTrainState(model=JTrainState.create(apply_fn=None, params=jparams, tx=optax.adamw(1e-3)))
    tstate = tbc.BCTrainState(model=topt.TrainState(model, topt.adamw(1e-3)))
    return jcfg, tcfg, jstate, tstate, jbc.BCConfig(non_action_weight), tbc.BCConfig(non_action_weight)


def _batch(b=3, t=14, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (b, t)).astype(np.int32)
    ids[0, t - 4:] = PAD
    ids[2, t - 1:] = PAD
    train = (rng.random((b, t)) < 0.5).astype(np.int32)
    return (jbc.BCBatch(jnp.asarray(ids), jnp.asarray(train)),
            tbc.BCBatch(torch.from_numpy(ids), torch.from_numpy(train)))


@pytest.mark.parametrize("non_action_weight", [0.0, 0.25])
def test_bc_loss_grad_and_steps_match_jax(non_action_weight):
    jcfg, tcfg, jstate, tstate, jconf, tconf = _pair(non_action_weight)
    jcore, tcore = JCore(jcfg), TCore(tcfg, device="cpu")
    jbatch, tbatch = _batch()

    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jbc.bc_loss_from_params(jcore, p, jbatch, jconf, PAD, train=True, rng=None), has_aux=True
    )(jstate.model.params)
    tloss, tlogs, tgrads = tbc.bc_loss_and_grads(tcore, tstate, tbatch, tconf, PAD)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(tlogs["loss"].item(), float(jloss), **LOSS_TOL)
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)
    assert set(ref) == set(tgrads)
    for k in ref:
        np.testing.assert_allclose(tgrads[k].numpy(), ref[k].numpy(), err_msg=k, **GRAD_TOL)
    noise = {k: np.abs(g.numpy()) <= NOISE * np.abs(g.numpy()).max() for k, g in ref.items()}

    jstep = jbc.make_bc_train_step(jcore, jconf, PAD)
    tstep = tbc.make_bc_train_step(tcore, tconf, PAD)
    for i in range(3):
        jbatch, tbatch = _batch(seed=i)
        jstate, jl, _ = jstep(jstate, jbatch, None)
        tstate, tl, _ = tstep(tstate, tbatch)
        np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    assert tstate.model.step == 3
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.model.params), tcfg)
    for k, t in tstate.model.params.state_dict().items():
        a, b = t.numpy(), ref[k].numpy()
        apart = np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b)
        if apart.any():
            print(f"{k}: {int(apart.sum())} of {apart.size} elements apart (noise-level gradients there: "
                  f"{int((apart & noise[k]).sum())}), max {np.abs(a - b).max():.3e}")
        assert not (apart & ~noise[k]).any(), k

    eval_loss, _ = tbc.make_bc_eval_loss(tcore, tconf, PAD)(tstate, tbatch)
    assert not eval_loss.requires_grad and np.isfinite(eval_loss.item())
