"""GPT-J-family train steps against the JAX package's, on the CPU.

GPT-J-6B trains through the same ILQL and BC steps as the GPT-2 family,
but its trunk takes rotary embeddings (64 of 256 dims, interleaved), the
parallel FFN, an untied lm_head and Dh = 256, where the port's K1-K3 take
their wide tensor-core kernels on the card. Here a GPT-J-shaped config cut
to CPU size keeps every one of those branches: d 512, 2 heads (Dh = 256),
2 layers, byte vocab (tests/test_torch_gptj_model.py's GPTJ_SMALL), f32.
Both packages start from the same weights (the flax trees through
`models/convert.py`) and take the same numpy batches; the port runs its
kernels' plain versions.

ILQL (tests/test_torch_ilql.py's default setup: separate target trunk,
twin Q heads and V head with a nonzero second layer, a next window) and BC
(tests/test_torch_bc.py's, AdamW) take three steps each. Each step's loss
within 1e-5; after the three steps every online and target parameter
within 2e-6 abs + 1e-4 rel, except elements whose gradient was at noise
level before some step (below 1e-5 of its tensor's largest, or under 10
Adam ε; the port's gradients, recorded as its steps apply them): Adam
moves such an element by up to ±lr whatever the noise's sign
(tests/test_torch_ilql.py's rule, taken at every step as
tests/test_torch_maze_gate_parity.py takes it). Before steps 2 and 3 the
port's parameters are set to the JAX package's, each package keeping its
own optimizer state: at this width a noise-level element that one step
moves by up to 2·lr apart shifts the next step's gradients of the other
elements by more than rounding, and Adam's normalisation then moves some
of them apart too (measured: a few elements of 10⁶ after three steps, each
with a next-step gradient 0.7–5% apart between the packages), so each step
is held from the same parameters.
"""
import jax
import numpy as np
import torch

from lmrl_gym_tpu.algos import bc as jbc
from lmrl_gym_tpu.algos import ilql as jilql
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_torch.algos import bc as tbc
from lmrl_gym_torch.algos import ilql as tilql
from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.models.convert import head_params_from_jax, ilql_state_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from test_torch_bc import _batch as _bc_batch
from test_torch_bc import _pair as _bc_pair
from test_torch_gptj_model import GPTJ_SMALL
from test_torch_ilql import LOSS_TOL, NOISE, PAD, STEPS, _assert_params_close, _batch, _setup
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

ADAM_EPS = 1e-8  # optax's and the port's default


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _recorder(monkeypatch, names: dict) -> dict:
    """Wrap the port's TrainState.apply_gradients: each step's gradients
    mark their noise-level elements in the returned {group: {key: mask}}
    (`names` maps each trained module's id to its group)."""
    noise = {name: {} for name in names.values()}
    apply = topt.TrainState.apply_gradients

    def recorded(self, grads):
        masks = noise[names[id(self.params)]]
        for k, g in grads.items():
            a = g.detach().abs().numpy()
            m = (a <= NOISE * a.max()) | (a < 10 * ADAM_EPS)
            masks[k] = masks[k] | m if k in masks else m
        return apply(self, grads)

    monkeypatch.setattr(topt.TrainState, "apply_gradients", recorded)
    return noise


def test_gptj_ilql_steps_match_jax(monkeypatch):
    (jcfg, jconf, jq, jv, jstate), (tcfg, tconf, tstate) = _setup(**GPTJ_SMALL)
    assert tcfg.head_dim == 256 and tcfg.rotary_interleaved and tcfg.parallel_ffn
    jbatch, tbatch = _batch()
    jstep = jilql.make_ilql_train_step(JCore(jcfg), jq, jv, jconf, PAD)
    tstep = tilql.make_ilql_train_step(TCore(tcfg, device="cpu"), tconf, PAD)
    noise = _recorder(monkeypatch, {id(tstate.base.params): "base", id(tstate.q1_head.params): "q1",
                                    id(tstate.q2_head.params): "q2", id(tstate.v_head.params): "v"})
    for i in range(STEPS):
        if i:  # the port's parameters set to the JAX package's; optimizer states kept
            ilql_state_from_jax(tstate, tcfg, *(_np_tree(t) for t in (
                jstate.base.params, jstate.target_base_params, jstate.q1_head.params, jstate.q2_head.params,
                jstate.v_head.params, jstate.q1_target_params, jstate.q2_target_params)))
        jstate, jl, _ = jstep(jstate, jbatch, None)
        tstate, tl, _ = tstep(tstate, tbatch)
        np.testing.assert_allclose(tl.item(), float(jl), err_msg=f"step {i}", **LOSS_TOL)
    assert tstate.base.step == int(jstate.base.step) == STEPS
    for name, got, ref, group in (
        ("base", tstate.base.params, jstate.base.params, "base"),
        ("target_base", tstate.target_base_params, jstate.target_base_params, "base"),
    ):
        _assert_params_close(name, got, params_from_jax(_np_tree(ref), tcfg), noise[group])
    for name, group in (("q1_head", "q1"), ("q2_head", "q2"), ("v_head", "v")):
        _assert_params_close(name, getattr(tstate, name).params,
                             head_params_from_jax(_np_tree(getattr(jstate, name).params)), noise[group])
    for name, group in (("q1_target_params", "q1"), ("q2_target_params", "q2")):
        _assert_params_close(name, getattr(tstate, name), head_params_from_jax(_np_tree(getattr(jstate, name))),
                             noise[group])


def test_gptj_bc_steps_match_jax(monkeypatch):
    jcfg, tcfg, jstate, tstate, jconf, tconf = _bc_pair(0.0, **GPTJ_SMALL)
    jstep = jbc.make_bc_train_step(JCore(jcfg), jconf, PAD)
    tstep = tbc.make_bc_train_step(TCore(tcfg, device="cpu"), tconf, PAD)
    noise = _recorder(monkeypatch, {id(tstate.model.params): "model"})["model"]
    for i in range(STEPS):
        if i:
            tstate.model.params.load_state_dict(params_from_jax(_np_tree(jstate.model.params), tcfg))
        jbatch, tbatch = _bc_batch(seed=i)
        jstate, jl, _ = jstep(jstate, jbatch, None)
        tstate, tl, _ = tstep(tstate, tbatch)
        np.testing.assert_allclose(tl.item(), float(jl), err_msg=f"step {i}", **LOSS_TOL)
    assert tstate.model.step == STEPS
    _assert_params_close("model", tstate.model.params, params_from_jax(_np_tree(jstate.model.params), tcfg), noise)
    assert torch.isfinite(torch.cat([p.flatten() for p in tstate.model.params.parameters()])).all()
