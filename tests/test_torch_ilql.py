"""The port's ILQL train step against the JAX package's, on the CPU.

Both packages start from one state: the JAX `init_ilql_state` is built
first and carried into the port's with `models/convert.py::
ilql_state_from_jax`. Batches are made with numpy from a seed, in the shape
of tests/test_algos.py's (right-padded windows, actions on ~40% of the
tokens, reward −1 at each action). Q/V heads have a nonzero second layer,
so gradients reach every parameter group on the first step.

- Step 1: the loss, every log term and the base/q1/q2/v gradients.
  Tolerance: 1e-4 abs/rel on gradients, 1e-5 on the loss and logs (f32; the
  JAX and ATen matmuls and reductions sum in different orders, ~1e-6
  relative measured).
- After 3 steps: online and target parameters, elementwise within 2e-6 abs
  + 1e-4 rel. Adam's first updates are ≈ ±lr per element, so an element
  whose gradient is at noise level can take the other sign on one side and
  land up to ≈ 2·lr away. Elements apart are counted and printed, and each
  must have a step-1 JAX gradient at noise level (below 1e-5 of its
  tensor's largest; a target tensor uses its online tensor's gradient, a
  grad_accum case the first mini step's); any other element apart fails.
  Measured in a serial run: no element apart in any case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lmrl_gym_tpu.ops.flash_attention as jfa
from lmrl_gym_tpu.algos import ilql as jilql
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_torch.algos import ilql as tilql
from lmrl_gym_torch.core import optimizer as topt
from lmrl_gym_torch.models import heads as theads
from lmrl_gym_torch.models.config import tiny_test_config as ttiny
from lmrl_gym_torch.models.convert import head_params_from_jax, ilql_state_from_jax, params_from_jax
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.text.tokenizer import ByteTokenizer
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

PAD = ByteTokenizer().pad_token_id
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
PARAM_ATOL, PARAM_RTOL = 2e-6, 1e-4
NOISE = 1e-5  # a gradient element below this share of its tensor's largest is noise
STEPS = 3
CASES = {
    "default": dict(),
    "no_next_window": dict(next_window=False),
    "freeze_base": dict(config=dict(freeze_base=True, use_separate_target_base=False), base_tx="zero"),
    "grad_accum_2": dict(grad_accum=2),
    "hard_update_every_2": dict(config=dict(hard_update_every=2)),
    "detach_v": dict(config=dict(detach_v=True)),
}


def _txs(o, base_tx, grad_accum):
    """(base optimizer, head optimizer) in optax (o=optax) or the port."""
    ms = optax.MultiSteps if o is optax else topt.multi_steps
    base = o.set_to_zero() if base_tx == "zero" else o.adam(1e-4)
    head = o.adam(1e-3)
    if grad_accum > 1:
        base, head = ms(base, every_k_schedule=grad_accum), ms(head, every_k_schedule=grad_accum)
    return base, head


def _setup(config=None, base_tx="adam", grad_accum=1, **cfg_kw):
    jcfg, tcfg = jtiny(**cfg_kw), ttiny(**cfg_kw)
    config = dict(polyak_alpha=0.1, **(config or {}))
    jconf, tconf = jilql.ILQLConfig(**config), tilql.ILQLConfig(**config)
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 4)
    qkw = dict(input_dim=jcfg.hidden_size, hidden_dim=2 * jcfg.hidden_size, output_dim=jcfg.padded_vocab_size)
    vkw = dict(qkw, output_dim=1)
    jq, jv = jheads.MLPHead(jheads.MLPHeadConfig(**qkw)), jheads.MLPHead(jheads.MLPHeadConfig(**vkw))
    jbase_tx, jhead_tx = _txs(optax, base_tx, grad_accum)
    jstate = jilql.init_ilql_state(
        init_params(jcfg, key),
        jheads.init_head_params(jq, jcfg.hidden_size, ks[0]),
        jheads.init_head_params(jq, jcfg.hidden_size, ks[1]),
        jheads.init_head_params(jv, jcfg.hidden_size, ks[2]),
        jbase_tx, jhead_tx, jconf,
    )
    tbase_tx, thead_tx = _txs(topt, base_tx, grad_accum)
    tq, tv = theads.MLPHeadConfig(**qkw), theads.MLPHeadConfig(**vkw)
    tstate = tilql.init_ilql_state(
        Transformer(tcfg, device="cpu"),
        theads.MLPHead(tq, device="cpu"), theads.MLPHead(tq, device="cpu"), theads.MLPHead(tv, device="cpu"),
        tbase_tx, thead_tx, tconf,
    )
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    ilql_state_from_jax(
        tstate, tcfg, np_tree(jstate.base.params),
        None if jstate.target_base_params is None else np_tree(jstate.target_base_params),
        np_tree(jstate.q1_head.params), np_tree(jstate.q2_head.params), np_tree(jstate.v_head.params),
        np_tree(jstate.q1_target_params), np_tree(jstate.q2_target_params),
    )
    return (jcfg, jconf, jq, jv, jstate), (tcfg, tconf, tstate)


def _batch(b=4, t=12, nt=6, next_window=True, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (b, t)).astype(np.int32)
    ids[1, t - 3:] = PAD  # right padding
    sta = rng.random((b, t - 1)) < 0.4
    sta[:, 0] = True
    nxt = rng.integers(1, 256, (b, nt)).astype(np.int32)
    nxt[2, nt - 2:] = PAD
    arrays = dict(
        input_ids=ids, should_take_action=sta, rewards=(-1.0 * sta).astype(np.float32),
        dones=np.array([True, False, True, False]), next_token_ids=nxt if next_window else None,
        next_dones=np.array([True, False, False, True]) if next_window else None,
    )
    jb = jilql.ILQLBatch(**{k: None if a is None else jnp.asarray(a) for k, a in arrays.items()})
    tb = tilql.ILQLBatch(**{k: None if a is None else torch.from_numpy(a) for k, a in arrays.items()})
    return jb, tb


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: float(tree)}


def _jax_value_and_grad(jcore, jq, jv, jconf, jstate, jbatch):
    def loss_fn(b, q1, q2, v):
        return jilql.ilql_forward(
            jcore, jq, jv, b, jstate.target_base_params, q1, q2, v,
            jstate.q1_target_params, jstate.q2_target_params, jbatch, jconf, PAD, train=True, rng=None,
        )

    return jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3), has_aux=True)(
        jstate.base.params, jstate.q1_head.params, jstate.q2_head.params, jstate.v_head.params
    )


def _assert_params_close(name, got: torch.nn.Module, ref: dict, noise: dict):
    for k, t in got.state_dict().items():
        a, b = t.numpy(), ref[k].numpy()
        apart = np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b)
        if apart.any():
            print(f"{name}.{k}: {int(apart.sum())} of {apart.size} elements apart (noise-level gradients there: "
                  f"{int((apart & noise[k]).sum())}), max {np.abs(a - b).max():.3e}")
        assert not (apart & ~noise[k]).any(), f"{name}.{k}: elements apart where the gradient is not noise"


def _run_case(case, T=12):
    kw = dict(CASES[case])
    next_window = kw.pop("next_window", True)
    (jcfg, jconf, jq, jv, jstate), (tcfg, tconf, tstate) = _setup(**kw)
    jbatch, tbatch = _batch(t=T, next_window=next_window)
    jcore, tcore = JCore(jcfg), TCore(tcfg, device="cpu")
    base0 = {k: v.clone() for k, v in tstate.base.params.state_dict().items()}

    # ---- step 1: loss, every log term, gradients ----
    (jloss, jlogs), jgrads = _jax_value_and_grad(jcore, jq, jv, jconf, jstate, jbatch)
    tloss, tlogs, tgrads = tilql.ilql_loss_and_grads(tcore, tstate, tbatch, tconf, PAD)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    jflat, tflat = _flat(jlogs), _flat(tlogs)
    assert set(jflat) == set(tflat)
    for name in jflat:
        np.testing.assert_allclose(tflat[name], jflat[name], err_msg=name, **LOSS_TOL)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    refs = [params_from_jax(np_tree(jgrads[0]), tcfg)] + [head_params_from_jax(np_tree(g)) for g in jgrads[1:]]
    for group, got, ref in zip(("base", "q1", "q2", "v"), tgrads, refs):
        assert set(got) == set(ref), group
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), err_msg=f"{group}.{k}", **GRAD_TOL)
    noise = {group: {k: np.abs(g.numpy()) <= NOISE * np.abs(g.numpy()).max() for k, g in ref.items()}
             for group, ref in zip(("base", "q1", "q2", "v"), refs)}

    # ---- STEPS full train steps: online and target parameters ----
    jstep = jilql.make_ilql_train_step(jcore, jq, jv, jconf, PAD)
    tstep = tilql.make_ilql_train_step(tcore, tconf, PAD)
    for _ in range(STEPS):
        jstate, jl, _ = jstep(jstate, jbatch, None)
        tstate, tl, _ = tstep(tstate, tbatch)
        assert np.isfinite(float(jl)) and np.isfinite(tl.item())
    assert tstate.base.step == int(jstate.base.step) == STEPS
    _assert_params_close("base", tstate.base.params, params_from_jax(np_tree(jstate.base.params), tcfg), noise["base"])
    if jstate.target_base_params is not None:
        _assert_params_close("target_base", tstate.target_base_params,
                             params_from_jax(np_tree(jstate.target_base_params), tcfg), noise["base"])
    for name, group in (("q1_head", "q1"), ("q2_head", "q2"), ("v_head", "v")):
        _assert_params_close(name, getattr(tstate, name).params,
                             head_params_from_jax(np_tree(getattr(jstate, name).params)), noise[group])
    for name, group in (("q1_target_params", "q1"), ("q2_target_params", "q2")):
        _assert_params_close(name, getattr(tstate, name), head_params_from_jax(np_tree(getattr(jstate, name))),
                             noise[group])
    return base0, tstate


@pytest.mark.parametrize("case", list(CASES))
def test_ilql_step_matches_jax(case):
    base0, tstate = _run_case(case)
    base_moved = any(not torch.equal(base0[k], v) for k, v in tstate.base.params.state_dict().items())
    # freeze_base with set_to_zero leaves the trunk bit-identical; otherwise it trains
    assert base_moved == (case != "freeze_base")


def test_ilql_step_at_t128_runs_jax_pallas_kernels(monkeypatch):
    """T = 128: the JAX trunk takes its Pallas flash kernels (interpret
    mode) for the trained and the target forward, forward and backward."""
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    assert jfa.supports_flash((4, 4, 128, 16), 128)
    _run_case("default", T=128)
