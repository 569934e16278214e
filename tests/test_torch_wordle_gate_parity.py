"""The port's Wordle ILQL gate against the JAX gate (`scripts/
wordle_ilql_gate.py`), stage by stage, on the JAX gate's own draws.

The JAX gate runs at a tiny budget (d64 L2 H4, bsize 16, 3 BC, 3 %BC and
4 ILQL updates, guided evals at updates 2 and 4, eval batch 8, no
OptimalPolicy bound) with f32 activations. Its calls are recorded: the
initial trunk and heads it draws, the PRNG key and batch of every scripted
and eval rollout, the parameters each eval rollout serves, and its final
ILQL state. The port's `Gate` stages then run from the same initial
weights on the replayed draws (each key turned into the Gumbel, `randint`
and `uniform` values it gives), so its glue is what is tested: the
streaming batches, the %BC filter with its ties, the warm-up and cosine
schedules, the ILQL state built from a copy of the BC trunk, the eval
parameter sets.

Tolerances: every eval's token stream, and so every return and win rate
of the JSON result, identical; parameters served by each eval and the
final ILQL state within test_torch_bc.py's and test_torch_ilql.py's 2e-6
abs + 1e-4 rel per element, where an element apart must have a
noise-level gradient (below 1e-5 of its tensor's largest) on the stage's
first batch: Adam moves such an element by about ±lr either way.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.algos import ilql as jilql
from lmrl_gym_tpu.loops import actor as jactor
from lmrl_gym_tpu.models import config as jconfig
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtransformer
from lmrl_gym_torch.algos import bc as tbc
from lmrl_gym_torch.algos import ilql as tilql
from lmrl_gym_torch.core.optimizer import TrainState, adamw
from lmrl_gym_torch.loops import actor as tactor
from lmrl_gym_torch.loops.online_device import wordle_rollout_to_ilql_batch
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.scripts import wordle_ilql_gate as tgate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--hidden", "64", "--layers", "2", "--heads", "4", "--bsize", "16", "--bc-steps", "3", "--pbc-steps", "3",
        "--ilql-steps", "4", "--eval-every", "2", "--eval-batch", "8", "--optimal-episodes", "0"]
PARAM_ATOL, PARAM_RTOL, NOISE = 2e-6, 1e-4, 1e-5


def _np(x):
    return torch.from_numpy(np.array(x))


def _scripted_noise(key, B, V):
    """rollout_wordle_scripted's per-turn key splits, as draws."""
    guess, idx, uni, env = [], [], [], []
    for tk in jax.random.split(key, jactor.N_TRIES):
        kg, kr, km, ke = jax.random.split(tk, 4)
        guess.append(_np(jax.random.gumbel(kg, (B, V), jnp.float32)))
        idx.append(_np(jax.random.randint(kr, (B,), 0, V)))
        uni.append(_np(jax.random.uniform(km, (B,))))
        env.append(_np(jax.random.gumbel(ke, (B, V), jnp.float32)))
    return tactor.ScriptedNoise(*(torch.stack(x) for x in (guess, idx, uni, env)))


def _rollout_noise(key, B, V, V_words):
    """rollout_wordle's per-turn and per-slot key splits, as Gumbel draws."""
    dec, env = [], []
    for turn_key in jax.random.split(key, jactor.N_TRIES):
        kd, ke = jax.random.split(turn_key)
        dec.append(torch.stack([_np(jax.random.gumbel(k, (B, V), jnp.float32))
                                for k in jax.random.split(kd, 2 * jactor.N_CHARS)]))
        env.append(_np(jax.random.gumbel(ke, (B, V_words), jnp.float32)))
    return tactor.WordleNoise(decode=torch.stack(dec), env=torch.stack(env))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX gate's result and its recorded calls."""
    spec = importlib.util.spec_from_file_location("jax_wordle_ilql_gate", os.path.join(ROOT, "scripts",
                                                                                       "wordle_ilql_gate.py"))
    jgate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgate)
    rec = dict(trunks=[], heads=[], scripted=[], evals=[], ilql=[])
    orig = dict(cfg=jconfig.TransformerConfig, init=jtransformer.init_params, head=jheads.init_head_params,
                scripted=jactor.rollout_wordle_scripted, rollout=jactor.rollout_wordle,
                ilql=jilql.make_ilql_train_step)

    def init_params(config, key, *a, **kw):
        params = orig["init"](config, key, *a, **kw)
        rec["trunks"].append(_np_tree(params))  # a copy: the train steps donate their state
        return params

    def init_head_params(module, input_dim, key):
        params = orig["head"](module, input_dim, key)
        rec["heads"].append(_np_tree(params))
        return params

    def scripted(env, key, holder, p_smart, p_repeat=0.0):
        rec["scripted"].append((key, holder.shape[0], p_smart, p_repeat))
        return orig["scripted"](env, key, holder, p_smart, p_repeat)

    def rollout(env, step_fn, params, carry, key, holder, temperature, greedy, constrain_vocab):
        rec["evals"].append(dict(key=key, B=holder.shape[0], greedy=greedy, params=_np_tree(params)))
        out = orig["rollout"](env, step_fn, params, carry, key, holder, temperature, greedy,
                              constrain_vocab=constrain_vocab)
        rec["evals"][-1]["tokens"] = np.asarray(out.tokens)
        return out

    def make_ilql_train_step(*a, **kw):
        step = orig["ilql"](*a, **kw)

        def recorded(state, batch, key):
            out = step(state, batch, key)
            rec["ilql"] = [_np_tree(out[0]), float(out[1])]
            return out

        return recorded

    patches = dict(TransformerConfig=(jconfig, lambda **kw: orig["cfg"](**kw, dtype="float32")),
                   init_params=(jtransformer, init_params), init_head_params=(jheads, init_head_params),
                   rollout_wordle_scripted=(jactor, scripted), rollout_wordle=(jactor, rollout),
                   make_ilql_train_step=(jilql, make_ilql_train_step))
    saved = {name: getattr(mod, name) for name, (mod, _) in patches.items()}
    try:
        for name, (mod, fn) in patches.items():
            setattr(mod, name, fn)
        result = jgate.main(ARGV)
    finally:
        for name, (mod, _) in patches.items():
            setattr(mod, name, saved[name])
    return result, rec


def _trunk(tree, gate):
    model = Transformer(gate.config, device="cpu")
    model.load_state_dict(params_from_jax(tree, gate.config))
    return model


def _assert_close(name, got: dict, ref: dict, noise: dict):
    for k, t in got.items():
        a, b = t.numpy(), ref[k].numpy()
        apart = np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b)
        if apart.any():
            print(f"{name}.{k}: {int(apart.sum())} of {apart.size} elements apart, max {np.abs(a - b).max():.3e}")
        assert not (apart & ~noise[k]).any(), f"{name}.{k}: elements apart where the gradient is not noise"


def _noise(grads: dict) -> dict:
    return {k: (g.abs() <= NOISE * g.abs().max()).numpy() for k, g in grads.items()}


def _snapshot(module: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _heads(trees, gate, value_bias_init):
    D, V = gate.config.hidden_size, gate.config.padded_vocab_size
    q_cfg = MLPHeadConfig(D, 2 * D, V, layer2_initializer_range=0.0, layer2_bias_init=value_bias_init)
    v_cfg = MLPHeadConfig(D, 2 * D, 1, layer2_initializer_range=0.0, layer2_bias_init=value_bias_init)
    heads = tuple(MLPHead(cfg, device="cpu") for cfg in (q_cfg, q_cfg, v_cfg))
    for head, tree in zip(heads, trees):
        head.load_state_dict(head_params_from_jax(tree))
    return heads


def test_port_gate_matches_jax_gate_on_replayed_draws(jax_run, monkeypatch):
    result, rec = jax_run
    served, ilql_state = [], []  # what each of the port's evals served and decoded; its ILQL state

    def recorded_rollout(env, step_fn, params, *a, **kw):
        out = rollout_wordle(env, step_fn, params, *a, **kw)
        snap = {k: _snapshot(m) for k, m in params.items()} if isinstance(params, dict) else _snapshot(params)
        served.append(dict(params=snap, tokens=out.tokens.numpy()))
        return out

    def recorded_step_factory(*a, **kw):
        step = make_ilql_train_step(*a, **kw)

        def recorded(state, batch):
            ilql_state[:] = [state]
            return step(state, batch)

        return recorded

    rollout_wordle, make_ilql_train_step = tactor.rollout_wordle, tilql.make_ilql_train_step
    monkeypatch.setattr(tactor, "rollout_wordle", recorded_rollout)
    monkeypatch.setattr(tilql, "make_ilql_train_step", recorded_step_factory)

    args = tgate.parse_args(ARGV + ["--device", "cpu"])
    gate = tgate.Gate(args, dtype="float32")
    V_words, V = len(gate.vocab), gate.config.padded_vocab_size
    # behavior and ceiling stats, BC, %BC (bsize / filter-frac episodes per chunk), ILQL
    assert [n for _, n, _, _ in rec["scripted"]] == [2048] * 4 + [16] * 3 + [64] * 3 + [16] * 4
    # BC and %BC sampled and greedy, the curve at updates 2 and 4, target heads, greedy
    assert [e["greedy"] for e in rec["evals"]] == [False, True, False, True, False, False, False, True]
    assert len(rec["trunks"]) == 2 and len(rec["heads"]) == 3
    for a, b in zip(*rec["trunks"]):  # one seed: BC and %BC start from one trunk
        np.testing.assert_array_equal(a, b)
    sn = [_scripted_noise(key, n, V_words) for key, n, _, _ in rec["scripted"]]
    en = [_rollout_noise(e["key"], e["B"], V, V_words) for e in rec["evals"]]
    replay = tgate.Replay(iter(sn), iter(en), _trunk(rec["trunks"][0], gate), _heads(rec["heads"], gate,
                                                                                       args.value_bias_init))
    out = tgate.run(tgate.Gate(args, dtype="float32", replay=replay))
    assert next(replay.scripted, None) is None and next(replay.evals, None) is None  # every draw consumed

    # every number of the JAX gate's result
    assert set(out) == set(result)
    for k in result:
        if k != "model":
            assert out[k] == result[k], (k, out[k], result[k])

    # noise masks: BC's from its first batch on the initial trunk; ILQL's
    # from its first batch on the initial state (BC's trunk, the JAX heads)
    first = tactor.rollout_wordle_scripted(gate.venv, 16, args.prob_smart, noise=sn[4])
    state0 = tbc.BCTrainState(TrainState(_trunk(rec["trunks"][0], gate), adamw(1e-3)))
    _, _, g0 = tbc.bc_loss_and_grads(gate.core, state0, tbc.BCBatch(first.tokens.clone(),
                                     first.token_action_mask().float()), tbc.BCConfig(), gate.tokenizer.pad_token_id)
    bc = Transformer(gate.config, device="cpu")
    bc.load_state_dict(served[0]["params"])
    probe = tgate.Gate(args, dtype="float32",
                       replay=tgate.Replay(iter(()), iter(()), bc, _heads(rec["heads"], gate, args.value_bias_init)))
    state, ilql_config = probe.init_ilql(bc)
    batch = wordle_rollout_to_ilql_batch(tactor.rollout_wordle_scripted(gate.venv, 16, args.prob_smart,
                                                                        noise=sn[10]))
    _, _, grads = tilql.ilql_loss_and_grads(gate.core, state, batch, ilql_config, gate.tokenizer.pad_token_id)
    masks = dict(pi_beta=_noise(g0), **dict(zip(("base", "q1", "q2", "v"), (_noise(g) for g in grads))))

    # every eval served the JAX gate's parameters and decoded its token stream
    assert len(served) == len(rec["evals"]) == 8
    for i, (port, ref) in enumerate(zip(served, rec["evals"])):
        np.testing.assert_array_equal(port["tokens"], ref["tokens"], err_msg=f"eval {i}")
        if i < 4:
            _assert_close(f"eval {i}", port["params"], params_from_jax(ref["params"], gate.config), masks["pi_beta"])
            continue
        assert set(port["params"]) == set(ref["params"]) == {"pi_beta", "base", "q1", "q2"}
        for name, got in port["params"].items():
            want = (params_from_jax(ref["params"][name], gate.config) if name in ("pi_beta", "base")
                    else head_params_from_jax(ref["params"][name]))
            _assert_close(f"eval {i} {name}", got, want, masks[name])

    # the final ILQL state's parts no eval serves
    (state,), jstate = ilql_state, rec["ilql"][0]
    _assert_close("target_base", _snapshot(state.target_base_params),
                  params_from_jax(jstate.target_base_params, gate.config), masks["base"])
    _assert_close("v", _snapshot(state.v_head.params), head_params_from_jax(jstate.v_head.params), masks["v"])
