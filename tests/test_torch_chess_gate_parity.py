"""The port's chess mate-in-1 ILQL gate against the JAX gate
(`scripts/chess_ilql_gate.py`) on the JAX gate's own draws.

The JAX gate runs at a tiny budget (d64 L2 H4, --obs grid, pools of 32 and
16 positions, 3 BC batches of 16, 4 ILQL batches of 32, reranker evals at
batches 2 and 4) with f32 activations. Its calls are recorded by wrapping
functions here: the initial trunk and heads it draws, the key of every
env reset and random-legal move made outside jit, the key of every
behavior batch (its jitted closure, caught at `jax.jit`), every move the
evals play and the guided rollout's output. The port's `Gate` then runs
from the same initial weights on the replayed draws (each key turned into
the `randint`, Gumbel and uniform values it gives), so its glue is what is
tested: the pools, the BC and behavior batches with the curriculum, the
ILQL state on a copy of the BC trunk, the reranker, the guided and the
legality-masked guided decodes.

Tolerances: every rate of the JSON result and every move an eval plays
identical; the curve's losses within test_torch_ilql.py's 1e-5.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.envs.chess import vector as jchess
from lmrl_gym_tpu.loops import actor as jactor
from lmrl_gym_tpu.models import config as jconfig
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtransformer
from lmrl_gym_torch.loops import actor as tactor
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.scripts import chess_ilql_gate as tgate
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--hidden", "64", "--layers", "2", "--heads", "4", "--train-pool", "32", "--eval-pool", "16",
        "--bc-batches", "3", "--bc-bsize", "16", "--ilql-batches", "4", "--ilql-bsize", "32", "--eval-every", "2",
        "--obs", "grid"]
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return torch.from_numpy(np.array(x))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _concrete(x):
    return not isinstance(x, jax.core.Tracer)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX gate's result and its recorded calls."""
    spec = importlib.util.spec_from_file_location("jax_chess_ilql_gate", os.path.join(ROOT, "scripts",
                                                                                      "chess_ilql_gate.py"))
    jgate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgate)
    rec = dict(trunks=[], heads=[], resets=[], actions=[], behavior=[], played=[], guided=[])
    env_cls = jchess.ChessEndgameVectorEnv
    orig = dict(cfg=jconfig.TransformerConfig, init=jtransformer.init_params, head=jheads.init_head_params,
                reset=env_cls.reset, action=env_cls.random_legal_action, step=env_cls.step,
                rollout=jactor.rollout_markov, jit=jax.jit)

    def init_params(config, key, *a, **kw):
        params = orig["init"](config, key, *a, **kw)
        rec["trunks"].append(_np_tree(params))
        return params

    def init_head_params(module, input_dim, key):
        params = orig["head"](module, input_dim, key)
        rec["heads"].append(_np_tree(params))
        return params

    def reset(self, key, batch):
        if _concrete(key):
            rec["resets"].append((key, batch))
        return orig["reset"](self, key, batch)

    def random_legal_action(self, state, key):
        if _concrete(key):
            rec["actions"].append((key, int(state.wk.shape[0])))
        return orig["action"](self, state, key)

    def step(self, state, act, key):
        if _concrete(act):  # the evals' moves (the behavior batches' and rollout's are traced)
            rec["played"].append(np.asarray(act))
        return orig["step"](self, state, act, key)

    def rollout_markov(*a, **kw):
        out = orig["rollout"](*a, **kw)
        rec["guided"].append(np.asarray(out[0].act_tokens))
        return out

    def jit(fun=None, **kw):
        if fun is None:
            return lambda f: jit(f, **kw)
        compiled = orig["jit"](fun, **kw)
        if getattr(fun, "__name__", "") != "make_behavior_batch":
            return compiled

        def recorded(key):
            rec["behavior"].append(key)
            return compiled(key)

        return recorded

    patches = [(jconfig, "TransformerConfig", lambda **kw: orig["cfg"](**kw, dtype="float32")),
               (jtransformer, "init_params", init_params), (jheads, "init_head_params", init_head_params),
               (env_cls, "reset", reset), (env_cls, "random_legal_action", random_legal_action),
               (env_cls, "step", step), (jactor, "rollout_markov", rollout_markov), (jax, "jit", jit)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        result = jgate.main(ARGV)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return result, rec


def _replay(rec, args, gate):
    """The recorded keys as the port's draws, and the JAX initial weights."""
    probes = [_np(jax.random.randint(k, (3, 8, b), 0, 64)) for k, b in rec["resets"] if b == tgate.PROBE]
    bc_resets = [(k, b) for k, b in rec["resets"] if b != tgate.PROBE]
    assert len(bc_resets) == args.bc_batches and len(rec["actions"]) == args.bc_batches + 1
    bc = [(_np(jax.random.randint(rk, (3, 8, b), 0, 64)), _np(jax.random.gumbel(ak, (b, 128), jnp.float32)))
          for (rk, b), (ak, _) in zip(bc_resets, rec["actions"])]
    behavior = []
    for key in rec["behavior"]:
        ki, ka, kc, _ = jax.random.split(key, 4)
        Bi = args.ilql_bsize
        behavior.append((_np(jax.random.randint(ki, (Bi,), 0, args.train_pool)),
                         _np(jax.random.gumbel(ka, (Bi, 128), jnp.float32)),
                         _np(jax.random.uniform(kc, (Bi,), jnp.float32))))
    k_base, n_base = rec["actions"][-1]
    trunk = Transformer(gate.config, device="cpu")
    trunk.load_state_dict(params_from_jax(rec["trunks"][0], gate.config))
    D = gate.config.hidden_size
    heads = []
    for tree, out_dim in zip(rec["heads"], (gate.config.padded_vocab_size, gate.config.padded_vocab_size, 1)):
        head = MLPHead(MLPHeadConfig(D, 2 * D, out_dim, layer2_initializer_range=0.0), device="cpu")
        head.load_state_dict(head_params_from_jax(tree))
        heads.append(head)
    return tgate.Replay(iter(probes), iter(bc), iter(behavior), _np(jax.random.gumbel(k_base, (n_base, 128),
                                                                                      jnp.float32)),
                        trunk, tuple(heads))


def test_port_gate_matches_jax_gate_on_replayed_draws(jax_run, monkeypatch):
    result, rec = jax_run
    args = tgate.parse_args(ARGV + ["--device", "cpu"])
    gate = tgate.Gate(args, dtype="float32")
    assert len(rec["trunks"]) == 1 and len(rec["heads"]) == 3 and len(rec["behavior"]) == args.ilql_batches
    replay = _replay(rec, args, gate)

    played, guided = [], []
    mate_rates, rollout_markov = tgate.Gate.mate_rates, tactor.rollout_markov

    def recorded_mate_rates(self, pool, act):
        played.append(act.numpy().copy())
        return mate_rates(self, pool, act)

    def recorded_rollout(*a, **kw):
        out = rollout_markov(*a, **kw)
        guided.append(out[0].act_tokens.numpy().copy())
        return out

    monkeypatch.setattr(tgate.Gate, "mate_rates", recorded_mate_rates)
    monkeypatch.setattr(tactor, "rollout_markov", recorded_rollout)
    out = tgate.run(tgate.Gate(args, dtype="float32", replay=replay))
    for it in (replay.probes, replay.bc, replay.behavior):
        assert next(it, None) is None  # every draw consumed

    assert set(out) == set(result)
    for k in result:
        if k != "curve":
            assert out[k] == result[k], (k, out[k], result[k])
    assert [c["batch"] for c in out["curve"]] == [c["batch"] for c in result["curve"]] == [2, 4]
    for a, b in zip(out["curve"], result["curve"]):
        assert a["rerank"] == b["rerank"]
        np.testing.assert_allclose(a["loss"], b["loss"], **LOSS_TOL)

    # every move the evals played: the baseline, four reranker evals, the masked guided decode
    assert len(played) == len(rec["played"]) == 6
    for i, (a, b) in enumerate(zip(played, rec["played"])):
        np.testing.assert_array_equal(a, b, err_msg=f"eval move {i}")
    (g,), (jg,) = guided, rec["guided"]
    np.testing.assert_array_equal(g, jg)
