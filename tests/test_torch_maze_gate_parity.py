"""The port's maze gate (`lmrl_gym_torch/scripts/maze_ilql_gate.py`) against
the JAX gate (`scripts/maze_ilql_gate.py`) on the JAX gate's own draws,
for `--algo cql` and `--algo mc`.

The JAX gate runs at a tiny budget (d64 L2 H4, 3 chains, one BC epoch, two
value epochs with an eval after each, the legal-move guided decode and the
cosine head lr) with f32 activations. Its draws are its initial trunk and
heads (the data and the batch order come from the same numpy RNG calls in
both packages, and every decode is greedy); they are recorded and replayed
into the port's `Gate`, together with the JAX gate's final value-learning
state for comparison.

Tolerances: every number of the JSON result (BC's accuracy and each eval's
guided, reranker and target-reranker accuracy) and every eval's chosen
action in each of the 25 cells identical; the final trunk and heads
(online and target) within 2e-6 abs + 1e-4 rel per element, as in
`test_torch_ilql.py`, where an element apart must have had, before some BC
or value step, a gradient whose rounding reaches Adam's step: at noise
level (below 1e-5 of its tensor's largest, as in `test_torch_ilql.py`; its
sign may differ) or below 10·ε = 1e-7 (the step's size then follows the
gradient's, and the first value steps' trunk gradients, which pass through
heads that start at zero, are that small). Tensors whose gradient is all
zero (the trunk and the heads' first layers on the first value step) are
exact in both packages and excuse nothing. The port's gradients stand in
for JAX's, which test_torch_cql.py and test_torch_mc.py hold within 1e-4.
A target tensor takes its online tensor's mask. Measured in a serial run:
one element apart in the MC case (6.4e-6, a gradient of 2.2e-8 on the
second value step); the masks cover 20-33% of each parameter group.
"""
import argparse
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.algos import cql as jcql
from lmrl_gym_tpu.algos import mc as jmc
from lmrl_gym_tpu.envs.maze import eval as jeval
from lmrl_gym_tpu.models import config as jconfig
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtransformer
from lmrl_gym_torch.algos import bc as tbc
from lmrl_gym_torch.algos import cql as tcql
from lmrl_gym_torch.algos import mc as tmc
from lmrl_gym_torch.envs.maze import eval as teval
from lmrl_gym_torch.core.optimizer import value_and_grads
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.scripts import maze_ilql_gate as tgate
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--hidden", "64", "--layers", "2", "--heads", "4", "--n-chains", "3", "--bc-epochs", "1", "--ilql-epochs",
        "2", "--eval-every", "1", "--lr-warmdown", "--guided-legal"]
PARAM_ATOL, PARAM_RTOL, NOISE = 2e-6, 1e-4, 1e-5
ADAM_EPS = 1e-8  # optax.adamw's, and the port's


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def jax_initial_weights(argv=()) -> tgate.Replay:
    """The JAX gate's initial weights for its flags `argv`, drawn as the
    JAX gate draws them (the trunk from PRNGKey(0), the heads from
    split(PRNGKey(2), 3)), as the port's `Replay` on the CPU. A run of the
    port's gate from them, on the card:

        python -c "import sys, torch; sys.path.insert(0, 'tests'); import test_torch_maze_gate_parity as t; \\
            torch.save(t.jax_initial_weights(), 'build/maze_jax_init.pt')"   # here, with JAX
        m.run(m.Gate(args, replay=torch.load('build/maze_jax_init.pt', map_location='cuda', weights_only=False)))
    """
    args = tgate.parse_args(list(argv) + ["--device", "cpu"])
    cfg = jconfig.TransformerConfig(
        vocab_size=259, hidden_size=args.hidden, num_layers=args.layers, num_heads=args.heads,
        max_position_embeddings=256, pad_vocab_to_multiple=64, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0,
    )
    replay = tgate.draw_initial_weights(tgate.Gate(args).config, args.value_bias_init, "cpu")
    replay.trunk.load_state_dict(params_from_jax(_np_tree(jtransformer.init_params(cfg, jax.random.PRNGKey(0))),
                                                 replay.trunk.config))
    D = cfg.hidden_size
    kw = dict(input_dim=D, hidden_dim=2 * D, layer2_initializer_range=0.0, layer2_bias_init=args.value_bias_init)
    heads = (jheads.MLPHead(jheads.MLPHeadConfig(output_dim=cfg.padded_vocab_size, **kw)),) * 2
    heads += (jheads.MLPHead(jheads.MLPHeadConfig(output_dim=1, **kw)),)
    for port, head, key in zip(replay.heads, heads, jax.random.split(jax.random.PRNGKey(2), 3)):
        port.load_state_dict(head_params_from_jax(_np_tree(jheads.init_head_params(head, D, key))))
    return replay


def _load_jax_gate():
    spec = importlib.util.spec_from_file_location("jax_maze_ilql_gate", os.path.join(ROOT, "scripts",
                                                                                     "maze_ilql_gate.py"))
    jgate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgate)
    return jgate


def _jax_run(algo):
    """The JAX gate's result, initial trunk and heads, and final state."""
    jgate = _load_jax_gate()
    rec = dict(trunks=[], heads=[], final=None, steps=0, cells=[])
    orig = dict(cfg=jconfig.TransformerConfig, init=jtransformer.init_params, head=jheads.init_head_params,
                cql=jcql.make_cql_train_step, mc=jmc.make_mc_train_step, acc=jeval.per_cell_optimal_move_accuracy)

    def init_params(config, key, *a, **kw):
        params = orig["init"](config, key, *a, **kw)
        rec["trunks"].append(_np_tree(params))
        return params

    def init_head_params(module, input_dim, key):
        params = orig["head"](module, input_dim, key)
        rec["heads"].append(_np_tree(params))
        return params

    def recording(factory):
        def make(*a, **kw):
            step = factory(*a, **kw)

            def recorded(state, batch, key):
                out = step(state, batch, key)
                rec["final"], rec["steps"] = _np_tree(out[0]), rec["steps"] + 1
                return out

            return recorded

        return make

    patches = dict(TransformerConfig=(jconfig, lambda **kw: orig["cfg"](**kw, dtype="float32")),
                   init_params=(jtransformer, init_params), init_head_params=(jheads, init_head_params),
                   make_cql_train_step=(jcql, recording(orig["cql"])), make_mc_train_step=(jmc, recording(orig["mc"])),
                   per_cell_optimal_move_accuracy=(jeval, _recording_accuracy(orig["acc"], rec["cells"])))
    saved = {name: getattr(mod, name) for name, (mod, _) in patches.items()}
    try:
        for name, (mod, fn) in patches.items():
            setattr(mod, name, fn)
        result = jgate.main(ARGV + ["--algo", algo])
    finally:
        for name, (mod, _) in patches.items():
            setattr(mod, name, saved[name])
    return result, rec


def _recording_accuracy(fn, cells: list):
    """per_cell_optimal_move_accuracy, keeping each eval's chosen action per cell."""
    def recorded(*a, **kw):
        acc, per_cell = fn(*a, **kw)
        cells.append(per_cell)
        return acc, per_cell

    return recorded


def _assert_close(name, got: torch.nn.Module, ref: dict, noise: dict):
    for k, t in got.state_dict().items():
        a, b = t.numpy(), ref[k].numpy()
        apart = np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b)
        if apart.any():
            print(f"{name}.{k}: {int(apart.sum())} of {apart.size} elements apart, max {np.abs(a - b).max():.3e}")
        bad = apart & ~noise.get(k, False)
        assert not bad.any(), (f"{name}.{k}: {int(bad.sum())} of {bad.size} elements apart where the gradient is "
                               f"not noise, max {np.abs(a - b)[bad].max():.3e}")


def _add_noise(masks: dict, grads: dict) -> None:
    """OR into `masks` the elements of `grads` whose rounding reaches Adam's
    step: at noise level (its sign may differ between the packages) or
    within 10·ε (the step's size follows the gradient's, not only its
    sign); a tensor whose gradient is all zero is exact in both."""
    for k, g in grads.items():
        g = g.abs()
        top = g.max()
        noise = ((g <= NOISE * top) | (g <= 10 * ADAM_EPS)) & (top > 0)
        masks[k] = masks.get(k, torch.zeros_like(g, dtype=torch.bool)) | noise


@pytest.fixture(scope="module")
def jax_runs():
    return {algo: _jax_run(algo) for algo in ("cql", "mc")}


@pytest.mark.parametrize("algo", ["cql", "mc"])
def test_port_maze_gate_matches_jax_gate(algo, jax_runs, monkeypatch):
    result, rec = jax_runs[algo]
    assert len(rec["trunks"]) == 1 and len(rec["heads"]) == {"cql": 2, "mc": 1}[algo] and rec["steps"] > 2

    args = tgate.parse_args(ARGV + ["--algo", algo, "--device", "cpu"])
    probe = tgate.Gate(args, dtype="float32")
    trunk = Transformer(probe.config, device="cpu")
    trunk.load_state_dict(params_from_jax(rec["trunks"][0], probe.config))
    D = probe.config.hidden_size
    q_cfg = MLPHeadConfig(D, 2 * D, probe.config.padded_vocab_size, layer2_initializer_range=0.0,
                          layer2_bias_init=args.value_bias_init)
    heads = [MLPHead(q_cfg, device="cpu") for _ in range(3)]
    for head, tree in zip(heads, rec["heads"]):
        head.load_state_dict(head_params_from_jax(tree))

    final, noise = {}, {"base": {}, "q1": {}, "q2": {}}
    factory = {"cql": (tcql, "make_cql_train_step"), "mc": (tmc, "make_mc_train_step")}[algo]
    make = getattr(*factory)

    def recording(core, config, pad):
        step = make(core, config, pad)

        def recorded(state, batch, generator=None):
            if algo == "cql":
                loss, _ = tcql.cql_forward(core, state.base.params, state.target_base_params, state.q1_head.params,
                                           state.q2_head.params, state.q1_target_params, state.q2_target_params,
                                           batch, config, pad, train=True)
                modules = (state.base.params, state.q1_head.params, state.q2_head.params)
            else:
                loss, _ = tmc.mc_loss_from_params(core, state.base.params, state.q_head.params, batch, config, pad,
                                                  train=True)
                modules = (state.base.params, state.q_head.params)
            for group, grads in zip(("base", "q1", "q2"), value_and_grads(loss, modules)):
                _add_noise(noise[group], grads)
            out = step(state, batch, generator)
            final["state"], final["steps"] = out[0], final.get("steps", 0) + 1
            return out

        return recorded

    def recording_bc(core, config, pad):
        step = make_bc(core, config, pad)

        def recorded(state, batch, generator=None):
            _add_noise(noise["base"], tbc.bc_loss_and_grads(core, state, batch, config, pad)[2])
            return step(state, batch, generator)

        return recorded

    cells, make_bc = [], tbc.make_bc_train_step
    monkeypatch.setattr(tbc, "make_bc_train_step", recording_bc)
    monkeypatch.setattr(*factory, recording)
    monkeypatch.setattr(teval, "per_cell_optimal_move_accuracy",
                        _recording_accuracy(teval.per_cell_optimal_move_accuracy, cells))
    out = tgate.run(tgate.Gate(args, dtype="float32", replay=tgate.Replay(trunk, tuple(heads))))

    # every number of the JAX gate's result, and every eval's action per cell
    assert out == result
    assert len(cells) == len(rec["cells"]) == 7 and cells == rec["cells"]
    assert final["steps"] == rec["steps"]

    # the final value-learning state
    state, ref, cfg = final["state"], rec["final"], probe.config
    noise = {group: {k: m.numpy() for k, m in masks.items()} for group, masks in noise.items()}
    _assert_close("base", state.base.params, params_from_jax(ref.base.params, cfg), noise["base"])
    if algo == "cql":
        _assert_close("target_base", state.target_base_params, params_from_jax(ref.target_base_params, cfg),
                      noise["base"])
        pairs = [("q1_head", state.q1_head.params, ref.q1_head.params, "q1"),
                 ("q2_head", state.q2_head.params, ref.q2_head.params, "q2"),
                 ("q1_target", state.q1_target_params, ref.q1_target_params, "q1"),
                 ("q2_target", state.q2_target_params, ref.q2_target_params, "q2")]
    else:
        pairs = [("q_head", state.q_head.params, ref.q_head.params, "q1")]
    for name, got, tree, group in pairs:
        _assert_close(name, got, head_params_from_jax(tree), noise[group])


def test_jax_initial_weights_are_the_jax_gates_draws(jax_runs):
    """`jax_initial_weights` gives the trunk and heads the JAX gate drew."""
    replay = jax_initial_weights(ARGV)
    _, rec = jax_runs["cql"]
    for k, t in params_from_jax(rec["trunks"][0], replay.trunk.config).items():
        assert torch.equal(replay.trunk.state_dict()[k], t), k
    for head, tree in zip(replay.heads, rec["heads"]):
        for k, t in head_params_from_jax(tree).items():
            assert torch.equal(head.state_dict()[k], t), k


class _Parsed(Exception):
    pass


def _flags(parse, monkeypatch) -> dict:
    """{dest: (default, choices)} of the parser `parse` builds."""
    seen = []

    def parse_args(self, argv=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        parse([])
    monkeypatch.undo()
    return {a.dest: (a.default, a.choices) for a in seen[0]._actions if a.dest != "help"}


def test_port_gate_flags_are_the_jax_gates_plus_device(monkeypatch):
    """The same flags, defaults and choices as the JAX gate, and --device."""
    jax_flags = _flags(_load_jax_gate().main, monkeypatch)
    port_flags = _flags(tgate.parse_args, monkeypatch)
    assert port_flags.pop("device") == ("cuda", None)
    assert port_flags == jax_flags
