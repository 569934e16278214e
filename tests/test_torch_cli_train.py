"""The port's training CLI (`lmrl_gym_torch/cli/train.py`) against the JAX
package's (`lmrl_gym_tpu/cli/train.py`) on the JAX CLI's own draws.

Each JAX CLI run (`--model-size tiny`, f32, no dropout, `--no-eval`) is
recorded: the initial modules it builds (`build_sharded_params`,
`build_head`), every train step's batch and loss (by wrapping the step
factory it calls), and every
`LMServer.generate_from_strs` call (key, prompts, outputs). The MLP
heads' layer 2, which the CLI zero-initialises, is drawn nonzero in the
JAX run (as test_torch_ilql.py's heads are), so every parameter group gets
a gradient on the first step: from a zero layer 2 the first step moves
layer 2 alone, by ±lr, its noise-level elements included, and their signs
then set the trunk's first gradients in either package. The port's
`main(argv, replay=Replay(...))` then starts from the same modules and, in
the online case, samples with the Gumbel noise each recorded key gives
(over the bucketed batch, as tests/test_torch_ppo_gate_parity.py does).

Tolerances:
- every step's batch arrays identical (the datasets and their order), but
  for PPO's float arrays (old logprobs, values, advantages, returns: the
  outputs of forwards), held to the loss tolerance;
- every step's loss within 1e-5 abs/rel (test_torch_ilql.py's loss
  tolerance);
- the saved modules within test_torch_ilql.py's 2e-6 abs + 1e-4 rel, where
  an element apart must have had, on some step, a gradient below 1e-5 of
  its tensor's largest (a tensor whose gradient is all zero on a step
  counts no element as noise there) or below 10·Adam ε = 1e-7 (the port's
  gradients, recorded by wrapping `value_and_grads`; a target module uses
  its online module's); test_torch_ilql.py's exemption, over several
  steps;
- the checkpoint layout equal to the JAX CLI's: module directories, files,
  leaf key paths and shapes, and `config.json`.

This file runs offline BC, ILQL and MC; test_torch_cli_train_ppo.py runs
offline and online PPO with the same helpers.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrl_gym_tpu.algos.value_policy as jvp
import lmrl_gym_tpu.cli.train as jtrain
from lmrl_gym_torch.algos import bc as tbc
from lmrl_gym_torch.algos import cql as tcql
from lmrl_gym_torch.algos import ilql as tilql
from lmrl_gym_torch.algos import mc as tmc
from lmrl_gym_torch.algos import ppo as tppo
from lmrl_gym_torch.cli import train as ttrain
from lmrl_gym_torch.core.checkpointing import flatten_with_paths
from lmrl_gym_torch.loops.checkpoints import load_module_params
from lmrl_gym_torch.models.convert import head_params_from_jax, head_params_to_jax, params_from_jax, params_to_jax
from lmrl_gym_torch.models.transformer import Transformer

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_ATOL, PARAM_RTOL, NOISE, ADAM_EPS = 2e-6, 1e-4, 1e-5, 1e-8
COMMON = ["--model-size", "tiny", "--n-data", "4", "--epochs", "1", "--no-eval", "--exp-name", "run"]
JAX_STEPS = ("make_bc_train_step", "make_ilql_train_step", "make_cql_train_step", "make_mc_train_step",
             "make_ppo_train_step")
PORT_STEPS = {tbc: "make_bc_train_step", tilql: "make_ilql_train_step", tcql: "make_cql_train_step",
              tmc: "make_mc_train_step", tppo: "make_ppo_train_step"}
# the online module each saved module's noise mask comes from
ONLINE_OF = {"target_base": "base", "q1_target_head": "q1_head", "q2_target_head": "q2_head"}


def _np(x):
    return None if x is None else np.asarray(x)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _batch_arrays(batch) -> dict:
    return {k: _np(v) for k, v in batch._asdict().items() if v is not None}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the CPU's small ops run faster alone than split
    across a shared machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cli_run(argv):
    """Run the JAX CLI's `main(argv)`, recording its draws, steps and
    serving calls."""
    rec = dict(trunks=[], heads=[], steps=[], calls=[])
    orig = {name: getattr(jtrain, name) for name in ("build_sharded_params", "build_head") + JAX_STEPS}
    gfs = jvp.LMServer.generate_from_strs

    def build_sharded_params(config, mesh, key):
        params = orig["build_sharded_params"](config, mesh, key)
        rec["trunks"].append(_np_tree(params))
        return params

    def build_head(kind, config, mesh, key, output_dim=None, bias_init=0.0):
        head, head_cfg, params = orig["build_head"](kind, config, mesh, key, output_dim, bias_init)
        if kind == "mlp":  # a nonzero layer 2, so every group gets a gradient on the first step
            k = params["dense2"]["kernel"]
            draw = np.random.default_rng(len(rec["heads"])).normal(0.0, 0.02, k.shape).astype(np.float32)
            params = dict(params, dense2=dict(params["dense2"], kernel=jnp.asarray(draw)))
        rec["heads"].append(dict(kind=kind, output_dim=output_dim, bias_init=bias_init, params=_np_tree(params)))
        return head, head_cfg, params

    def step_factory(name):
        def make(*a, **kw):
            step = orig[name](*a, **kw)

            def recorded(state, batch, key):
                out = step(state, batch, key)
                rec["steps"].append(dict(batch=_batch_arrays(batch), loss=float(out[1])))
                return out

            return recorded

        return make

    def generate_from_strs(self, params, prompts, max_input_length, sampling, key):
        outs = gfs(self, params, prompts, max_input_length, sampling, key)
        rec["calls"].append(dict(key=key, B=len(prompts), greedy=sampling.greedy, n=sampling.max_new_tokens,
                                 prompts=list(prompts), outs=list(outs)))
        return outs

    patches = {"build_sharded_params": build_sharded_params, "build_head": build_head,
               **{name: step_factory(name) for name in JAX_STEPS}}
    try:
        for name, fn in patches.items():
            setattr(jtrain, name, fn)
        jvp.LMServer.generate_from_strs = generate_from_strs
        jtrain.main(argv)
    finally:
        for name, fn in orig.items():
            setattr(jtrain, name, fn)
        jvp.LMServer.generate_from_strs = gfs
    return rec


def gumbel_of(call: dict, V: int) -> torch.Tensor:
    """The noise a sampled JAX `generate` call drew: per new token, the
    Gumbel draw of its split key over the bucketed batch (the next power of
    two, `_bucket_batch`), cut to the call's rows."""
    Bp = 1 << max(0, call["B"] - 1).bit_length()
    keys = jax.random.split(call["key"], call["n"])
    return torch.stack([torch.from_numpy(np.array(jax.random.gumbel(k, (Bp, V), jnp.float32)))[:call["B"]]
                        for k in keys])


def replay_of(rec: dict, algo: str, config) -> ttrain.Replay:
    """The recorded initial modules as the port's, by checkpoint name."""
    trunk = Transformer(config, device="cpu")
    trunk.load_state_dict(params_from_jax(rec["trunks"][0], config))
    names = {"ilql": ["q1_head", "q2_head", "v_head"], "cql": ["q1_head", "q2_head"], "mc": ["q_head"],
             "ppo": ["value_head"]}.get(algo, [])
    modules = {"policy" if algo == "ppo" else "base": trunk}
    for name, h in zip(names, rec["heads"]):
        head, _ = ttrain.build_head(h["kind"], config, "cpu", 0, h["output_dim"], h["bias_init"])
        head.load_state_dict(head_params_from_jax(h["params"]))
        modules[name] = head
    gumbels = iter([gumbel_of(c, config.padded_vocab_size) for c in rec["calls"] if not c["greedy"]])
    return ttrain.Replay(modules, gumbels)


def port_cli_run(argv, replay, monkeypatch):
    """Run the port's `main(argv, replay)`, recording each step's batch,
    loss and gradients (by module) and every serving call."""
    rec = dict(steps=[], grads=[], calls=[])
    for module, name in PORT_STEPS.items():
        make = getattr(module, name)

        def factory(*a, _make=make, **kw):
            step = _make(*a, **kw)

            def recorded(state, batch, generator=None):
                out = step(state, batch, generator)
                rec["steps"].append(dict(batch={k: v.numpy() for k, v in batch._asdict().items() if v is not None},
                                         loss=float(out[1])))
                return out

            return recorded

        monkeypatch.setattr(module, name, factory)
        vag = module.value_and_grads

        def value_and_grads(loss, modules, _vag=vag):
            grads = _vag(loss, modules)
            rec["grads"].append([(m, g) for m, g in zip(modules, grads)])
            return grads

        monkeypatch.setattr(module, "value_and_grads", value_and_grads)
    gfs = ttrain.LMServer.generate_from_strs

    def generate_from_strs(self, params, prompts, *a, **kw):
        outs = gfs(self, params, prompts, *a, **kw)
        rec["calls"].append(dict(prompts=list(prompts), outs=list(outs)))
        return outs

    monkeypatch.setattr(ttrain.LMServer, "generate_from_strs", generate_from_strs)
    state, loop_state = ttrain.main(argv + ["--device", "cpu"], replay=replay)
    return rec, state, loop_state


def noise_masks(port_rec, modules: dict, config) -> dict:
    """Per checkpoint module, per flax key path: where some step's gradient
    was at noise level (the module identified among the step's groups)."""
    masks = {}
    by_id = {id(m): name for name, m in modules.items()}
    for groups in port_rec["grads"]:
        for module, grads in groups:
            name = by_id[id(module)]
            sd = {k: g.detach().abs() for k, g in grads.items()}
            tree = params_to_jax(sd, config) if isinstance(module, Transformer) else head_params_to_jax(sd)
            for path, g in flatten_with_paths(tree):
                top = g.max()
                noise = (((g <= NOISE * top) | (g <= 10 * ADAM_EPS)) & (top > 0)).numpy()
                key = (name, path)
                masks[key] = masks.get(key, np.zeros_like(noise)) | noise
    return masks


def assert_same_checkpoint(jax_dir: str, port_dir: str, masks: dict):
    """Equal layout (module dirs, files, key paths, shapes, config.json)
    and parameters within the tolerances above."""
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    for name in names:
        jd, pd = os.path.join(jax_dir, name), os.path.join(port_dir, name)
        if not os.path.isdir(jd):
            continue
        assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)), name
        if os.path.exists(os.path.join(jd, "config.json")):
            with open(os.path.join(jd, "config.json")) as f, open(os.path.join(pd, "config.json")) as g:
                assert json.load(g) == json.load(f), name
        jt, pt = dict(flatten_with_paths(load_module_params(jax_dir, name))), dict(
            flatten_with_paths(load_module_params(port_dir, name)))
        assert sorted(pt) == sorted(jt), name
        for path, ref in jt.items():
            a, b = pt[path].numpy(), ref.numpy()
            assert a.shape == b.shape, (name, path)
            apart = np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b)
            if apart.any():
                print(f"{name}/{path}: {int(apart.sum())} of {apart.size} apart, max {np.abs(a - b).max():.3e}")
            mask = masks.get((ONLINE_OF.get(name, name), path), np.zeros_like(apart))
            assert not (apart & ~mask).any(), f"{name}/{path}: elements apart where the gradient is not noise"


def assert_same_steps(jrec, prec):
    assert len(prec["steps"]) == len(jrec["steps"]) > 0
    for i, (js, ps) in enumerate(zip(jrec["steps"], prec["steps"])):
        assert sorted(ps["batch"]) == sorted(js["batch"]), i
        for k, v in js["batch"].items():
            if v.dtype.kind == "f":  # PPO's logprobs, values, advantages: computed by forwards
                np.testing.assert_allclose(ps["batch"][k], v, err_msg=f"step {i} {k}", **LOSS_TOL)
            else:
                np.testing.assert_array_equal(ps["batch"][k], v, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(ps["loss"], js["loss"], err_msg=f"step {i}", **LOSS_TOL)


def check_cli_parity(algo: str, extra, tmp_path, monkeypatch, last="last"):
    """The JAX CLI run and recorded, then the port's replayed; → both
    records."""
    argv = ["--algo", algo] + COMMON + list(extra)
    jrec = jax_cli_run(argv + ["--save-dir", str(tmp_path / "jax")])
    assert jrec["trunks"] and jrec["steps"]
    config = ttrain.MODEL_SIZES["tiny"]()
    replay = replay_of(jrec, algo, config)
    modules = dict(replay.modules)
    prec, state, _ = port_cli_run(argv + ["--save-dir", str(tmp_path / "port")], replay, monkeypatch)
    assert_same_steps(jrec, prec)
    masks = noise_masks(prec, modules, config)
    assert_same_checkpoint(str(tmp_path / "jax" / "run" / last), str(tmp_path / "port" / "run" / last), masks)
    return jrec, prec


@pytest.mark.parametrize("algo,extra", [
    ("bc", ["--task", "maze"]),
    ("ilql", ["--task", "maze", "--train-bsize", "32"]),
    ("mc", ["--task", "text_nav", "--max-length", "256"]),
])
def test_offline_cli_matches_jax_cli(algo, extra, tmp_path, monkeypatch):
    check_cli_parity(algo, extra, tmp_path, monkeypatch)
