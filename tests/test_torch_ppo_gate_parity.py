"""The port's PPO gates (`lmrl_gym_torch/scripts/{text_nav,maze}_ppo_gate.py`)
against the JAX gates (`scripts/{text_nav,maze}_ppo_gate.py`) on the JAX
gates' own draws.

Each JAX gate runs at a tiny budget (d64 L2 H4, a few BC episodes or
chains, two PPO rounds of two rollouts and one epoch, the first warming
up the value head only, four eval episodes per policy, episodes cut to 5 turns (Text-Nav's
--max-steps) or 8 moves (the maze env's, patched into both packages'
`build_maze_env`)) with f32 activations. Its draws are
recorded: the initial trunk and value head, and the PRNG key of every
`LMServer.generate_from_strs` call, with the prompts and the actions it
returned. The port's `run` then replays them (each sampled call's key
turned into the Gumbel noise it gives, on the call's bucketed batch), so
what is tested is the glue: the data and its windows (Text-Nav's history
context, `MAX_LEN` = 640 at H = 2), the serving prompt, the BC stage, the
value warm-up round, the KL-penalised GAE data, the eval seeds.

Tolerances: every serving call's prompts and actions identical, and so
every return of the JSON result; each round's mean KL within 1e-5 abs /
1e-4 rel (a difference of two logprob forwards); the final policy and
value head within `test_torch_ilql.py`'s 2e-6 abs + 1e-4 rel, where an
element apart must have had, on some BC or PPO step, a gradient below
1e-3 of its tensor's largest or below 10·Adam ε = 1e-7 (the port's
gradients, recorded; test_torch_ppo.py holds them to JAX's). The share is
1e-3 here, not the one-stage tests' 1e-5: across the gate's two stages
(BC steps at lr 1e-3, then PPO steps on advantages that agree to 1e-4) a
gradient that small, summed in another order, differs by ~1e-4 of itself,
and Adam's first steps move it by ±lr whatever its size. Measured in a
serial run: 8 elements apart in the Text-Nav case and 5 in the maze case
(at most 2.9e-5); the masks cover 2-4% of the MLP and attention-out
weights and 50-88% of the embeddings and qkv (tokens and key directions
that barely get a gradient).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_torch.algos import bc as tbc
from lmrl_gym_torch.algos import ppo as tppo
from lmrl_gym_torch.algos import value_policy as tvp
from lmrl_gym_torch.cli import tasks as ttasks
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.heads import LinearHead, LinearHeadConfig
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.scripts import maze_ppo_gate, text_nav_ppo_gate
from lmrl_gym_tpu.algos import ppo as jppo
from lmrl_gym_tpu.algos import value_policy as jvp
from lmrl_gym_tpu.cli import tasks as jtasks
from lmrl_gym_tpu.models import config as jconfig
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtransformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--hidden", "64", "--layers", "2", "--heads", "4", "--bc-epochs", "1", "--rounds", "2",
          "--value-warmup-rounds", "1", "--epochs-per-round", "1", "--rollouts-per-round", "2",
          "--eval-rollouts", "4", "--bsize", "16"]
GATES = {
    "text_nav": (text_nav_ppo_gate, "text_nav_ppo_gate.py", COMMON + ["--n-episodes", "4", "--max-steps", "5"]),
    "maze": (maze_ppo_gate, "maze_ppo_gate.py", COMMON + ["--n-chains", "8"]),
}
MAZE_MAX_STEPS = 8  # both packages' maze gate episodes cut to 8 moves (the gate's env allows 100)
PARAM_ATOL, PARAM_RTOL, NOISE, ADAM_EPS = 2e-6, 1e-4, 1e-3, 1e-8


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _short_maze(build):
    return lambda max_steps=100, last_k=1: build(max_steps=min(max_steps, MAZE_MAX_STEPS), last_k=last_k)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the CPU decode's many small ops run faster
    alone than split across a shared machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(script: str, argv):
    """The JAX gate's result and its recorded draws, serving calls and
    final PPO state."""
    spec = importlib.util.spec_from_file_location(f"jax_{script[:-3]}", os.path.join(ROOT, "scripts", script))
    jgate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgate)
    rec = dict(trunks=[], heads=[], calls=[], final=None)
    orig = dict(cfg=jconfig.TransformerConfig, init=jtransformer.init_params, head=jheads.init_head_params,
                gfs=jvp.LMServer.generate_from_strs, ppo=jppo.make_ppo_train_step)

    def init_params(config, key, *a, **kw):
        params = orig["init"](config, key, *a, **kw)
        rec["trunks"].append(_np_tree(params))
        return params

    def init_head_params(module, input_dim, key):
        params = orig["head"](module, input_dim, key)
        rec["heads"].append(_np_tree(params))
        return params

    def generate_from_strs(self, params, prompts, max_input_length, sampling, key):
        outs = orig["gfs"](self, params, prompts, max_input_length, sampling, key)
        rec["calls"].append(dict(key=key, B=len(prompts), greedy=sampling.greedy, n=sampling.max_new_tokens,
                                 prompts=list(prompts), outs=list(outs)))
        return outs

    def make_ppo_train_step(*a, **kw):
        step = orig["ppo"](*a, **kw)

        def recorded(state, batch, key):
            out = step(state, batch, key)
            rec["final"] = _np_tree(out[0])
            return out

        return recorded

    patches = dict(TransformerConfig=(jconfig, lambda **kw: orig["cfg"](**kw, dtype="float32")),
                   init_params=(jtransformer, init_params), init_head_params=(jheads, init_head_params),
                   generate_from_strs=(jvp.LMServer, generate_from_strs),
                   make_ppo_train_step=(jppo, make_ppo_train_step),
                   build_maze_env=(jtasks, _short_maze(jtasks.build_maze_env)))
    saved = {name: getattr(obj, name) for name, (obj, _) in patches.items()}
    try:
        for name, (obj, fn) in patches.items():
            setattr(obj, name, fn)
        result = jgate.main(argv)
    finally:
        for name, (obj, _) in patches.items():
            setattr(obj, name, saved[name])
    return result, rec


def _gumbel(call: dict, V: int) -> torch.Tensor:
    """The noise a sampled JAX `generate` call drew: per new token, the
    Gumbel draw of its split key over the bucketed batch (a power of two,
    `_bucket_batch`), cut to the call's rows."""
    Bp = 1 << max(0, call["B"] - 1).bit_length()
    keys = jax.random.split(call["key"], call["n"])
    return torch.stack([torch.from_numpy(np.array(jax.random.gumbel(k, (Bp, V), jnp.float32)))[:call["B"]]
                        for k in keys])


def _add_noise(masks: dict, grads: dict) -> None:
    for k, g in grads.items():
        g = g.detach().abs()
        top = g.max()
        noise = ((g <= NOISE * top) | (g <= 10 * ADAM_EPS)) & (top > 0)
        masks[k] = masks.get(k, torch.zeros_like(g, dtype=torch.bool)) | noise


def _assert_close(name, got: torch.nn.Module, ref: dict, noise: dict):
    for k, t in got.state_dict().items():
        a, b = t.numpy(), ref[k].numpy()
        apart = np.abs(a - b) > PARAM_ATOL + PARAM_RTOL * np.abs(b)
        if apart.any():
            print(f"{name}.{k}: {int(apart.sum())} of {apart.size} elements apart, max {np.abs(a - b).max():.3e}")
        mask = noise[k].numpy() if k in noise else np.zeros_like(apart)
        bad = apart & ~mask
        assert not bad.any(), f"{name}.{k}: {int(bad.sum())} elements apart where the gradient is not noise"


def test_port_text_nav_gate_matches_jax_gate(monkeypatch):
    check_port_gate("text_nav", monkeypatch)


def check_port_gate(name: str, monkeypatch):
    """The JAX gate `name` run and recorded, then the port's replayed."""
    module, script, argv = GATES[name]
    result, rec = _jax_run(script, argv)
    assert len(rec["trunks"]) == 1 and len(rec["heads"]) == 1 and rec["final"] is not None
    assert any(not c["greedy"] for c in rec["calls"]) and any(c["greedy"] for c in rec["calls"])

    args = module.parse_args(argv + ["--device", "cpu"])
    probe = module.Gate(args, dtype="float32")
    if name == "text_nav":
        assert probe.MAX_LEN == 640 and probe.config.max_position_embeddings == 640
    trunk = Transformer(probe.config, device="cpu")
    trunk.load_state_dict(params_from_jax(rec["trunks"][0], probe.config))
    value_head = LinearHead(LinearHeadConfig(probe.config.hidden_size, 1, bias_init=0.0), device="cpu")
    value_head.load_state_dict(head_params_from_jax(rec["heads"][0]))
    V = probe.config.padded_vocab_size
    gumbels = [_gumbel(c, V) for c in rec["calls"] if not c["greedy"]]

    calls, noise, final = [], {"policy": {}, "value_head": {}}, {}
    gfs, vag_ppo, vag_bc, make_step = (tvp.LMServer.generate_from_strs, tppo.value_and_grads, tbc.value_and_grads,
                                       tppo.make_ppo_train_step)

    def generate_from_strs(self, params, prompts, *a, **kw):
        outs = gfs(self, params, prompts, *a, **kw)
        calls.append(dict(prompts=list(prompts), outs=list(outs)))
        return outs

    def ppo_grads(loss, modules):
        grads = vag_ppo(loss, modules)
        for group, g in zip(("policy", "value_head"), grads):
            _add_noise(noise[group], g)
        return grads

    def bc_grads(loss, modules):
        grads = vag_bc(loss, modules)
        _add_noise(noise["policy"], grads[0])
        return grads

    def recording_step(*a, **kw):
        step = make_step(*a, **kw)

        def recorded(state, batch, generator=None):
            out = step(state, batch, generator)
            final["state"] = out[0]
            return out

        return recorded

    monkeypatch.setattr(tvp.LMServer, "generate_from_strs", generate_from_strs)
    monkeypatch.setattr(tppo, "value_and_grads", ppo_grads)
    monkeypatch.setattr(tbc, "value_and_grads", bc_grads)
    monkeypatch.setattr(tppo, "make_ppo_train_step", recording_step)
    monkeypatch.setattr(ttasks, "build_maze_env", _short_maze(ttasks.build_maze_env))
    replay = module.Replay(trunk, value_head, iter(gumbels))
    out = module.run(module.Gate(args, dtype="float32", replay=replay))
    assert next(replay.gumbels, None) is None  # every draw consumed

    # every serving call: the same prompts, the same actions
    assert len(calls) == len(rec["calls"])
    for i, (port, ref) in enumerate(zip(calls, rec["calls"])):
        assert port["prompts"] == ref["prompts"], f"call {i}: prompts"
        assert port["outs"] == ref["outs"], f"call {i}: actions"
    if name == "text_nav":  # the prompts carry H = 2 past turns: three observations at most
        assert max(p.count("Admissible commands") for c in calls for p in c["prompts"]) == 3

    # every number of the JSON result
    assert set(out) == set(result)
    for k in ("bc_return", "ppo_return", "improvement", "bc_return_greedy", "ppo_return_greedy"):
        assert out[k] == result[k], (k, out[k], result[k])
    assert len(out["kl_trace"]) == len(result["kl_trace"]) == 2
    for got, want in zip(out["kl_trace"], result["kl_trace"]):
        assert set(got) == set(want) and got["round"] == want["round"]
        assert got["rollout_reward"] == want["rollout_reward"]
        for k in set(got) - {"round", "rollout_reward"}:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-4, err_msg=k)

    # the final policy and value head
    state, ref = final["state"], rec["final"]
    _assert_close("policy", state.policy.params, params_from_jax(ref.policy.params, probe.config), noise["policy"])
    _assert_close("value_head", state.value_head.params, head_params_from_jax(ref.value_head.params),
                  noise["value_head"])


class _Parsed(Exception):
    pass


def _flags(parse, monkeypatch) -> dict:
    """{dest: (default, choices)} of the parser `parse` builds."""
    import argparse

    seen = []

    def parse_args(self, argv=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        parse([])
    monkeypatch.undo()
    return {a.dest: (a.default, a.choices) for a in seen[0]._actions if a.dest != "help"}


@pytest.mark.parametrize("name", sorted(GATES))
def test_port_gate_flags_are_the_jax_gates_plus_device(name, monkeypatch):
    module, script, _ = GATES[name]
    spec = importlib.util.spec_from_file_location(f"jax_flags_{script[:-3]}", os.path.join(ROOT, "scripts", script))
    jgate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgate)
    port, ref = _flags(module.parse_args, monkeypatch), _flags(jgate.main, monkeypatch)
    assert port.pop("device") == ("cuda", None)
    assert port == ref
