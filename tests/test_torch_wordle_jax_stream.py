"""The port's Wordle ILQL gate draws the JAX gate's own random stream
(`lmrl_gym_torch/core/threefry.py`; `ScriptedNoise.from_key`,
`WordleNoise.from_key`, `init_params_from_key`, `head_from_key`), held to
the JAX package on the CPU. Both gates run once, at the gate parity
test's tiny budget (d64 L2 H4, f32 activations; `ARGV` of
`test_torch_wordle_gate_parity.py`), the port's with no replayed draw or
weight:

- its behavior and ceiling statistics (PRNGKey(1000 + s) and
  PRNGKey(2000 + s), B = 2,048) equal the four numbers of
  `GATE_WORDLE_ILQL_r05.json` exactly;
- its scripted rollout at PRNGKey(1000) writes the JAX rollout's tokens,
  rewards and wins;
- its JSON result equals the JAX gate's, number for number, and every
  eval rollout decodes the JAX gate's token stream;
- the key-to-noise constructors give the draws the gate parity test
  replays (`_scripted_noise`, `_rollout_noise`), bit for bit;
- the gate's initial trunk (PRNGKey(seed)) and heads (split(PRNGKey(2),
  3)) at its default d256 L4 lie within 1e-6 abs of the JAX gate's (the
  one inexact step is erf⁻¹ in the normal draws).
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_wordle_gate_parity import ARGV, _rollout_noise, _scripted_noise

from lmrl_gym_torch.core import threefry as tf
from lmrl_gym_torch.envs.wordle.vector import WordleVocab
from lmrl_gym_torch.loops import actor as tactor
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.heads import head_from_key
from lmrl_gym_torch.models.transformer import init_params_from_key
from lmrl_gym_torch.scripts import wordle_ilql_gate as tgate
from lmrl_gym_tpu.envs.wordle.vector import WordleVectorEnv as JaxWordleVectorEnv
from lmrl_gym_tpu.envs.wordle.vector import WordleVocab as JaxWordleVocab
from lmrl_gym_tpu.loops import actor as jactor
from lmrl_gym_tpu.models import config as jconfig
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtransformer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHT_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the draws' many elementwise passes run faster
    alone than split across a shared machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX gate at the parity test's tiny budget (f32 activations):
    its result and every eval rollout's tokens."""
    spec = importlib.util.spec_from_file_location("jax_wordle_ilql_gate", os.path.join(ROOT, "scripts",
                                                                                       "wordle_ilql_gate.py"))
    jgate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgate)
    tokens, cfg, rollout = [], jconfig.TransformerConfig, jactor.rollout_wordle

    def recorded(*a, **kw):
        out = rollout(*a, **kw)
        tokens.append(np.asarray(out.tokens))
        return out

    saved = jconfig.TransformerConfig, jactor.rollout_wordle
    try:
        jconfig.TransformerConfig = lambda **kw: cfg(**kw, dtype="float32")
        jactor.rollout_wordle = recorded
        result = jgate.main(ARGV)
    finally:
        jconfig.TransformerConfig, jactor.rollout_wordle = saved
    return result, tokens


@pytest.fixture(scope="module")
def port_run():
    """The port's gate at the same budget with no replay: its result, its
    scripted rollouts (key, batch, rollout) and every eval's tokens."""
    g = tgate.Gate(tgate.parse_args(ARGV + ["--device", "cpu"]), dtype="float32")
    scripted, tokens = [], []
    gate_scripted, rollout = g.scripted, tactor.rollout_wordle

    def recorded_scripted(batch, p_smart, p_repeat, key):
        out = gate_scripted(batch, p_smart, p_repeat, key)
        scripted.append((key.clone(), batch, out))
        return out

    def recorded_rollout(*a, **kw):
        out = rollout(*a, **kw)
        tokens.append(out.tokens.numpy())
        return out

    g.scripted = recorded_scripted
    tactor.rollout_wordle = recorded_rollout
    try:
        result = tgate.run(g)
    finally:
        tactor.rollout_wordle = rollout
    return g, result, scripted, tokens


def test_gate_stats_equal_the_record(port_run):
    g, result, scripted, _ = port_run
    with open(os.path.join(ROOT, "GATE_WORDLE_ILQL_r05.json")) as f:
        record = json.load(f)
    assert (g.args.prob_smart, g.args.prob_repeat) == (record["args"]["prob_smart"], 0.0)
    assert [(tuple(k.tolist()), n) for k, n, _ in scripted[:4]] == [((0, s), 2048) for s in (1000, 1001, 2000, 2001)]
    for k in ("behavior_return", "behavior_win", "consistent_ceiling_return", "consistent_ceiling_win"):
        assert result[k] == record[k], (k, result[k], record[k])


def test_scripted_rollout_equals_jax(port_run):
    g, _, scripted, _ = port_run
    key, B, got = scripted[0]
    want = jactor.rollout_wordle_scripted(JaxWordleVectorEnv(JaxWordleVocab.from_file()), jax.random.PRNGKey(1000),
                                          jnp.zeros((B,)), g.args.prob_smart, 0.0)
    for name in ("tokens", "turn_reward", "turn_live", "win", "n_turns"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)


def test_tiny_gate_equals_the_jax_gate(port_run, jax_run):
    """No replayed draw or weight: every number of the JAX gate's result
    and every eval's token stream, identically."""
    _, result, _, tokens = port_run
    want, want_tokens = jax_run
    assert set(result) == set(want)
    for k in want:
        if k != "model":
            assert result[k] == want[k], (k, result[k], want[k])
    assert len(tokens) == len(want_tokens) == 8
    for i, (a, b) in enumerate(zip(tokens, want_tokens)):
        np.testing.assert_array_equal(a, b, err_msg=f"eval {i}")


@pytest.mark.parametrize("seed,B", [(7, 16), (5 * 977 + 13, 64), (2001, 5)])
def test_scripted_noise_from_key(seed, B):
    V_words = len(WordleVocab.from_file())
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    got = tactor.ScriptedNoise.from_key(tf.split(tf.PRNGKey(seed))[1], B, V_words, "cpu")
    want = _scripted_noise(key, B, V_words)
    for name in got._fields:
        assert getattr(got, name).shape == getattr(want, name).shape, name
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name).numpy(), err_msg=name)


@pytest.mark.parametrize("seed,B", [(5 * 31, 8), (5 * 31 + 1, 3)])
def test_rollout_noise_from_key(seed, B):
    V, V_words = 320, len(WordleVocab.from_file())
    got = tactor.WordleNoise.from_key(tf.PRNGKey(seed), B, V, V_words, "cpu")
    want = _rollout_noise(jax.random.PRNGKey(seed), B, V, V_words)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name).numpy(), err_msg=name)


def test_initial_weights_match_the_jax_gate():
    """At the gate's defaults (d256 L4 H4, byte vocab padded to 320)."""
    args = tgate.parse_args(["--device", "cpu"])
    cfg = tgate.Gate.trunk_config(args, "float32")
    jcfg = jconfig.TransformerConfig(
        vocab_size=cfg.vocab_size, hidden_size=args.hidden, num_layers=args.layers, num_heads=args.heads,
        max_position_embeddings=jactor.EPISODE_LEN, pad_vocab_to_multiple=64, embd_pdrop=0.0, resid_pdrop=0.0,
        attn_pdrop=0.0)
    want = params_from_jax(jax.tree.map(np.asarray, jtransformer.init_params(jcfg, jax.random.PRNGKey(args.seed))), cfg)
    got = init_params_from_key(cfg, tf.PRNGKey(args.seed), device="cpu").state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=WEIGHT_ATOL, err_msg=k)

    D = args.hidden
    heads = tgate.Gate.head_modules(args, cfg, "cpu")
    for head, jkey, tkey in zip(heads, jax.random.split(jax.random.PRNGKey(2), 3), tf.split(tf.PRNGKey(2), 3)):
        c = head.config
        jhead = jheads.MLPHead(jheads.MLPHeadConfig(
            input_dim=D, hidden_dim=2 * D, output_dim=c.output_dim, layer2_initializer_range=0.0,
            layer2_bias_init=args.value_bias_init))
        want = head_params_from_jax(jax.tree.map(np.asarray, jheads.init_head_params(jhead, D, jkey)))
        got = head_from_key(head, tkey).state_dict()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=WEIGHT_ATOL, err_msg=k)
