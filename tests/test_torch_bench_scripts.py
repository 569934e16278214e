"""The port's bench (`lmrl_gym_torch/scripts/bench.py`) against `bench.py`,
on the CPU.

(a) FLOP counts: `ilql_update_flops` equals bench.py's inline count
    (bench.py:147-164, the same formula at :319-337, copied below) exactly,
    as integers, at both ILQL operating points. The JAX parameter counts
    come from `jax.eval_shape` of `init_params` / `init_head_params` (no
    jit, no step); the port's from its modules built under
    `FakeTensorMode` (shapes only, nothing allocated). At 50,257 ids one
    update is 11.784 TFLOP.
(b) Setup glue: each ILQL section and the profile's `build_step`, cut to
    d64 L2 H4 f32 by `bench.ilql_config` (their own vocab and pad rules
    kept), build their state, step and batch; the JAX side is the JAX
    package's functions built the way bench.py:87-133 and scripts/
    profile_ilql.py:34-84 build them, at the same width. The batch equals
    the JAX bench's draws; with the JAX weights carried in
    (`models/convert.py`), the first step's loss is within
    tests/test_torch_ilql.py's LOSS_TOL (1e-5 abs and rel) of the JAX
    step's. `bench_actor`, `bench_actor_real_vocab`, `bench_actor_markov`
    and `bench_env` run one B=4 rollout each and return exactly the JAX
    section's keys (bench.py:166-173, 222-228, 338-343, 387-395, 456-458,
    495-500).
(f) `main --device cpu` prints one JSON line that parses; without it and
    without CUDA it raises; a failing section raises.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from lmrl_gym_tpu.algos import ilql as jilql
from lmrl_gym_tpu.models.config import TransformerConfig as JConfig
from lmrl_gym_tpu.models.heads import MLPHead as JMLPHead
from lmrl_gym_tpu.models.heads import MLPHeadConfig as JMLPHeadConfig
from lmrl_gym_tpu.models.heads import init_head_params
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.models.transformer import init_params as jinit_params
from lmrl_gym_torch.models.convert import ilql_state_from_jax
from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.transformer import init_params
from lmrl_gym_torch.scripts import bench
from test_torch_ilql import LOSS_TOL
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = dict(hidden_size=64, num_layers=2, num_heads=4, dtype="float32")
B, T = 4, 16
# bench.py's ILQL points: (vocab, pad multiple, pad id); and the profile's
# build_step rules at 50,257 ids: pad to 128 above 1,000 ids, pad id
# min(vocab - 1, 256) (scripts/profile_ilql.py:49-53, :79)
POINTS = {"bench_ilql": (259, 64, 256), "bench_ilql_real_vocab": (50257, 128, 50256)}
PROFILE_POINT = (50257, 128, 256)
SECTION_KEYS = {  # bench.py:166-173, 222-228, 338-343, 387-395, 456-458, 495-500
    "bench_ilql": {"ilql_updates_per_s_gpt2small", "ilql_tokens_per_s", "ilql_mfu_pct", "ilql_model"},
    "bench_actor": {"fused_actor_env_steps_per_s_per_chip", "fused_actor_tokens_per_s_per_chip", "fused_actor_model"},
    "bench_ilql_real_vocab": {"ilql_updates_per_s_vocab50257", "ilql_tokens_per_s_vocab50257",
                              "ilql_mfu_pct_vocab50257", "ilql_model_vocab50257"},
    "bench_actor_real_vocab": {"fused_actor_env_steps_per_s_per_chip_vocab50257",
                               "fused_actor_tokens_per_s_per_chip_vocab50257", "fused_actor_model_vocab50257"},
    "bench_actor_markov": {"fused_maze_actor_env_steps_per_s_per_chip", "fused_chess_actor_env_steps_per_s_per_chip"},
    "bench_env": {"metric", "value", "unit", "vs_baseline"},
}


def _bench_py_flops(config, B, T, N_base, N_head, N_v):
    """bench.py:147-164, as written there (B, T and the 16-token next window)."""
    L, H, Dh = config.num_layers, config.num_heads, config.head_dim
    tok_main = B * T
    tok_next = B * 16
    attn_fwd = 4 * L * H * Dh * T * tok_main
    return (
        tok_main * 6 * N_base
        + tok_main * 2 * N_base
        + tok_next * 2 * N_base
        + tok_main * (2 * 6 * N_head + 6 * N_v)
        + tok_main * 2 * 2 * N_head
        + 3 * attn_fwd
    )


def _jax_config(vocab, pad_multiple, **kw):
    return JConfig(vocab_size=vocab, hidden_size=768, num_layers=12, num_heads=12, max_position_embeddings=1024,
                   pad_vocab_to_multiple=pad_multiple, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0).replace(**kw)


def _jax_heads(config):
    D = config.hidden_size
    q = JMLPHead(JMLPHeadConfig(input_dim=D, hidden_dim=2 * D, output_dim=config.padded_vocab_size,
                                layer2_initializer_range=0.0))
    v = JMLPHead(JMLPHeadConfig(input_dim=D, hidden_dim=2 * D, output_dim=1, layer2_initializer_range=0.0))
    return q, v


def _size(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("section", sorted(POINTS))
def test_ilql_update_flops_equals_bench_py(section):
    vocab, pad_multiple, _ = POINTS[section]
    jcfg = _jax_config(vocab, pad_multiple)
    q, v = _jax_heads(jcfg)
    key = jax.random.PRNGKey(0)
    n_base = _size(jax.eval_shape(lambda k: jinit_params(jcfg, k), key))
    n_head = _size(jax.eval_shape(lambda k: init_head_params(q, 768, k), key))
    n_v = _size(jax.eval_shape(lambda k: init_head_params(v, 768, k), key))

    tcfg = bench.ilql_config(vocab, pad_multiple)
    D = tcfg.hidden_size
    with FakeTensorMode():
        counts = (bench.n_params(init_params(tcfg, device="cpu")),
                  bench.n_params(MLPHead(MLPHeadConfig(D, 2 * D, tcfg.padded_vocab_size), device="cpu")),
                  bench.n_params(MLPHead(MLPHeadConfig(D, 2 * D, 1), device="cpu")))
    assert counts == (n_base, n_head, n_v)
    got = bench.ilql_update_flops(tcfg, 32, 160, 16, *counts)
    assert isinstance(got, int) and got == _bench_py_flops(jcfg, 32, 160, n_base, n_head, n_v)
    if vocab == 50257:
        assert round(got / 1e12, 3) == 11.784


def _jax_setup(vocab, pad_multiple):
    """bench.py:87-133 (and scripts/profile_ilql.py:34-84) at WIDTH: the
    config, the heads, the state and the batch (the initializers under jit:
    eager flax init compiles op by op)."""
    config = _jax_config(vocab, pad_multiple, **WIDTH)
    q, v = _jax_heads(config)
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    D = config.hidden_size
    heads = jax.jit(init_head_params, static_argnums=(0, 1))
    state = jilql.init_ilql_state(
        jax.jit(jinit_params, static_argnums=0)(config, ks[0]), heads(q, D, ks[1]), heads(q, D, ks[2]),
        heads(v, D, ks[3]), optax.adamw(1e-4), optax.adamw(1e-3), jilql.ILQLConfig(),
    )
    rng = np.random.default_rng(0)
    sta = np.zeros((B, T - 1), bool)
    sta[:, 1::2] = True
    batch = jilql.ILQLBatch(
        input_ids=jnp.asarray(rng.integers(1, 256, (B, T)), jnp.int32),
        should_take_action=jnp.asarray(sta),
        rewards=jnp.asarray(-1.0 * sta, jnp.float32),
        dones=jnp.zeros((B,), bool),
        next_token_ids=jnp.asarray(rng.integers(1, 256, (B, 16)), jnp.int32),
        next_dones=jnp.ones((B,), bool),
    )
    return config, q, v, state, batch


@pytest.fixture(scope="module")
def jax_runs():
    """{(vocab, pad multiple): (config, initial state as numpy, batch, first loss)}
    at each ILQL point, pad id as bench.py passes it. The first step's loss
    is the value `make_ilql_train_step`'s step returns before its update:
    `ilql_forward` with `train=True` and no dropout key, here under jit
    (forward only: half the compile of the whole step)."""
    out = {}
    for vocab, pad_multiple, pad_id in POINTS.values():
        config, q, v, state, batch = _jax_setup(vocab, pad_multiple)

        def loss_fn(st, b):
            return jilql.ilql_forward(JCore(config), q, v, st.base.params, st.target_base_params, st.q1_head.params,
                                      st.q2_head.params, st.v_head.params, st.q1_target_params, st.q2_target_params,
                                      b, jilql.ILQLConfig(), pad_id, train=True, rng=None)[0]

        out[(vocab, pad_multiple)] = (config, jax.tree.map(np.asarray, state), batch,
                                      float(jax.jit(loss_fn)(state, batch)))
    return out


@pytest.fixture
def tiny_bench(monkeypatch):
    """bench's ILQL trunk cut to WIDTH (vocab and pad rules kept), and
    every `ilql_setup` call recorded."""
    full = bench.ilql_config
    monkeypatch.setattr(bench, "ilql_config", lambda vocab, pad: full(vocab, pad).replace(**WIDTH))
    calls = []
    setup = bench.ilql_setup

    def recorded(config, B, T, pad_id, device="cuda"):
        out = setup(config, B, T, pad_id, device)
        calls.append((config, pad_id, out))
        return out

    monkeypatch.setattr(bench, "ilql_setup", recorded)
    return calls


def _hold_to_jax(config, pad_id, state, step, batch, point, jax_runs):
    vocab, pad_multiple, want_pad = point
    jconfig, jinit, jbatch, jloss = jax_runs[(vocab, pad_multiple)]
    assert (config.vocab_size, config.padded_vocab_size, pad_id) == (vocab, jconfig.padded_vocab_size, want_pad)
    for name in jbatch._fields:
        got, want = getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name))
        assert got.shape == want.shape and np.array_equal(got, want), name
    # no batch token is a pad id, so the JAX step's loss holds for either pad id
    assert not np.isin(batch.input_ids.numpy(), [256, vocab - 1]).any()
    ilql_state_from_jax(state, config, jinit.base.params, jinit.target_base_params, jinit.q1_head.params,
                        jinit.q2_head.params, jinit.v_head.params, jinit.q1_target_params, jinit.q2_target_params)
    _, loss, _ = step(state, batch)
    np.testing.assert_allclose(loss.item(), jloss, **LOSS_TOL)


@pytest.mark.parametrize("section", sorted(POINTS))
def test_ilql_section_setup_matches_jax(section, tiny_bench, jax_runs):
    out = getattr(bench, section)(B=B, T=T, reps=1, device="cpu")
    assert set(out) == SECTION_KEYS[section] and all(np.isfinite(v) for v in out.values() if not isinstance(v, str))
    assert len(tiny_bench) == 1
    config, pad_id, _ = tiny_bench[0]
    state, step, batch = bench.ilql_setup(config, B, T, pad_id, "cpu")  # fresh: the section stepped its own
    _hold_to_jax(config, pad_id, state, step, batch, POINTS[section], jax_runs)


def test_profile_build_step_matches_jax(tiny_bench, jax_runs):
    from lmrl_gym_torch.scripts import profile_ilql

    profile_ilql.build_step(50257, B, T, "cpu")
    config, pad_id, (state, step, batch) = tiny_bench[0]
    _hold_to_jax(config, pad_id, state, step, batch, PROFILE_POINT, jax_runs)


SMALL = dict(hidden_size=64, num_layers=2, num_heads=4)


@pytest.mark.parametrize("section,kw", [
    ("bench_actor", dict(config=bench.actor_config(512).replace(**SMALL))),
    ("bench_actor_real_vocab", dict(config=bench.actor_config(50257).replace(**SMALL), serve_f32=True)),
    ("bench_actor_markov", dict(config=bench.actor_config(512).replace(**SMALL))),
    ("bench_env", dict()),
])
def test_rollout_sections_return_the_jax_keys(section, kw):
    out = getattr(bench, section)(B=4, reps=1, device="cpu", **kw)
    assert set(out) == SECTION_KEYS[section]
    assert all(v > 0 for k, v in out.items() if k.endswith("_per_chip") or k in ("value", "vs_baseline"))


def test_main_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_MODE", "env")
    monkeypatch.setenv("BENCH_BATCH", "4")
    monkeypatch.setenv("BENCH_REPS", "1")
    result = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result and set(result) == SECTION_KEYS["bench_env"]
    assert result["metric"] == "wordle_batched_env_steps_per_s_per_chip" and result["unit"] == "env-steps/s/chip"


def test_main_order_and_sizes_follow_bench_py(monkeypatch):
    """BENCH_MODE=all runs bench.py:529-549's order; the sizes come from
    the JAX bench's environment variables; a failing section raises."""
    ran = []
    for name in bench.MODES["all"]:
        monkeypatch.setattr(bench, name, lambda _n=name, **kw: ran.append((_n, kw)) or {_n: 1})
    monkeypatch.setenv("BENCH_BATCH", "8")
    monkeypatch.setenv("BENCH_SEQ", "24")
    monkeypatch.setenv("BENCH_REPS", "2")
    monkeypatch.setenv("BENCH_SERVE_F32", "1")
    monkeypatch.delenv("BENCH_MODE", raising=False)
    assert bench.main(["--device", "cpu"]) == {name: 1 for name in bench.MODES["all"]}
    assert [n for n, _ in ran] == ["bench_ilql_real_vocab", "bench_actor_real_vocab", "bench_actor", "bench_ilql",
                                   "bench_actor_markov", "bench_env"]
    sizes = dict(ran)
    assert sizes["bench_ilql"] == dict(device=torch.device("cpu"), B=8, T=24, reps=2)
    assert sizes["bench_actor"] == dict(device=torch.device("cpu"), B=8, reps=2, serve_f32=True)
    assert sizes["bench_env"] == dict(device=torch.device("cpu"), B=8, reps=2)

    def fails(**kw):
        raise RuntimeError("section failed")

    monkeypatch.setattr(bench, "bench_actor", fails)
    with pytest.raises(RuntimeError, match="section failed"):
        bench.main(["--device", "cpu"])


def test_main_refuses_a_host_without_cuda(monkeypatch):
    monkeypatch.setenv("BENCH_MODE", "env")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_bench_py_sections_are_the_ported_ones():
    """Every section of bench.py has its counterpart, by name."""
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(ROOT, "bench.py"))
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    jax_sections = {n for n in vars(jbench) if n.startswith("bench_")}
    assert jax_sections == set(SECTION_KEYS) == set(bench.MODES["all"])
