"""The port's dialog gates (`lmrl_gym_torch/scripts/{car_dealer_ilql,
dialog_ilql,twenty_questions}_gate.py`) against the JAX gates
(`scripts/*.py`) on the JAX gates' own draws.

Each JAX gate runs at a tiny budget (d64 L2 H4 policy, a few behavior
episodes, one epoch per stage of batches of 4, K = 2 rerank proposals, two eval rollouts
per policy and env, windows and prompts of 256 tokens; the LM buyer /
oracle at d64 (the dialog gate's at its fixed d128 L4), Car-Dealer
LM-buyer episodes cut to 6 turns and 20Q episodes to 5 questions, and
the balanced oracle QA to its first 40 windows, by patching both
packages' builders and collector alike), in f32 as the JAX gates run
(`tiny_test_config`). Its draws are
recorded: the initial policy trunk, the (q1, q2, v) heads, the LM
oracle's or buyer's initial weights, and the PRNG key of every
`LMServer.generate_from_strs` call with its prompts and the actions it
returned. The port's `run` replays them (each sampled call's key turned
into the Gumbel noise it gives on the call's bucketed batch), so what is
tested is the glue: the behavior data and tokenizer, the BC, ILQL and MC
stages' data and batch order, the serving prompts, the reranker's
candidates and score batch, the oracle's and buyer's training windows
and prompts, the probes and the eval seeds.

Tolerances: every serving call's prompts and actions identical (the
oracle's and the LM buyer's answers among them), and so every reward
and rate of the JSON result; the ranking probes' scores within 1e-4
(f32 trunks after BC and value steps that agree to 1e-4 relative).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_torch.algos import value_policy as tvp
from lmrl_gym_torch.cli import tasks as ttasks
from lmrl_gym_torch.envs import lm_oracle as tlo
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.scripts import car_dealer_ilql_gate, dialog_ilql_gate, twenty_questions_gate
from lmrl_gym_tpu.algos import value_policy as jvp
from lmrl_gym_tpu.cli import tasks as jtasks
from lmrl_gym_tpu.envs import lm_oracle as jlo
from lmrl_gym_tpu.models import heads as jheads
from lmrl_gym_tpu.models import transformer as jtransformer
from test_torch_ppo_gate_parity import _flags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--hidden", "64", "--layers", "2", "--heads", "4", "--bc-epochs", "1", "--eval-rollouts", "2",
        "--eval-bsize", "2", "--max-len", "256", "--bsize", "4"]
GATES = {
    "car_dealer": (car_dealer_ilql_gate, "car_dealer_ilql_gate.py",
                   TINY + ["--behavior-episodes", "12", "--ilql-epochs", "1", "--mc-epochs", "1", "--rerank-k", "2",
                           "--buyer-episodes", "6", "--buyer-epochs", "1", "--buyer-hidden", "64"]),
    "dialog_ilql": (dialog_ilql_gate, "dialog_ilql_gate.py",
                    TINY + ["--behavior-episodes", "8", "--ilql-epochs", "1", "--rerank-k", "2",
                            "--oracle-episodes", "2", "--oracle-epochs", "1"]),
    "twenty_questions": (twenty_questions_gate, "twenty_questions_gate.py",
                         TINY + ["--behavior-episodes", "8", "--oracle-episodes", "2", "--oracle-epochs", "1",
                                 "--oracle-hidden", "64", "--oracle-layers", "2", "--p-good", "-1"]),
}
BUYER_TURNS = 6  # both packages' LM-buyer episodes cut to 6 turns (the gate's env allows 50)
QUESTIONS = 5  # both packages' 20Q episodes cut to 5 questions (the env allows 20)
BALANCED_QA = 40  # the balanced QA set (~1,260 windows) cut to its first 40
PROBE_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the CPU decode's many small ops run faster
    alone than split across a shared machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _short_buyer(build):
    return lambda core, tok, params, max_conversation_length=50: build(
        core, tok, params, max_conversation_length=min(max_conversation_length, BUYER_TURNS))


def _short_20q(build):
    return lambda *a, **kw: build(*a, **{**kw, "max_conversation_length": QUESTIONS})


def _short_balanced(collect):
    return lambda n_neg_per_word=4, seed=0: collect(n_neg_per_word, seed)[:BALANCED_QA]


def _cuts(tasks, lo) -> dict:
    """{name: (module, patched function)}: the budget cuts, applied alike
    to both packages."""
    return dict(build_lm_car_dealer_env=(lo, _short_buyer(lo.build_lm_car_dealer_env)),
                build_lm_twenty_questions_env=(lo, _short_20q(lo.build_lm_twenty_questions_env)),
                build_twenty_questions_env=(tasks, _short_20q(tasks.build_twenty_questions_env)),
                collect_twenty_questions_qa_balanced=(lo, _short_balanced(lo.collect_twenty_questions_qa_balanced)))


def _load_jax_gate(script: str):
    spec = importlib.util.spec_from_file_location(f"jax_{script[:-3]}", os.path.join(ROOT, "scripts", script))
    jgate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jgate)
    return jgate


def _jax_run(script: str, argv):
    """The JAX gate's result and its recorded draws and serving calls."""
    jgate = _load_jax_gate(script)
    rec = dict(trunks=[], heads=[], calls=[])
    orig = dict(init=jtransformer.init_params, head=jheads.init_head_params, gfs=jvp.LMServer.generate_from_strs)
    assert jlo.init_params is orig["init"]

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

    patches = [(jtransformer, "init_params", init_params), (jlo, "init_params", init_params),
               (jheads, "init_head_params", init_head_params), (jvp.LMServer, "generate_from_strs", generate_from_strs)]
    patches += [(obj, name, fn) for name, (obj, fn) in _cuts(jtasks, jlo).items()]
    saved = [getattr(obj, name) for obj, name, _ in patches]
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        result = jgate.main(argv)
    finally:
        for (obj, name, _), fn in zip(patches, saved):
            setattr(obj, name, fn)
    return result, rec


def _gumbel(call: dict, V: int) -> torch.Tensor:
    """The noise a sampled JAX `generate` call drew: per new token, the
    Gumbel draw of its split key over the bucketed batch (a power of two),
    cut to the call's rows."""
    Bp = 1 << max(0, call["B"] - 1).bit_length()
    keys = jax.random.split(call["key"], call["n"])
    return torch.stack([torch.from_numpy(np.array(jax.random.gumbel(k, (Bp, V), jnp.float32)))[:call["B"]]
                        for k in keys])


def _replay(name: str, probe, rec: dict):
    """The JAX draws as the port gate's Replay."""
    trunk = Transformer(probe.config, device="cpu")
    trunk.load_state_dict(params_from_jax(rec["trunks"][0], probe.config))
    oracle = Transformer(probe.oracle_config, device="cpu")
    oracle.load_state_dict(params_from_jax(rec["trunks"][1], probe.oracle_config))
    if name == "twenty_questions":
        return twenty_questions_gate.Replay(trunk, oracle)
    D = probe.config.hidden_size
    heads = []
    for tree, out in zip(rec["heads"][:3], (probe.config.padded_vocab_size,) * 2 + (1,)):
        h = MLPHead(MLPHeadConfig(input_dim=D, hidden_dim=2 * D, output_dim=out), device="cpu")
        h.load_state_dict(head_params_from_jax(tree))
        heads.append(h)
    V = probe.config.padded_vocab_size
    gumbels = iter([_gumbel(c, V) for c in rec["calls"] if not c["greedy"]])
    return dialog_ilql_gate.Replay(trunk, tuple(heads), oracle, gumbels)


def check_port_gate(name: str, monkeypatch):
    module, script, argv = GATES[name]
    result, rec = _jax_run(script, argv)
    n_trunks = 2
    assert len(rec["trunks"]) == n_trunks + (name == "twenty_questions")  # 20Q: BC and filtered BC each draw
    if name == "twenty_questions":
        for a, b in zip(jax.tree.leaves(rec["trunks"][1]), jax.tree.leaves(rec["trunks"][2])):
            np.testing.assert_array_equal(a, b)  # one draw, PRNGKey(seed), for both
        rec["trunks"] = [rec["trunks"][1], rec["trunks"][0]]  # (policy, oracle): the oracle trains first
    if name != "twenty_questions":
        assert any(not c["greedy"] for c in rec["calls"])
        if name == "car_dealer":
            # the MC head's draw is the q2 head's (one key)
            for a, b in zip(jax.tree.leaves(rec["heads"][1]), jax.tree.leaves(rec["heads"][3])):
                np.testing.assert_array_equal(a, b)

    for attr, (obj, fn) in _cuts(ttasks, tlo).items():
        monkeypatch.setattr(obj, attr, fn)
    args = module.parse_args(argv + ["--device", "cpu"])
    probe = module.Gate(args)
    replay = _replay(name, probe, rec)

    calls = []
    gfs = tvp.LMServer.generate_from_strs

    def generate_from_strs(self, params, prompts, *a, **kw):
        outs = gfs(self, params, prompts, *a, **kw)
        calls.append(dict(prompts=list(prompts), outs=list(outs)))
        return outs

    monkeypatch.setattr(tvp.LMServer, "generate_from_strs", generate_from_strs)
    out = module.run(module.Gate(args, replay=replay))
    if name != "twenty_questions":
        assert next(replay.gumbels, None) is None  # every draw consumed

    assert len(calls) == len(rec["calls"])
    for i, (port, ref) in enumerate(zip(calls, rec["calls"])):
        assert port["prompts"] == ref["prompts"], f"call {i}: prompts"
        assert port["outs"] == ref["outs"], f"call {i}: actions"

    assert set(out) == set(result)
    for k, want in result.items():
        if k in ("ilql_probe", "mc_probe"):
            for got_row, want_row in zip(out[k], want):
                assert got_row["picked"] == want_row["picked"] and got_row["best"] == want_row["best"]
                for p in want_row["scores"]:
                    np.testing.assert_allclose(got_row["scores"][p], want_row["scores"][p], **PROBE_TOL)
        elif k in ("bc_summary", "filtered_bc_summary"):
            assert out[k] == want, k
        else:
            assert out[k] == want, (k, out[k], want)
    return out, calls


def test_port_car_dealer_gate_matches_jax_gate(monkeypatch):
    out, calls = check_port_gate("car_dealer", monkeypatch)
    assert out["buyer_fidelity"] is not None and out["mc_rerank_reward"] is not None


@pytest.mark.parametrize("name", sorted(GATES))
def test_port_gate_flags_are_the_jax_gates_plus_device(name, monkeypatch):
    module, script, _ = GATES[name]
    jgate = _load_jax_gate(script)
    port, ref = _flags(module.parse_args, monkeypatch), _flags(jgate.main, monkeypatch)
    assert port.pop("device") == ("cuda", None)
    assert port == ref
