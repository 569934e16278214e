"""The port's generic train loops (`lmrl_gym_torch/loops/{offline,online}.py`)
against the JAX package's (`lmrl_gym_tpu/loops/{offline,online}.py`):
`tests/test_loops.py`'s cases (step counts, skipped rounds, the evaluator
and the best checkpoint, resume fast-forward) on both packages with the
same batches recorded, then one small ILQL run through the offline loop
and one small PPO run through the online loop, each starting from one
state in both packages.

Tolerances: the batch sequence, step / epoch / round counts and the
checkpoint directories identical; every step's loss within
`test_torch_ilql.py`'s 1e-5 (ILQL; its parity over three steps) or
`test_torch_ppo.py`'s data tolerance 1e-4 (PPO, whose advantages divide
by a batch std). The log trees merge (`combine_logs`) to the same
numbers within the same tolerance.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_torch.algos import ilql as tilql
from lmrl_gym_torch.algos import ppo as tppo
from lmrl_gym_torch.algos.data import ArrayDataset as TDataset
from lmrl_gym_torch.core import logs as tlogs
from lmrl_gym_torch.core.blocking import BlockingStrategy as TStrategy, Padding as TPad, Truncation as TTrunc
from lmrl_gym_torch.loops import checkpoints as tckpt
from lmrl_gym_torch.loops.offline import OfflineLoopConfig as TOfflineConfig, offline_train_loop as t_offline
from lmrl_gym_torch.loops.online import OnlineLoopConfig as TOnlineConfig, online_train_loop as t_online
from lmrl_gym_torch.models.interface import LMCore as TCore
from lmrl_gym_torch.text.frames import TokenTrajectoryChain as TTokenChain
from lmrl_gym_tpu.algos import ilql as jilql
from lmrl_gym_tpu.algos import ppo as jppo
from lmrl_gym_tpu.algos.data import ArrayDataset as JDataset
from lmrl_gym_tpu.cli.tasks import generate_maze_chains
from lmrl_gym_tpu.core import logs as jlogs
from lmrl_gym_tpu.core.blocking import BlockingStrategy as JStrategy, Padding as JPad, Truncation as JTrunc
from lmrl_gym_tpu.loops import checkpoints as jckpt
from lmrl_gym_tpu.loops.offline import OfflineLoopConfig as JOfflineConfig, offline_train_loop as j_offline
from lmrl_gym_tpu.loops.online import OnlineLoopConfig as JOnlineConfig, online_train_loop as j_online
from lmrl_gym_tpu.models.interface import LMCore as JCore
from lmrl_gym_tpu.text.frames import TokenTrajectoryChain as JTokenChain

import test_torch_ilql as ilql_case
import test_torch_ppo as ppo_case
from test_torch_ppo_gate_parity import one_thread  # noqa: F401  (one intra-op thread for this module)

PKGS = {
    "jax": dict(dataset=JDataset, offline=(j_offline, JOfflineConfig), online=(j_online, JOnlineConfig),
                ckpt=jckpt, zero=lambda: jnp.asarray(0.0)),
    "port": dict(dataset=TDataset, offline=(t_offline, TOfflineConfig), online=(t_online, TOnlineConfig),
                 ckpt=tckpt, zero=lambda: torch.zeros(())),
}
PPO_TOL = dict(atol=1e-4, rtol=1e-4)


def _recorder(pkg, calls):
    def step_fn(state, batch, rng):
        calls.append(batch["x"].tolist())
        return state, PKGS[pkg]["zero"](), {"loss": PKGS[pkg]["zero"]() + len(calls)}

    return step_fn


def test_resume_fast_forward_matches():
    """The offline loop resumes at loop_state.epoch: only epochs 2 and 3
    run, on the same batches in both packages."""
    out = {}
    for pkg, p in PKGS.items():
        calls = []
        loop, config = p["offline"]
        _, ls = loop(object(), _recorder(pkg, calls), p["dataset"]({"x": np.arange(8)}),
                     config(epochs=4, train_bsize=4, log_every=None, eval_every_epochs=None, save_at_end=False),
                     loop_state=p["ckpt"].LoopState(epoch=2))
        assert len(calls) == 2 * 2 and ls.epoch == 4 and ls.step == 4
        out[pkg] = calls
    assert out["jax"] == out["port"]


def test_offline_step_counts_logs_and_drop_last(capsys):
    """Step counts, `log_every` lines and the dropped last partial batch."""
    out = {}
    for pkg, p in PKGS.items():
        calls = []
        loop, config = p["offline"]
        _, ls = loop(object(), _recorder(pkg, calls), p["dataset"]({"x": np.arange(10)}),
                     config(epochs=3, train_bsize=4, log_every=2, eval_every_epochs=None, save_at_end=False, seed=3))
        assert ls.step == 6 and ls.epoch == 3
        out[pkg] = (calls, capsys.readouterr().out)
    assert out["jax"] == out["port"]
    assert out["port"][1].count("'train'") == 3


def test_rounds_and_skip_match():
    out = {}
    for pkg, p in PKGS.items():
        loads, calls = [], []
        loop, config = p["online"]

        def load_dataset(state, round_idx):
            loads.append(round_idx)
            return None if round_idx == 1 else p["dataset"]({"x": np.arange(4)})  # an empty filter skips round 1

        _, ls = loop(object(), _recorder(pkg, calls), load_dataset,
                     config(n_rounds=3, epochs_per_round=2, train_bsize=2, log_every=None, eval_every_rounds=None,
                            save_at_end=False))
        assert loads == [0, 1, 2] and len(calls) == 2 * 2 * 2 and ls.round == 3
        out[pkg] = calls
    assert out["jax"] == out["port"]


def test_evaluator_and_best_match(tmp_path):
    for pkg, p in PKGS.items():
        perfs = iter([0.1, 0.5, 0.3])
        loop, config = p["online"]
        d = str(tmp_path / pkg)
        _, ls = loop({"w": np.ones(2, np.float32)}, _recorder(pkg, []),
                     lambda state, r: p["dataset"]({"x": np.arange(2)}),
                     config(n_rounds=3, epochs_per_round=1, train_bsize=2, log_every=None, eval_every_rounds=1,
                            save_every_rounds=1, save_at_end=True, save_dir=d),
                     evaluator=lambda state: (next(perfs), {"perf": 1.0}), module_getter=lambda s: {"m": s})
        assert ls.best_perf == 0.5 and ls.round == 3
        # max_checkpoints=2 keeps the last two rolling saves; best and last stay
        assert sorted(os.listdir(d)) == ["best", "last", "round_2"]
    assert sorted(os.listdir(tmp_path / "jax" / "best")) == sorted(os.listdir(tmp_path / "port" / "best"))


def test_combine_and_pull_logs_match():
    rng = np.random.default_rng(0)
    trees = [dict(loss=rng.standard_normal(), q=dict(mean=rng.standard_normal(), min=rng.standard_normal(),
                                                    max=rng.standard_normal()), n=[rng.standard_normal(), 2.0])
             for _ in range(5)]
    jt = [jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), t) for t in trees]
    tt = [jax.tree.map(lambda x: torch.tensor(x, dtype=torch.float32), t) for t in trees]
    jout = jlogs.pull_logs(jlogs.combine_logs(jt))
    tout = tlogs.pull_logs(tlogs.combine_logs(tt))
    assert jax.tree.structure(jout) == jax.tree.structure(tout)
    np.testing.assert_allclose(jax.tree.leaves(tout), jax.tree.leaves(jout), rtol=1e-6)
    counted = tlogs.combine_logs([tlogs.LogTuple(torch.tensor(1.0), 3), tlogs.LogTuple(torch.tensor(3.0), 1)])
    assert counted.count == 4 and float(counted.mean) == 1.5
    assert tlogs._flatten("", dict(a=dict(b=1), c=2)) == jlogs._flatten("", dict(a=dict(b=1), c=2)) == {"a/b": 1,
                                                                                                        "c": 2}
    assert tlogs.label_logs({"x": 1}, "eval", {"step": 2}) == jlogs.label_logs({"x": 1}, "eval", {"step": 2})


def _ilql_arrays(n=10, t=12, nt=6, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, (n, t)).astype(np.int32)
    ids[1, t - 3:] = ilql_case.PAD
    sta = rng.random((n, t - 1)) < 0.4
    sta[:, 0] = True
    nxt = rng.integers(1, 256, (n, nt)).astype(np.int32)
    return dict(input_ids=ids, should_take_action=sta, rewards=(-1.0 * sta).astype(np.float32),
                dones=rng.random(n) < 0.5, next_token_ids=nxt, next_dones=rng.random(n) < 0.5)


def _ilql_modules(s):
    return {"base": s.base, "target_base": s.target_base_params, "q1_head": s.q1_head, "q2_head": s.q2_head,
            "v_head": s.v_head, "q1_target_head": s.q1_target_params, "q2_target_head": s.q2_target_params}


def test_offline_ilql_run_and_resume_match(tmp_path):
    """A small ILQL run (10 windows, batch 4, three epochs, an eval and a
    train-state save after each epoch) in both packages, then each resumed
    from its own epoch_0 checkpoint (params restored; the loop restarts at
    that epoch with its batch order seeded afresh)."""
    (jcfg, jconf, jq, jv, jstate), (tcfg, tconf, tstate) = ilql_case._setup()
    arrays = _ilql_arrays()
    jstep = jilql.make_ilql_train_step(JCore(jcfg), jq, jv, jconf, ilql_case.PAD)
    tstep = tilql.make_ilql_train_step(TCore(tcfg, device="cpu"), tconf, ilql_case.PAD)
    runs = {}
    steps = {"jax": lambda s, b: jstep(s, b, None), "port": tstep}
    for pkg, state, to in (("jax", jstate, jnp.asarray), ("port", tstate, torch.from_numpy)):
        p = PKGS[pkg]
        loop, config = p["offline"]
        losses, orders, evals = [], [], []
        batch_cls = jilql.ILQLBatch if pkg == "jax" else tilql.ILQLBatch

        def step_fn(s, b, rng, step=steps[pkg]):
            s, loss, logs = step(s, b)
            losses.append(float(loss))
            return s, loss, logs

        def batch_prep(b, to=to, batch_cls=batch_cls):
            orders.append(b["input_ids"][:, 0].tolist())
            return batch_cls(**{k: to(np.asarray(v)) for k, v in b.items()})

        def evaluator(s):
            evals.append(len(losses))
            return -losses[-1], {"last_loss": losses[-1]}

        d = str(tmp_path / pkg)
        cfg = config(epochs=3, train_bsize=4, log_every=None, eval_every_epochs=1, save_every_epochs=1,
                     save_train_state=True, save_dir=d, seed=1)
        _, ls = loop(state, step_fn, p["dataset"](dict(arrays)), cfg, batch_prep=batch_prep, evaluator=evaluator,
                     module_getter=_ilql_modules)
        runs[pkg] = dict(losses=losses, orders=orders, evals=evals, ls=(ls.step, ls.epoch), dirs=sorted(os.listdir(d)))
    assert runs["jax"]["orders"] == runs["port"]["orders"] and len(runs["port"]["orders"]) == 6
    np.testing.assert_allclose(runs["port"]["losses"], runs["jax"]["losses"], **ilql_case.LOSS_TOL)
    for k in ("evals", "ls", "dirs"):
        assert runs["jax"][k] == runs["port"][k], k
    assert runs["port"]["dirs"] == ["best", "epoch_1", "epoch_2", "last"]  # max_checkpoints=3 rolled epoch_0 out

    # resume from epoch_1: JAX's params (from its train_state files), the
    # port's params and optimizer state
    resumed = {}
    for pkg in PKGS:
        p = PKGS[pkg]
        ck = str(tmp_path / pkg / "epoch_1")
        ls = p["ckpt"].LoopState.load(os.path.join(ck, "loop_state.pkl"))
        assert (ls.step, ls.epoch) == (4, 1)
        orders = []
        _, ls = p["offline"][0](object(), lambda s, b, r: (s, p["zero"](), {}), p["dataset"](dict(arrays)),
                                p["offline"][1](epochs=3, train_bsize=4, log_every=None, eval_every_epochs=None,
                                                save_at_end=False, seed=1),
                                batch_prep=lambda b: orders.append(b["input_ids"][:, 0].tolist()), loop_state=ls)
        resumed[pkg] = (orders, ls.step, ls.epoch)
    assert resumed["jax"] == resumed["port"] and resumed["port"][1:] == (8, 3)
    assert resumed["port"][0] == runs["port"]["orders"][:4]  # the batch order restarts from the seed
    _, _, other = ilql_case._setup()[1]
    for name, module in _ilql_modules(other).items():
        tckpt.restore_module(str(tmp_path / "port" / "epoch_1"), name, module)
    assert other.base.step == 4


def test_online_ppo_rounds_match(tmp_path):
    """Three PPO rounds through the online loop on fixed maze chains (round
    1 skipped), the data refreshed from the live state each round, a round
    checkpoint after each round: the same losses, round counts and
    checkpoints in both packages."""
    (jcfg, jvh, jstate), (tcfg, tstate) = ppo_case._setup(max_pos=256)
    text_chains = generate_maze_chains(3, seed=2, p_optimal=0.5)
    jcore, tcore = JCore(jcfg), TCore(tcfg, device="cpu")
    jinit = jax.tree.map(lambda x: x * 1.01, jstate.policy.params)
    tinit = type(tstate.policy.params)(tcfg, device="cpu")
    tinit.load_state_dict(ppo_case.params_from_jax(ppo_case.np_tree(jinit), tcfg))
    jstep = jppo.make_ppo_train_step(jcore, jvh, jppo.PPOConfig(), ilql_case.PAD)
    tstep = tppo.make_ppo_train_step(tcore, tppo.PPOConfig(), ilql_case.PAD)
    tok, L = ppo_case.TOK, 160
    runs = {}
    for pkg in PKGS:
        p = PKGS[pkg]
        losses, n_windows = [], []
        if pkg == "jax":
            chains = [JTokenChain.from_text_trajectory_chain(c, tok) for c in text_chains]
            make_fwd = lambda s: jppo.make_ppo_forward_fn(jcore, jvh, jinit, s.policy.params,  # noqa: E731
                                                          s.value_head.params, ilql_case.PAD)
            data_fn, block, strategy = jppo.get_ppo_data_from_chains, jppo.block_ppo_data, JStrategy(
                JPad.RIGHT, JTrunc.RIGHT, L)
            batch = lambda b: jppo.PPOBatch(**{k: jnp.asarray(v) for k, v in b.items()},  # noqa: E731
                                            bc_input_ids=None, bc_training_mask=None)
            step, state = (lambda s, b, r: jstep(s, b, None)), jstate
        else:
            chains = [TTokenChain.from_text_trajectory_chain(c, tok) for c in text_chains]
            make_fwd = lambda s: tppo.make_ppo_forward_fn(tcore, tinit, s.policy.params,  # noqa: E731
                                                          s.value_head.params, ilql_case.PAD)
            data_fn, block, strategy = tppo.get_ppo_data_from_chains, tppo.block_ppo_data, TStrategy(
                TPad.RIGHT, TTrunc.RIGHT, L)
            batch = lambda b: tppo.PPOBatch(**{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})  # noqa
            step, state = (lambda s, b, r: tstep(s, b)), tstate

        def load_dataset(s, r, chains=chains, make_fwd=make_fwd, data_fn=data_fn, block=block, strategy=strategy,
                         p=p):
            if r == 1:
                return None
            datas, _ = data_fn(make_fwd(s), tok, chains, 8, L, gamma=0.99, lam=0.95, kl_weight=0.05)
            n_windows.append(len(datas))
            return p["dataset"](block(datas, strategy, ilql_case.PAD))

        def step_fn(s, b, r, step=step):
            s, loss, logs = step(s, b, r)
            losses.append(float(loss))
            return s, loss, logs

        d = str(tmp_path / pkg)
        _, ls = p["online"][0](state, step_fn, load_dataset,
                               p["online"][1](n_rounds=3, epochs_per_round=2, train_bsize=8, log_every=None,
                                              eval_every_rounds=None, save_every_rounds=1, save_dir=d, seed=2),
                               batch_prep=batch,
                               module_getter=lambda s: {"policy": s.policy, "value_head": s.value_head})
        runs[pkg] = dict(losses=losses, n=n_windows, round=ls.round, step=ls.step, dirs=sorted(os.listdir(d)))
    assert runs["jax"]["n"] == runs["port"]["n"] and runs["port"]["round"] == 3
    assert runs["jax"]["step"] == runs["port"]["step"] == len(runs["port"]["losses"]) > 4
    np.testing.assert_allclose(runs["port"]["losses"], runs["jax"]["losses"], **PPO_TOL)
    # round 1 is skipped before its save; max_checkpoints=2 rolls round_0 out when last is saved
    assert runs["jax"]["dirs"] == runs["port"]["dirs"] == ["last", "round_2"]
    for pkg in PKGS:  # each package reads the other's round checkpoint
        other = "port" if pkg == "jax" else "jax"
        a = PKGS[pkg]["ckpt"].load_module_params(str(tmp_path / other / "round_2"), "value_head")
        b = PKGS[other]["ckpt"].load_module_params(str(tmp_path / other / "round_2"), "value_head")
        np.testing.assert_array_equal(np.asarray(a["dense"]["kernel"]), np.asarray(b["dense"]["kernel"]))
