"""The port's training CLI on every task and every algorithm (port only,
CPU, `--model-size tiny`): one short run each, covering the ten tasks and
six algorithms between them, with `--oracle lm` on Twenty Questions, BC
data round-tripped through `--dump-data-jsonl` and `--data-jsonl`, online
rounds, an eval, and a PPO `--resume`. Each run's losses are finite and it
leaves a checkpoint with its algorithm's modules. Cut for time: Text-Nav
windows to 128 tokens (BC and ILQL), dialog prompts to 256, one rollout per online
round, and full-game chess self-play (its engine plays at Elo 2000, about
20 s a game) to 8 moves by patching the task's generator.
"""
import dataclasses
import math
import os

import pytest

from lmrl_gym_torch.cli import tasks as ttasks
from lmrl_gym_torch.envs.chess.data import generate_selfplay_games
from test_torch_cli_train import one_thread, port_cli_run  # noqa: F401

MODULES = {
    "bc": ["base"], "filtered_bc": ["base"], "mc": ["base", "q_head"], "ppo": ["policy", "value_head"],
    "ilql": ["base", "target_base", "q1_head", "q2_head", "v_head", "q1_target_head", "q2_target_head"],
    "cql": ["base", "target_base", "q1_head", "q2_head", "q1_target_head", "q2_target_head"],
}
TINY = ["--model-size", "tiny", "--n-data", "2", "--epochs", "1", "--train-bsize", "8", "--rollouts-per-round", "1",
        "--rollout-bsize", "1", "--eval-max-new-tokens", "12", "--exp-name", "run"]
NO_EVAL = ["--no-eval"]
DIALOG = ["--max-length", "256", "--online-rounds", "1"] + NO_EVAL
CASES = {
    "maze-ppo": ["--task", "maze", "--algo", "ppo", "--bc-loss-weight", "0.1"] + NO_EVAL,
    "maze_partial-filtered_bc": ["--task", "maze_partial", "--algo", "filtered_bc", "--filter-top-frac", "0.5"]
    + NO_EVAL,
    "chess-mc": ["--task", "chess", "--algo", "mc", "--n-data", "1"] + NO_EVAL,
    "chess_endgames-cql": ["--task", "chess_endgames", "--algo", "cql"] + NO_EVAL,
    "text_nav-bc": ["--task", "text_nav", "--algo", "bc", "--max-length", "128", "--n-data", "1"] + NO_EVAL,
    "text_nav_partial-ilql": ["--task", "text_nav_partial", "--algo", "ilql", "--max-length", "128", "--n-data", "1"]
    + NO_EVAL,
    "twenty_questions-filtered_bc-lm_oracle": ["--task", "twenty_questions", "--algo", "filtered_bc", "--oracle", "lm",
                                               "--oracle-episodes", "4", "--oracle-epochs", "1"] + DIALOG,
    "guess_city-ilql-online": ["--task", "guess_city", "--algo", "ilql", "--eval-max-new-tokens", "8"] + DIALOG,
    "wordle-ilql-eval": ["--task", "wordle", "--algo", "ilql", "--eval-rollouts", "2"],
    "car_dealer-mc": ["--task", "car_dealer", "--algo", "mc", "--n-data", "1", "--max-length", "256"] + NO_EVAL,
}


@pytest.fixture(autouse=True)
def short_chess_games(monkeypatch):
    def generate_chess_chains(n, seed):
        return generate_selfplay_games(n, from_position_fn=None, agent_elo=2000, opponent_elo=1200, max_moves=8,
                                       seed=seed)

    monkeypatch.setitem(ttasks.TASKS, "chess", dataclasses.replace(ttasks.TASKS["chess"],
                                                                   generate_chains=generate_chess_chains))


def _run(argv, save_dir):
    with pytest.MonkeyPatch.context() as mp:  # each run records its own steps
        rec, _, loop_state = port_cli_run(TINY + argv + ["--save-dir", save_dir], None, mp)
    losses = [s["loss"] for s in rec["steps"]]
    assert losses and all(math.isfinite(x) for x in losses), losses
    return rec, loop_state


def _assert_checkpoint(run_dir, algo):
    last = os.path.join(run_dir, "last")
    for name in MODULES[algo]:
        assert os.path.exists(os.path.join(last, name, "params.msgpack")), name
    assert os.path.exists(os.path.join(last, "loop_state.pkl"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_run(case, tmp_path):
    argv = CASES[case]
    rec, loop_state = _run(argv, str(tmp_path))
    algo = argv[argv.index("--algo") + 1]
    _assert_checkpoint(str(tmp_path / "run"), algo)
    if "--eval-rollouts" in argv:  # the eval ran and recorded its mean reward as the best
        assert math.isfinite(loop_state.best_perf)
    if "--online-rounds" in argv and algo != "ilql":  # LMServer serves BC / PPO rounds, ValueGuidedServer ILQL's
        assert rec["calls"]
    if "--oracle" in argv:
        assert os.path.exists(os.path.join(str(tmp_path / "run"), "oracle_lm", "oracle", "params.msgpack"))


def test_bc_data_jsonl_round_trip(tmp_path):
    dump = str(tmp_path / "car_dealer.jsonl")
    argv = ["--task", "car_dealer", "--algo", "bc", "--max-length", "256", "--train-bsize", "2"] + NO_EVAL
    first, _ = _run(argv + ["--dump-data-jsonl", dump], str(tmp_path / "a"))
    assert os.path.getsize(dump) > 0
    streamed, _ = _run(argv + ["--data-jsonl", dump], str(tmp_path / "b"))
    # the same windows, streamed from disk: as many steps
    assert len(streamed["steps"]) == len(first["steps"])
    _assert_checkpoint(str(tmp_path / "b" / "run"), "bc")


def test_online_ppo_resumes(tmp_path, capsys):
    base = ["--task", "wordle", "--algo", "ppo", "--ppo-kl-target", "0.05"] + NO_EVAL
    _run(base + ["--online-rounds", "1"], str(tmp_path / "a"))
    last = str(tmp_path / "a" / "run" / "last")
    _assert_checkpoint(str(tmp_path / "a" / "run"), "ppo")
    assert os.path.exists(str(tmp_path / "a" / "run" / "round_0" / "policy" / "params.msgpack"))
    capsys.readouterr()
    _, loop_state = _run(base + ["--online-rounds", "2", "--resume", last], str(tmp_path / "b"))
    out = capsys.readouterr().out
    assert "resumed PPO from" in out and "round 1:" in out and "round 0:" not in out
    assert loop_state.round == 2
