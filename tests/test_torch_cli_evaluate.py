"""The port's evaluation CLI (`lmrl_gym_torch/cli/evaluate.py`) against the
JAX package's (`lmrl_gym_tpu/cli/evaluate.py`).

- Wordle checkpoints written by the JAX CLI (`--model-size tiny`, one
  epoch on 4 episodes, f32) are evaluated by both CLIs, greedy: `--policy
  generate` on a BC checkpoint and the inferred `guided` on an ILQL one.
  The summaries are identical (every rollout's actions are, so are the
  float32 means). test_torch_cli_evaluate_maze.py covers `reranker` and
  the maze's per-cell accuracy.
- A checkpoint the port's CLI wrote is evaluated by both, identically.
- The checkpoint-free baselines: `HumanPolicy` with a scripted input and
  `--policy api` over a stub transport (a BFS-optimal "model", as
  tests/test_api_policy.py), each through both CLIs, identically; and the
  API policy's parsing and rendering on their own. No test calls
  `openai_chat_transport`'s network path.
"""
import json
import re

import pytest
import torch

import lmrl_gym_tpu.cli.evaluate as jeval
import lmrl_gym_tpu.cli.train as jtrain
from lmrl_gym_torch.cli import evaluate as teval
from lmrl_gym_torch.cli import train as ttrain
from lmrl_gym_torch.envs.api_policy import (
    APIChatPolicy,
    extract_json_action,
    openai_chat_transport,
    render_history,
)
from lmrl_gym_torch.envs.human import HumanPolicy
from lmrl_gym_torch.envs.maze.grids import DOUBLE_T_GOAL, double_t_maze, maze_solver
from lmrl_gym_torch.text.frames import Text

TRAIN = ["--model-size", "tiny", "--n-data", "4", "--epochs", "1", "--train-bsize", "32", "--no-eval",
         "--exp-name", "run"]
EVAL = ["--n-rollouts", "2", "--bsize", "2", "--max-new-tokens", "12"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_cli")
    for algo in ("bc", "ilql"):
        jtrain.main(TRAIN + ["--task", "wordle", "--algo", algo, "--save-dir", str(root / algo)])
    return {algo: str(root / algo / "run") for algo in ("bc", "ilql")}


def _both(argv):
    """(JAX summary, port summary) of one evaluate command line."""
    return jeval.main(list(argv)), teval.main(list(argv) + ["--device", "cpu"])


@pytest.mark.parametrize("algo,extra", [
    ("bc", ["--policy", "generate"]),
    ("ilql", []),  # --algo inferred, guided decoding
])
def test_jax_checkpoint_evaluates_identically(algo, extra, jax_checkpoints):
    j, t = _both(EVAL + ["--task", "wordle", "--checkpoint", jax_checkpoints[algo]] + extra)
    assert t == j and t["rollouts"]["length"]["mean"] > 1


def test_port_checkpoint_evaluates_identically_in_jax(tmp_path):
    ttrain.main(TRAIN + ["--task", "wordle", "--algo", "bc", "--save-dir", str(tmp_path), "--device", "cpu"])
    j, t = _both(EVAL + ["--task", "wordle", "--checkpoint", str(tmp_path / "run")])
    assert t == j


def test_human_policy_scripted_input(monkeypatch):
    fed, shown = iter(["move up"]), []
    policy = HumanPolicy(input_fn=lambda _: next(fed), print_fn=shown.append)
    out = policy.act((Text("obs1\n", False),))
    assert shown == ["obs1\n"] and out[-1] == Text("move up\n", True)
    # through both CLIs: one episode at the terminal, a scripted player
    moves = ["move up", "move left", "move down", "move right"]
    for cli in ("jax", "port"):
        feed = iter(moves * 30)
        monkeypatch.setattr("builtins.input", lambda _prompt: next(feed))
        if cli == "jax":
            j = jeval.main(["--task", "maze", "--policy", "human", "--n-rollouts", "1"])
        else:
            t = teval.main(["--task", "maze", "--policy", "human", "--n-rollouts", "1"])
    assert t == j and "optimal_move_accuracy" not in t


def _optimal_transport(model):
    table = maze_solver(double_t_maze(), DOUBLE_T_GOAL)

    def transport(messages):
        # the env spells coordinates digit by digit: the last "current
        # position" sentence of the transcript
        lines = [ln for ln in messages[1]["content"].splitlines() if "current position" in ln]
        m = re.search(r"current position is at position ([\d ]+), ([\d ]+)\.", lines[-1])
        pos = tuple(int(g.replace(" ", "")) for g in m.groups())
        return "Sure. " + json.dumps({"action": table[pos].strip()})

    return transport


def test_api_policy_through_both_clis(monkeypatch):
    monkeypatch.setattr("lmrl_gym_tpu.envs.api_policy.openai_chat_transport", _optimal_transport)
    monkeypatch.setattr("lmrl_gym_torch.envs.api_policy.openai_chat_transport", _optimal_transport)
    j, t = _both(["--task", "maze", "--policy", "api", "--n-rollouts", "2", "--bsize", "1"])
    assert t == j
    assert t["rollouts"]["reward"]["mean"] > -30 and t["optimal_move_accuracy"] == 1.0


def test_api_policy_parsing_and_rendering(monkeypatch):
    assert extract_json_action('Sure!\n```{"action": "move left"}```') == "move left"
    assert extract_json_action("plain text answer") == "plain text answer"
    with pytest.raises(ValueError):
        extract_json_action("no json here", fallback_to_reply=False)
    assert render_history((Text("obs\n", False), Text("act\n", True))).splitlines() == [
        "environment: obs", "action: act"]
    seen = {}

    def transport(messages):
        seen["messages"] = messages
        return json.dumps({"action": "move right"})

    out = APIChatPolicy(transport, instructions="INSTR").act((Text("the maze\n", False),))
    assert out[-1] == Text("move right\n", True)
    assert seen["messages"][1]["content"].startswith("INSTR")
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    with pytest.raises(RuntimeError, match="API key"):  # raised before any request is made
        openai_chat_transport()([{"role": "user", "content": "hi"}])
