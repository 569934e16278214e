"""The port's Wordle ILQL gate end to end on the CPU at a tiny budget
(d64 L2, 4 steps per stage, eval batch 16, no OptimalPolicy bound): it runs
every stage and returns every JSON key the JAX gate returns. This checks
that the gate runs, not what it learns."""
import ast
import json
import math
import os

from lmrl_gym_torch.scripts import wordle_ilql_gate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--hidden", "64", "--layers", "2", "--heads", "4", "--bc-steps", "4", "--pbc-steps", "4",
        "--ilql-steps", "4", "--eval-every", "2", "--eval-batch", "16", "--bsize", "32", "--optimal-episodes", "0"]


def _jax_gate_keys():
    """The keyword names of the JAX gate's `result = dict(...)`."""
    with open(os.path.join(ROOT, "scripts", "wordle_ilql_gate.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result"
                and isinstance(node.value, ast.Call)):
            return {kw.arg for kw in node.value.keywords}
    raise AssertionError("no result = dict(...) in the JAX gate")


def test_gate_runs_every_stage_and_returns_the_jax_keys(tmp_path, capsys):
    out = tmp_path / "gate.json"
    result = wordle_ilql_gate.main(TINY + ["--out", str(out)])
    keys = _jax_gate_keys()
    assert len(keys) > 15 and keys <= set(result)
    for k, v in result.items():
        if k.endswith(("_return", "_return_greedy", "_return_target_heads")) and v is not None:
            assert -6.0 <= v <= 0.0, (k, v)
        if k.endswith(("_win", "_win_greedy", "_win_target_heads")):
            assert 0.0 <= v <= 1.0, (k, v)
    assert result["optimal_return"] is None
    # the behavior mixture beats nothing-learned and the ceiling beats it
    assert result["consistent_ceiling_return"] > result["behavior_return"] > -6.0
    assert [c["step"] for c in result["curve"]] == [2, 4] and all(math.isfinite(c["ret"]) for c in result["curve"])
    saved = json.loads(out.read_text())
    assert saved["args"]["device"] == "cpu" and saved["bc_return"] == result["bc_return"]
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed).keys() == result.keys()
