"""The port's evaluation CLI against the JAX package's on the maze:
`--policy reranker` (the four moves scored by ILQL's score function) on an
ILQL checkpoint the JAX CLI wrote (`--model-size tiny`, one epoch on 4
episodes, f32), with the per-cell optimal-move accuracy. Both CLIs give
identical summaries and accuracy, as in test_torch_cli_evaluate.py.
"""
import lmrl_gym_tpu.cli.evaluate as jeval
import lmrl_gym_tpu.cli.train as jtrain
from lmrl_gym_torch.cli import evaluate as teval
from test_torch_cli_evaluate import TRAIN, one_thread  # noqa: F401


def test_jax_ilql_checkpoint_reranks_identically(tmp_path):
    jtrain.main(TRAIN + ["--task", "maze", "--algo", "ilql", "--save-dir", str(tmp_path)])
    argv = ["--task", "maze", "--checkpoint", str(tmp_path / "run"), "--policy", "reranker", "--n-rollouts", "1",
            "--bsize", "1"]
    j, t = jeval.main(list(argv)), teval.main(argv + ["--device", "cpu"])
    assert 0.0 <= t["optimal_move_accuracy"] <= 1.0
    assert t == j
