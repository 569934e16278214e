"""The port's maze PPO gate (`lmrl_gym_torch/scripts/maze_ppo_gate.py`)
against the JAX gate (`scripts/maze_ppo_gate.py`) on the JAX gate's own
draws: `test_torch_ppo_gate_parity.py`'s check (its docstring gives the
budget and the tolerances) on the maze, in a file of its own so the two
gates' runs split across test workers."""
from test_torch_ppo_gate_parity import check_port_gate, one_thread  # noqa: F401  (the fixture applies here too)


def test_port_maze_gate_matches_jax_gate(monkeypatch):
    check_port_gate("maze", monkeypatch)
