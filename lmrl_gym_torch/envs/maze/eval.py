"""Maze functional-oracle evaluation, per-cell optimal-move accuracy: the
port's copy of `lmrl_gym_tpu/envs/maze/eval.py`.

The reference's headline maze metric (llm_rl_scripts/maze/env/
maze_utils.py:63-89, inlined at maze/ilql/train_ilql.py:472-499): query
the policy once from every open cell and score the fraction of cells
where its move is BFS-optimal. An action counts as correct if it is in
the *set* of optimal moves for the cell (ties allowed), matching the
reference's optimal-direction table semantics (mazes.py:20-48).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from lmrl_gym_torch.envs.maze.env import describe_observation_give_position
from lmrl_gym_torch.envs.maze.grids import optimal_actions
from lmrl_gym_torch.text.frames import Text, TextHistory

Cell = Tuple[int, int]


def per_cell_optimal_move_accuracy(
    policy_act: Callable[[List[TextHistory]], List[TextHistory]],
    maze: np.ndarray,
    goal: Cell,
    describe_function: Callable = describe_observation_give_position,
    bsize: int = 32,
) -> Tuple[float, Dict[Cell, Tuple[str, bool]]]:
    """`policy_act(histories) -> histories-with-appended-action` (a
    BatchedTextPolicy.act without the done mask).

    Returns (accuracy, {cell: (chosen_action, correct)}).
    """
    opts = optimal_actions(maze, goal)
    cells = sorted(opts)
    histories: List[TextHistory] = [
        (Text(describe_function(maze, cell, goal), False),) for cell in cells
    ]
    per_cell: Dict[Cell, Tuple[str, bool]] = {}
    n_correct = 0
    for i in range(0, len(cells), bsize):
        outs = policy_act(histories[i : i + bsize])
        for cell, out in zip(cells[i : i + bsize], outs):
            action = out[-1].text if out is not None else ""
            ok = action in opts[cell]
            per_cell[cell] = (action, ok)
            n_correct += int(ok)
    return n_correct / max(1, len(cells)), per_cell


def render_accuracy_grid(
    maze: np.ndarray, goal: Cell, per_cell: Dict[Cell, Tuple[str, bool]]
) -> str:
    """ASCII map: '#' wall, 'G' goal, '+' optimal move, 'x' suboptimal."""
    rows = []
    for y in range(maze.shape[0]):
        row = []
        for x in range(maze.shape[1]):
            if (y, x) == tuple(goal):
                row.append("G")
            elif maze[y, x] != 0:
                row.append("#")
            elif (y, x) in per_cell:
                row.append("+" if per_cell[(y, x)][1] else "x")
            else:
                row.append(" ")
        rows.append("".join(row))
    return "\n".join(rows)
