"""Maze TextEnv (host-side, reference-parity): the port's copy of
`lmrl_gym_tpu/envs/maze/env.py`.

Semantics of llm_rl_scripts/maze/env/env.py:104-214: actions are
'move up\\n' etc.; the agent moves iff the target cell is open; reward
functions standard/illegal-penalty; history windowed to `last_k` texts;
`max_steps` exceeded → ('Failure\\n', -1, done); goal → ('Success\\n').
Coordinates in observations are spelled digit-by-digit via
`' '.join(str(n))` (env.py:57-58).
"""
from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from lmrl_gym_torch.envs.base import TextEnv
from lmrl_gym_torch.envs.maze.grids import ACTION_DELTAS
from lmrl_gym_torch.text.frames import Text, TextHistory

Position = Tuple[int, int]


def _spell(n: int) -> str:
    return " ".join(str(n))


def describe_objects(obj: str, relations: List[str]) -> str:
    if len(relations) == 0:
        return f"There are no {obj}s near you."
    if len(relations) == 1:
        return f"There is a {obj} {relations[0]}."
    return f"There are {obj}s {', '.join(relations)}."


_WALL_DIRS = {
    "to your right": (0, 1),
    "to your left": (0, -1),
    "above you": (-1, 0),
    "below you": (1, 0),
}


def _walls_near(maze: np.ndarray, position: Position) -> List[str]:
    return [
        k
        for k, (dy, dx) in _WALL_DIRS.items()
        if maze[position[0] + dy, position[1] + dx] == 1
    ]


def describe_observation(maze, position, goal, initial_position=None, move_history=None) -> str:
    """Fully-observed minus position (env.py:15-49)."""
    goal_desc = f"The goal is at position {_spell(goal[0])}, {_spell(goal[1])}."
    wall_desc = describe_objects("wall", _walls_near(maze, position))
    return f"{goal_desc} {wall_desc}\n"


def describe_observation_give_position(maze, position, goal, initial_position=None, move_history=None) -> str:
    """Fully-observed (env.py:51-68) — the default."""
    goal_desc = f"The goal is at position {_spell(goal[0])}, {_spell(goal[1])}."
    pos_desc = (
        f"Your current position is at position {_spell(position[0])}, {_spell(position[1])}."
    )
    wall_desc = describe_objects("wall", _walls_near(maze, position))
    return f"{goal_desc} {pos_desc} {wall_desc}\n"


def describe_observation_only_walls(maze, position, goal=None, initial_position=None, move_history=None) -> str:
    """Partially-observed (env.py:70-81)."""
    return f"{describe_objects('wall', _walls_near(maze, position))}\n"


def standard_reward(action, goal, position, possible_actions) -> float:
    if position[0] == goal[0] and position[1] == goal[1]:
        return 0.0
    if action not in possible_actions:
        return -4.0
    return -1.0


def illegal_penalty_reward(action, goal, position, possible_actions) -> float:
    if position[0] == goal[0] and position[1] == goal[1]:
        return 1.0
    if action not in possible_actions:
        return -1.0
    return 0.0


def illegal_penalty_diff_scale(action, goal, position, possible_actions) -> float:
    if position[0] == goal[0] and position[1] == goal[1]:
        return 1.0
    if action not in possible_actions:
        return -100.0
    return -1.0


def update_position(maze: np.ndarray, position: Position, action: str, actions: Dict[str, Position]) -> Position:
    """Move iff action is known and the target cell is open (env.py:104-107)."""
    if action in actions:
        dy, dx = actions[action]
        ny, nx = position[0] + dy, position[1] + dx
        if maze[ny, nx] == 0:
            return (ny, nx)
    return position


class MazeEnv(TextEnv):
    def __init__(
        self,
        maze: np.ndarray,
        valid_goals: np.ndarray,
        actions: Dict[str, Position] = ACTION_DELTAS,
        max_steps: Optional[int] = None,
        display_initial_position: bool = False,
        describe_function: Callable = describe_observation_give_position,
        reward_function: Callable = standard_reward,
        last_k: int = 40,
    ):
        assert maze.ndim == 2
        assert all(maze[g[0], g[1]] == 0 for g in valid_goals)
        self.maze = maze
        self.valid_goals = valid_goals
        self.actions = actions
        self.max_steps = max_steps
        self.display_initial_position = display_initial_position
        self.describe_function = describe_function
        self.reward_function = reward_function
        self.last_k = last_k
        self.rng = random.Random()
        self.num_steps = 0
        self.move_history: List[str] = []
        self.reset()

    def step(self, text_history: TextHistory) -> Tuple[TextHistory, float, bool]:
        assert text_history[-1].is_action
        if self.max_steps is not None and self.num_steps >= self.max_steps:
            return (Text("Failure\n", False),), -1.0, True

        action = text_history[-1].text
        self.position = update_position(self.maze, self.position, action, self.actions)
        self.move_history.append(action.replace("\n", ""))

        reward = self.reward_function(action, self.goal, self.position, self.actions)
        if self.position[0] == self.goal[0] and self.position[1] == self.goal[1]:
            return (Text("Success\n", False),), reward, True

        self.num_steps += 1
        obs = self.describe_function(
            self.maze, self.position, self.goal, self.initial_position, self.move_history
        )
        if action not in self.actions:
            # unknown action: restart the window with just the observation
            return (Text(obs, False),), reward, False

        new_history = list(text_history) + [Text(obs, False)]
        new_history = new_history[max(0, len(new_history) - self.last_k):]
        return tuple(new_history), reward, False

    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None) -> TextHistory:
        self.rng = random.Random(seed)
        self.num_steps = 0
        self.move_history = []

        if options is not None and "goal" in options:
            self.goal = tuple(options["goal"])
        else:
            self.goal = tuple(self.rng.choice(self.valid_goals.tolist()))

        open_cells = [tuple(p) for p in np.argwhere(self.maze == 0).tolist()]
        open_cells.remove(tuple(self.goal))

        if options is not None and "init_position" in options:
            assert tuple(options["init_position"]) in open_cells
            self.position = tuple(options["init_position"])
        else:
            self.position = self.rng.choice(open_cells)

        self.initial_position = self.position if self.display_initial_position else None
        obs = self.describe_function(self.maze, self.position, self.goal, self.initial_position)
        return (Text(obs, False),)
