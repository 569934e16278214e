"""Task registry, the maze part: the port of `build_maze_env` and
`generate_maze_chains` from `lmrl_gym_tpu/cli/tasks.py` (host only), with
the `Task` record and a `TASKS` table that holds the tasks ported so far.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np

from lmrl_gym_torch.envs.base import TextEnv
from lmrl_gym_torch.text.frames import Text, TextTrajectory, TextTrajectoryChain


@dataclass
class Task:
    name: str
    build_env: Callable[..., TextEnv]
    generate_chains: Callable[[int, int], List[TextTrajectoryChain]]
    max_length: int  # default training window
    # policy-side text processing for generation
    stop_token: str = "\n"


def _chain_from_markov_steps(steps) -> TextTrajectoryChain:
    """[(obs_text, action_text, reward, done)] → chain of 1-step windows."""
    chain = None
    for obs, action, reward, done in reversed(steps):
        chain = TextTrajectoryChain(
            TextTrajectory(
                (Text(obs, False), Text(action, True)), (0.0, reward), done
            ),
            chain,
        )
    return chain


# ---------------- maze ----------------


def build_maze_env(max_steps: int = 100, last_k: int = 1) -> TextEnv:
    from lmrl_gym_torch.envs.maze.env import MazeEnv
    from lmrl_gym_torch.envs.maze.grids import double_t_maze

    return MazeEnv(
        maze=double_t_maze(),
        valid_goals=np.asarray([(8, 6)]),
        max_steps=max_steps,
        last_k=last_k,
    )


def generate_maze_chains(
    n: int, seed: int, p_optimal: float = 0.7, wrong_bias: bool = False
) -> List[TextTrajectoryChain]:
    """Mixture of BFS-optimal and random moves; Markov (obs, action)
    windows chained for cross-window credit assignment.

    wrong_bias=True makes the non-optimal mass DETERMINISTIC (the first
    non-optimal action per cell) instead of uniform. With p_optimal < 0.5
    the behavior policy's mode is then systematically wrong, so BC
    imitation fails while the returns still identify optimal paths — the
    adversarial regime where only value learning recovers the optimal
    policy (used by the reference-scale ILQL gate)."""
    from lmrl_gym_torch.envs.maze.env import MazeEnv
    from lmrl_gym_torch.envs.maze.grids import ACTION_STRS, double_t_maze, maze_solver

    maze = double_t_maze()
    solver = maze_solver(maze, (8, 6))
    rng = random.Random(seed)
    env = build_maze_env()
    chains = []
    for i in range(n):
        obs = env.reset(seed=seed * 100003 + i)
        steps = []
        done = False
        while not done and len(steps) < 40:
            if rng.random() < p_optimal and tuple(env.position) in solver:
                action = solver[tuple(env.position)]
            elif wrong_bias and tuple(env.position) in solver:
                opt = solver[tuple(env.position)]
                action = next(a for a in ACTION_STRS if a != opt)
            else:
                action = rng.choice(ACTION_STRS)
            history = obs + (Text(action, True),)
            obs, reward, done = env.step(history)
            steps.append((history[0].text, action, reward, done))
        if not done:
            steps[-1] = steps[-1][:3] + (True,)
        chains.append(_chain_from_markov_steps(steps))
    return chains


TASKS: Dict[str, Task] = {
    "maze": Task("maze", build_maze_env, generate_maze_chains, max_length=192),
}
