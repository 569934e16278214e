"""Task registry, the maze and text-nav parts: the port of
`transitions_to_chain`, `build_maze_env`, `generate_maze_chains`,
`build_text_nav_env` and `generate_text_nav_chains` from
`lmrl_gym_tpu/cli/tasks.py` (host only), with the `Task` record and a
`TASKS` table that holds the tasks ported so far.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

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


def transitions_to_chain(transitions) -> TextTrajectoryChain:
    """One rollout's InteractionTransitions → TextTrajectoryChain (the
    conversion every online loader performs on fresh rollouts, cf.
    wordle/ppo/train_ppo_gpt2.py:311).

    If the env keeps the whole conversation in the history (dialog tasks,
    wordle), emit one window with each action's reward on its Text. If the
    env windows its history (maze last_k, chess Markov FEN), the final
    history has dropped earlier actions — emit a chain of per-step windows
    (post_action_history) instead, linked for cross-window credit."""
    final = transitions[-1].post_transition_history
    n_actions_in_final = sum(1 for t in final if t.is_action)
    if n_actions_in_final == len(transitions):
        per_action = [t.reward for t in transitions]
        rewards, ai = [], 0
        for t in final:
            if t.is_action:
                rewards.append(per_action[ai])
                ai += 1
            else:
                rewards.append(0.0)
        return TextTrajectoryChain(
            TextTrajectory(final, tuple(rewards), transitions[-1].done), None
        )
    chain = None
    for tr in reversed(transitions):
        h = tr.post_action_history
        assert h[-1].is_action
        rewards = [0.0] * len(h)
        rewards[-1] = float(tr.reward)
        chain = TextTrajectoryChain(
            TextTrajectory(h, tuple(rewards), bool(tr.done)), chain
        )
    return chain


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


# ---------------- text-nav ----------------


def build_text_nav_env(display_location: bool = True, max_steps: int = 30) -> TextEnv:
    from lmrl_gym_torch.envs.text_nav.env import TextNavEnv

    return TextNavEnv(display_location=display_location, max_steps=max_steps)


def generate_text_nav_chains(n: int, seed: int, known_rooms: Optional[List[str]] = None) -> List[TextTrajectoryChain]:
    """PartialWalkthroughAgent rollouts; whole conversation in one window,
    windowed to the last (obs, action) pair per step for Markov training."""
    from lmrl_gym_torch.envs.text_nav.env import (
        PartialWalkthroughAgent,
        ROOMS,
        TextNavEnv,
    )

    rng = random.Random(seed)
    chains = []
    for i in range(n):
        env = TextNavEnv(display_location=True, max_steps=30)
        agent = PartialWalkthroughAgent(
            env, known_rooms=known_rooms or ROOMS[:5], rng=rng
        )
        history = env.reset(seed=seed * 7919 + i)
        steps = []
        done = False
        while not done:
            acted = agent.act(history)
            new_history, reward, done = env.step(acted)
            steps.append((acted[-2].text, acted[-1].text, float(reward), bool(done)))
            history = new_history
        chains.append(_chain_from_markov_steps(steps))
    return chains


TASKS: Dict[str, Task] = {
    "maze": Task("maze", build_maze_env, generate_maze_chains, max_length=192),
    "text_nav": Task("text_nav", build_text_nav_env, generate_text_nav_chains, max_length=512),
    "text_nav_partial": Task(
        "text_nav_partial",
        lambda **kw: build_text_nav_env(display_location=False, **kw),
        generate_text_nav_chains,
        max_length=512,
    ),
}
