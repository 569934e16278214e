"""Wordle dataset generation: the port's own copy of
`lmrl_gym_tpu/envs/wordle/data.py`.

Rolls scripted policies against the host Wordle env and emits
TextTrajectory(Chain)s in the reformatted (space-separated-letter)
protocol the LM consumes.
"""
from __future__ import annotations

import random
from typing import List, Optional

from lmrl_gym_torch.envs.base import interact_environment
from lmrl_gym_torch.envs.wordle.env import WordleEnv, reformat_history
from lmrl_gym_torch.envs.wordle.vector import WordleVocab
from lmrl_gym_torch.text.frames import (
    Text,
    TextTrajectory,
    TextTrajectoryChain,
    TextHistory,
)


def rollout_trajectory(
    env: WordleEnv,
    policy,
    seed: Optional[int] = None,
    reformat: bool = True,
) -> TextTrajectory:
    """One episode → TextTrajectory (whole conversation in one window)."""
    transitions = interact_environment(env, policy, env_seed=seed)[0]
    final_history: TextHistory = transitions[-1].post_transition_history
    rewards_by_action = [t.reward for t in transitions]

    if reformat:
        final_history = reformat_history(final_history)
        # [header, a1, o1, a2, o2, ...]
        reward = [0.0]
        action_i = 0
        for t in final_history[1:]:
            if t.is_action:
                reward.append(rewards_by_action[action_i])
                action_i += 1
            else:
                reward.append(0.0)
    else:
        reward = []
        action_i = 0
        for t in final_history:
            if t.is_action:
                reward.append(rewards_by_action[action_i])
                action_i += 1
            else:
                reward.append(0.0)
    return TextTrajectory(tuple(final_history), tuple(reward), transitions[-1].done)


def generate_trajectories(
    n_trajectories: int,
    policy,
    vocab: WordleVocab,
    seed: int = 0,
    reformat: bool = True,
) -> List[TextTrajectory]:
    env = WordleEnv(vocab)
    return [
        rollout_trajectory(env, policy, seed=seed + i, reformat=reformat)
        for i in range(n_trajectories)
    ]


def trajectories_to_chains(
    trajectories: List[TextTrajectory],
) -> List[TextTrajectoryChain]:
    """Single-window chains (wordle episodes fit one context)."""
    return [TextTrajectoryChain(t, None) for t in trajectories]
