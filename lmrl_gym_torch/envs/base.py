"""Environment / policy interfaces and the host-side interaction loop: the
port's own copy of `lmrl_gym_tpu/envs/base.py` (numpy only).

Behavioral parity with LLM_RL/environment.py:41-267: TextEnv/TextPolicy
single and batched variants, adapters in both directions, the lockstep
`interact_environment` loop (batch padding with empty done slots), and the
`text_env_eval` aggregation harness.

This host-side path is the text interface every environment shares
(parity tests, text serving). The device hot path is the vectorized env in
`lmrl_gym_torch.envs.wordle.vector`, which steps thousands of games in
lockstep and never touches these Python types per step.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from copy import deepcopy
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

import numpy as np

from lmrl_gym_torch.text.frames import Text, TextHistory

StepResult = Tuple[TextHistory, float, bool]


class TextEnv(ABC):
    @abstractmethod
    def step(self, text_history: TextHistory) -> StepResult:
        ...

    @abstractmethod
    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None) -> TextHistory:
        ...

    def close(self) -> None:
        pass

    def copy(self) -> "TextEnv":
        return deepcopy(self)


class BatchedTextEnv(ABC):
    @abstractmethod
    def step(
        self,
        text_history: List[Optional[TextHistory]],
        done: Optional[List[bool]] = None,
    ) -> List[Optional[StepResult]]:
        ...

    @abstractmethod
    def reset(
        self,
        seed: Optional[List[Optional[int]]] = None,
        options: Optional[List[Optional[Dict]]] = None,
    ) -> List[TextHistory]:
        ...

    def close(self) -> None:
        pass

    def copy(self) -> "BatchedTextEnv":
        return deepcopy(self)


class TextPolicy(ABC):
    @abstractmethod
    def act(self, text_history: TextHistory) -> TextHistory:
        ...


class BatchedTextPolicy(ABC):
    @abstractmethod
    def act(
        self,
        text_history: List[Optional[TextHistory]],
        done: Optional[List[bool]] = None,
    ) -> List[Optional[TextHistory]]:
        ...


class BatchedFromSingleEnv(BatchedTextEnv):
    """Run a batch by copying a single env per slot (environment.py:71-98)."""

    def __init__(self, env: TextEnv):
        self.env = env
        self.slots: Optional[List[TextEnv]] = None

    def reset(self, seed=None, options=None) -> List[TextHistory]:
        if seed is None and options is None:
            seed, options = [None], [None]
        elif seed is None:
            seed = [None] * len(options)
        elif options is None:
            options = [None] * len(seed)
        assert len(seed) == len(options)
        self.slots = [self.env.copy() for _ in seed]
        return [e.reset(seed=s, options=o) for e, s, o in zip(self.slots, seed, options)]

    def step(self, text_history, done=None):
        assert self.slots is not None, "reset before step"
        assert len(text_history) == len(self.slots)
        if done is None:
            done = [False] * len(text_history)
        return [
            None if d else env.step(h)
            for env, h, d in zip(self.slots, text_history, done)
        ]

    def close(self) -> None:
        if self.slots:
            for e in self.slots:
                e.close()
        self.env.close()


class SingleFromBatchedEnv(TextEnv):
    def __init__(self, env: BatchedTextEnv):
        self.env = env

    def step(self, text_history: TextHistory) -> StepResult:
        return self.env.step([text_history])[0]

    def reset(self, seed=None, options=None) -> TextHistory:
        return self.env.reset(seed=[seed], options=[options])[0]

    def close(self) -> None:
        self.env.close()


class BatchedFromSinglePolicy(BatchedTextPolicy):
    def __init__(self, policy: TextPolicy):
        self.policy = policy

    def act(self, text_history, done=None):
        if done is None:
            done = [False] * len(text_history)
        return [
            None if d else self.policy.act(h)
            for h, d in zip(text_history, done)
        ]


class SingleFromBatchedPolicy(TextPolicy):
    def __init__(self, policy: BatchedTextPolicy):
        self.policy = policy

    def act(self, text_history: TextHistory) -> TextHistory:
        return self.policy.act([text_history])[0]


class InteractionTransition(NamedTuple):
    pre_action_history: TextHistory
    post_action_history: TextHistory
    post_transition_history: TextHistory
    reward: float
    done: bool


def interact_environment(
    env: Union[TextEnv, BatchedTextEnv],
    policy: Union[TextPolicy, BatchedTextPolicy],
    initial_text_history: Optional[Union[TextHistory, List[TextHistory]]] = None,
    env_seed: Union[Optional[int], Optional[List[Optional[int]]]] = None,
    env_options: Union[Optional[Dict], Optional[List[Optional[Dict]]]] = None,
    bsize: int = 1,
    npad: int = 0,
) -> List[List[InteractionTransition]]:
    """Lockstep policy.act → env.step loop until all slots are done
    (environment.py:154-207). `npad` extra slots are padded with empty
    already-done histories so the policy always sees a fixed batch size."""
    assert bsize > 0
    if isinstance(env, TextEnv):
        env = BatchedFromSingleEnv(env)
    if isinstance(policy, TextPolicy):
        policy = BatchedFromSinglePolicy(policy)
    if isinstance(env_seed, int):
        env_seed = [env_seed] * bsize
    if isinstance(env_options, dict):
        env_options = [env_options] * bsize
    if initial_text_history is not None and isinstance(initial_text_history, tuple):
        initial_text_history = [initial_text_history] * bsize

    text_history = initial_text_history
    if text_history is None:
        text_history = env.reset(env_seed, env_options)

    transitions: List[List[InteractionTransition]] = [[] for _ in range(bsize)]
    done = [False] * bsize
    pad_histories = [(Text("", False),)] * npad
    while not all(done):
        pre_action = text_history
        acted = policy.act(
            list(text_history) + pad_histories, done=done + [True] * npad
        )
        text_history = acted[:bsize]
        post_action = text_history

        step_results = env.step(text_history, done=done)
        step_results = [
            (None, None, True) if r is None else r for r in step_results
        ]
        text_history = [r[0] for r in step_results]
        reward = [r[1] for r in step_results]
        done = [r[2] for r in step_results]

        for i in range(bsize):
            if done[i] and (
                pre_action[i] is None
                or post_action[i] is None
                or text_history[i] is None
                or reward[i] is None
            ):
                continue
            transitions[i].append(
                InteractionTransition(
                    pre_action_history=pre_action[i],
                    post_action_history=post_action[i],
                    post_transition_history=text_history[i],
                    reward=reward[i],
                    done=done[i],
                )
            )
    return transitions


def text_env_eval(
    env: Union[TextEnv, BatchedTextEnv],
    policy: Union[TextPolicy, BatchedTextPolicy],
    n_rollouts: int,
    initial_text_history: Optional[TextHistory] = None,
    seed_generator: Optional[Iterator[int]] = None,
    env_options: Optional[Dict] = None,
    interaction_callback: Optional[Callable] = None,
    bsize: int = 1,
    verbose: bool = False,
) -> Tuple[List[List[InteractionTransition]], Dict[str, Any]]:
    """Batched rollout + reward/done/length summary (environment.py:211-267)."""
    interactions: List[List[InteractionTransition]] = []
    rewards, dones, lengths = [], [], []
    n_batches = (n_rollouts + bsize - 1) // bsize
    for _ in range(n_batches):
        actual = min(n_rollouts - len(interactions), bsize)
        batch = interact_environment(
            env,
            policy,
            initial_text_history=initial_text_history,
            env_seed=[None] * actual
            if seed_generator is None
            else [next(seed_generator) for _ in range(actual)],
            env_options=[env_options] * actual,
            bsize=actual,
            npad=bsize - actual,
        )
        for rollout in batch:
            interactions.append(rollout)
            rewards.append(sum(t.reward for t in rollout))
            dones.append(rollout[-1].done)
            lengths.append(len(rollout))
            if interaction_callback is not None:
                interaction_callback(rollout)

    rewards_arr = np.asarray(rewards, dtype=np.float32)
    dones_arr = np.asarray(dones, dtype=np.float32)
    lengths_arr = np.asarray(lengths, dtype=np.float32)

    def summary(a: np.ndarray) -> Dict[str, float]:
        return dict(
            mean=float(a.mean()),
            std=float(a.std()),
            min=float(a.min()),
            max=float(a.max()),
        )

    return interactions, dict(
        reward=summary(rewards_arr),
        done=summary(dones_arr),
        length=summary(lengths_arr),
    )
