"""The text MDP data model: the port's own copy of
`lmrl_gym_tpu/text/frames.py` (numpy only, same semantics).

Semantics identical to the reference's LLM_RL/environment.py:12-37,294-419:
a conversation is a tuple of (text, is_action) segments; trajectories carry
one scalar reward per segment (0 on non-action segments); tokenization
flattens segments into aligned per-token (token, is_action, reward) arrays
with each segment's reward placed on its **last** token — this alignment is
the contract every algorithm's data layer consumes and is kept bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Text:
    text: str
    is_action: bool


TextHistory = Tuple[Text, ...]


def text_history_to_str(text_history: TextHistory) -> str:
    return "".join(t.text for t in text_history)


@dataclass(frozen=True)
class TextTrajectory:
    """A single context-window-sized trajectory (environment.py:23-31)."""

    text_history: TextHistory
    reward: Tuple[float, ...]
    done: bool

    def __post_init__(self):
        assert len(self.reward) == len(self.text_history), (
            "one reward per text segment"
        )
        for r, t in zip(self.reward, self.text_history):
            if not t.is_action:
                assert r == 0.0, "non-action segments must have 0 reward"


@dataclass(frozen=True)
class TextTrajectoryChain:
    """Linked list of trajectories for cross-window credit assignment
    (environment.py:34-37)."""

    text_trajectory: TextTrajectory
    next: Optional["TextTrajectoryChain"]

    def to_list(self) -> List[TextTrajectory]:
        out, curr = [], self
        while curr is not None:
            out.append(curr.text_trajectory)
            curr = curr.next
        return out


TokenProcess = Callable[[List[int]], List[int]]


def _encode_history(
    text_history: TextHistory, tokenizer, token_process: Optional[TokenProcess]
):
    if token_process is None:
        token_process = lambda x: x
    tokens: List[int] = []
    is_action: List[bool] = []
    seg_lens: List[int] = []
    for seg in text_history:
        seg_tokens = token_process(tokenizer.encode(seg.text))
        tokens.extend(seg_tokens)
        is_action.extend([seg.is_action] * len(seg_tokens))
        seg_lens.append(len(seg_tokens))
    return tokens, is_action, seg_lens


@dataclass(frozen=True)
class TokenHistory:
    """Flattened (tokens, is_action) view of a TextHistory
    (environment.py:294-327)."""

    tokens: np.ndarray  # [t] int32
    is_action: np.ndarray  # [t] bool

    def __post_init__(self):
        assert self.tokens.ndim == 1 and self.is_action.ndim == 1
        assert self.tokens.shape == self.is_action.shape

    @classmethod
    def from_text_history(
        cls,
        text_history: TextHistory,
        tokenizer,
        token_process: Optional[TokenProcess] = None,
    ) -> "TokenHistory":
        tokens, is_action, _ = _encode_history(text_history, tokenizer, token_process)
        return cls(
            np.asarray(tokens, dtype=np.int32),
            np.asarray(is_action, dtype=np.bool_),
        )


@dataclass(frozen=True)
class TokenTrajectory:
    """Per-token (tokens, is_action, reward, done); each segment's scalar
    reward lands on the segment's last token (environment.py:361-380)."""

    tokens: np.ndarray  # [t] int32
    is_action: np.ndarray  # [t] bool
    reward: np.ndarray  # [t] float32
    done: np.ndarray  # [] bool

    def __post_init__(self):
        assert self.tokens.ndim == 1
        assert self.is_action.shape == self.tokens.shape
        assert self.reward.shape == self.tokens.shape
        assert self.done.ndim == 0
        assert not np.any(
            (~self.is_action) & (self.reward != 0.0)
        ), "reward must be 0 on non-action tokens"

    @classmethod
    def from_text_trajectory(
        cls,
        text_trajectory: TextTrajectory,
        tokenizer,
        token_process: Optional[TokenProcess] = None,
    ) -> "TokenTrajectory":
        tokens, is_action, seg_lens = _encode_history(
            text_trajectory.text_history, tokenizer, token_process
        )
        reward: List[float] = []
        for seg_len, seg_reward in zip(seg_lens, text_trajectory.reward):
            reward.extend([0.0] * (seg_len - 1) + [seg_reward])
        return cls(
            np.asarray(tokens, dtype=np.int32),
            np.asarray(is_action, dtype=np.bool_),
            np.asarray(reward, dtype=np.float32),
            np.asarray(text_trajectory.done, dtype=np.bool_),
        )


@dataclass(frozen=True)
class TokenTrajectoryChain:
    token_trajectory: TokenTrajectory
    next: Optional["TokenTrajectoryChain"]

    def __post_init__(self):
        dones, curr = [], self
        while curr.next is not None:
            dones.append(bool(curr.token_trajectory.done))
            curr = curr.next
        assert not any(dones[:-1]), "chain can only be done at the end"

    def to_list(self) -> List[TokenTrajectory]:
        out, curr = [], self
        while curr is not None:
            out.append(curr.token_trajectory)
            curr = curr.next
        return out

    @classmethod
    def from_text_trajectory_chain(
        cls,
        chain: TextTrajectoryChain,
        tokenizer,
        token_process: Optional[TokenProcess] = None,
    ) -> "TokenTrajectoryChain":
        return cls(
            TokenTrajectory.from_text_trajectory(
                chain.text_trajectory, tokenizer, token_process
            ),
            cls.from_text_trajectory_chain(chain.next, tokenizer, token_process)
            if chain.next is not None
            else None,
        )
