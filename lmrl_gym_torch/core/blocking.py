"""Sequence padding/truncation ("blocking") utilities.

The port's own copy of `lmrl_gym_tpu/core/blocking.py` (same semantics):
pad to `max_length` with `pad_value` on the chosen side; truncate from the
chosen side when longer.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


class Padding(enum.Enum):
    LEFT = "left"
    RIGHT = "right"


class Truncation(enum.Enum):
    LEFT = "left"
    RIGHT = "right"


@dataclass(frozen=True)
class BlockingStrategy:
    padding: Padding
    truncation: Truncation
    max_length: Optional[int]


def block_sequence(
    seq: Sequence,
    pad_value,
    dtype,
    strategy: BlockingStrategy,
) -> np.ndarray:
    seq = list(seq)
    L = strategy.max_length
    if L is None:
        return np.asarray(seq, dtype=dtype)
    if len(seq) > L:
        if strategy.truncation == Truncation.LEFT:
            seq = seq[len(seq) - L:]
        else:
            seq = seq[:L]
    pad = [pad_value] * (L - len(seq))
    if strategy.padding == Padding.LEFT:
        seq = pad + seq
    else:
        seq = seq + pad
    return np.asarray(seq, dtype=dtype)


def block_sequences(
    seqs: Sequence[Sequence],
    pad_value,
    dtype,
    strategy: BlockingStrategy,
) -> np.ndarray:
    """[n_seqs] list of variable-length lists → [n_seqs, max_length] array."""
    if strategy.max_length is None:
        max_len = max((len(s) for s in seqs), default=0)
        strategy = BlockingStrategy(strategy.padding, strategy.truncation, max_len)
    return np.stack(
        [block_sequence(s, pad_value, dtype, strategy) for s in seqs], axis=0
    )


def strip_prompt_from_completion(prompt: str, completion: str) -> str:
    """Remove the prompt prefix from a decoded generation."""
    if completion.startswith(prompt):
        return completion[len(prompt):]
    return completion
