"""Wordle TextEnv layers (host-side): the port's own copy of
`lmrl_gym_tpu/envs/wordle/env.py`.

Parity with llm_rl_scripts/wordle/env/env.py:7-55: the raw environment
appends '<g><y><b>'-style transition strings; `ReformatWordleEnv` renders
the tokenizer-friendly space-separated-letters view.
"""
from __future__ import annotations

import random
from typing import Dict, Optional, Tuple

from lmrl_gym_torch.envs.base import TextEnv
from lmrl_gym_torch.envs.wordle.game import WordleGame
from lmrl_gym_torch.envs.wordle.vector import WordleVocab
from lmrl_gym_torch.text.frames import Text, TextHistory


class WordleEnv(TextEnv):
    """Raw Wordle TextEnv (env.py:39-55). reset() returns an empty history;
    the agent acts first."""

    def __init__(self, vocab: WordleVocab, bad_word_reward: float = -1.0):
        self.vocab = vocab
        self.bad_word_reward = bad_word_reward
        self.rng = random.Random()
        self.reset()

    def step(self, text_history: TextHistory) -> Tuple[TextHistory, float, bool]:
        assert text_history[-1].is_action
        self.game, reward, done, feedback = self.game.next(text_history[-1].text)
        return text_history + (Text(feedback, False),), reward, done

    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None) -> TextHistory:
        self.rng = random.Random(seed)
        self.game = WordleGame(
            self.vocab, rng=self.rng, bad_word_reward=self.bad_word_reward
        )
        return tuple()


def reformat_history(text_history: TextHistory) -> TextHistory:
    """'<g><y><b>' + raw words → space-separated letters (env.py:7-17)."""
    out = (Text("Wordle:\n", False),)
    for item in text_history:
        if item.is_action:
            out += (Text(" ".join(list(item.text)) + "\n", True),)
        elif len(item.text) == 0:
            out += (Text("\n", False),)
        else:
            out += (Text(" ".join(item.text[1:-1].split("><")) + "\n", False),)
    return out


def deformat_history(text_history: TextHistory) -> TextHistory:
    """Inverse of reformat_history (env.py:19-26); drops the header."""
    out = tuple()
    for item in text_history[1:]:
        stripped = item.text.strip().replace(" ", "")
        if item.is_action:
            out += (Text(stripped, True),)
        else:
            out += (Text("<" + "><".join(list(stripped)) + ">", False),)
    return out


class ReformatWordleEnv(TextEnv):
    def __init__(self, env: WordleEnv):
        self.env = env

    def step(self, text_history: TextHistory) -> Tuple[TextHistory, float, bool]:
        history, reward, done = self.env.step(deformat_history(text_history))
        return reformat_history(history), reward, done

    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None) -> TextHistory:
        return reformat_history(self.env.reset(seed=seed, options=options))
