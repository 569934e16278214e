"""Host-side Wordle game: the port's own copy of
`lmrl_gym_tpu/envs/wordle/game.py`, on the port's `vector.py` constants.

An independent numpy implementation of the knowledge-state Wordle MDP —
used for dataset generation, scripted policies and the text env, and as a
cross-check of the vectorized env (envs/wordle/vector.py). Knowledge is a
[26,5] int8 array rather than the reference's object graph; all decision
semantics are identical.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from lmrl_gym_torch.envs.wordle.vector import (
    ALPHA,
    GRAY,
    GREEN,
    HERE,
    N_CHARS,
    N_TRIES,
    NOT_HERE,
    POSSIBLE,
    YELLOW,
    WordleVocab,
    encode_word,
)


def word_satisfies(knowledge: np.ndarray, word: str) -> bool:
    """Does `word` satisfy the [26,5] knowledge state? (game.py:53-80)"""
    chars = encode_word(word)
    for c in range(ALPHA):
        row = knowledge[c]
        if np.all(row == POSSIBLE):
            continue
        if np.all(row == NOT_HERE):
            if c in chars:
                return False
            continue
        ok = True
        for i in range(N_CHARS):
            if row[i] == HERE and chars[i] != c:
                ok = False
                break
            if row[i] == NOT_HERE and chars[i] == c:
                ok = False
                break
        if not ok or c not in chars:
            return False
    return True


def apply_guess(knowledge: np.ndarray, guess: str, target: str) -> np.ndarray:
    """Sequential per-position knowledge update (game.py:82-92)."""
    out = knowledge.copy()
    tchars = set(target)
    for i, c in enumerate(guess):
        ci = ord(c) - ord("a")
        if c == target[i]:
            out[ci, i] = HERE
        elif c in tchars:
            out[ci, i] = NOT_HERE
        else:
            out[ci, :] = NOT_HERE
    return out


def feedback_string(knowledge: np.ndarray, guess: str) -> str:
    """Render the '<g><y><b>' transition string from the post-update state
    (game.py:273-288)."""
    out = []
    for i, c in enumerate(guess):
        ci = ord(c) - ord("a")
        if knowledge[ci, i] == HERE:
            out.append("<g>")
        elif np.all(knowledge[ci] == NOT_HERE):
            out.append("<b>")
        elif knowledge[ci, i] == NOT_HERE:
            out.append("<y>")
    return "".join(out)


class WordleGame:
    """One game; immutable-style `next()` returning a new game
    (game.py:193-296)."""

    def __init__(
        self,
        vocab: WordleVocab,
        knowledge: Optional[np.ndarray] = None,
        action_history: Optional[List[str]] = None,
        rng: Optional[random.Random] = None,
        bad_word_reward: float = -1.0,
        filtered: Optional[List[str]] = None,
    ):
        self.vocab = vocab
        self.knowledge = (
            knowledge
            if knowledge is not None
            else np.full((ALPHA, N_CHARS), POSSIBLE, dtype=np.int8)
        )
        self.action_history = action_history or []
        self.rng = rng if rng is not None else random.Random()
        self.bad_word_reward = bad_word_reward
        if filtered is None:
            filtered = [w for w in vocab.words if word_satisfies(self.knowledge, w)]
        self.filtered = filtered

    def _is_valid(self, action: str) -> bool:
        return (
            len(action) == N_CHARS
            and all("a" <= c <= "z" for c in action)
            and action in self.vocab.words
        )

    def next(self, action: str) -> Tuple["WordleGame", float, bool, str]:
        """Returns (new_game, reward, done, feedback_str). Invalid guesses
        consume a try, leave knowledge unchanged, and yield
        bad_word_reward with an empty feedback string (game.py:213-216)."""
        if not self._is_valid(action):
            g = WordleGame(
                self.vocab,
                self.knowledge,
                self.action_history + [action],
                self.rng,
                self.bad_word_reward,
                filtered=self.filtered,
            )
            return g, g.reward(), g.is_terminal(), ""
        # feedback target: random word from the *current* filtered vocab
        target = self.rng.choice(self.filtered)
        new_knowledge = apply_guess(self.knowledge, action, target)
        g = WordleGame(
            self.vocab,
            new_knowledge,
            self.action_history + [action],
            self.rng,
            self.bad_word_reward,
        )
        return g, g.reward(), g.is_terminal(), feedback_string(new_knowledge, action)

    def reward(self) -> float:
        """game.py:290-293."""
        if self.action_history and not self._is_valid(self.action_history[-1]):
            return self.bad_word_reward
        win = len(self.filtered) == 1 and self.filtered[0] in self.action_history
        return float(int(win) - 1)

    def is_terminal(self) -> bool:
        return len(self.action_history) == N_TRIES or self.reward() == 0.0
