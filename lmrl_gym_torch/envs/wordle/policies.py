"""Scripted Wordle policies for dataset generation and eval bounds: the
port's own copy of `lmrl_gym_tpu/envs/wordle/policies.py`.

Parity with llm_rl_scripts/wordle/env/scripted_policies.py:42-174:
StartWordPolicy, OptimalPolicy (exact expected-information argmax over
the successor-state distribution, with a state cache), RepeatPolicy,
RandomMixturePolicy, WrongPolicy, MixturePolicy. The reference scores
candidates with a Python object-graph loop; here the inner loop
(patterns × vocab consistency counts) is vectorized numpy over the
[26,5] knowledge arrays — same argmax sets.

Policies act on the RAW Wordle text protocol (guess words + '<g><y><b>'
feedback strings); game state is rebuilt from the history exactly like
the reference's WordleGame.from_str (game.py:251-271).
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from lmrl_gym_torch.envs.base import TextPolicy
from lmrl_gym_torch.envs.wordle.game import word_satisfies
from lmrl_gym_torch.envs.wordle.vector import (
    ALPHA,
    HERE,
    N_CHARS,
    NOT_HERE,
    POSSIBLE,
    WordleVocab,
    encode_word,
)
from lmrl_gym_torch.text.frames import Text, TextHistory

IDX2CHAR = "abcdefghijklmnopqrstuvwxyz"

# default strong openers (scripted_policies.py:48-54)
DEFAULT_START_WORDS = [
    "opera", "tears", "soare", "roate", "raise", "arose", "earls", "laser",
    "reals", "aloes", "reais", "slate", "sauce", "slice", "shale", "saute",
    "share", "sooty", "shine", "suite", "crane", "adieu", "audio", "stare",
    "roast", "ratio", "arise", "tales",
]


def apply_feedback(knowledge: np.ndarray, guess: str, feedback: str) -> np.ndarray:
    """transition_from_str (game.py:94-107): '<g>'→HERE@i, '<y>'→NOT_HERE@i,
    '<b>'→whole row NOT_HERE; sequential over positions."""
    out = knowledge.copy()
    codes = [feedback[i : i + 3] for i in range(0, len(feedback), 3)]
    for i, c in enumerate(guess):
        ci = ord(c) - ord("a")
        if codes[i] == "<g>":
            out[ci, i] = HERE
        elif codes[i] == "<y>":
            out[ci, i] = NOT_HERE
        elif codes[i] == "<b>":
            out[ci, :] = NOT_HERE
        else:
            raise ValueError(codes[i])
    return out


def state_from_history(
    text_history: TextHistory, vocab: WordleVocab
) -> Tuple[np.ndarray, List[str]]:
    """Rebuild (knowledge, action_history) from raw alternating
    (guess, feedback) texts; malformed/OOV guesses are skipped for state
    purposes (game.py:251-271)."""
    knowledge = np.full((ALPHA, N_CHARS), POSSIBLE, dtype=np.int8)
    actions: List[str] = []
    items = [t.text for t in text_history]
    guesses = items[0::2]
    feedbacks = items[1::2]
    for i, guess in enumerate(guesses):
        actions.append(guess)
        if i >= len(feedbacks):
            break
        # empty feedback marks a guess the ENV rejected (malformed or
        # outside the env's vocab — which may differ from `vocab`, e.g.
        # opener lists): no knowledge update (game.py:276-278)
        if (
            len(guess) == N_CHARS
            and all("a" <= c <= "z" for c in guess)
            and guess in vocab.words
            and len(feedbacks[i]) == 3 * N_CHARS
        ):
            knowledge = apply_feedback(knowledge, guess, feedbacks[i])
    return knowledge, actions


def _filtered_mask(knowledge: np.ndarray, vocab: WordleVocab) -> np.ndarray:
    """[V] bool consistency, vectorized (mirrors vector.consistent_mask
    in numpy)."""
    chars = vocab.chars  # [V,5]
    has = vocab.has_char  # [V,26]
    all_possible = (knowledge == POSSIBLE).all(axis=1)  # [26]
    all_nothere = (knowledge == NOT_HERE).all(axis=1)
    w_match = np.eye(ALPHA, dtype=bool)[chars]  # [V,5,26]
    w_match = np.transpose(w_match, (0, 2, 1))  # [V,26,5]
    here = knowledge == HERE
    nothere = knowledge == NOT_HERE
    here_viol = (here[None] & ~w_match).any(axis=2)  # [V,26]
    nothere_viol = (nothere[None] & w_match).any(axis=2)
    mixed_ok = ~here_viol & ~nothere_viol & has
    ok = np.where(all_possible[None], True, np.where(all_nothere[None], ~has, mixed_ok))
    return ok.all(axis=1)


class _StateCache:
    def __init__(self):
        self._d: Dict[bytes, List[str]] = {}

    def get(self, knowledge: np.ndarray) -> Optional[List[str]]:
        return self._d.get(knowledge.tobytes())

    def put(self, knowledge: np.ndarray, value: List[str]) -> None:
        self._d[knowledge.tobytes()] = value


class StartWordPolicy(TextPolicy):
    def __init__(self, start_words: Optional[List[str]] = None, rng: Optional[random.Random] = None):
        self.start_words = start_words or list(DEFAULT_START_WORDS)
        self.rng = rng or random.Random()

    def act(self, text_history: TextHistory) -> TextHistory:
        # filter openers to knowledge-consistent ones (vocab = openers)
        opener_vocab = WordleVocab.from_words(self.start_words)
        knowledge, _ = state_from_history(text_history, opener_vocab)
        mask = _filtered_mask(knowledge, opener_vocab)
        options = [w for w, ok in zip(opener_vocab.words, mask) if ok]
        if not options:
            word = "".join(self.rng.choice(IDX2CHAR) for _ in range(N_CHARS))
        else:
            word = self.rng.choice(options)
        return text_history + (Text(word, True),)


class OptimalPolicy(TextPolicy):
    """Exact expected-information argmax (scripted_policies.py:66-96):
    score(a) = log|F| − Σ_patterns (n_p/N)·log|filtered(K'_p)|; candidates
    and feedback targets are the current filtered set F."""

    def __init__(
        self,
        vocab: WordleVocab,
        start_word_policy: Optional[TextPolicy] = None,
        rng: Optional[random.Random] = None,
    ):
        self.vocab = vocab
        self.start_word_policy = start_word_policy
        self.rng = rng or random.Random()
        self.cache = _StateCache()

    def act(self, text_history: TextHistory) -> TextHistory:
        knowledge, actions = state_from_history(text_history, self.vocab)
        cached = self.cache.get(knowledge)
        if cached is not None:
            return text_history + (Text(self.rng.choice(cached), True),)
        if len(actions) == 0 and self.start_word_policy is not None:
            return self.start_word_policy.act(text_history)

        best_words = self._best_words(knowledge)
        self.cache.put(knowledge, best_words)
        return text_history + (Text(self.rng.choice(best_words), True),)

    def _best_words(self, knowledge: np.ndarray) -> List[str]:
        vocab = self.vocab
        filt = _filtered_mask(knowledge, vocab)
        f_idx = np.where(filt)[0]
        F = vocab.chars[f_idx]  # [N,5] targets = candidates
        N = len(f_idx)
        log_full = math.log(N)

        best_words, best_info = [], float("-inf")
        for a_pos, a_idx in enumerate(f_idx):
            guess = vocab.chars[a_idx]  # [5]
            # feedback patterns vs all targets
            green = F == guess[None, :]  # [N,5]
            inword = vocab.has_char[f_idx][:, guess]  # [N,5]
            code = np.where(green, 2, np.where(inword, 1, 0))  # [N,5]
            pattern_ids = (code * (3 ** np.arange(N_CHARS))[None, :]).sum(axis=1)
            uniq, counts = np.unique(pattern_ids, return_counts=True)

            # next knowledge per unique pattern (sequential position update)
            P = len(uniq)
            codes = (uniq[:, None] // (3 ** np.arange(N_CHARS))[None, :]) % 3  # [P,5]
            K = np.broadcast_to(knowledge, (P, ALPHA, N_CHARS)).copy()
            for i in range(N_CHARS):
                c = int(guess[i])
                row = K[:, c, :]
                is_g = codes[:, i] == 2
                is_y = codes[:, i] == 1
                is_b = codes[:, i] == 0
                row[is_b] = NOT_HERE
                row[is_y, i] = NOT_HERE
                row[is_g, i] = HERE

            # |filtered(K')| per pattern, batched
            sizes = self._batch_filtered_sizes(K)
            total_entropy = float((np.log(sizes) * counts).sum())
            info_gain = log_full - total_entropy / counts.sum()
            if info_gain > best_info + 1e-12:
                best_words, best_info = [vocab.words[a_idx]], info_gain
            elif abs(info_gain - best_info) <= 1e-12:
                best_words.append(vocab.words[a_idx])
        return best_words

    def _batch_filtered_sizes(self, K: np.ndarray) -> np.ndarray:
        """[P,26,5] knowledge → [P] consistent-word counts."""
        vocab = self.vocab
        chars = vocab.chars
        has = vocab.has_char
        w_match = np.transpose(np.eye(ALPHA, dtype=bool)[chars], (0, 2, 1))  # [V,26,5]
        all_possible = (K == POSSIBLE).all(axis=2)  # [P,26]
        all_nothere = (K == NOT_HERE).all(axis=2)
        here = K == HERE  # [P,26,5]
        nothere = K == NOT_HERE
        here_viol = np.einsum("pcs,vcs->pvc", here, ~w_match) > 0  # [P,V,26]
        nothere_viol = np.einsum("pcs,vcs->pvc", nothere, w_match) > 0
        mixed_ok = ~here_viol & ~nothere_viol & has[None]
        ok = np.where(
            all_possible[:, None, :],
            True,
            np.where(all_nothere[:, None, :], ~has[None], mixed_ok),
        )
        return ok.all(axis=2).sum(axis=1)


class RepeatPolicy(TextPolicy):
    """Repeat one of the first_n previous guesses (scripted_policies.py:98-112)."""

    def __init__(
        self,
        start_word_policy: Optional[TextPolicy] = None,
        first_n: Optional[int] = None,
        rng: Optional[random.Random] = None,
    ):
        self.start_word_policy = start_word_policy
        self.first_n = first_n
        self.rng = rng or random.Random()

    def act(self, text_history: TextHistory) -> TextHistory:
        actions = [t.text for t in text_history][0::2]
        if len(actions) == 0:
            if self.start_word_policy is not None:
                return self.start_word_policy.act(text_history)
            word = "".join(self.rng.choice(IDX2CHAR) for _ in range(N_CHARS))
            return text_history + (Text(word, True),)
        pool = actions if self.first_n is None else actions[: self.first_n]
        return text_history + (Text(self.rng.choice(pool), True),)


class RandomMixturePolicy(TextPolicy):
    """p_smart → random consistent word; else random vocab word
    (scripted_policies.py:114-127)."""

    def __init__(self, prob_smart: float, vocab: WordleVocab, rng: Optional[random.Random] = None):
        self.prob_smart = prob_smart
        self.vocab = vocab
        self.rng = rng or random.Random()

    def act(self, text_history: TextHistory) -> TextHistory:
        if self.rng.random() < self.prob_smart:
            knowledge, _ = state_from_history(text_history, self.vocab)
            mask = _filtered_mask(knowledge, self.vocab)
            options = [w for w, ok in zip(self.vocab.words, mask) if ok]
        else:
            options = list(self.vocab.words)
        return text_history + (Text(self.rng.choice(options), True),)


class WrongPolicy(TextPolicy):
    """Deliberately inconsistent guesses (scripted_policies.py:129-142)."""

    def __init__(self, vocab: WordleVocab, rng: Optional[random.Random] = None):
        self.vocab = vocab
        self.rng = rng or random.Random()

    def act(self, text_history: TextHistory) -> TextHistory:
        knowledge, _ = state_from_history(text_history, self.vocab)
        mask = _filtered_mask(knowledge, self.vocab)
        bad = [w for w, ok in zip(self.vocab.words, mask) if not ok]
        options = bad if bad else list(self.vocab.words)
        return text_history + (Text(self.rng.choice(options), True),)


class MixturePolicy(TextPolicy):
    def __init__(self, prob1: float, policy1: TextPolicy, policy2: TextPolicy, rng: Optional[random.Random] = None):
        self.prob1 = prob1
        self.policy1 = policy1
        self.policy2 = policy2
        self.rng = rng or random.Random()

    def act(self, text_history: TextHistory) -> TextHistory:
        if self.rng.random() < self.prob1:
            return self.policy1.act(text_history)
        return self.policy2.act(text_history)
