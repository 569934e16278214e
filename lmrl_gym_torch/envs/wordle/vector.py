"""Vectorized Wordle: the letter-knowledge game as batched tensor code.

The port of `lmrl_gym_tpu/envs/wordle/vector.py` (which property-tests its
semantics against the reference's object-graph game). B games step in
lockstep on the device:

- state is per-letter/position knowledge ∈ {NOT_HERE, POSSIBLE, HERE};
  each guess is scored against a *random knowledge-consistent word*
  (adversarial/lazy Wordle);
- the knowledge update is sequential over the 5 positions (gray
  overwrites the whole row, so order matters for repeated letters);
- reward: `bad_word_reward` for malformed/OOV guesses (which still consume
  a try), else `win - 1`; terminal at 6 tries or a win.

The target draw and `random_consistent_guess` sample as
`jax.random.categorical` does (argmax of logits plus Gumbel noise), from an
explicit `torch.Generator` or from noise the caller hands in.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lmrl_gym_torch.core.device import DeviceLike, resolve_device
from lmrl_gym_torch.core.random import categorical

N_CHARS = 5
N_TRIES = 6
ALPHA = 26

NOT_HERE, POSSIBLE, HERE = 0, 1, 2

# feedback codes
GRAY, YELLOW, GREEN = 0, 1, 2

_DEFAULT_VOCAB = os.path.join(os.path.dirname(__file__), "vocab", "wordle_official_400.txt")


def encode_word(word: str) -> np.ndarray:
    return np.asarray([ord(c) - ord("a") for c in word], dtype=np.int8)


@dataclass(frozen=True)
class WordleVocab:
    """Static vocab tables: chars [V,5] int8, has_char [V,26] bool."""

    words: Tuple[str, ...]
    chars: np.ndarray
    has_char: np.ndarray

    @classmethod
    def from_words(cls, words: List[str]) -> "WordleVocab":
        words = [w for w in words if len(w) == N_CHARS]
        chars = np.stack([encode_word(w) for w in words])
        has_char = np.zeros((len(words), ALPHA), dtype=bool)
        for i, w in enumerate(words):
            for c in w:
                has_char[i, ord(c) - ord("a")] = True
        return cls(tuple(words), chars, has_char)

    @classmethod
    def from_file(cls, path: str = _DEFAULT_VOCAB) -> "WordleVocab":
        with open(path) as f:
            return cls.from_words([line.strip() for line in f])

    def __len__(self) -> int:
        return len(self.words)


@dataclass(frozen=True, eq=False)  # tensor fields: identity, not elementwise ==
class WordleState:
    """Batched env state; all tensors have a leading batch dim B."""

    knowledge: torch.Tensor  # [B, 26, 5] int8 ∈ {NOT_HERE, POSSIBLE, HERE}
    guess_hist: torch.Tensor  # [B, 6, 5] int8, -1 where unused/invalid
    n_guesses: torch.Tensor  # [B] int32 (counts every try, incl. invalid)
    last_invalid: torch.Tensor  # [B] bool — last guess was malformed/OOV
    done: torch.Tensor  # [B] bool
    reward: torch.Tensor  # [B] float32 — reward of the last step


def initial_state(batch: int, device: DeviceLike = None) -> WordleState:
    device = resolve_device(device)
    return WordleState(
        knowledge=torch.full((batch, ALPHA, N_CHARS), POSSIBLE, dtype=torch.int8, device=device),
        guess_hist=torch.full((batch, N_TRIES, N_CHARS), -1, dtype=torch.int8, device=device),
        n_guesses=torch.zeros((batch,), dtype=torch.int32, device=device),
        last_invalid=torch.zeros((batch,), dtype=torch.bool, device=device),
        done=torch.zeros((batch,), dtype=torch.bool, device=device),
        reward=torch.zeros((batch,), dtype=torch.float32, device=device),
    )


def consistent_mask(
    knowledge: torch.Tensor,  # [..., 26, 5] int8
    vocab_chars: torch.Tensor,  # [V, 5] int8
    vocab_has: torch.Tensor,  # [V, 26] bool
) -> torch.Tensor:
    """[..., V] bool: which vocab words satisfy the knowledge state.

    A word is consistent iff for every letter c: an all-POSSIBLE row
    constrains nothing; an all-NOT_HERE row forbids c; otherwise every HERE
    cell matches, no NOT_HERE cell matches, and the word contains c."""
    all_possible = (knowledge == POSSIBLE).all(dim=-1)  # [...,26]
    all_not_here = (knowledge == NOT_HERE).all(dim=-1)
    # w_match[v, c, p]: word v has letter c at position p
    w_match = F.one_hot(vocab_chars.long(), ALPHA).bool().transpose(1, 2)  # [V,26,5]
    here = (knowledge == HERE)[..., None, :, :]  # [...,1,26,5]
    nothere = (knowledge == NOT_HERE)[..., None, :, :]
    here_viol = (here & ~w_match).any(dim=-1)  # [...,V,26]
    nothere_viol = (nothere & w_match).any(dim=-1)
    mixed_ok = ~here_viol & ~nothere_viol & vocab_has
    ap = all_possible[..., None, :]  # [...,1,26]
    anh = all_not_here[..., None, :]
    ok = torch.where(ap, True, torch.where(anh, ~vocab_has, mixed_ok))
    return ok.all(dim=-1)  # [..., V]


def _where_state(frozen: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    return torch.where(frozen.view((-1,) + (1,) * (old.dim() - 1)), old, new)


class WordleVectorEnv:
    """B Wordle games stepped in lockstep on one device.

    `step(state, guess, valid)` consumes [B,5] char-index guesses and
    returns (new_state, feedback [B,5] ∈ {GRAY,YELLOW,GREEN})."""

    def __init__(self, vocab: WordleVocab, bad_word_reward: float = -1.0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.vocab = vocab
        self.bad_word_reward = bad_word_reward
        self.vocab_chars = torch.as_tensor(vocab.chars, device=self.device)
        self.vocab_has = torch.as_tensor(vocab.has_char, device=self.device)

    def step(
        self,
        state: WordleState,
        guess: torch.Tensor,  # [B,5] char indices
        valid: torch.Tensor,  # [B] bool — parseable 5-letter guess
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,  # [B, V_words] noise for the target draw
    ) -> Tuple[WordleState, torch.Tensor]:
        B = state.done.shape[0]
        guess = guess.long()
        knowledge = state.knowledge
        rows_b = torch.arange(B, device=knowledge.device)

        # vocab membership of each guess
        in_vocab = valid & (self.vocab_chars[None, :, :] == guess[:, None, :].to(torch.int8)).all(-1).any(-1)

        # sample feedback targets from the CURRENT consistent set
        pre_mask = consistent_mask(knowledge, self.vocab_chars, self.vocab_has)  # [B,V]
        logits = torch.where(pre_mask, 0.0, -torch.inf)
        target_idx = categorical(logits, generator, gumbel)
        target = self.vocab_chars[target_idx].long()  # [B,5]

        # batched sequential knowledge update
        target_has = F.one_hot(target, ALPHA).bool().any(dim=1)  # [B,26]
        green = guess == target
        inword = torch.gather(target_has, 1, guess)  # [B,5]
        new_knowledge = knowledge.clone()
        for i in range(N_CHARS):
            c = guess[:, i]
            row = new_knowledge[rows_b, c]  # [B,5]
            row_green = row.clone()
            row_green[:, i] = HERE
            row_yellow = row.clone()
            row_yellow[:, i] = NOT_HERE
            row_gray = torch.full_like(row, NOT_HERE)
            new_row = torch.where(
                green[:, i:i + 1], row_green, torch.where(inword[:, i:i + 1], row_yellow, row_gray)
            )
            new_knowledge[rows_b, c] = new_row

        # invalid guesses leave knowledge unchanged
        new_knowledge = torch.where(in_vocab[:, None, None], new_knowledge, knowledge)

        # observed feedback rendered from the post-update state
        rows = new_knowledge[rows_b[:, None], guess]  # [B,5,5]
        pos = torch.arange(N_CHARS, device=knowledge.device)
        cell = rows[:, pos, pos]  # [B,5]
        row_all_nothere = (rows == NOT_HERE).all(dim=-1)
        feedback = torch.where(
            cell == HERE,
            GREEN,
            torch.where(row_all_nothere, GRAY, torch.where(cell == NOT_HERE, YELLOW, GRAY)),
        ).to(torch.int8)
        feedback = torch.where(in_vocab[:, None], feedback, torch.tensor(GRAY, dtype=torch.int8, device=feedback.device))

        # history: every try consumes a slot; valid guesses stored
        slot = state.n_guesses.clamp(0, N_TRIES - 1).long()
        stored = torch.where(in_vocab[:, None], guess.to(torch.int8), torch.tensor(-1, dtype=torch.int8, device=guess.device))
        new_hist = state.guess_hist.clone()
        new_hist[rows_b, slot] = stored
        new_n = state.n_guesses + 1

        # win: the post-update filtered set is a singleton already guessed
        post_mask = consistent_mask(new_knowledge, self.vocab_chars, self.vocab_has)
        n_consistent = post_mask.sum(dim=-1)
        only_idx = post_mask.to(torch.int32).argmax(dim=-1)  # first consistent word
        only_word = self.vocab_chars[only_idx]  # [B,5]
        guessed = (new_hist == only_word[:, None, :]).all(dim=-1).any(dim=-1)
        win = (n_consistent == 1) & guessed

        reward = torch.where(in_vocab, win.float() - 1.0, torch.tensor(self.bad_word_reward, device=win.device))
        new_done = (new_n >= N_TRIES) | (reward == 0.0)

        frozen = state.done
        new_state = WordleState(
            knowledge=_where_state(frozen, knowledge, new_knowledge),
            guess_hist=_where_state(frozen, state.guess_hist, new_hist),
            n_guesses=torch.where(frozen, state.n_guesses, new_n),
            last_invalid=torch.where(frozen, False, ~in_vocab),
            done=torch.where(frozen, state.done, new_done),
            reward=torch.where(frozen, 0.0, reward),
        )
        return new_state, feedback

    def random_consistent_guess(
        self,
        state: WordleState,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,  # [B, V_words] noise
    ) -> torch.Tensor:
        """[B,5] guesses sampled uniformly from each env's consistent set."""
        mask = consistent_mask(state.knowledge, self.vocab_chars, self.vocab_has)
        logits = torch.where(mask, 0.0, -torch.inf)
        return self.vocab_chars[categorical(logits, generator, gumbel)]
