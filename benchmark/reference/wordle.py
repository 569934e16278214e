"""Plain value-guided Wordle: the game's rules replayed from the same draws,
and the guided logits π_β + β·min(Q1, Q2) recomputed from the weights by a
full forward over each served episode.

The episode's byte stream is fixed-width: an 8-token header, then per turn
five letters with separators ("c o p s e\\n", the model's action) and five
feedback letters ("b y g b b\\n", the game's answer). Each turn the game
scores the guess against a word drawn uniformly from the words still
consistent with everything revealed (the draw given as Gumbel noise over
the word list: the consistent word with the largest noise), so the answers
can be replayed exactly. A decode constrained to the word list may put at
letter j only a letter that some word matching the guess so far has there.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from benchmark.reference.gpt import Quant, lm_logits, mlp_head, strict_f32, trunk_hidden

HEADER = 8
TURN = 20
N_TRIES, N_CHARS = 6, 5
A, SP, NL = 97, 32, 10
FEEDBACK = {0: 98, 1: 121, 2: 103}  # gray 'b', yellow 'y', green 'g'
NOT_HERE, POSSIBLE, HERE = 0, 1, 2


def letter_positions() -> List[int]:
    """Stream index of every letter the model chooses."""
    return [HEADER + t * TURN + 2 * j for t in range(N_TRIES) for j in range(N_CHARS)]


def read_words(path: str) -> List[str]:
    with open(path) as f:
        return [w.strip() for w in f if len(w.strip()) == N_CHARS]


def _consistent(know: List[List[int]], word: str) -> bool:
    """A word satisfies the knowledge: for every letter, an all-POSSIBLE row
    says nothing, an all-NOT_HERE row forbids the letter, and otherwise
    every HERE cell matches, no NOT_HERE cell matches and the word holds
    the letter."""
    for c in range(26):
        row = know[c]
        if all(s == POSSIBLE for s in row):
            continue
        ch = chr(A + c)
        if all(s == NOT_HERE for s in row):
            if ch in word:
                return False
            continue
        if ch not in word:
            return False
        for p in range(N_CHARS):
            if row[p] == HERE and word[p] != ch or row[p] == NOT_HERE and word[p] == ch:
                return False
    return True


def _score(know: List[List[int]], guess: str, target: str) -> List[List[int]]:
    """Knowledge after `guess` against `target`, position by position: a
    green marks the cell HERE, a letter elsewhere in the target marks it
    NOT_HERE, an absent letter marks its whole row NOT_HERE."""
    know = [row[:] for row in know]
    for i, ch in enumerate(guess):
        c = ord(ch) - A
        if target[i] == ch:
            know[c][i] = HERE
        elif ch in target:
            know[c][i] = NOT_HERE
        else:
            know[c] = [NOT_HERE] * N_CHARS
    return know


def _render(know: List[List[int]], guess: str) -> List[int]:
    """The feedback shown, read from the new knowledge: green where the
    cell is HERE, gray where the letter's row is all NOT_HERE, yellow where
    the cell is NOT_HERE, else gray."""
    out = []
    for i, ch in enumerate(guess):
        row = know[ord(ch) - A]
        if row[i] == HERE:
            out.append(2)
        elif all(s == NOT_HERE for s in row):
            out.append(0)
        else:
            out.append(1 if row[i] == NOT_HERE else 0)
    return out


def replay_answers(tokens: Sequence[int], env_noise: torch.Tensor, words: List[str]) -> int:
    """Replays one game from its served letters and the game's draws
    (`env_noise` [N_TRIES, n_words]) and returns how many feedback tokens
    differ from the stream's. A finished game keeps its knowledge, and its
    later turns still show the feedback of a fresh draw."""
    know = [[POSSIBLE] * N_CHARS for _ in range(26)]
    hist: List[str] = []
    n_guesses, done, wrong = 0, False, 0
    for t in range(N_TRIES):
        off = HEADER + t * TURN
        act = tokens[off:off + 2 * N_CHARS]
        letters = act[0::2]
        valid = all(A <= x < A + 26 for x in letters) and all(x == SP for x in act[1:-1:2]) and act[-1] == NL
        guess = "".join(chr(x) for x in letters) if valid else None
        in_vocab = valid and guess in words
        ok = [i for i, w in enumerate(words) if _consistent(know, w)]
        target = words[max(ok, key=lambda i: float(env_noise[t, i]))]
        new_know = _score(know, guess, target) if in_vocab else know
        fb = _render(new_know, guess) if in_vocab else [0] * N_CHARS
        expect = []
        for code in fb:
            expect += [FEEDBACK[code], SP]
        expect[-1] = NL
        wrong += sum(int(a != b) for a, b in zip(expect, tokens[off + 2 * N_CHARS: off + TURN]))
        if done:
            continue
        hist.append(guess if in_vocab else None)
        n_guesses += 1
        post = [w for w in words if _consistent(new_know, w)]
        win = len(post) == 1 and post[0] in hist
        reward = (float(win) - 1.0) if in_vocab else -1.0
        know = new_know
        done = n_guesses >= N_TRIES or reward == 0.0
    return wrong


def allowed_letters(prefix: str, j: int, words: List[str]) -> List[int]:
    """Letters (as byte ids) some word starting with `prefix` has at j."""
    return sorted({ord(w[j]) for w in words if w.startswith(prefix)})


def guided_logits(params: Dict[str, Dict[str, torch.Tensor]], cfg: dict, tokens: torch.Tensor, beta: float,
                  quant: Quant = None) -> torch.Tensor:
    """[G, T, V] float32 guided logits π_β + β·min(Q1, Q2) at every
    position of `tokens` [G, T]: the policy trunk's logits and the value
    trunk's hidden states through both Q heads; ids past the true vocab
    set to float32's lowest."""
    strict_f32()
    pi = lm_logits(params["pi_beta"], cfg, trunk_hidden(params["pi_beta"], cfg, tokens, quant))
    h = trunk_hidden(params["base"], cfg, tokens, quant)
    q = torch.minimum(mlp_head(params["q1"], h), mlp_head(params["q2"], h))
    logits = pi + beta * q
    logits[..., cfg["vocab_size"]:] = torch.finfo(torch.float32).min
    return logits


def served_gaps(logits: torch.Tensor, tokens: Sequence[int], words: List[str], constrain: bool,
                chosen: torch.Tensor = None) -> List[float]:
    """For every letter the model chose in one game: how far below the
    reference's best allowed logit the served letter's logit lies (0 when
    the served letter is the reference's own greedy choice). With `chosen`
    [T, V]-shaped logits of another computation, the gap of the letter
    that one would have put first, on the same stream."""
    gaps = []
    for pos in letter_positions():
        t, j = divmod(pos - HEADER, TURN)
        j //= 2
        prefix = "".join(chr(tokens[HEADER + t * TURN + 2 * i]) for i in range(j))
        ref = logits[pos - 1]
        allowed = allowed_letters(prefix, j, words) if constrain else list(range(ref.shape[0]))
        if not allowed:
            gaps.append(float("inf"))
            continue
        idx = torch.tensor(allowed, device=ref.device)
        best = float(ref[idx].max())
        if chosen is None:
            served = tokens[pos]
        else:
            served = allowed[int(torch.argmax(chosen[pos - 1][idx]))]
        gaps.append(best - float(ref[served]) if served in allowed else float("inf"))
    return gaps
