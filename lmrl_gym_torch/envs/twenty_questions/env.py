"""Twenty Questions environments (reference twenty_questions/env/env.py):
the port of `lmrl_gym_tpu/envs/twenty_questions/env.py`.

The agent asks questions (actions); the env answers via an oracle. The
batched variant pads the oracle query batch with INVALID_QUESTION slots
(env.py:66-141).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from lmrl_gym_torch.envs.base import BatchedTextEnv, TextEnv
from lmrl_gym_torch.envs.twenty_questions.data import (
    INITIAL_STR,
    INVALID_QUESTION,
    WordVariants,
    create_trajectory_from_history,
)
from lmrl_gym_torch.envs.twenty_questions.oracle import TwentyQuestionsOracle
from lmrl_gym_torch.text.frames import Text, TextHistory


class TwentyQuestionsEnv(TextEnv):
    def __init__(
        self,
        oracle: TwentyQuestionsOracle,
        word_list: List[WordVariants],
        max_conversation_length: int = 20,
    ):
        self.oracle = oracle
        self.word_list = word_list
        self.max_conversation_length = max_conversation_length
        self.random = random.Random(None)
        self.curr_word: Optional[WordVariants] = None

    def step(self, text_history: TextHistory) -> Tuple[TextHistory, float, bool]:
        assert text_history[-1].is_action
        assert self.curr_word is not None, "call reset() first"
        question = text_history[-1].text.strip()
        answer = self.oracle.generate_answers(self.curr_word, question)
        answer_text = Text(answer + "\n", False)
        trajectory = create_trajectory_from_history(
            self.curr_word, text_history + (answer_text,), self.max_conversation_length
        )
        return trajectory.text_history, trajectory.reward[-2], trajectory.done

    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None) -> TextHistory:
        if seed is not None:
            self.random = random.Random(seed)
        options = options or {}
        if options.get("deterministic", False):
            assert seed is not None
            self.curr_word = self.word_list[seed % len(self.word_list)]
        else:
            self.curr_word = self.random.choice(self.word_list)
        return (Text(INITIAL_STR, False),)

    def copy(self) -> "TwentyQuestionsEnv":
        return TwentyQuestionsEnv(
            self.oracle, self.word_list, self.max_conversation_length
        )


class BatchedTwentyQuestionsEnv(BatchedTextEnv):
    """Batches oracle queries; padded/done slots query INVALID_QUESTION
    (env.py:66-141)."""

    def __init__(
        self,
        oracle: TwentyQuestionsOracle,
        word_list: List[WordVariants],
        max_conversation_length: int = 20,
        bsize: Optional[int] = None,
    ):
        self.oracle = oracle
        self.word_list = word_list
        self.max_conversation_length = max_conversation_length
        self.bsize = bsize
        self.curr_words: Optional[List[WordVariants]] = None

    def step(self, text_history, done=None):
        assert self.curr_words is not None, "call reset() first"
        if self.bsize is None:
            self.bsize = len(text_history)
        questions = [
            h[-1].text.strip() if h is not None else INVALID_QUESTION
            for h in text_history
        ]
        answers = self.oracle.generate_answers(
            self.curr_words[: len(questions)], questions
        )
        results = []
        for answer, word, history in zip(answers, self.curr_words, text_history):
            if history is None:
                results.append(None)
                continue
            answer_text = Text(answer + "\n", False)
            trajectory = create_trajectory_from_history(
                word, history + (answer_text,), self.max_conversation_length
            )
            results.append(
                (trajectory.text_history, trajectory.reward[-2], trajectory.done)
            )
        return results

    def reset(self, seed=None, options=None):
        if seed is None:
            assert self.bsize is not None
            seed = [None] * self.bsize
        self.bsize = len(seed)
        if options is None:
            options = [{} for _ in seed]
        self.curr_words = []
        out = []
        for s, o in zip(seed, options):
            rng = random.Random(s)
            o = o or {}
            if o.get("deterministic", False):
                assert s is not None
                self.curr_words.append(self.word_list[s % len(self.word_list)])
            else:
                self.curr_words.append(rng.choice(self.word_list))
            out.append((Text(INITIAL_STR, False),))
        return out

    def copy(self) -> "BatchedTwentyQuestionsEnv":
        return BatchedTwentyQuestionsEnv(
            self.oracle, self.word_list, self.max_conversation_length, self.bsize
        )
