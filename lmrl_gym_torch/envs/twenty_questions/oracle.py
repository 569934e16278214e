"""Twenty-Questions oracles: the port of
`lmrl_gym_tpu/envs/twenty_questions/oracle.py`.

The reference runs a finetuned flan-t5-xl on-mesh as the answerer
(twenty_questions/env/oracle.py:20-147). With no pretrained weights
available offline, two oracle backends share the same interface:

- `LMOracle`: any decoder LM served by LMServer (trained in-repo), same
  prompt text and yes/no normalization as the reference;
- `ScriptedOracle`: a deterministic knowledge-base answerer over the 17
  object categories — used for tests, dataset generation, and CPU runs.
"""
from __future__ import annotations

import re
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Union

import torch

from lmrl_gym_torch.envs.twenty_questions.data import (
    DEFAULT_OBJECT_DICT,
    INVALID_QUESTION,
    WordVariants,
    simple_word_tokenize,
)

_ANSWER_RE = re.compile(r"(yes|no)")


def oracle_prompt(word: WordVariants, question: str) -> str:
    """Reference prompt verbatim (oracle.py:21-28)."""
    return (
        "Answer the question about the object truthfully.\n"
        f"object: {word}\n"
        f"question: {question}\n"
        "answer (yes or no): "
    )


class TwentyQuestionsOracle(ABC):
    @abstractmethod
    def generate_answers(
        self,
        words: Union[WordVariants, List[WordVariants]],
        questions: Union[str, List[str]],
        return_full: bool = False,
    ):
        ...


def _normalize(raw_answers: List[str], questions: List[str]):
    """yes/no regex normalization (oracle.py:63-84): prefix-match yes|no,
    default 'No.'; INVALID_QUESTION always answers 'No.'."""
    answers, full = [], []
    for question, out in zip(questions, raw_answers):
        if question == INVALID_QUESTION:
            answers.append("No.")
            full.append("No.")
            continue
        raw = out.strip().lower()
        m = _ANSWER_RE.match(raw)
        answers.append(m[0].capitalize() + "." if m else "No.")
        full.append(raw)
    return answers, full


class LMOracle(TwentyQuestionsOracle):
    """Answers from an LM served by `LMServer` or `Seq2SeqServer`, one
    generate per call. Its sampling is greedy (`envs/lm_oracle.py`), so the
    optional `generator` is drawn from only under a sampled config."""

    def __init__(self, server, params, sampling, max_input_length: int = 256,
                 generator: Optional[torch.Generator] = None):
        self.server = server
        self.params = params
        self.sampling = sampling
        self.max_input_length = max_input_length
        self.generator = generator

    def generate_answers(self, words, questions, return_full: bool = False):
        single = not isinstance(words, list)
        if single:
            words, questions = [words], [questions]
        prompts = [oracle_prompt(w, q) for w, q in zip(words, questions)]
        outs = self.server.generate_from_strs(
            self.params, prompts, self.max_input_length, self.sampling, self.generator
        )
        answers, full = _normalize(outs, questions)
        if single:
            answers, full = answers[0], full[0]
        return (answers, full) if return_full else answers


# ---- scripted knowledge base ----

_CATEGORY_SYNONYMS: Dict[str, List[str]] = {
    "Sports": ["sport", "sports", "ball", "game"],
    "Animals": ["animal", "animals", "creature", "pet", "mammal"],
    "Fruits": ["fruit", "fruits", "food"],
    "Vehicles": ["vehicle", "vehicles", "transportation", "transport"],
    "Clothes": ["clothing", "clothes", "garment", "apparel"],
    "Electronics": ["electronic", "electronics", "device", "appliance", "machine", "gadget"],
    "Musical Instruments": ["instrument", "instruments", "music", "musical"],
    "Furniture": ["furniture"],
    "Office Supplies": ["office", "stationery", "supply", "supplies"],
    "Vegetables": ["vegetable", "vegetables", "food", "plant"],
    "Art": ["art", "artwork"],
    "Kitchen Tools": ["kitchen", "utensil", "utensils", "cookware"],
    "Nature": ["nature", "natural"],
    "Toys": ["toy", "toys"],
    "Jewelry": ["jewelry", "jewellery", "accessory"],
    "Garden Supplies": ["garden", "gardening"],
    "Tools": ["tool", "tools"],
}

_ALIVE_CATEGORIES = {"Animals"}
_EDIBLE_CATEGORIES = {"Fruits", "Vegetables"}


def _category_of(word: WordVariants) -> str:
    for category, entries in DEFAULT_OBJECT_DICT.items():
        for entry in entries:
            if word.words[0] in entry.split(";"):
                return category
    return ""


class ScriptedOracle(TwentyQuestionsOracle):
    """Deterministic rule answerer: direct word-mention → Yes; category
    mention (e.g. 'Is it an animal?') → Yes iff the target's category;
    'alive/living' and 'eat/edible' handled; everything else → No."""

    def generate_answers(self, words, questions, return_full: bool = False):
        single = not isinstance(words, list)
        if single:
            words, questions = [words], [questions]
        raw = [self._answer(w, q) for w, q in zip(words, questions)]
        answers, full = _normalize(raw, questions)
        if single:
            answers, full = answers[0], full[0]
        return (answers, full) if return_full else answers

    def _answer(self, word: WordVariants, question: str) -> str:
        q_tokens = set(simple_word_tokenize(question))
        # direct mention of any variant word
        for variant in word.words:
            v_tokens = simple_word_tokenize(variant)
            if all(t in q_tokens for t in v_tokens):
                return "yes"
        category = _category_of(word)
        for syn in _CATEGORY_SYNONYMS.get(category, []):
            if syn in q_tokens:
                return "yes"
        if {"alive", "living", "live"} & q_tokens:
            return "yes" if category in _ALIVE_CATEGORIES else "no"
        if {"eat", "edible", "food"} & q_tokens:
            return "yes" if category in _EDIBLE_CATEGORIES else "no"
        return "no"
