"""Guess-My-City environment + oracles (reference guess_city/env/): the
port of `lmrl_gym_tpu/envs/guess_city/env.py`.

Single-env only, like the reference (env.py:9-58). Oracle answers are
normalized exactly as the reference T5 oracle (oracle.py:44-68):
prefix-match yes|no → 'Yes.'/'No.', else 'No.'.
"""
from __future__ import annotations

import random
import re
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple

import torch

from lmrl_gym_torch.envs.base import TextEnv
from lmrl_gym_torch.envs.guess_city.data import (
    INITIAL_STR,
    INVALID_QUESTION,
    create_trajectory_from_history,
)
from lmrl_gym_torch.envs.twenty_questions.data import simple_word_tokenize
from lmrl_gym_torch.text.frames import Text, TextHistory

_ANSWER_RE = re.compile(r"(yes|no)")


def oracle_prompt(word: str, question: str) -> str:
    """Reference prompt verbatim (guess_city/env/oracle.py:20-27)."""
    return (
        "Answer the question about the city truthfully.\n"
        f"    object: {word}\n"
        f"    question: {question}\n"
        "    answer: "
    )


class GuessCityOracle(ABC):
    @abstractmethod
    def generate_answer(self, word: str, question: str, return_full: bool = False):
        ...


def _normalize(raw: str, question: str):
    if question == INVALID_QUESTION:
        return "No.", "No."
    raw = raw.strip().lower()
    m = _ANSWER_RE.match(raw)
    return (m[0].capitalize() + "." if m else "No."), raw


class LMGuessCityOracle(GuessCityOracle):
    """Answers from a served LM; greedy sampling, so the optional
    `generator` is drawn from only under a sampled config."""

    def __init__(self, server, params, sampling, max_input_length: int = 256,
                 generator: Optional[torch.Generator] = None):
        self.server = server
        self.params = params
        self.sampling = sampling
        self.max_input_length = max_input_length
        self.generator = generator

    def generate_answer(self, word: str, question: str, return_full: bool = False):
        outs = self.server.generate_from_strs(
            self.params,
            [oracle_prompt(word, question)],
            self.max_input_length,
            self.sampling,
            self.generator,
        )
        answer, full = _normalize(outs[0], question)
        return (answer, full) if return_full else answer


# small fact table for the scripted oracle
_EUROPE = {"France", "United Kingdom", "Spain", "Italy", "Germany", "Russia",
           "Ukraine", "Greece", "Portugal", "Austria", "Netherlands",
           "Belgium", "Sweden", "Czech Republic", "Poland", "Hungary",
           "Denmark", "Finland", "Norway", "Ireland", "Switzerland", "Turkey"}
_ASIA = {"Japan", "India", "China", "Bangladesh", "Pakistan", "Turkey",
         "Philippines", "Indonesia", "Thailand", "South Korea", "Vietnam",
         "Iran", "Iraq", "Saudi Arabia", "Singapore", "Malaysia", "Myanmar",
         "United Arab Emirates"}
_AMERICAS = {"Brazil", "Mexico", "United States", "Argentina", "Peru",
             "Colombia", "Chile", "Canada", "Venezuela", "Cuba", "Jamaica"}
_AFRICA = {"Egypt", "Nigeria", "South Africa", "Ivory Coast", "Kenya",
           "Morocco", "Ghana", "Ethiopia"}
_OCEANIA = {"Australia", "New Zealand"}

_CAPITALS = {"Tokyo", "Delhi", "Cairo", "Beijing", "Dhaka", "Buenos Aires",
             "Manila", "Moscow", "Jakarta", "Paris", "London", "Lima",
             "Bangkok", "Seoul", "Bogota", "Tehran", "Madrid", "Riyadh",
             "Santiago", "Baghdad", "Singapore", "Ankara", "Kiev", "Berlin",
             "Nairobi", "Rome", "Accra", "Addis Ababa", "Kuala Lumpur",
             "Hanoi", "Athens", "Lisbon", "Vienna", "Amsterdam", "Brussels",
             "Stockholm", "Prague", "Warsaw", "Budapest", "Copenhagen",
             "Helsinki", "Oslo", "Dublin", "Caracas", "Havana", "Kingston",
             "Edinburgh", "Cape Town"}


class ScriptedGuessCityOracle(GuessCityOracle):
    """Deterministic fact answerer for tests/data-gen: city/country
    mention, continent, capital-city."""

    def generate_answer(self, word: str, question: str, return_full: bool = False):
        q = set(simple_word_tokenize(question))
        name, country = word.split(",")[0], word.split(",")[-1]
        raw = "no"
        name_tokens = simple_word_tokenize(name.lower())
        country_tokens = simple_word_tokenize(country.lower())
        if all(t in q for t in name_tokens) or all(t in q for t in country_tokens):
            raw = "yes"
        elif "europe" in q or "european" in q:
            raw = "yes" if country in _EUROPE else "no"
        elif "asia" in q or "asian" in q:
            raw = "yes" if country in _ASIA else "no"
        elif "america" in q or "americas" in q:
            raw = "yes" if country in _AMERICAS else "no"
        elif "africa" in q or "african" in q:
            raw = "yes" if country in _AFRICA else "no"
        elif "oceania" in q:
            raw = "yes" if country in _OCEANIA else "no"
        elif "capital" in q:
            raw = "yes" if name in _CAPITALS else "no"
        answer, full = _normalize(raw, question)
        return (answer, full) if return_full else answer


class GuessCityEnv(TextEnv):
    def __init__(
        self,
        oracle: GuessCityOracle,
        word_list: List[str],
        max_conversation_length: int = 20,
    ):
        self.oracle = oracle
        self.word_list = word_list
        self.max_conversation_length = max_conversation_length
        self.random = random.Random(None)
        self.curr_word: Optional[str] = None

    def step(self, text_history: TextHistory) -> Tuple[TextHistory, float, bool]:
        assert text_history[-1].is_action
        assert self.curr_word is not None, "call reset() first"
        question = text_history[-1].text.strip()
        answer = self.oracle.generate_answer(self.curr_word, question)
        trajectory = create_trajectory_from_history(
            self.curr_word,
            text_history + (Text(answer + "\n", False),),
            self.max_conversation_length,
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

    def copy(self) -> "GuessCityEnv":
        return GuessCityEnv(self.oracle, self.word_list, self.max_conversation_length)
