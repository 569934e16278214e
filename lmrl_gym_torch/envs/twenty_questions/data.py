"""Twenty Questions: word list, trajectory construction, question rules.
The port's copy of `lmrl_gym_tpu/envs/twenty_questions/data.py`.

Parity with llm_rl_scripts/twenty_questions/env/data.py: 158 objects in 17
categories (word variants ';'-separated), reward −1 per question and 0 on
the winning question, done on guess or at 20 questions, question
validation (must start Is/Does/Can/Do/Are/Could, ≤40 words), and guess
detection `is_done` = the question ends with the target word and contains
no other content nouns.

DEVIATION (documented): the reference tags nouns with nltk's perceptron
tagger (data.py:83-116); its model files are unavailable offline, so
`simple_pos_tag` approximates it with a closed-class function-word list —
unknown words default to NN, which preserves both directions of the
gameplay contract (extra unknown nouns block the guess; the target's own
words are always allowed).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Tuple

from lmrl_gym_torch.text.frames import Text, TextHistory, TextTrajectory

INVALID_QUESTION = "Is this a valid question?\n"
INITIAL_STR = "Questions:\n"

DEFAULT_OBJECT_DICT: Dict[str, List[str]] = {
    "Sports": ["Basketball", "Football", "Baseball", "Soccer ball", "Golf ball", "Tennis ball", "Volleyball", "Tennis racket", "Baseball bat", "Helmet"],
    "Animals": ["Cat", "Dog", "Horse", "Cow", "Sheep", "Rabbit", "Lion", "Tiger", "Bear", "Elephant"],
    "Fruits": ["Apple", "Banana", "Orange", "Strawberry", "Grape", "Watermelon", "Pineapple", "Mango", "Cantaloupe", "Peach"],
    "Vehicles": ["Car", "Truck", "Motorcycle", "Boat", "Airplane;Plane", "Train", "Bus", "Helicopter", "Scooter", "Ship"],
    "Clothes": ["Shirt", "Pants;Pant;Pair of pants", "Jacket", "Dress", "Skirt", "Belt", "Shoes;Shoe;Pair of shoes", "Boots;Boot;Pair of boots", "Socks;Sock;Pair of socks", "Hat", "Scarf"],
    "Electronics": ["Computer", "Smartphone", "Television;TV", "Headphone;Headphones;Pair of headphones", "Monitor;Computer monitor", "Camera", "Microwave;Microwave oven", "Refrigerator", "Blender", "Computer keyboard;Keyboard"],
    "Musical Instruments": ["Piano", "Guitar", "Drum;Drums", "Violin", "Saxophone", "Flute", "Trumpet", "Clarinet", "Harp", "Trombone"],
    "Furniture": ["Chair", "Table", "Bed", "Desk", "Couch", "Dresser", "Bookcase", "Nightstand", "Mattress", "Pillow"],
    "Office Supplies": ["Pen", "Paper;Piece of paper", "Stapler", "Printer", "Calculator", "Battery;Battery pack;Pack of batteries", "Toothbrush", "Toothpaste", "Pencil", "Sharpie", "Scissors;Pair of scissors", "Key", "Diary", "Calendar"],
    "Vegetables": ["Carrot", "Potato", "Broccoli", "Tomato", "Onion", "Spinach", "Corn", "Peas;Pea", "Celery", "Cucumber"],
    "Art": ["Painting;Canvas painting;Oil painting;Watercolor painting", "Paintbrush", "Canvas;Painting canvas", "Eraser;Pencil eraser", "Marker", "Glue;Glue stick;Bottle of glue", "Sculpture"],
    "Kitchen Tools": ["Knife", "Spoon", "Fork", "Plate", "Bowl", "Cooking pot;Pot", "Pan;Saucepan;Frying pan", "Cup", "Chopstick;Chopsticks;Pair of chopsticks", "Whisk"],
    "Nature": ["Rock", "Tree", "Bush", "Mountain", "Forest", "Ocean", "Sea", "Lake", "River", "Meteorite", "Cactus"],
    "Toys": ["Lego;Lego set", "Doll;Toy doll;Plush doll", "Kite", "Puzzle;Jigsaw puzzle", "Stuffed animal"],
    "Jewelry": ["Earring;Earrings;Pair of earrings", "Necklace", "Bracelet", "Ring", "Brooch", "Hairclip", "Pendant", "Watch", "Locket"],
    "Garden Supplies": ["Gloves;Glove;Pair of gloves", "Shovel", "Rake", "Watering can", "Lawn mower"],
    "Tools": ["Hammer", "Screwdriver", "Wrench", "Saw", "Pliers;plier;Pair of pliers", "Drill"],
}

# ---- lightweight tokenizer/tagger (nltk replacement) ----

_WORD_RE = re.compile(r"[a-z]+|[0-9]+|[^\sa-z0-9]")

# closed-class / non-noun vocabulary for question-style English
_FUNCTION_WORDS = {
    # determiners / pronouns
    "a", "an", "the", "it", "this", "that", "these", "those", "its", "my",
    "your", "their", "his", "her", "one", "any", "some", "all", "every",
    "each", "something", "anything", "there", "you", "we", "they", "i",
    # auxiliaries / verbs common in questions
    "is", "are", "was", "were", "be", "been", "being", "does", "do", "did",
    "can", "could", "would", "should", "will", "shall", "has", "have",
    "had", "made", "make", "makes", "used", "use", "uses", "using", "find",
    "found", "eat", "eaten", "eats", "wear", "worn", "wears", "play",
    "played", "plays", "live", "lives", "living", "grow", "grows", "grown",
    "fly", "flies", "swim", "swims", "run", "runs", "move", "moves",
    "keep", "kept", "hold", "holds", "carry", "carries", "need", "needs",
    "require", "requires", "come", "comes", "belong", "belongs", "seen",
    "see", "considered", "consider", "get", "gets", "put", "turn",
    # prepositions / conjunctions / adverbs
    "in", "on", "at", "of", "for", "to", "from", "with", "without", "by",
    "as", "or", "and", "not", "than", "then", "so", "if", "when", "where",
    "what", "which", "who", "how", "why", "usually", "typically",
    "commonly", "often", "mostly", "mainly", "generally", "very", "more",
    "most", "less", "least", "also", "too", "only", "outside", "inside",
    "indoors", "outdoors", "up", "down", "out", "into", "onto", "over",
    "under", "around", "etc",
    # common 20Q adjectives
    "big", "small", "large", "tiny", "huge", "long", "short", "tall",
    "round", "square", "flat", "soft", "hard", "heavy", "light", "alive",
    "dead", "living", "electronic", "electric", "electrical", "mechanical",
    "wooden", "metal", "metallic", "plastic", "glass", "red", "blue",
    "green", "yellow", "orange", "black", "white", "brown", "sharp",
    "edible", "dangerous", "expensive", "cheap", "common", "rare", "wild",
    "domestic", "useful", "portable", "musical", "hot", "cold", "wet",
    "dry", "fast", "slow", "new", "old", "man", "natural", "bigger",
    "smaller", "larger",
}


def simple_word_tokenize(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


def simple_pos_tag(text: str) -> List[Tuple[str, str]]:
    """(word, tag) pairs; tag ∈ {'NN', 'X'} — only nounhood matters for
    is_done. Unknown alphabetic words default to NN."""
    out = []
    for w in simple_word_tokenize(text):
        if not w.isalpha():
            out.append((w, "X"))
        elif w in _FUNCTION_WORDS:
            out.append((w, "X"))
        else:
            out.append((w, "NN"))
    return out


@dataclass
class WordVariants:
    """An object with alternative names (data.py:20-49)."""

    words: List[str]
    pos_tags: List[List[Tuple[str, str]]]

    @classmethod
    def from_list(cls, words_list: List[str]) -> "WordVariants":
        return cls(
            words=words_list,
            pos_tags=[simple_pos_tag(w.lower()) for w in words_list],
        )

    @classmethod
    def from_str(cls, words_str: str) -> "WordVariants":
        return cls.from_list(words_str.split(";"))

    def __len__(self):
        return len(self.words)

    def __getitem__(self, idx):
        return self.words[idx]

    def json(self):
        return self.words.copy()

    def __str__(self):
        return f"({', '.join(self.words)})"


def get_default_word_list() -> List[WordVariants]:
    out = []
    for words in DEFAULT_OBJECT_DICT.values():
        out.extend(WordVariants.from_str(w) for w in words)
    return out


def is_done(word_var: WordVariants, question: str) -> bool:
    """Guess detection (data.py:351-391): the question must end with one
    of the target's variants and contain no other content nouns (modulo
    the ignore list and counter-words before 'of')."""
    while len(question) > 0 and not question[-1].isalpha():
        question = question[:-1]
    if len(question) == 0:
        return False

    question_pos = simple_pos_tag(question.lower())

    ignores = {"object", "something", "type", "kind"}
    for pos_list in word_var.pos_tags:
        for w, _ in pos_list:
            ignores.add(w)

    for q_i, (q_word, q_tag) in enumerate(question_pos):
        if q_tag[:2] == "NN" and q_word not in ignores:
            # counter word before 'of' (e.g. "pair of …") is allowed
            if q_i + 1 < len(question_pos) and question_pos[q_i + 1][0] == "of":
                continue
            return False

    for word_pos in word_var.pos_tags:
        if len(word_pos) > len(question_pos):
            continue
        tail = question_pos[-len(word_pos):]
        if all(vw == qw for (vw, _), (qw, _) in zip(word_pos, tail)):
            return True
    return False


def create_trajectory_from_history(
    word_var: WordVariants,
    text_history: TextHistory,
    max_conversation_len: int = 20,
) -> TextTrajectory:
    """(data.py:83-116): reward −1 per question; on a winning question the
    last question's reward becomes 0; done on win or at the limit."""
    assert len(text_history) % 2 == 1, (
        "history must be [initial, q1, a1, ..., qN, aN]"
    )
    assert all(q.is_action for q in text_history[1::2])
    assert all(not a.is_action for a in text_history[0::2])
    conversation_len = (len(text_history) - 1) // 2
    assert conversation_len <= max_conversation_len

    reward = [-1.0 if t.is_action else 0.0 for t in text_history]

    if len(text_history) < 2:
        done = False
    else:
        last_question = text_history[-2].text.strip()
        last_answer = text_history[-1].text.strip()
        word_guessed = last_answer == "Yes." and is_done(word_var, last_question)
        done = word_guessed or conversation_len == max_conversation_len
        if word_guessed:
            reward[-2] = 0.0

    return TextTrajectory(tuple(text_history), tuple(reward), done)


def asker_postproc(question: str) -> str:
    """Question validation (data.py:292-315): must start with
    Is/Does/Can/Do/Are/Could, ≤40 words, end with '?'."""
    question = question.strip()
    if len(question) == 0:
        return INVALID_QUESTION
    if question[-1] != "?":
        question += "?"
    question = question[0].upper() + question[1:]
    if len(question.split(" ")) > 40:
        return INVALID_QUESTION
    if question.split(" ")[0] not in ["Is", "Does", "Can", "Do", "Are", "Could"]:
        return INVALID_QUESTION
    if question[-2] == "." and question.split(" ")[-1] != "etc.?":
        return INVALID_QUESTION
    return question + "\n"


def asker_postproc_simple(question: str) -> str:
    question = question.strip()
    if len(question) == 0:
        return "?\n"
    if question[-1] != "?":
        question += "?"
    return question + "\n"


def asker_postproc_filter_repeats(question: str) -> str:
    question = question.strip()
    if len(question) == 0:
        return "?\n"
    words = question.split(" ")
    if len(words) > 50:
        question = " ".join(words[:50])
    if question[-1] != "?":
        question += "?"
    return question + "\n"


def rtg_to_token_str(rtg: float, max_conversation_len: int = 20) -> str:
    """Decision-transformer RTG token '<|rtg=-N|>' (data.py:246-289)."""
    rtg_int = int(round(rtg))
    rtg_int = max(-max_conversation_len, min(0, rtg_int))
    return f"<|rtg={rtg_int}|>"


def token_str_to_rtg(s: str) -> float:
    m = re.match(r"<\|rtg=(-?\d+)\|>", s)
    assert m is not None, f"not an rtg token: {s}"
    return float(m.group(1))
