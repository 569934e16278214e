"""Guess-My-City: city list, trajectory construction, guess detection.
The port's copy of `lmrl_gym_tpu/envs/guess_city/data.py`.

Parity with llm_rl_scripts/guess_city/env/data.py: same question/answer
conversation shape as Twenty Questions (reward −1 per question, 0 on the
winning question, done on guess or at 20 questions). Targets are
'City,Country' strings. The city list is embedded data (the reference
reads an un-vendored worldcities dump, data.py:49-64).

DEVIATION (documented): the reference's is_done (data.py:330-354)
zips the raw target *string* (i.e. its characters) against tagged
question tokens — broken code that can essentially never fire. Here
is_done compares the question's trailing tokens against the city name's
tokens, which is the evident intent.
"""
from __future__ import annotations

from typing import List

from lmrl_gym_torch.envs.twenty_questions.data import simple_word_tokenize
from lmrl_gym_torch.text.frames import Text, TextHistory, TextTrajectory

INVALID_QUESTION = "Is this a valid question?\n"
INITIAL_STR = "Questions:\n"

# major world cities: 'City,Country'
DEFAULT_CITIES: List[str] = [
    "Tokyo,Japan", "Delhi,India", "Shanghai,China", "Sao Paulo,Brazil",
    "Mexico City,Mexico", "Cairo,Egypt", "Bombay,India", "Beijing,China",
    "Dhaka,Bangladesh", "Osaka,Japan", "New York,United States",
    "Karachi,Pakistan", "Buenos Aires,Argentina", "Istanbul,Turkey",
    "Lagos,Nigeria", "Manila,Philippines", "Rio de Janeiro,Brazil",
    "Guangzhou,China", "Lahore,Pakistan", "Shenzhen,China",
    "Bangalore,India", "Moscow,Russia", "Jakarta,Indonesia",
    "Paris,France", "London,United Kingdom", "Lima,Peru", "Bangkok,Thailand",
    "Seoul,South Korea", "Bogota,Colombia", "Nagoya,Japan",
    "Johannesburg,South Africa", "Chennai,India", "Tehran,Iran",
    "Ho Chi Minh City,Vietnam", "Hong Kong,China", "Chicago,United States",
    "Hyderabad,India", "Wuhan,China", "Hangzhou,China", "Madrid,Spain",
    "Riyadh,Saudi Arabia", "Santiago,Chile", "Baghdad,Iraq", "Toronto,Canada",
    "Singapore,Singapore", "Calcutta,India", "Saint Petersburg,Russia",
    "Sydney,Australia", "Melbourne,Australia", "Los Angeles,United States",
    "Alexandria,Egypt", "Yangon,Myanmar", "Ankara,Turkey",
    "Abidjan,Ivory Coast", "Kiev,Ukraine", "Berlin,Germany",
    "Casablanca,Morocco", "Nairobi,Kenya", "Cape Town,South Africa",
    "Rome,Italy", "Montreal,Canada", "Accra,Ghana", "Houston,United States",
    "Addis Ababa,Ethiopia", "Kuala Lumpur,Malaysia", "Hanoi,Vietnam",
    "Athens,Greece", "Lisbon,Portugal", "Barcelona,Spain", "Dubai,United Arab Emirates",
    "Vienna,Austria", "Amsterdam,Netherlands", "Brussels,Belgium",
    "Stockholm,Sweden", "Munich,Germany", "Prague,Czech Republic",
    "Warsaw,Poland", "Budapest,Hungary", "Copenhagen,Denmark",
    "Helsinki,Finland", "Oslo,Norway", "Dublin,Ireland", "Zurich,Switzerland",
    "Auckland,New Zealand", "Caracas,Venezuela", "Havana,Cuba",
    "Kingston,Jamaica", "Edinburgh,United Kingdom", "Venice,Italy",
    "Florence,Italy", "Naples,Italy", "Marseille,France", "Lyon,France",
    "Seville,Spain", "Porto,Portugal", "Krakow,Poland", "Dallas,United States",
    "San Francisco,United States", "Seattle,United States", "Boston,United States",
    "Miami,United States", "Atlanta,United States", "Denver,United States",
    "Vancouver,Canada", "Perth,Australia", "Brisbane,Australia",
]


def get_default_word_list() -> List[str]:
    return list(DEFAULT_CITIES)


def city_name(word: str) -> str:
    return word.split(",")[0]


def is_done(word: str, question: str) -> bool:
    """Question ends with the city name's tokens."""
    while len(question) > 0 and not question[-1].isalpha():
        question = question[:-1]
    if len(question) == 0:
        return False
    q_tokens = simple_word_tokenize(question.lower())
    name_tokens = simple_word_tokenize(city_name(word).lower())
    if len(name_tokens) > len(q_tokens):
        return False
    return q_tokens[-len(name_tokens):] == name_tokens


def create_trajectory_from_history(
    word: str,
    text_history: TextHistory,
    max_conversation_len: int = 20,
) -> TextTrajectory:
    """Same scoring shape as 20Q (guess_city/env/data.py:66-99)."""
    assert len(text_history) % 2 == 1
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
        word_guessed = last_answer == "Yes." and is_done(word, last_question)
        done = word_guessed or conversation_len == max_conversation_len
        if word_guessed:
            reward[-2] = 0.0
    return TextTrajectory(tuple(text_history), tuple(reward), done)


def asker_postproc(question: str) -> str:
    """Question validation (guess_city/env/data.py:275-294). Unlike 20Q
    there is no question-word whitelist: city questions are open-ended."""
    question = question.strip()
    if len(question) == 0:
        return INVALID_QUESTION
    if question[-1] != "?":
        question += "?"
    question = question[0].upper() + question[1:]
    if len(question.split(" ")) > 40:
        return INVALID_QUESTION
    if question[-2] == "." and question.split(" ")[-1] != "etc.?":
        return INVALID_QUESTION
    return question + "\n"
