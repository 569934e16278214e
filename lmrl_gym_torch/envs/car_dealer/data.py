"""Car-Dealer: personas, rewards, conversation ↔ trajectory builders.
The port's copy of `lmrl_gym_tpu/envs/car_dealer/data.py`.

Parity with llm_rl_scripts/car_dealer/env/data.py: buyer personas sampled
as personality × brand × type × 1-4 features × budget; episodes end when
the buyer emits 'Output: Decision=(Accept|Reject) MSRP=$… (Buy Price=$…)'
(regex extraction); rewards 'fancy' = buy_price/((budget+msrp)/2) on sale
else −(budget−msrp)/msrp, 'revenue' = buy_price/1000.
"""
from __future__ import annotations

import enum
import re
from dataclasses import replace as dc_replace
from typing import Dict, List, Optional, Tuple, Union

from lmrl_gym_torch.text.frames import Text, TextHistory, TextTrajectory

INITIAL_STR = "Start\n"
DEFAULT_BUDGETS = [10000, 30000, 50000, 70000, 90000]
DEFAULT_PERSONALITIES = [
    "abusive", "angry", "insulting", "polite", "respectful", "rude",
    "sarcastic", "talkative", "toxic", "uncommunicative",
]
DEFAULT_BRANDS = [
    "a Volkswagen", "a Lexus", "a Ford", "a Mazda", "a Hyundai", "a Toyota",
    "a Mercedes-Benz", "a BMW", "an Audi", "a Subaru", "a Honda",
    "a Porsche", "a Tesla",
]
DEFAULT_TYPES = ["luxury", "sedan", "convertible", "truck", "electric", "SUV"]
DEFAULT_FEATURES = [
    "backup camera", "navigation system", "heated seats", "leather seats",
    "third-row seating", "blind spot monitoring", "sunroof", "Apple CarPlay",
]

BuyerInfo = Dict[str, Union[str, List[str], int]]
ConversationOutput = Dict[str, Union[bool, int, Optional[int]]]


class Role(enum.Enum):
    SELLER = 0
    BUYER = 1

    def other(self) -> "Role":
        return Role.BUYER if self == Role.SELLER else Role.SELLER

    def __str__(self):
        return "Seller" if self == Role.SELLER else "Buyer"


def create_buyer_info_str(buyer_info: BuyerInfo) -> str:
    features = ", ".join(buyer_info["preferred_features"])
    return (
        f"Personality: {buyer_info['personality']}. "
        f"Prefers {buyer_info['preferred_brands']} {buyer_info['preferred_type']} "
        f"with {features}. Budget: ${buyer_info['budget']:,}\n"
    )


def join_consecutive_actions(text_history: TextHistory) -> TextHistory:
    """Merge runs of consecutive action texts into one line
    (data.py:52-77)."""
    out: List[Text] = []
    pending: List[Text] = []

    def join(texts: List[Text], is_action: bool) -> Text:
        parts = []
        for t in texts:
            s = t.text
            while s.endswith("\n"):
                s = s[:-1]
            parts.append(s)
        return Text(" ".join(parts) + "\n", is_action)

    for t in text_history:
        if t.is_action:
            pending.append(t)
        else:
            if pending:
                out.append(join(pending, True))
                pending = []
            out.append(t)
    if pending:
        out.append(join(pending, True))
    return tuple(out)


def create_lines_from_text_history(text_history: TextHistory) -> List[Dict[str, str]]:
    """Seller-perspective rollout history → role-tagged lines
    (data.py:100-123)."""
    curr_role = Role.SELLER
    lines = []
    for t in text_history[1:]:
        assert t.is_action == (curr_role == Role.SELLER)
        lines.append({"role": str(curr_role), "text": t.text.strip()})
        curr_role = curr_role.other()
    return lines


def compute_reward(
    buyer_info: BuyerInfo, output: ConversationOutput, reward_mode: str = "fancy"
) -> float:
    """(data.py:130-173)."""
    msrp = output["msrp"]
    car_bought = output["car_bought"]
    budget = buyer_info["budget"]
    buy_price = output["buy_price"] if car_bought else None

    if reward_mode == "fancy":
        if msrp == 0:
            return 0.0
        if car_bought:
            if buy_price is None:
                return 0.0
            return buy_price / ((budget + msrp) * 0.5)
        return -(budget - msrp) / msrp
    if reward_mode == "revenue":
        if car_bought and buy_price is not None:
            return buy_price / 1000.0
        return 0.0
    raise NotImplementedError(reward_mode)


# MSRP must start 1-9 (data.py:176)
OUTPUT_EXTRACTION_PATTERN = re.compile(
    r"Output: Decision=(Accept|Reject) MSRP=\$([1-9][0-9,]*)( Buy Price=\$([0-9][0-9,]*))?"
)


def extract_output_from_str(line: str) -> Tuple[Optional[ConversationOutput], str]:
    """(data.py:178-204): parse the buyer's verdict; returns (output|None,
    line with the verdict text removed)."""
    m = re.search(OUTPUT_EXTRACTION_PATTERN, line)
    if m is None:
        return None, line
    car_bought = m.group(1) == "Accept"
    msrp = int(m.group(2).replace(",", ""))
    buy_price = (
        int(m.group(4).replace(",", ""))
        if car_bought and m.group(4) is not None
        else None
    )
    start = line.find(m.group(0))
    return (
        {"car_bought": car_bought, "msrp": msrp, "buy_price": buy_price},
        line[:start] + line[start + len(m.group(0)):],
    )


def create_trajectory_from_conversation(
    conversation: Dict, role: Role, reward_mode: str = "fancy"
) -> TextTrajectory:
    """(data.py:206-263): build either role's view. Buyer view prepends
    the persona line and appends the Output verdict as an action; seller
    view puts the episode reward on the last seller action."""
    text_history: List[Text] = [Text(INITIAL_STR, False)]
    if role == Role.BUYER:
        text_history.append(Text(create_buyer_info_str(conversation["buyer_info"]), False))
    for line in conversation["lines"]:
        is_action = line["role"] == str(role)
        text_history.append(Text(line["text"] + "\n", is_action))

    done = "output" in conversation
    if done and role == Role.BUYER:
        out = conversation["output"]
        if out["car_bought"]:
            text_history.append(
                Text(
                    f"Output: Decision=Accept MSRP=${out['msrp']:,} Buy Price=${out['buy_price']:,}\n",
                    True,
                )
            )
        else:
            text_history.append(
                Text(f"Output: Decision=Reject MSRP=${out['msrp']:,}\n", True)
            )

    text_history = list(join_consecutive_actions(tuple(text_history)))
    text_history = [
        dc_replace(t, text=t.text if t.text.endswith("\n") else t.text + "\n")
        for t in text_history
    ]

    reward = [0.0] * len(text_history)
    if done and role == Role.SELLER:
        r = compute_reward(conversation["buyer_info"], conversation["output"], reward_mode)
        for i in range(len(text_history) - 1, -1, -1):
            if text_history[i].is_action:
                reward[i] = r
                break

    return TextTrajectory(tuple(text_history), tuple(reward), done)


def create_trajectories_from_conversations(
    conversations: List[Dict], role: Role, reward_mode: str = "fancy"
) -> List[TextTrajectory]:
    return [
        create_trajectory_from_conversation(c, role, reward_mode)
        for c in conversations
    ]
