"""Car-Dealer environment + buyer policies (reference car_dealer/env/):
the port of `lmrl_gym_tpu/envs/car_dealer/env.py`.

The agent is the seller; the env embeds a buyer policy (the reference
wraps a finetuned GPT-2 buyer checkpoint, env/buyer.py:12-83). Episode
ends when the buyer's text contains the Output verdict; at
max_conversation_length the buyer is re-prompted with 'Output: Decision='
to force one (env.py:64-87).
"""
from __future__ import annotations

import random
from typing import Dict, Optional, Tuple

import torch

from lmrl_gym_torch.envs.base import TextEnv, TextPolicy
from lmrl_gym_torch.envs.car_dealer.data import (
    DEFAULT_BRANDS,
    DEFAULT_BUDGETS,
    DEFAULT_FEATURES,
    DEFAULT_PERSONALITIES,
    DEFAULT_TYPES,
    INITIAL_STR,
    BuyerInfo,
    Role,
    compute_reward,
    create_lines_from_text_history,
    create_trajectory_from_conversation,
    extract_output_from_str,
)
from lmrl_gym_torch.text.frames import Text, TextHistory, text_history_to_str


class LMBuyerPolicy(TextPolicy):
    """Buyer from a trained LM (reference BatchedGPT2BuyerPolicy,
    env/buyer.py:12-83): the buyer view of the conversation is the prompt;
    the generation is the buyer's next line."""

    def __init__(self, server, params, sampling, max_input_length: int = 768,
                 generator: Optional[torch.Generator] = None):
        self.server = server
        self.params = params
        self.sampling = sampling
        self.max_input_length = max_input_length
        self.generator = generator  # drawn from only under a sampled config

    def act(self, text_history: TextHistory) -> TextHistory:
        prompt = text_history_to_str(text_history)
        out = self.server.generate_from_strs(
            self.params, [prompt], self.max_input_length, self.sampling, self.generator
        )[0]
        if not out.endswith("\n"):
            out += "\n"
        return text_history + (Text(out, True),)


class ScriptedBuyerPolicy(TextPolicy):
    """Deterministic persona-driven buyer for tests and data generation.

    Negotiates for `patience` turns, then accepts iff the seller's last
    offer mentioned a price within budget (digits found in the seller
    text), else rejects at an MSRP above budget."""

    def __init__(self, buyer_info: BuyerInfo, patience: int = 3):
        self.buyer_info = buyer_info
        self.patience = patience

    def _seller_price(self, text: str) -> Optional[int]:
        import re

        m = re.findall(r"\$([0-9][0-9,]*)", text)
        if not m:
            return None
        return int(m[-1].replace(",", ""))

    def act(self, text_history: TextHistory) -> TextHistory:
        # buyer view: [Start, persona, seller, buyer, ..., seller]
        n_exchanges = sum(1 for t in text_history if t.is_action is False) - 2
        last_seller = text_history[-1].text
        budget = self.buyer_info["budget"]
        price = self._seller_price(last_seller)
        forced = "Output: Decision=" in last_seller

        if forced or n_exchanges >= self.patience:
            msrp = price if price is not None else budget + 10000
            if price is not None and price <= budget:
                out = f"Output: Decision=Accept MSRP=${msrp:,} Buy Price=${price:,}\n"
            else:
                out = f"Output: Decision=Reject MSRP=${msrp:,}\n"
            return text_history + (Text(out, True),)

        if price is not None and price <= budget:
            out = f"That works for me. Let's do ${price:,}. Output: Decision=Accept MSRP=${price:,} Buy Price=${price:,}\n"
        elif price is not None:
            counter = min(budget, int(price * 0.9))
            out = f"That's too much. I could do ${counter:,}.\n"
        else:
            out = (
                f"I'm looking for {self.buyer_info['preferred_brands']} "
                f"{self.buyer_info['preferred_type']}. What have you got?\n"
            )
        return text_history + (Text(out, True),)


class CarDealerEnv(TextEnv):
    """Seller-perspective env (reference CarDealerPolicyEnvironment,
    env.py:12-110)."""

    def __init__(
        self,
        buyer_factory,  # BuyerInfo -> TextPolicy
        max_conversation_length: int = 50,
        reward_mode: str = "fancy",
    ):
        self.buyer_factory = buyer_factory
        self.max_conversation_length = max_conversation_length
        self.reward_mode = reward_mode
        self.random = random.Random(None)
        self.buyer_info: Optional[BuyerInfo] = None
        self.buyer: Optional[TextPolicy] = None
        self.output = None

    def step(self, text_history: TextHistory) -> Tuple[TextHistory, float, bool]:
        assert text_history[-1].is_action
        assert self.buyer_info is not None, "call reset() first"

        conversation = {
            "buyer_info": self.buyer_info,
            "lines": create_lines_from_text_history(text_history),
        }
        buyer_view = create_trajectory_from_conversation(conversation, Role.BUYER)
        buyer_history = self.buyer.act(buyer_view.text_history)
        last_buyer_str = buyer_history[-1].text

        output, extracted = extract_output_from_str(last_buyer_str)
        if output is not None:
            self.output = output
            reward = compute_reward(self.buyer_info, output, self.reward_mode)
            return text_history + (Text(extracted, False),), reward, True

        out_history = text_history + (Text(last_buyer_str, False),)
        if len(out_history) - 1 >= self.max_conversation_length:
            # force a verdict (env.py:64-87)
            forced_prompt = last_buyer_str
            if forced_prompt.endswith("\n"):
                forced_prompt = forced_prompt[:-1]
            forced_prompt += "Output: Decision="
            buyer_history = self.buyer.act(
                buyer_history[:-1] + (Text(forced_prompt, True),)
            )
            output, extracted = extract_output_from_str(buyer_history[-1].text)
            if output is not None:
                self.output = output
                reward = compute_reward(self.buyer_info, output, self.reward_mode)
                return text_history + (Text(extracted, False),), reward, True
            return out_history, 0.0, True

        return out_history, 0.0, False

    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None) -> TextHistory:
        if seed is not None:
            self.random = random.Random(seed)
        self.buyer_info = {
            "personality": self.random.choice(DEFAULT_PERSONALITIES),
            "preferred_brands": self.random.choice(DEFAULT_BRANDS),
            "preferred_type": self.random.choice(DEFAULT_TYPES),
            "preferred_features": self.random.sample(
                DEFAULT_FEATURES, k=self.random.randint(1, 4)
            ),
            "budget": self.random.choice(DEFAULT_BUDGETS),
        }
        self.buyer = self.buyer_factory(self.buyer_info)
        self.output = None
        return (Text(INITIAL_STR, False),)

    def copy(self) -> "CarDealerEnv":
        return CarDealerEnv(
            self.buyer_factory, self.max_conversation_length, self.reward_mode
        )
