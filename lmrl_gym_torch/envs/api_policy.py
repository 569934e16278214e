"""External-API baseline policy — the reference's GPT-4 eval role. The
port of `lmrl_gym_tpu/envs/api_policy.py`.

The reference ships per-task GPT-4 baseline scripts
(llm_rl_scripts/maze/gpt4/gpt4_maze.py, gpt4_po_maze.py and siblings for
the other tasks) that evaluate a chat API against the environments:
few-shot prompt, chat-completions call, JSON `{"action": ...}`
extraction, `text_env_eval` rollout. Here that is ONE generic
`TextPolicy` over a pluggable transport:

- tests and offline runs inject any `transport(messages) -> str`;
- live use builds `openai_chat_transport(...)`, which speaks the
  chat-completions wire format over urllib (no SDK dependency) and reads
  OPENAI_API_KEY / OPENAI_BASE_URL. With no key configured it raises a
  clear error at call time — this image has no egress, so the live path
  is exercised only by users who bring credentials.
"""
from __future__ import annotations

import json
import os
import re
import urllib.request
from typing import Callable, List, Optional, Sequence

from lmrl_gym_torch.envs.base import TextPolicy
from lmrl_gym_torch.text.frames import Text, TextHistory

Message = dict
ChatTransport = Callable[[List[Message]], str]


def openai_chat_transport(
    model: str = "gpt-4",
    base_url: Optional[str] = None,
    api_key: Optional[str] = None,
    temperature: float = 0.0,
    timeout: float = 60.0,
) -> ChatTransport:
    """Chat-completions transport for any OpenAI-compatible endpoint."""
    base_url = base_url or os.environ.get("OPENAI_BASE_URL", "https://api.openai.com/v1")
    api_key = api_key or os.environ.get("OPENAI_API_KEY")

    def transport(messages: List[Message]) -> str:
        if not api_key:
            raise RuntimeError(
                "openai_chat_transport needs an API key (OPENAI_API_KEY or "
                "api_key=); for offline use inject a custom transport"
            )
        body = json.dumps(
            {"model": model, "messages": messages, "temperature": temperature}
        ).encode()
        req = urllib.request.Request(
            base_url.rstrip("/") + "/chat/completions",
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {api_key}",
            },
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = json.load(resp)
        return out["choices"][0]["message"]["content"]

    return transport


def extract_json_action(reply: str, fallback_to_reply: bool = True) -> str:
    """Pull `{"action": "..."}` out of a model reply (the reference's
    extraction convention, gpt4_maze.py); falls back to the raw reply."""
    for m in re.finditer(r"\{[^{}]*\}", reply, re.DOTALL):
        try:
            obj = json.loads(m.group(0))
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and "action" in obj:
            return str(obj["action"])
    if fallback_to_reply:
        return reply.strip()
    raise ValueError(f"no action object in reply: {reply!r}")


def render_history(history: TextHistory) -> str:
    """Default prompt rendering: the environment/action transcript."""
    lines = []
    for item in history:
        role = "action" if item.is_action else "environment"
        lines.append(f"{role}: {item.text.rstrip()}")
    return "\n".join(lines)


class APIChatPolicy(TextPolicy):
    """TextPolicy over a chat API. `render` turns the history into the
    user message; `extract` turns the reply into the action text."""

    def __init__(
        self,
        transport: ChatTransport,
        system_prompt: str = "You are playing a text game. Reply with your "
        'next action as JSON: {"action": "..."}.',
        instructions: str = "",
        render: Callable[[TextHistory], str] = render_history,
        extract: Callable[[str], str] = extract_json_action,
        append_newline: bool = True,
    ):
        self.transport = transport
        self.system_prompt = system_prompt
        self.instructions = instructions
        self.render = render
        self.extract = extract
        self.append_newline = append_newline

    def act(self, text_history: TextHistory) -> TextHistory:
        user = self.render(text_history)
        if self.instructions:
            user = self.instructions + "\n\n" + user
        reply = self.transport(
            [
                {"role": "system", "content": self.system_prompt},
                {"role": "user", "content": user},
            ]
        )
        action = self.extract(reply)
        if self.append_newline and not action.endswith("\n"):
            action += "\n"
        return text_history + (Text(action, True),)


MAZE_INSTRUCTIONS = (
    "Your objective is to reach the goal of the maze in as few steps as "
    "possible. Each step you see the goal, your position, and the walls "
    "around you. Your possible actions are \"move up\", \"move down\", "
    "\"move left\", \"move right\". Reply with JSON like "
    '{"action": "move up"}.'
)


def task_instructions(task: str) -> str:
    """Per-task instruction blocks for the API baseline (maze mirrors the
    reference's gpt4_maze.py prompt role; other tasks get the generic
    transcript + their env's own header text)."""
    return {"maze": MAZE_INSTRUCTIONS}.get(task, "")
