"""Human-in-the-loop evaluation policy: the port of
`lmrl_gym_tpu/envs/human.py`.

The reference ships per-task human-eval scripts
(llm_rl_scripts/maze/human_eval/*, twenty_questions_human_eval.py,
SURVEY.md §4) where a person plays the environment through stdin. This is
the generic equivalent: wrap any TextEnv with `text_env_eval(env,
HumanPolicy(), ...)` and the transcript is printed turn by turn.

`input_fn` is injectable so tests (and batch transcript replays) can
drive it without a terminal.
"""
from __future__ import annotations

from typing import Callable, Optional

from lmrl_gym_torch.envs.base import TextPolicy
from lmrl_gym_torch.text.frames import Text, TextHistory


class HumanPolicy(TextPolicy):
    def __init__(
        self,
        prompt: str = "> ",
        input_fn: Optional[Callable[[str], str]] = None,
        print_fn: Callable[[str], None] = print,
        append_newline: bool = True,
    ):
        self.prompt = prompt
        self.input_fn = input_fn or input
        self.print_fn = print_fn
        self.append_newline = append_newline
        self._shown = 0

    def act(self, text_history: TextHistory) -> TextHistory:
        if len(text_history) < self._shown:  # new episode started
            self._shown = 0
        # show only what's new since the last turn
        for item in text_history[self._shown:]:
            self.print_fn(item.text)
        action = self.input_fn(self.prompt)
        if self.append_newline and not action.endswith("\n"):
            action += "\n"
        self._shown = len(text_history) + 1
        return text_history + (Text(action, True),)
