"""Text-Nav: the 8-room house navigation game; the port's copy of
`lmrl_gym_tpu/envs/text_nav/env.py`.

Game layout parity with the reference (text_nav/env/make_game.py:30-124):
rooms bedroom/office/bathroom/living room/kitchen/dining room/garden/
backyard with the same connections; tables in bedroom/living room/dining
room, a closed chest in the office, a closed fridge in the kitchen; the
stale food on the living-room table with 6 distractor items; random start
room. Quest: put the stale food into the fridge and close it (win,
reward 1); eating the stale food fails the episode. The env surface
matches text_nav/env/env.py:12-72: observations append the admissible-
commands list; `display_location` / `display_inventory` toggle the
partially-observed variant; room headers are stripped when hidden.
"""
from __future__ import annotations

import random
import re
from typing import Dict, List, Optional, Tuple

from lmrl_gym_torch.envs.base import TextEnv, TextPolicy
from lmrl_gym_torch.envs.text_nav.engine import Thing, World
from lmrl_gym_torch.text.frames import Text, TextHistory

ROOMS = [
    "bedroom", "office", "bathroom", "living room",
    "kitchen", "dining room", "garden", "backyard",
]

OBJECTIVE = (
    "Your objective is to put the stale food on the table in the living room"
    " into the fridge in the kitchen."
)

_HEADER_RE = re.compile(r"-=.*=-\n?")


def build_house(rng: random.Random) -> World:
    """The fixed house game with a random start room (make_game.py:33-99)."""
    world = World()
    for name in ROOMS:
        world.add_room(name)
    # connections (make_game.py:42-49)
    world.connect("bedroom", "west", "living room")
    world.connect("living room", "west", "dining room")
    world.connect("dining room", "west", "kitchen")
    world.connect("kitchen", "north", "garden")
    world.connect("living room", "south", "office")
    world.connect("office", "east", "bathroom")
    world.connect("bedroom", "south", "bathroom")
    world.connect("kitchen", "west", "backyard")

    table1 = Thing("table", "supporter")
    table2 = Thing("table", "supporter")
    table3 = Thing("table", "supporter")
    chest = Thing("chest", "container", openable=True, is_open=False)
    fridge = Thing("fridge", "container", openable=True, is_open=False)
    world.place("bedroom", table1)
    world.place("living room", table2)
    world.place("dining room", table3)
    world.place("office", chest)
    world.place("kitchen", fridge)

    table2.contents.append(Thing("stale food", "food"))
    table2.contents.append(Thing("fresh food", "food"))
    table1.contents.append(Thing("bowl", "object"))
    table3.contents.append(Thing("coffee cup", "object"))
    table3.contents.append(Thing("plate", "object"))
    chest.contents.append(Thing("utensils", "object"))
    fridge.contents.append(Thing("fruit", "food"))

    world.player_room = rng.choice(ROOMS)
    return world


def quest_status(world: World) -> Tuple[bool, bool]:
    """(won, failed): won = stale food inside the CLOSED fridge; failed =
    stale food eaten (make_game.py:88-99)."""
    if "stale food" in world.eaten:
        return False, True
    fridge = next(t for t in world.rooms["kitchen"].things if t.name == "fridge")
    food_in_fridge = any(t.name == "stale food" for t in fridge.contents)
    return food_in_fridge and not fridge.is_open, False


def walkthrough_from(world: World) -> List[str]:
    """Optimal command list from the CURRENT world state (generalizes the
    reference's reset-time walkthrough, make_game.py:103-119)."""
    fridge = next(t for t in world.rooms["kitchen"].things if t.name == "fridge")
    have_food = any(t.name == "stale food" for t in world.inventory)
    food_in_fridge = any(t.name == "stale food" for t in fridge.contents)

    if food_in_fridge:
        return ["close fridge"] if fridge.is_open else []

    cmds: List[str] = []
    position = world.player_room
    if not have_food:
        cmds += [f"go {d}" for d in _shortest_path(world, position, "living room")]
        cmds.append("take stale food from table")
        position = "living room"
    cmds += [f"go {d}" for d in _shortest_path(world, position, "kitchen")]
    if not fridge.is_open:
        cmds.append("open fridge")
    cmds += ["insert stale food into fridge", "close fridge"]
    return cmds


def _shortest_path(world: World, start: str, goal: str) -> List[str]:
    from collections import deque

    if start == goal:
        return []
    prev: Dict[str, Tuple[str, str]] = {}
    q = deque([start])
    while q:
        cur = q.popleft()
        for direction, nxt in world.rooms[cur].exits.items():
            if nxt not in prev and nxt != start:
                prev[nxt] = (cur, direction)
                if nxt == goal:
                    q.clear()
                    break
                q.append(nxt)
    path = []
    cur = goal
    while cur != start:
        parent, direction = prev[cur]
        path.append(direction)
        cur = parent
    return path[::-1]


class TextNavEnv(TextEnv):
    """Reference TextNavEnv surface (env.py:12-72): feedback + admissible
    commands per step; cumulative score as reward (1 only on the winning
    step); display_location=False strips room headers."""

    def __init__(
        self,
        display_location: bool = False,
        display_inventory: bool = False,
        max_steps: int = 40,
    ):
        self.display_location = display_location
        self.display_inventory = display_inventory
        self.max_steps = max_steps
        self.rng = random.Random()
        self.reset()

    def _observe(self, feedback: str) -> str:
        if self.display_inventory:
            feedback += "\n" + self.world.describe_inventory()
        commands = self.world.admissible_commands()
        feedback += "\nAdmissible commands: {}\n".format(", ".join(commands))
        if not self.display_location:
            feedback = _HEADER_RE.sub("", feedback)
        return feedback

    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None) -> TextHistory:
        self.rng = random.Random(seed)
        self.world = build_house(self.rng)
        self.num_steps = 0
        self.score = 0
        first = OBJECTIVE + "\n" + self.world.describe_room(self.display_location)
        return (Text(self._observe(first), False),)

    def step(self, text_history: TextHistory) -> Tuple[TextHistory, float, bool]:
        assert text_history[-1].is_action
        command = text_history[-1].text.strip()
        feedback = self.world.execute(command)
        self.num_steps += 1

        won, failed = quest_status(self.world)
        if won:
            self.score = 1
        reward = float(self.score)
        done = won or failed or self.num_steps >= self.max_steps

        obs = Text(self._observe(feedback) , False)
        return text_history + (obs,), reward, done

    def copy(self) -> "TextNavEnv":
        return TextNavEnv(self.display_location, self.display_inventory, self.max_steps)


class WalkthroughAgent(TextPolicy):
    """Optimal scripted agent (for dataset generation)."""

    def __init__(self, env: TextNavEnv):
        self.env = env
        self.plan: List[str] = []

    def act(self, text_history: TextHistory) -> TextHistory:
        if not self.plan:
            self.plan = walkthrough_from(self.env.world)
        command = self.plan.pop(0) if self.plan else "go north"
        return text_history + (Text(command + "\n", True),)


class PartialWalkthroughAgent(TextPolicy):
    """Optimal within a room subset, random elsewhere (reference
    text_nav/dataset/collect_data.py:21-40)."""

    def __init__(self, env: TextNavEnv, known_rooms: List[str], rng: Optional[random.Random] = None):
        self.env = env
        self.known_rooms = set(known_rooms)
        self.rng = rng or random.Random()

    def act(self, text_history: TextHistory) -> TextHistory:
        if self.env.world.player_room in self.known_rooms:
            plan = walkthrough_from(self.env.world)
            command = plan[0] if plan else "go north"
        else:
            command = self.rng.choice(self.env.world.admissible_commands())
        return text_history + (Text(command + "\n", True),)
