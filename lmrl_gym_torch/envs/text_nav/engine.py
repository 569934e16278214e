"""A compact text-adventure engine (TextWorld replacement): the port's copy
of `lmrl_gym_tpu/envs/text_nav/engine.py`, pure Python, identical strings.

The reference's Text-Nav env builds one fixed 8-room house game with the
TextWorld framework (llm_rl_scripts/text_nav/env/make_game.py:30-124) —
a dependency unavailable here. This module implements the subset of
TextWorld semantics that game uses: rooms with directional exits,
supporters (tables), openable containers (chest/fridge), portable objects
and foods, the command set (go/take/put/insert/open/close/drop/eat),
admissible-command enumeration, and win/fail quest events.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

OPPOSITE = {"north": "south", "south": "north", "east": "west", "west": "east"}


@dataclass
class Thing:
    name: str
    kind: str  # 'object' | 'food' | 'supporter' | 'container'
    openable: bool = False
    is_open: bool = True
    contents: List["Thing"] = field(default_factory=list)

    @property
    def portable(self) -> bool:
        return self.kind in ("object", "food")


@dataclass
class Room:
    name: str
    exits: Dict[str, str] = field(default_factory=dict)  # direction → room name
    things: List[Thing] = field(default_factory=list)


class World:
    """Mutable game state: rooms, player location, inventory."""

    def __init__(self):
        self.rooms: Dict[str, Room] = {}
        self.player_room: Optional[str] = None
        self.inventory: List[Thing] = []
        self.eaten: Set[str] = set()

    # ---- construction ----

    def add_room(self, name: str) -> Room:
        room = Room(name)
        self.rooms[name] = room
        return room

    def connect(self, a: str, direction: str, b: str) -> None:
        self.rooms[a].exits[direction] = b
        self.rooms[b].exits[OPPOSITE[direction]] = a

    def place(self, room: str, thing: Thing) -> None:
        self.rooms[room].things.append(thing)

    # ---- queries ----

    def room(self) -> Room:
        return self.rooms[self.player_room]

    def find_thing(self, name: str) -> Optional[Tuple[Thing, Optional[Thing]]]:
        """→ (thing, holder) where holder is a supporter/container in the
        room, None if on the floor/in inventory; searches current room
        then inventory; closed containers hide their contents."""
        for thing in self.room().things:
            if thing.name == name:
                return thing, None
            if thing.kind in ("supporter", "container") and (
                thing.kind == "supporter" or thing.is_open
            ):
                for inner in thing.contents:
                    if inner.name == name:
                        return inner, thing
        for thing in self.inventory:
            if thing.name == name:
                return thing, None
        return None

    def visible_things(self) -> List[Tuple[Thing, Optional[Thing]]]:
        out = []
        for thing in self.room().things:
            out.append((thing, None))
            if thing.kind == "supporter" or (
                thing.kind == "container" and thing.is_open
            ):
                for inner in thing.contents:
                    out.append((inner, thing))
        return out

    # ---- commands ----

    def admissible_commands(self) -> List[str]:
        cmds: List[str] = []
        for direction in sorted(self.room().exits):
            cmds.append(f"go {direction}")
        for thing, holder in self.visible_things():
            if thing.kind == "container" and thing.openable:
                cmds.append(f"close {thing.name}" if thing.is_open else f"open {thing.name}")
            if thing.portable and holder is not None:
                cmds.append(f"take {thing.name} from {holder.name}")
            elif thing.portable:
                cmds.append(f"take {thing.name}")
        for item in self.inventory:
            cmds.append(f"drop {item.name}")
            if item.kind == "food":
                cmds.append(f"eat {item.name}")
            for thing, holder in self.visible_things():
                if holder is not None:
                    continue
                if thing.kind == "supporter":
                    cmds.append(f"put {item.name} on {thing.name}")
                elif thing.kind == "container" and thing.is_open:
                    cmds.append(f"insert {item.name} into {thing.name}")
        return cmds

    def execute(self, command: str) -> str:
        """Run a command; returns feedback text. Unknown/invalid commands
        return a failure message and change nothing."""
        command = " ".join(command.strip().lower().split())
        words = command.split()
        if not words:
            return "I beg your pardon?"

        if words[0] == "go" and len(words) == 2:
            direction = words[1]
            if direction not in self.room().exits:
                return "You can't go that way."
            self.player_room = self.room().exits[direction]
            return f"-= {self.room().name.title()} =-\nYou go {direction}."

        if words[0] == "open" and len(words) >= 2:
            name = " ".join(words[1:])
            found = self.find_thing(name) or self._find_closed(name)
            if not found or found[0].kind != "container":
                return f"You can't see any such thing."
            thing = found[0]
            if not thing.openable:
                return f"You can't open the {name}."
            if thing.is_open:
                return f"The {name} is already open."
            thing.is_open = True
            inside = ", ".join(t.name for t in thing.contents) or "nothing"
            return f"You open the {name}, revealing {inside}."

        if words[0] == "close" and len(words) >= 2:
            name = " ".join(words[1:])
            found = self.find_thing(name)
            if not found or found[0].kind != "container":
                return "You can't see any such thing."
            thing = found[0]
            if not thing.is_open:
                return f"The {name} is already closed."
            thing.is_open = False
            return f"You close the {name}."

        if words[0] == "take":
            rest = " ".join(words[1:])
            if " from " in rest:
                name, holder_name = rest.split(" from ", 1)
            else:
                name, holder_name = rest, None
            found = self.find_thing(name)
            if not found or not found[0].portable:
                return "You can't see any such thing."
            thing, holder = found
            if thing in self.inventory:
                return "You already have it."
            if holder_name is not None and (holder is None or holder.name != holder_name):
                return "You can't see any such thing."
            if holder is not None:
                holder.contents.remove(thing)
            else:
                self.room().things.remove(thing)
            self.inventory.append(thing)
            return f"You take the {name}" + (
                f" from the {holder.name}." if holder else "."
            )

        if words[0] == "drop" and len(words) >= 2:
            name = " ".join(words[1:])
            item = next((t for t in self.inventory if t.name == name), None)
            if item is None:
                return "You don't have that."
            self.inventory.remove(item)
            self.room().things.append(item)
            return f"You drop the {name}."

        if words[0] == "put" and " on " in command:
            rest = " ".join(words[1:])
            name, target_name = rest.split(" on ", 1)
            item = next((t for t in self.inventory if t.name == name), None)
            target = self.find_thing(target_name)
            if item is None:
                return "You don't have that."
            if not target or target[0].kind != "supporter":
                return "You can't put things on that."
            self.inventory.remove(item)
            target[0].contents.append(item)
            return f"You put the {name} on the {target_name}."

        if words[0] == "insert" and " into " in command:
            rest = " ".join(words[1:])
            name, target_name = rest.split(" into ", 1)
            item = next((t for t in self.inventory if t.name == name), None)
            target = self.find_thing(target_name)
            if item is None:
                return "You don't have that."
            if not target or target[0].kind != "container":
                return "You can't put things in that."
            if not target[0].is_open:
                return f"The {target_name} is closed."
            self.inventory.remove(item)
            target[0].contents.append(item)
            return f"You insert the {name} into the {target_name}."

        if words[0] == "eat" and len(words) >= 2:
            name = " ".join(words[1:])
            item = next((t for t in self.inventory if t.name == name), None)
            if item is None or item.kind != "food":
                return "You can't eat that."
            self.inventory.remove(item)
            self.eaten.add(item.name)
            return f"You eat the {name}. Not bad."

        return "That's not a verb I recognise."

    def _find_closed(self, name: str):
        """Closed containers are still visible (just not their contents)."""
        for thing in self.room().things:
            if thing.name == name:
                return thing, None
        return None

    # ---- descriptions ----

    def describe_room(self, show_location: bool = True) -> str:
        room = self.room()
        parts = []
        if show_location:
            parts.append(f"-= {room.name.title()} =-")
        for thing in room.things:
            if thing.kind == "supporter":
                on = ", ".join(t.name for t in thing.contents) or "nothing"
                parts.append(f"There is a {thing.name} here. On it: {on}.")
            elif thing.kind == "container":
                state = "open" if thing.is_open else "closed"
                desc = f"There is a {state} {thing.name} here."
                if thing.is_open and thing.contents:
                    desc += " Inside: " + ", ".join(t.name for t in thing.contents) + "."
                parts.append(desc)
            else:
                parts.append(f"There is a {thing.name} on the floor.")
        exits = ", ".join(sorted(room.exits))
        parts.append(f"Exits: {exits}.")
        return "\n".join(parts)

    def describe_inventory(self) -> str:
        if not self.inventory:
            return "You are carrying nothing."
        return "You are carrying: " + ", ".join(t.name for t in self.inventory) + "."
