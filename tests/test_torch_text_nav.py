"""The port's Text-Nav env (`lmrl_gym_torch/envs/text_nav/`) and its task
builders (`cli/tasks.py`) against the JAX package's, on the same
`random.Random` seeds: every observation, admissible-command list,
reward, done flag, walkthrough and generated chain identical (they are
pure Python; nothing may drift)."""
import random

import pytest

from lmrl_gym_torch.cli import tasks as ttasks
from lmrl_gym_torch.envs.base import interact_environment as t_interact
from lmrl_gym_torch.envs.text_nav import engine as tengine
from lmrl_gym_torch.envs.text_nav import env as tenv
from lmrl_gym_tpu.cli import tasks as jtasks
from lmrl_gym_tpu.envs.base import interact_environment as j_interact
from lmrl_gym_tpu.envs.text_nav import engine as jengine
from lmrl_gym_tpu.envs.text_nav import env as jenv


def _texts(history):
    return [(t.text, t.is_action) for t in history]


def _chain_list(chain):
    out = []
    while chain is not None:
        tt = chain.text_trajectory
        out.append((_texts(tt.text_history), tuple(tt.reward), tt.done))
        chain = chain.next
    return out


@pytest.mark.parametrize("display_location,display_inventory", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_random_play_matches(seed, display_location, display_inventory):
    """Random admissible (and some invalid) commands from one stream drive
    both envs; every step's observation, reward, done and admissible
    commands are identical."""
    envs = [m.TextNavEnv(display_location=display_location, display_inventory=display_inventory, max_steps=40)
            for m in (jenv, tenv)]
    obs = [e.reset(seed=seed) for e in envs]
    assert _texts(obs[0]) == _texts(obs[1])
    rng = random.Random(seed + 100)
    for _ in range(40):
        cmds = [e.world.admissible_commands() for e in envs]
        assert cmds[0] == cmds[1]
        cmd = rng.choice(cmds[0] + ["look at the ceiling", "eat fridge", "put bowl on chest", "go up", ""])
        steps = [e.step(o + (type(o[-1])(cmd + "\n", True),)) for e, o in zip(envs, obs)]
        (h0, r0, d0), (h1, r1, d1) = steps
        assert _texts(h0) == _texts(h1) and r0 == r1 and d0 == d1
        assert envs[0].world.describe_room() == envs[1].world.describe_room()
        assert envs[0].world.describe_inventory() == envs[1].world.describe_inventory()
        assert jenv.quest_status(envs[0].world) == tenv.quest_status(envs[1].world)
        obs = [h0, h1]
        if d0:
            break


@pytest.mark.parametrize("seed", range(8))
def test_walkthroughs_and_agents_match(seed):
    """Walkthroughs from every start room win in both packages with the
    same commands; the partial agent's episode is identical."""
    worlds = [m.build_house(random.Random(seed)) for m in (jenv, tenv)]
    assert worlds[0].player_room == worlds[1].player_room
    plans = [jenv.walkthrough_from(worlds[0]), tenv.walkthrough_from(worlds[1])]
    assert plans[0] == plans[1]
    for start in jenv.ROOMS:
        assert jenv._shortest_path(worlds[0], start, "kitchen") == tenv._shortest_path(worlds[1], start, "kitchen")

    for agent_cls in ("WalkthroughAgent", "PartialWalkthroughAgent"):
        runs = []
        for m in (jenv, tenv):
            env = m.TextNavEnv(display_location=False, max_steps=30)
            agent = (getattr(m, agent_cls)(env) if agent_cls == "WalkthroughAgent"
                     else getattr(m, agent_cls)(env, m.ROOMS[:5], rng=random.Random(seed)))
            history, done, rewards = env.reset(seed=seed), False, []
            while not done:
                history, reward, done = env.step(agent.act(history))
                rewards.append(reward)
            runs.append((_texts(history), rewards))
        assert runs[0] == runs[1]
        if agent_cls == "WalkthroughAgent":
            assert runs[1][1][-1] == 1.0  # the optimal agent wins


def test_engine_commands_match():
    """Every command form, valid and invalid, on a hand-built world."""
    feedback = []
    for m in (jengine, tengine):
        w = m.World()
        for name in ("a", "b"):
            w.add_room(name)
        w.connect("a", "north", "b")
        box = m.Thing("box", "container", openable=True, is_open=False)
        box.contents.append(m.Thing("key", "object"))
        shelf = m.Thing("shelf", "supporter")
        w.place("a", box)
        w.place("a", shelf)
        w.place("a", m.Thing("apple", "food"))
        w.player_room = "a"
        out = []
        for cmd in ("take key", "open box", "open box", "take key from shelf", "take key from box", "take key",
                    "put key on shelf", "take key from shelf", "insert key into box", "close box", "close box",
                    "insert apple into box", "take apple", "eat key", "drop apple", "take apple", "eat apple",
                    "go south", "go north", "drop key", "", "dance"):
            out.append((w.execute(cmd), w.admissible_commands(), w.describe_room(), w.describe_inventory()))
        feedback.append(out)
    assert feedback[0] == feedback[1]


@pytest.mark.parametrize("seed", [0, 13])
def test_generate_text_nav_chains_match(seed):
    j = jtasks.generate_text_nav_chains(6, seed)
    t = ttasks.generate_text_nav_chains(6, seed)
    assert [_chain_list(c) for c in j] == [_chain_list(c) for c in t]
    for task in ("text_nav", "text_nav_partial"):
        assert ttasks.TASKS[task].max_length == jtasks.TASKS[task].max_length
        a, b = jtasks.TASKS[task].build_env(), ttasks.TASKS[task].build_env()
        assert (a.display_location, a.max_steps) == (b.display_location, b.max_steps)


@pytest.mark.parametrize("windowed", [False, True])
def test_transitions_to_chain_matches(windowed):
    """`transitions_to_chain` on the same rollouts: one whole-conversation
    window (the env keeps the conversation), or a chain of per-step
    windows when the final history has dropped earlier actions."""

    class Scripted:
        """Plays the k-th admissible command of the latest observation (k
        the history's length); trims each history to its last two turns
        when `windowed`."""

        def act(self, histories, done=None):
            out = []
            for h, d in zip(histories, done):
                if d:
                    out.append(None)
                    continue
                cmds = h[-1].text.split("Admissible commands: ")[-1].strip().split(", ")
                h = h + (type(h[-1])(cmds[len(h) % len(cmds)] + "\n", True),)
                out.append(h[-3:] if windowed and len(h) > 3 else h)
            return out

    results = []
    for m, interact, tasks in ((jenv, j_interact, jtasks), (tenv, t_interact, ttasks)):
        env = m.TextNavEnv(display_location=True, max_steps=12)
        transitions = interact(env, Scripted(), env_seed=5)[0]
        results.append(_chain_list(tasks.transitions_to_chain(transitions)))
    assert results[0] == results[1] and len(results[0]) >= 1
