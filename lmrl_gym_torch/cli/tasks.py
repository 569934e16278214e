"""Task registry: the port of `lmrl_gym_tpu/cli/tasks.py` (host only).

Each task provides the same capabilities behind one interface consumed by
`cli/train.py` and `cli/evaluate.py`:

- build_env(): the TextEnv used for eval rollouts;
- generate_chains(n, seed): scripted-policy behavior data as
  TextTrajectoryChains;
- max_length: the default training window.

`TASKS` has the JAX package's key set, and every builder and generator
gives the JAX package's strings.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from lmrl_gym_torch.envs.base import TextEnv, TextPolicy
from lmrl_gym_torch.text.frames import Text, TextHistory, TextTrajectory, TextTrajectoryChain


@dataclass
class Task:
    name: str
    build_env: Callable[..., TextEnv]
    generate_chains: Callable[[int, int], List[TextTrajectoryChain]]
    max_length: int  # default training window
    # policy-side text processing for generation
    stop_token: str = "\n"


def transitions_to_chain(transitions) -> TextTrajectoryChain:
    """One rollout's InteractionTransitions → TextTrajectoryChain (the
    conversion every online loader performs on fresh rollouts, cf.
    wordle/ppo/train_ppo_gpt2.py:311).

    If the env keeps the whole conversation in the history (dialog tasks,
    wordle), emit one window with each action's reward on its Text. If the
    env windows its history (maze last_k, chess Markov FEN), the final
    history has dropped earlier actions — emit a chain of per-step windows
    (post_action_history) instead, linked for cross-window credit."""
    final = transitions[-1].post_transition_history
    n_actions_in_final = sum(1 for t in final if t.is_action)
    if n_actions_in_final == len(transitions):
        per_action = [t.reward for t in transitions]
        rewards, ai = [], 0
        for t in final:
            if t.is_action:
                rewards.append(per_action[ai])
                ai += 1
            else:
                rewards.append(0.0)
        return TextTrajectoryChain(
            TextTrajectory(final, tuple(rewards), transitions[-1].done), None
        )
    chain = None
    for tr in reversed(transitions):
        h = tr.post_action_history
        assert h[-1].is_action
        rewards = [0.0] * len(h)
        rewards[-1] = float(tr.reward)
        chain = TextTrajectoryChain(
            TextTrajectory(h, tuple(rewards), bool(tr.done)), chain
        )
    return chain


def _chain_from_markov_steps(steps) -> TextTrajectoryChain:
    """[(obs_text, action_text, reward, done)] → chain of 1-step windows."""
    chain = None
    for obs, action, reward, done in reversed(steps):
        chain = TextTrajectoryChain(
            TextTrajectory(
                (Text(obs, False), Text(action, True)), (0.0, reward), done
            ),
            chain,
        )
    return chain


# ---------------- maze ----------------


def build_maze_env(max_steps: int = 100, last_k: int = 1) -> TextEnv:
    from lmrl_gym_torch.envs.maze.env import MazeEnv
    from lmrl_gym_torch.envs.maze.grids import double_t_maze

    return MazeEnv(
        maze=double_t_maze(),
        valid_goals=np.asarray([(8, 6)]),
        max_steps=max_steps,
        last_k=last_k,
    )


def generate_maze_chains(
    n: int, seed: int, p_optimal: float = 0.7, wrong_bias: bool = False
) -> List[TextTrajectoryChain]:
    """Mixture of BFS-optimal and random moves; Markov (obs, action)
    windows chained for cross-window credit assignment.

    wrong_bias=True makes the non-optimal mass DETERMINISTIC (the first
    non-optimal action per cell) instead of uniform. With p_optimal < 0.5
    the behavior policy's mode is then systematically wrong, so BC
    imitation fails while the returns still identify optimal paths — the
    adversarial regime where only value learning recovers the optimal
    policy (used by the reference-scale ILQL gate)."""
    from lmrl_gym_torch.envs.maze.env import MazeEnv
    from lmrl_gym_torch.envs.maze.grids import ACTION_STRS, double_t_maze, maze_solver

    maze = double_t_maze()
    solver = maze_solver(maze, (8, 6))
    rng = random.Random(seed)
    env = build_maze_env()
    chains = []
    for i in range(n):
        obs = env.reset(seed=seed * 100003 + i)
        steps = []
        done = False
        while not done and len(steps) < 40:
            if rng.random() < p_optimal and tuple(env.position) in solver:
                action = solver[tuple(env.position)]
            elif wrong_bias and tuple(env.position) in solver:
                opt = solver[tuple(env.position)]
                action = next(a for a in ACTION_STRS if a != opt)
            else:
                action = rng.choice(ACTION_STRS)
            history = obs + (Text(action, True),)
            obs, reward, done = env.step(history)
            steps.append((history[0].text, action, reward, done))
        if not done:
            steps[-1] = steps[-1][:3] + (True,)
        chains.append(_chain_from_markov_steps(steps))
    return chains


# ---------------- wordle ----------------


def build_wordle_env(vocab_file: Optional[str] = None) -> TextEnv:
    from lmrl_gym_torch.envs.wordle.env import ReformatWordleEnv, WordleEnv
    from lmrl_gym_torch.envs.wordle.vector import WordleVocab

    vocab = WordleVocab.from_file(vocab_file) if vocab_file else WordleVocab.from_file()
    return ReformatWordleEnv(WordleEnv(vocab))


def generate_wordle_chains(n: int, seed: int, prob_smart: float = 0.66) -> List[TextTrajectoryChain]:
    from lmrl_gym_torch.envs.wordle.data import generate_trajectories, trajectories_to_chains
    from lmrl_gym_torch.envs.wordle.policies import MixturePolicy, RandomMixturePolicy, StartWordPolicy
    from lmrl_gym_torch.envs.wordle.vector import WordleVocab

    vocab = WordleVocab.from_file()
    rng = random.Random(seed)
    policy = MixturePolicy(
        0.33,
        StartWordPolicy(rng=rng),
        RandomMixturePolicy(prob_smart, vocab, rng=rng),
        rng=rng,
    )
    return trajectories_to_chains(generate_trajectories(n, policy, vocab, seed=seed))


# ---------------- partially observed maze ----------------


def build_maze_partial_env(max_steps: int = 100, last_k: int = 40) -> TextEnv:
    """Partially observed maze: walls-only observations (the reference's
    partially_observed script family; describe_observation_only_walls,
    maze/env/env.py:69-81). History window carries the missing state."""
    from lmrl_gym_torch.envs.maze.env import MazeEnv, describe_observation_only_walls
    from lmrl_gym_torch.envs.maze.grids import double_t_maze

    return MazeEnv(
        maze=double_t_maze(),
        valid_goals=np.asarray([(8, 6)]),
        max_steps=max_steps,
        describe_function=describe_observation_only_walls,
        last_k=last_k,
    )


def generate_maze_partial_chains(n: int, seed: int, p_optimal: float = 0.7) -> List[TextTrajectoryChain]:
    """Optimal/random mixture on the walls-only env; whole rolling window
    per step (non-Markov: position must be inferred from move history)."""
    from lmrl_gym_torch.envs.maze.grids import ACTION_STRS, double_t_maze, maze_solver

    maze = double_t_maze()
    solver = maze_solver(maze, (8, 6))
    rng = random.Random(seed)
    env = build_maze_partial_env()
    chains = []
    for i in range(n):
        obs = env.reset(seed=seed * 100003 + i)
        steps = []
        done = False
        while not done and len(steps) < 40:
            if rng.random() < p_optimal and tuple(env.position) in solver:
                action = solver[tuple(env.position)]
            else:
                action = rng.choice(ACTION_STRS)
            history = obs + (Text(action, True),)
            new_obs, reward, done = env.step(history)
            steps.append((history[0].text, action, reward, done))
            obs = new_obs
        if not done:
            steps[-1] = steps[-1][:3] + (True,)
        chains.append(_chain_from_markov_steps(steps))
    return chains


# ---------------- text-nav ----------------


def build_text_nav_env(display_location: bool = True, max_steps: int = 30) -> TextEnv:
    from lmrl_gym_torch.envs.text_nav.env import TextNavEnv

    return TextNavEnv(display_location=display_location, max_steps=max_steps)


def generate_text_nav_chains(n: int, seed: int, known_rooms: Optional[List[str]] = None) -> List[TextTrajectoryChain]:
    """PartialWalkthroughAgent rollouts; whole conversation in one window,
    windowed to the last (obs, action) pair per step for Markov training."""
    from lmrl_gym_torch.envs.text_nav.env import (
        PartialWalkthroughAgent,
        ROOMS,
        TextNavEnv,
    )

    rng = random.Random(seed)
    chains = []
    for i in range(n):
        env = TextNavEnv(display_location=True, max_steps=30)
        agent = PartialWalkthroughAgent(
            env, known_rooms=known_rooms or ROOMS[:5], rng=rng
        )
        history = env.reset(seed=seed * 7919 + i)
        steps = []
        done = False
        while not done:
            acted = agent.act(history)
            new_history, reward, done = env.step(acted)
            steps.append((acted[-2].text, acted[-1].text, float(reward), bool(done)))
            history = new_history
        chains.append(_chain_from_markov_steps(steps))
    return chains


# ---------------- chess endgames ----------------


def build_chess_endgame_env(pieces: str = "kQK", max_moves: int = 50) -> TextEnv:
    from lmrl_gym_torch.envs.chess.env import FenChessEnv, large_piece_random_endgame

    return FenChessEnv(from_position=large_piece_random_endgame(pieces, rng=random.Random(0)), max_moves=max_moves)


def generate_chess_endgame_chains(n: int, seed: int, pieces: str = "kQK") -> List[TextTrajectoryChain]:
    from lmrl_gym_torch.envs.chess.data import generate_selfplay_games
    from lmrl_gym_torch.envs.chess.env import large_piece_random_endgame

    return generate_selfplay_games(
        n,
        from_position_fn=lambda rng: large_piece_random_endgame(pieces, rng=rng),
        agent_elo=2000,
        opponent_elo=1200,
        max_moves=50,
        seed=seed,
    )


# ---------------- chess (full game) ----------------


def build_chess_env(max_moves: int = 100, opponent_elo: int = 1200) -> TextEnv:
    """Full chess from the standard start against the engine opponent
    (reference FenChessHistoryEnv over full games, chess/env/env.py:218-244)."""
    from lmrl_gym_torch.envs.chess.env import FenChessEnv

    return FenChessEnv(max_moves=max_moves, opponent_elo=opponent_elo)


def generate_chess_chains(n: int, seed: int) -> List[TextTrajectoryChain]:
    from lmrl_gym_torch.envs.chess.data import generate_selfplay_games

    return generate_selfplay_games(n, from_position_fn=None, agent_elo=2000, opponent_elo=1200, max_moves=60,
                                   seed=seed)


# ---------------- twenty questions ----------------


class HeuristicAskerPolicy(TextPolicy):
    """Category-elimination asker for data generation: asks category
    questions, then guesses members of the confirmed category."""

    def __init__(self, rng: Optional[random.Random] = None):
        from lmrl_gym_torch.envs.twenty_questions.data import DEFAULT_OBJECT_DICT

        self.rng = rng or random.Random()
        self.categories = list(DEFAULT_OBJECT_DICT.keys())
        self.object_dict = DEFAULT_OBJECT_DICT
        self.category_questions = {
            "Animals": "Is it an animal?",
            "Fruits": "Is it a fruit?",
            "Vegetables": "Is it a vegetable?",
            "Vehicles": "Is it a vehicle?",
            "Clothes": "Is it clothing?",
            "Electronics": "Is it an electronic device?",
            "Musical Instruments": "Is it a musical instrument?",
            "Furniture": "Is it furniture?",
            "Sports": "Is it a sport?",
            "Kitchen Tools": "Is it a kitchen utensil?",
            "Tools": "Is it a tool?",
            "Toys": "Is it a toy?",
            "Jewelry": "Is it jewelry?",
            "Nature": "Is it nature?",
            "Art": "Is it art?",
            "Office Supplies": "Is it an office supply?",
            "Garden Supplies": "Is it a garden tool?",
        }

    def act(self, text_history: TextHistory) -> TextHistory:
        # parse conversation: [init, q, a, q, a, ...]
        qa = [(text_history[i].text.strip(), text_history[i + 1].text.strip())
              for i in range(1, len(text_history) - 1, 2)]
        confirmed = None
        asked = set()
        guessed = set()
        for q, a in qa:
            asked.add(q)
            for category, cq in self.category_questions.items():
                if q == cq and a == "Yes.":
                    confirmed = category
            if q.startswith("Is it a ") or q.startswith("Is it an "):
                guessed.add(q)
        if confirmed is None:
            order = sorted(self.category_questions.values())
            self.rng.shuffle(order)
            for cq in order:
                if cq not in asked:
                    return text_history + (Text(cq + "\n", True),)
            confirmed = self.rng.choice(self.categories)
        # guess members
        members = []
        for entry in self.object_dict[confirmed]:
            members.append(entry.split(";")[0])
        self.rng.shuffle(members)
        for m in members:
            article = "an" if m[0].lower() in "aeiou" else "a"
            q = f"Is it {article} {m.lower()}?"
            if q not in guessed:
                return text_history + (Text(q + "\n", True),)
        return text_history + (Text("Is it a mystery?\n", True),)


def build_twenty_questions_env(max_conversation_length: int = 20) -> TextEnv:
    from lmrl_gym_torch.envs.twenty_questions.data import get_default_word_list
    from lmrl_gym_torch.envs.twenty_questions.env import TwentyQuestionsEnv
    from lmrl_gym_torch.envs.twenty_questions.oracle import ScriptedOracle

    return TwentyQuestionsEnv(
        ScriptedOracle(), get_default_word_list(), max_conversation_length
    )


def generate_twenty_questions_chains(n: int, seed: int) -> List[TextTrajectoryChain]:
    env = build_twenty_questions_env()
    rng = random.Random(seed)
    chains = []
    for i in range(n):
        policy = HeuristicAskerPolicy(rng=rng)
        from lmrl_gym_torch.envs.base import interact_environment

        transitions = interact_environment(env, policy, env_seed=seed * 104729 + i)[0]
        chains.append(transitions_to_chain(transitions))
    return chains


# ---------------- guess city ----------------


def build_guess_city_env(max_conversation_length: int = 20) -> TextEnv:
    from lmrl_gym_torch.envs.guess_city.data import get_default_word_list
    from lmrl_gym_torch.envs.guess_city.env import GuessCityEnv, ScriptedGuessCityOracle

    return GuessCityEnv(
        ScriptedGuessCityOracle(), get_default_word_list(), max_conversation_length
    )


class HeuristicCityAskerPolicy(TextPolicy):
    def __init__(self, rng: Optional[random.Random] = None):
        from lmrl_gym_torch.envs.guess_city.data import DEFAULT_CITIES

        self.rng = rng or random.Random()
        self.cities = DEFAULT_CITIES
        self.continent_questions = [
            "Is it in Europe?", "Is it in Asia?", "Is it in America?",
            "Is it in Africa?", "Is it in Oceania?",
        ]

    def act(self, text_history: TextHistory) -> TextHistory:
        qa = [(text_history[i].text.strip(), text_history[i + 1].text.strip())
              for i in range(1, len(text_history) - 1, 2)]
        asked = {q for q, _ in qa}
        for cq in self.continent_questions:
            if cq not in asked:
                return text_history + (Text(cq + "\n", True),)
        candidates = [c.split(",")[0] for c in self.cities]
        self.rng.shuffle(candidates)
        for name in candidates:
            q = f"Is it {name}?"
            if q not in asked:
                return text_history + (Text(q + "\n", True),)
        return text_history + (Text("Is it Atlantis?\n", True),)


def generate_guess_city_chains(n: int, seed: int) -> List[TextTrajectoryChain]:
    env = build_guess_city_env()
    rng = random.Random(seed)
    from lmrl_gym_torch.envs.base import interact_environment

    chains = []
    for i in range(n):
        policy = HeuristicCityAskerPolicy(rng=rng)
        transitions = interact_environment(env, policy, env_seed=seed * 15485863 + i)[0]
        chains.append(transitions_to_chain(transitions))
    return chains


# ---------------- car dealer ----------------


def build_car_dealer_env(max_conversation_length: int = 50) -> TextEnv:
    from lmrl_gym_torch.envs.car_dealer.env import CarDealerEnv, ScriptedBuyerPolicy

    return CarDealerEnv(
        buyer_factory=lambda info: ScriptedBuyerPolicy(info, patience=4),
        max_conversation_length=max_conversation_length,
    )


class ScriptedSellerPolicy(TextPolicy):
    """Data-gen seller: pitches, then offers a price ladder."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng or random.Random()

    def act(self, text_history: TextHistory) -> TextHistory:
        n_turns = sum(1 for t in text_history if t.is_action)
        base = self.rng.choice([20000, 35000, 55000, 75000])
        price = int(base * (0.9 ** n_turns))
        if n_turns == 0:
            line = "Welcome! We have excellent cars on the lot today.\n"
        else:
            line = f"I can offer this one for ${price:,}. It's a great deal.\n"
        return text_history + (Text(line, True),)


def generate_car_dealer_chains(n: int, seed: int) -> List[TextTrajectoryChain]:
    from lmrl_gym_torch.envs.base import interact_environment

    env = build_car_dealer_env()
    rng = random.Random(seed)
    chains = []
    for i in range(n):
        policy = ScriptedSellerPolicy(rng=rng)
        transitions = interact_environment(env, policy, env_seed=seed * 32452843 + i)[0]
        chains.append(transitions_to_chain(transitions))
    return chains


TASKS: Dict[str, Task] = {
    "maze": Task("maze", build_maze_env, generate_maze_chains, max_length=192),
    "maze_partial": Task(
        "maze_partial", build_maze_partial_env, generate_maze_partial_chains, max_length=384
    ),
    "wordle": Task("wordle", build_wordle_env, generate_wordle_chains, max_length=160),
    "chess": Task("chess", build_chess_env, generate_chess_chains, max_length=160),
    "chess_endgames": Task("chess_endgames", build_chess_endgame_env, generate_chess_endgame_chains, max_length=160),
    "text_nav": Task("text_nav", build_text_nav_env, generate_text_nav_chains, max_length=512),
    "text_nav_partial": Task(
        "text_nav_partial",
        lambda **kw: build_text_nav_env(display_location=False, **kw),
        generate_text_nav_chains,
        max_length=512,
    ),
    "twenty_questions": Task(
        "twenty_questions",
        build_twenty_questions_env,
        generate_twenty_questions_chains,
        max_length=1024,
    ),
    "guess_city": Task(
        "guess_city", build_guess_city_env, generate_guess_city_chains, max_length=1024
    ),
    "car_dealer": Task(
        "car_dealer", build_car_dealer_env, generate_car_dealer_chains, max_length=1024
    ),
}
