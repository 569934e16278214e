"""Chess dataset construction: the port of `lmrl_gym_tpu/envs/chess/data.py`.

Parity with llm_rl_scripts/chess/env/data.py:83-151: games become
TextTrajectoryChains of single (state, action) windows — Markov in FEN —
with reward on the action and done on the last link. Also a self-play
generator (native engine both sides) replacing the reference's pre-
collected game dumps, since no dataset ships with this tree.
"""
from __future__ import annotations

import json
import random
from typing import Iterator, List, Optional, Tuple

from lmrl_gym_torch.envs.chess.engine import Board, STARTING_FEN, best_move_san, random_move_san
from lmrl_gym_torch.envs.chess.env import (
    ChessGame,
    preprocess_move,
    preprocess_state_og,
)
from lmrl_gym_torch.text.frames import Text, TextTrajectory, TextTrajectoryChain


def chain_from_steps(
    steps: List[Tuple[str, str, float, bool]],  # (fen, san, reward, done)
    scaling: float = 1.0,
) -> Optional[TextTrajectoryChain]:
    """[(state, action, reward, done)] → linked chain of 1-step windows."""
    chain = None
    for fen, san, reward, done in reversed(steps):
        chain = TextTrajectoryChain(
            TextTrajectory(
                (
                    Text(preprocess_state_og(fen), False),
                    Text(preprocess_move(san), True),
                ),
                (0.0, scaling * reward),
                done,
            ),
            chain,
        )
    return chain


def chains_from_jsonl(
    lines: List[str], scaling: float = 1.0, rng: Optional[random.Random] = None
) -> List[TextTrajectoryChain]:
    """Reference jsonl format: records with from_state/action/reward/done,
    games separated by empty lines, windows capped at 200 links
    (chess/env/data.py:83-117)."""
    chains = []
    idx = 0
    while idx < len(lines):
        steps = []
        done = False
        while not done and idx < len(lines):
            if lines[idx] == "":
                idx += 1
                break
            rec = json.loads(lines[idx])
            steps.append((rec["from_state"], rec["action"], rec["reward"], rec["done"]))
            done = rec["done"]
            idx += 1
            if len(steps) == 200:
                break
        if not steps:
            break
        chains.append(chain_from_steps(steps, scaling))
    if rng is not None:
        rng.shuffle(chains)
    return chains


def generate_selfplay_games(
    n_games: int,
    from_position_fn=None,
    agent_elo: int = 1600,
    opponent_elo: int = 1200,
    max_moves: int = 100,
    seed: int = 0,
) -> List[TextTrajectoryChain]:
    """Roll games of native-engine agent vs engine opponent and convert to
    chains — the in-repo replacement for the reference's GCS game dumps."""
    rng = random.Random(seed)
    chains = []
    for g in range(n_games):
        start = from_position_fn(rng) if from_position_fn else STARTING_FEN
        game = ChessGame(from_position=start, opponent_elo=opponent_elo, rng=rng)
        steps = []
        done = False
        for _ in range(max_moves):
            fen_before = game.board.fen
            mv = best_move_san(fen_before, elo=agent_elo, seed=rng.getrandbits(63))
            if mv is None:
                break
            _, reward, done, _ = game.step(mv)
            steps.append((fen_before, mv, reward, bool(done)))
            if done:
                break
        if steps:
            if not done:  # truncated: mark last step done for chain validity
                steps[-1] = steps[-1][:3] + (True,)
            chains.append(chain_from_steps(steps))
    return chains
