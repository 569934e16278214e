"""Chess text environments: the port of `lmrl_gym_tpu/envs/chess/env.py`
(reference llm_rl_scripts/chess/env/env.py), on the port's own engine
binding (`envs/chess/engine.py`).

Text protocol: FEN states and SAN moves spelled character-by-character
(env.py:13-26). Step semantics (env.py:91-140): illegal SAN → reward −1,
episode continues, board unchanged; legal move → engine opponent replies;
agent checkmate +1, loss −1, draw/ongoing 0. The opponent is the native
chesscore engine at an Elo handicap (default 1200, matching the
reference's Stockfish setting) or a uniform random mover.
"""
from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from lmrl_gym_torch.envs.base import (
    BatchedTextPolicy,
    TextEnv,
    TextPolicy,
    interact_environment,
)
from lmrl_gym_torch.envs.chess.engine import (
    Board,
    CHECKMATE,
    ONGOING,
    STARTING_FEN,
    best_move_san,
    random_move_san,
    validate_fen,
)
from lmrl_gym_torch.text.frames import Text, TextHistory


def preprocess_move(move: str) -> str:
    return " ".join(move) + "\n"


def postprocess_move(move: str) -> str:
    return move.replace(" ", "").strip()


def preprocess_state(state: str) -> str:
    return " ".join(state) + "\n"


def preprocess_state_og(state: str) -> str:
    return " ".join(state)


def postprocess_state(state: str) -> str:
    return state.replace("  ", "__temp__").replace(" ", "").replace("__temp__", " ").strip()


class ChessGame:
    """Core game vs engine opponent (reference ChessEnv, env.py:28-184).

    The agent always plays the side to move in `from_position` (the
    reference asserts white)."""

    def __init__(
        self,
        from_position: Optional[str] = None,
        opponent_elo: int = 1200,
        random_opponent: bool = False,
        rng: Optional[random.Random] = None,
    ):
        self.starting_position = from_position or STARTING_FEN
        self.opponent_elo = opponent_elo
        self.random_opponent = random_opponent
        self.rng = rng or random.Random()
        self.reset()

    def reset(self) -> Tuple[str, Dict]:
        self.board = Board(self.starting_position)
        return self.starting_position, {}

    def step(self, action_san: str) -> Tuple[str, float, bool, Dict]:
        """→ (fen, reward, done, info). Mirrors env.py:91-140."""
        legal = self.board.push_san(action_san)
        if not legal:
            # illegal: reward −1, game continues, board unchanged
            return self.board.fen, -1.0, False, {"opponent move": None}

        state = self.board.game_state()
        if state != ONGOING:
            # game ended on the agent's move: +1 only for checkmate
            reward = 1.0 if state == CHECKMATE else 0.0
            return self.board.fen, reward, True, {"opponent move": None}

        # opponent reply
        seed = self.rng.getrandbits(63)
        if self.random_opponent:
            opp = random_move_san(self.board.fen, seed=seed)
        else:
            opp = best_move_san(self.board.fen, elo=self.opponent_elo, seed=seed)
        assert opp is not None
        pushed = self.board.push_san(opp)
        assert pushed, f"engine produced illegal move {opp}"

        state = self.board.game_state()
        reward = -1.0 if state == CHECKMATE else 0.0
        done = state != ONGOING
        return self.board.fen, reward, done, {"opponent move": opp}


class FenChessEnv(TextEnv):
    """Markov FEN env: each observation is ONLY the current FEN, spelled
    char-by-char (reference FenChessHistoryEnv, env.py:218-244)."""

    def __init__(
        self,
        max_moves: int = 400,
        from_position: Optional[str] = None,
        opponent_elo: int = 1200,
        random_opponent: bool = False,
    ):
        self.max_moves = max_moves
        self.from_position = from_position
        self.opponent_elo = opponent_elo
        self.random_opponent = random_opponent
        self.rng = random.Random()
        self.game: Optional[ChessGame] = None

    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None) -> TextHistory:
        self.rng = random.Random(seed)
        self.game = ChessGame(
            from_position=self.from_position,
            opponent_elo=self.opponent_elo,
            random_opponent=self.random_opponent,
            rng=self.rng,
        )
        self.num_moves = 0
        fen, _ = self.game.reset()
        return (Text(preprocess_state_og(fen), False),)

    def step(self, text_history: TextHistory) -> Tuple[TextHistory, float, bool]:
        assert text_history[-1].is_action
        action = postprocess_move(text_history[-1].text)
        fen, reward, done, _ = self.game.step(action)
        self.num_moves += 1
        if self.num_moves > self.max_moves:
            done = True
        return (Text(preprocess_state_og(fen), False),), reward, bool(done)

    def copy(self) -> "FenChessEnv":
        return FenChessEnv(
            self.max_moves, self.from_position, self.opponent_elo, self.random_opponent
        )


class FenChessSingleTurnEnv(TextEnv):
    """Single-turn variant with a fixed prompt prefix (reference
    FenChessHistoryEnvSingleTurn, env.py:190-216)."""

    def __init__(
        self,
        initial_history: TextHistory = (),
        max_moves: int = 400,
        from_position: Optional[str] = None,
        opponent_elo: int = 1200,
    ):
        self.initial_history = initial_history
        self.max_moves = max_moves
        self.from_position = from_position
        self.opponent_elo = opponent_elo
        self.game: Optional[ChessGame] = None

    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None) -> TextHistory:
        self.game = ChessGame(
            from_position=self.from_position,
            opponent_elo=self.opponent_elo,
            rng=random.Random(seed),
        )
        self.num_moves = 0
        fen, _ = self.game.reset()
        return self.initial_history + (Text(preprocess_state(fen), False),)

    def step(self, text_history: TextHistory) -> Tuple[TextHistory, float, bool]:
        assert text_history[-1].is_action
        action = postprocess_move(text_history[-1].text)
        fen, reward, done, _ = self.game.step(action)
        self.num_moves += 1
        if self.num_moves > self.max_moves:
            done = True
        return (
            self.initial_history + (Text(preprocess_state(fen), False),),
            reward,
            bool(done),
        )

    def copy(self) -> "FenChessSingleTurnEnv":
        return FenChessSingleTurnEnv(
            self.initial_history, self.max_moves, self.from_position, self.opponent_elo
        )


def large_piece_random_endgame(pieces: str, rng: Optional[random.Random] = None) -> str:
    """Rejection-sample a valid non-check endgame FEN from a piece string
    like 'kQK' (reference env.py:246-260). Lowercase = black, white to move."""
    rng = rng or random.Random()
    while True:
        board = [["" for _ in range(8)] for _ in range(8)]
        squares = list(range(64))
        for piece in pieces:
            sq = rng.choice(squares)
            squares.remove(sq)
            board[sq // 8][sq % 8] = piece
        rows = []
        for rank in range(7, -1, -1):
            row, empty = "", 0
            for f in range(8):
                p = board[rank][f]
                if not p:
                    empty += 1
                else:
                    if empty:
                        row += str(empty)
                        empty = 0
                    row += p
            if empty:
                row += str(empty)
            rows.append(row)
        fen = "/".join(rows) + " w - - 0 1"
        if not validate_fen(fen):
            continue
        b = Board(fen)
        # valid = both kings present, white to move, nobody in check,
        # black king not attackable immediately (mirrors board.is_valid()
        # + not board.is_check())
        if b.in_check():
            continue
        # black king must not be capturable (i.e. black not in check while
        # it's white's move): flip side to test
        flip = fen.replace(" w ", " b ")
        if validate_fen(flip) and Board(flip).in_check():
            continue
        if b.legal_moves_san():
            return fen


def text_env_eval_chess_positions(
    positions: List[str],
    policy: Union[TextPolicy, BatchedTextPolicy],
    n_rollouts: int,
    seed_generator: Optional[Iterator[int]] = None,
    bsize: int = 1,
    random_opponent: bool = False,
    max_moves: int = 400,
    opponent_elo: int = 1200,
    interaction_callback=None,
):
    """Positional eval harness with victories / %-illegal / episode-length
    metrics (reference env.py:262-345)."""
    interactions, rewards, dones = [], [], []
    victories, percent_illegals, episode_lengths = [], [], []
    for position in positions:
        env = FenChessEnv(
            from_position=position,
            random_opponent=random_opponent,
            max_moves=max_moves,
            opponent_elo=opponent_elo,
        )
        env_interactions = []
        while len(env_interactions) < n_rollouts:
            actual = min(n_rollouts - len(env_interactions), bsize)
            batch = interact_environment(
                env,
                policy,
                env_seed=[None] * actual
                if seed_generator is None
                else [next(seed_generator) for _ in range(actual)],
                bsize=actual,
                npad=bsize - actual,
            )
            for rollout in batch:
                env_interactions.append(rollout)
                rs = [t.reward for t in rollout]
                victories.append(1 if 1 in rs else 0)
                num_illegal = sum(
                    1
                    for i, t in enumerate(rollout)
                    if t.reward == -1 and i < len(rs) - 1
                )
                percent_illegals.append(num_illegal / len(rs) * 100)
                episode_lengths.append(len(rs))
                rewards.append(sum(rs))
                dones.append(rollout[-1].done)
                if interaction_callback is not None:
                    interaction_callback(rollout)
        interactions.extend(env_interactions)

    def summary(a):
        a = np.asarray(a, np.float32)
        return dict(mean=float(a.mean()), std=float(a.std()), min=float(a.min()), max=float(a.max()))

    return interactions, dict(
        reward=summary(rewards),
        done=summary(dones),
        victories=summary(victories),
        percent_illegals=summary(percent_illegals),
        episode_length=summary(episode_lengths),
    )
