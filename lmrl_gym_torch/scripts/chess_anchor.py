"""Anchor the native chess opponent's Elo-handicap scale: the port of
`scripts/chess_anchor.py`, on the port's own engine binding
(`lmrl_gym_torch/envs/chess/engine.py`). The reference pins Stockfish
UCI_Elo 1200 / 100 ms as a "beatable-but-nontrivial" opponent
(chess/env/env.py:54-56); the native engine's handicap is
depth/noise-based, so this harness records absolute anchors per level:

  - mate-in-1 / mate-in-2 / mate-in-3 solve rates over classified kQK
    positions (does the engine at that level play a forced-mate move?)
  - win rate playing white from random kQK endgames vs the uniform-random
    opponent over seeded games

    python -m lmrl_gym_torch.scripts.chess_anchor [--out anchor.json]

CPU only: it runs the host engine and nothing on the card. The JAX
package's table is `tests/goldens/chess_anchor.json`.
"""
from __future__ import annotations

import argparse
import json
import random

from lmrl_gym_torch.envs.chess.engine import CHECKMATE, ONGOING, Board, best_move_san, random_move_san
from lmrl_gym_torch.envs.chess.env import large_piece_random_endgame

LEVELS = [800, 1200, 1600, 2000, 2400]
PINNED = 1200  # the level chess task configs use (reference UCI_Elo 1200)


def is_mate_in_1(fen):
    b = Board(fen)
    for m in b.legal_moves_san():
        c = Board(fen)
        c.push_san(m)
        if c.game_state() == CHECKMATE:
            return True
    return False


def wins_in(fen, n):
    """White to move: does white have a forced mate in <= n moves?"""
    if n <= 0:
        return False
    b = Board(fen)
    for m in b.legal_moves_san():
        if move_forces_mate(fen, m, n):
            return True
    return False


def move_forces_mate(fen, move, n):
    c = Board(fen)
    assert c.push_san(move)
    gs = c.game_state()
    if gs == CHECKMATE:
        return True
    if gs != ONGOING or n <= 1:
        return False
    for r in c.legal_moves_san():
        d = c.copy()
        assert d.push_san(r)
        if d.game_state() != ONGOING:
            return False  # stalemate/draw escape
        if not wins_in(d.fen, n - 1):
            return False
    return True


def classify_positions(n_each=12, seed=0, max_tries=4000):
    """Collect kQK positions with forced mate in exactly 1, 2, 3 among the
    first `max_tries` random ones."""
    rng = random.Random(seed)
    buckets = {1: [], 2: [], 3: []}
    tries = 0
    while any(len(v) < n_each for v in buckets.values()) and tries < max_tries:
        tries += 1
        fen = large_piece_random_endgame("kQK", rng)
        if is_mate_in_1(fen):
            d = 1
        elif wins_in(fen, 2):
            d = 2
        elif wins_in(fen, 3):
            d = 3
        else:
            continue
        if len(buckets[d]) < n_each:
            buckets[d].append(fen)
    return buckets


def solve_rate(fens, depth_to_mate, elo):
    ok = 0
    for i, fen in enumerate(fens):
        mv = best_move_san(fen, elo=elo, seed=1234 + i)
        if mv is not None and move_forces_mate(fen, mv, depth_to_mate):
            ok += 1
    return ok / max(1, len(fens))


def win_rate_vs_random(elo, n_games=20, seed=0, max_plies=120):
    """Engine as white from random kQK starts vs uniform-random black."""
    wins = 0
    for g in range(n_games):
        rng = random.Random(seed * 1000 + g)
        fen = large_piece_random_endgame("kQK", rng)
        b = Board(fen)
        for ply in range(max_plies):
            if b.turn_white:
                mv = best_move_san(b.fen, elo=elo, seed=rng.getrandbits(63))
            else:
                mv = random_move_san(b.fen, seed=rng.getrandbits(63))
            if mv is None:
                break
            assert b.push_san(mv)
            gs = b.game_state()
            if gs == CHECKMATE:
                if not b.turn_white:  # white delivered mate
                    wins += 1
                break
            if gs != ONGOING:
                break
    return wins / n_games


def anchor_table(levels=LEVELS, n_each=12, n_games=20) -> dict:
    """The per-level table in the layout of `tests/goldens/chess_anchor.json`."""
    buckets = classify_positions(n_each)
    print(f"positions: m1={len(buckets[1])} m2={len(buckets[2])} m3={len(buckets[3])}")
    rows = []
    for elo in levels:
        row = dict(
            elo=elo,
            mate1=solve_rate(buckets[1], 1, elo),
            mate2=solve_rate(buckets[2], 2, elo),
            mate3=solve_rate(buckets[3], 3, elo),
            win_vs_random=win_rate_vs_random(elo, n_games),
        )
        rows.append(row)
        print(json.dumps(row))
    return dict(pinned=PINNED, levels=rows, positions={str(k): v for k, v in buckets.items()})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", type=str, default=None, help="write the table as JSON here")
    args = p.parse_args(argv)
    out = anchor_table()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
