"""The port's chess anchor (`lmrl_gym_torch/scripts/chess_anchor.py`, on the
port's own engine binding) against the JAX package's recorded table,
`tests/goldens/chess_anchor.json` (written by `scripts/chess_anchor.py`).

On a subset small enough for a few seconds: the classification of the
first 10 random positions (its buckets are prefixes of the recorded
ones), each recorded position's mate depth by `wins_in` /
`move_forces_mate`, every level's mate-in-1/2/3 solve rate over the
recorded positions, and the win rate against the random opponent at the
two lowest levels (the higher levels' games take tens of seconds).
"""
import json
import os

import pytest

from lmrl_gym_torch.scripts import chess_anchor as anchor

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "chess_anchor.json")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_classification_prefix(golden):
    buckets = anchor.classify_positions(max_tries=10)
    assert sum(len(v) for v in buckets.values()) > 0
    for depth, fens in buckets.items():
        assert fens == golden["positions"][str(depth)][: len(fens)], depth


def test_recorded_positions_mate_depths(golden):
    for depth in (1, 2, 3):
        for fen in golden["positions"][str(depth)][:3]:
            assert anchor.wins_in(fen, depth), (depth, fen)
            assert not anchor.wins_in(fen, depth - 1), (depth, fen)
            assert anchor.is_mate_in_1(fen) == (depth == 1)


@pytest.mark.parametrize("elo", anchor.LEVELS)
def test_solve_rates(elo, golden):
    row = next(r for r in golden["levels"] if r["elo"] == elo)
    for depth in (1, 2, 3):
        assert anchor.solve_rate(golden["positions"][str(depth)], depth, elo) == row[f"mate{depth}"], depth


@pytest.mark.parametrize("elo", [800, 1200])
def test_win_rate_vs_random(elo, golden):
    row = next(r for r in golden["levels"] if r["elo"] == elo)
    assert anchor.win_rate_vs_random(elo) == row["win_vs_random"]
    assert golden["pinned"] == anchor.PINNED
