"""The port's host chess side — its own engine binding (`envs/chess/
engine.py`), the text envs (`envs/chess/env.py`), the data builders
(`envs/chess/data.py`) and the chess task builders of `cli/tasks.py` —
against the JAX package's on the same FENs and seeds, and the JAX
package's chess goldens replayed through the port. Everything must be
identical (tolerance 0)."""
import json
import os
import random

import pytest

from lmrl_gym_tpu.cli import tasks as jtasks
from lmrl_gym_tpu.envs.chess import engine as jengine
from lmrl_gym_tpu.envs.chess import env as jenv
from lmrl_gym_torch.cli import tasks as ttasks
from lmrl_gym_torch.envs.chess import data as tdata
from lmrl_gym_torch.envs.chess import engine as tengine
from lmrl_gym_torch.envs.chess import env as tenv

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
FENS = [
    tengine.STARTING_FEN,
    "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1",  # kiwipete
    "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1",
    "7k/8/5K2/8/8/8/8/6Q1 w - - 0 1",  # mate in one
    "8/8/8/4k3/8/8/4Q3/4K3 w - - 0 1",
    "7k/5Q2/6K1/8/8/8/8/8 b - - 0 1",  # stalemate
]


def _chain(c):
    return [(tuple((x.text, x.is_action) for x in tt.text_history), tt.reward, tt.done) for tt in c.to_list()]


def test_library_builds_from_the_repo_source_into_build():
    path = tengine.library_path()
    assert os.path.dirname(path) == tengine.BUILD_DIR and os.path.basename(tengine.SRC_PATH) == "chesscore.cpp"
    tengine.get_lib()
    assert os.path.exists(path) and "lmrl_gym_tpu" not in path
    assert tengine.get_lib()._name == path


@pytest.mark.parametrize("fen", FENS)
def test_engine_calls_match(fen):
    jb, tb = jengine.Board(fen), tengine.Board(fen)
    assert tb.legal_moves_san() == jb.legal_moves_san()
    assert tb.game_state() == jb.game_state() and tb.in_check() == jb.in_check()
    assert tengine.perft(fen, 2) == jengine.perft(fen, 2)
    for seed in (0, 7):
        assert tengine.random_move_san(fen, seed) == jengine.random_move_san(fen, seed)
        assert tengine.best_move_san(fen, elo=1200, node_budget=2000, seed=seed) == \
            jengine.best_move_san(fen, elo=1200, node_budget=2000, seed=seed)
    for san in (tb.legal_moves_san() + ["Qz9", "O-O", "e4"])[:12]:
        j2, t2 = jb.copy(), tb.copy()
        assert t2.push_san(san) == j2.push_san(san)
        assert t2.fen == j2.fen and t2.game_state() == j2.game_state()
    for f in (fen, "8/8/8 w - - 0 1", "k7/8/8/8/8/8/8/7K x - - 0 1"):
        assert tengine.validate_fen(f) == bool(jengine.get_lib().cc_validate_fen(f.encode()))
    with tengine.EnginePool(workers=2, node_budget=2000) as pool:
        assert pool.best_moves([fen, fen], [1, 2]) == [
            jengine.best_move_san(fen, 1200, 2000, 1), jengine.best_move_san(fen, 1200, 2000, 2)]


def test_perft_depth_three():
    assert tengine.perft(tengine.STARTING_FEN, 3) == 8902


def test_chess_text_goldens():
    with open(os.path.join(GOLDENS, "chess_text.json")) as f:
        cases = json.load(f)
    for name, table in cases.items():
        for arg, want in table.items():
            assert getattr(tenv, name)(arg) == want, (name, arg)


def test_chess_game_goldens():
    """The JAX package's fixed-seed random-opponent games replay move for
    move through the port's ChessGame."""
    with open(os.path.join(GOLDENS, "chess_game.json")) as f:
        games = json.load(f)
    for g in games:
        game = tenv.ChessGame(from_position=None if g["start"].startswith("rnbqkbnr") else g["start"],
                              random_opponent=True, rng=random.Random(g["seed"]))
        fen, _ = game.reset()
        assert fen == g["start"]
        for s in g["steps"]:
            new_fen, reward, done, info = game.step(s["action"])
            assert (new_fen, reward, done, info.get("opponent move")) == (s["fen"], s["reward"], s["done"],
                                                                          s["opponent"])


def test_chess_san_vectors():
    with open(os.path.join(GOLDENS, "chess_san_vectors.json")) as f:
        vectors = json.load(f)
    states = {name: getattr(tengine, name) for name in ("ONGOING", "CHECKMATE", "STALEMATE", "DRAW_50",
                                                        "DRAW_MATERIAL")}
    for vec in vectors["positions"]:
        board = tengine.Board(vec["fen"])
        sans = board.legal_moves_san()
        assert sans == jengine.Board(vec["fen"]).legal_moves_san()
        if "legal_count" in vec:
            assert len(sans) == vec["legal_count"]
        if "legal_sans" in vec:
            assert sorted(sans) == sorted(vec["legal_sans"])
        assert all(s in sans for s in vec.get("contains", ())) and not any(s in sans for s in vec.get("excludes", ()))
        if "in_check" in vec:
            assert board.in_check() == vec["in_check"]
        if "game_state" in vec:
            assert board.game_state() == states[vec["game_state"]]
    for seq in vectors["sequences"]:
        board = tengine.Board()
        for san in seq["moves"]:
            assert board.push_san(san), san
        if "final_board" in seq:
            assert board.fen.split()[:2] == [seq["final_board"], seq["final_side"]]
        assert board.game_state() == states[seq["final_state"]]


def test_text_envs_and_endgame_sampler_match():
    for seed in (0, 3):
        a = jenv.large_piece_random_endgame("kQK", random.Random(seed))
        assert tenv.large_piece_random_endgame("kQK", random.Random(seed)) == a
        assert tenv.large_piece_random_endgame("kRK", random.Random(seed)) == \
            jenv.large_piece_random_endgame("kRK", random.Random(seed))
    start = jenv.large_piece_random_endgame("kQK", random.Random(1))
    rng = random.Random(9)
    for cls in ("FenChessEnv", "FenChessSingleTurnEnv"):
        je, te = getattr(jenv, cls)(from_position=start, max_moves=6), getattr(tenv, cls)(from_position=start,
                                                                                           max_moves=6)
        jh, th = je.reset(seed=4), te.reset(seed=4)
        assert [(x.text, x.is_action) for x in th] == [(x.text, x.is_action) for x in jh]
        for _ in range(8):
            moves = tengine.Board(te.game.board.fen).legal_moves_san() + ["Qz9"]
            move = tenv.preprocess_move(rng.choice(moves))
            jh, jr, jd = je.step(jh + (type(jh[0])(move, True),))
            th, tr, td = te.step(th + (type(th[0])(move, True),))
            assert [(x.text, x.is_action) for x in th] == [(x.text, x.is_action) for x in jh] and (tr, td) == (jr, jd)
            if td:
                break


def test_task_builders_and_data_match(monkeypatch):
    """The builders' chains for one seed; both packages' engine searches
    are cut to 2,000 nodes (a full search takes seconds per move)."""
    from lmrl_gym_tpu.envs.chess import data as jdata

    for mod, eng in ((jdata, jengine), (jenv, jengine), (tdata, tengine), (tenv, tengine)):
        search = eng.best_move_san
        monkeypatch.setattr(mod, "best_move_san", lambda fen, elo=1200, node_budget=0, seed=0, _s=search:
                            _s(fen, elo, 2000, seed))
    j, t = jtasks.build_chess_endgame_env(), ttasks.build_chess_endgame_env()
    assert t.from_position == j.from_position and t.max_moves == j.max_moves
    assert ttasks.build_chess_env().max_moves == jtasks.build_chess_env().max_moves
    for jc, tc in ((jtasks.generate_chess_endgame_chains(2, seed=3), ttasks.generate_chess_endgame_chains(2, seed=3)),
                   (jtasks.generate_chess_chains(1, seed=5), ttasks.generate_chess_chains(1, seed=5))):
        assert len(jc) == len(tc) > 0
        assert [_chain(c) for c in tc] == [_chain(c) for c in jc]
    lines = [json.dumps(dict(from_state=f, action="Kb1", reward=0.0, done=i == 2)) for i, f in enumerate(FENS[:3])]
    assert [_chain(c) for c in tdata.chains_from_jsonl(lines + [""] + lines)] == \
        [_chain(c) for c in jdata.chains_from_jsonl(lines + [""] + lines)]
