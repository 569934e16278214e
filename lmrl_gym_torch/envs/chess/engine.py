"""ctypes binding for the native chess core (`native/chess/chesscore.cpp`):
the port's own, with the API of `lmrl_gym_tpu/envs/chess/engine.py`.

The core fills the roles of python-chess (rules, SAN, FEN) and the
reference's Stockfish opponent in one C++ library. This module builds it
from the repository's source at first use, with
`g++ -O2 -std=c++17 -shared -fPIC`, into the git-ignored `build/chess/`
beside the package. The file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library never loads; the
build writes a temporary file and renames it into place, so processes that
race on the first build each see a whole library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
SRC_PATH = os.path.join(_REPO_DIR, "native", "chess", "chesscore.cpp")
BUILD_DIR = os.path.join(_REPO_DIR, "build", "chess")
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

STARTING_FEN = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"

# game states (chesscore.cpp GameState)
ONGOING, CHECKMATE, STALEMATE, DRAW_50, DRAW_MATERIAL = 0, 1, 2, 3, 4

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256()
    with open(SRC_PATH, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libchesscore-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is not built yet; returns its path."""
    out = library_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        subprocess.check_call(["g++", *CXX_FLAGS, SRC_PATH, "-o", tmp])
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.cc_validate_fen.argtypes = [ctypes.c_char_p]
        lib.cc_legal_moves.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.cc_push_san.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.cc_game_state.argtypes = [ctypes.c_char_p]
        lib.cc_in_check.argtypes = [ctypes.c_char_p]
        lib.cc_zobrist.argtypes = [ctypes.c_char_p]
        lib.cc_zobrist.restype = ctypes.c_uint64
        lib.cc_best_move.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.cc_random_move.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int]
        lib.cc_perft.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.cc_perft.restype = ctypes.c_long
        _lib = lib
        return lib


def validate_fen(fen: str) -> bool:
    return bool(get_lib().cc_validate_fen(fen.encode()))


class Board:
    """A minimal python-chess-like board over the native core: a FEN
    string plus a zobrist history for the fivefold-repetition draw."""

    def __init__(self, fen: str = STARTING_FEN):
        lib = get_lib()
        if not lib.cc_validate_fen(fen.encode()):
            raise ValueError(f"invalid FEN: {fen}")
        self.fen = fen
        self._history = [lib.cc_zobrist(fen.encode())]

    @property
    def turn_white(self) -> bool:
        return self.fen.split()[1] == "w"

    def legal_moves_san(self) -> List[str]:
        buf = ctypes.create_string_buffer(16384)
        n = get_lib().cc_legal_moves(self.fen.encode(), buf, len(buf))
        if n < 0:
            raise RuntimeError(f"legal_moves failed: {n}")
        s = buf.value.decode()
        return s.split() if s else []

    def push_san(self, san: str) -> bool:
        """Apply a SAN move; False (board unchanged) if it is illegal."""
        lib = get_lib()
        out = ctypes.create_string_buffer(128)
        if lib.cc_push_san(self.fen.encode(), san.encode(), out) != 0:
            return False
        self.fen = out.value.decode()
        self._history.append(lib.cc_zobrist(self.fen.encode()))
        return True

    def game_state(self) -> int:
        state = get_lib().cc_game_state(self.fen.encode())
        if state == ONGOING and self._history.count(self._history[-1]) >= 5:
            return DRAW_50  # fivefold repetition: an automatic draw
        return state

    def is_game_over(self) -> bool:
        return self.game_state() != ONGOING

    def is_checkmate(self) -> bool:
        return self.game_state() == CHECKMATE

    def in_check(self) -> bool:
        return bool(get_lib().cc_in_check(self.fen.encode()))

    def copy(self) -> "Board":
        b = Board.__new__(Board)
        b.fen = self.fen
        b._history = list(self._history)
        return b


def best_move_san(fen: str, elo: int = 1200, node_budget: int = 200_000, seed: int = 0) -> Optional[str]:
    """The engine's reply at an Elo handicap (the reference's Stockfish
    opponent ran at UCI_Elo 1200)."""
    out = ctypes.create_string_buffer(32)
    if get_lib().cc_best_move(fen.encode(), elo, node_budget, seed, out, len(out)) != 0:
        return None
    return out.value.decode()


def random_move_san(fen: str, seed: int = 0) -> Optional[str]:
    out = ctypes.create_string_buffer(32)
    if get_lib().cc_random_move(fen.encode(), seed, out, len(out)) != 0:
        return None
    return out.value.decode()


def perft(fen: str, depth: int) -> int:
    return get_lib().cc_perft(fen.encode(), depth)


class EnginePool:
    """Batched engine calls for vectorized stepping: ctypes releases the
    GIL for each native search, so a thread pool runs a batch of positions
    in parallel."""

    def __init__(self, workers: int = 8, elo: int = 1200, node_budget: int = 200_000):
        from concurrent.futures import ThreadPoolExecutor

        get_lib()  # build and load once, before the threads
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self.elo = elo
        self.node_budget = node_budget

    def best_moves(self, fens, seeds=None):
        """[fen, ...] → [san | None, ...], searched concurrently."""
        if seeds is None:
            seeds = range(len(fens))
        futs = [self._pool.submit(best_move_san, f, self.elo, self.node_budget, s) for f, s in zip(fens, seeds)]
        return [f.result() for f in futs]

    def close(self) -> None:
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
