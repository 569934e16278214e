"""Maze grids + ground-truth optimal-move table: the port's copy of
`lmrl_gym_tpu/envs/maze/grids.py` (numpy only).

Grid data matches llm_rl_scripts/maze/env/mazes.py:6-58 (1 = wall,
0 = open). The optimal-direction table for the double-T maze
(mazes.py:20-48) is *derived* here from BFS rather than hardcoded, and
verified equal to the reference table in tests.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

import numpy as np

ACTION_STRS = ["move up\n", "move down\n", "move left\n", "move right\n"]
ACTION_DELTAS: Dict[str, Tuple[int, int]] = {
    "move up\n": (-1, 0),
    "move down\n": (1, 0),
    "move left\n": (0, -1),
    "move right\n": (0, 1),
}


def double_t_maze() -> np.ndarray:
    return np.array(
        [
            [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
            [1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1],
            [1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1],
            [1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1],
            [1, 1, 1, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1],
            [1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1],
            [1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1],
            [1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1],
            [1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1],
            [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        ],
        dtype=np.uint8,
    )


def maze2d_umaze() -> np.ndarray:
    return np.array(
        [
            [1, 1, 1, 1, 1],
            [1, 0, 0, 0, 1],
            [1, 0, 1, 0, 1],
            [1, 0, 1, 0, 1],
            [1, 1, 1, 1, 1],
        ],
        dtype=np.uint8,
    )


DOUBLE_T_GOAL = (8, 6)


def bfs_distances(maze: np.ndarray, goal: Tuple[int, int]) -> np.ndarray:
    """[H,W] step counts to goal through open cells; -1 unreachable."""
    H, W = maze.shape
    dist = np.full((H, W), -1, dtype=np.int32)
    dist[goal] = 0
    q = deque([goal])
    while q:
        y, x = q.popleft()
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ny, nx = y + dy, x + dx
            if 0 <= ny < H and 0 <= nx < W and maze[ny, nx] == 0 and dist[ny, nx] < 0:
                dist[ny, nx] = dist[y, x] + 1
                q.append((ny, nx))
    return dist


def optimal_actions(maze: np.ndarray, goal: Tuple[int, int]) -> Dict[Tuple[int, int], List[str]]:
    """Per open cell, the set of BFS-optimal action strings (possibly >1)."""
    dist = bfs_distances(maze, goal)
    out: Dict[Tuple[int, int], List[str]] = {}
    H, W = maze.shape
    for y in range(H):
        for x in range(W):
            if maze[y, x] != 0 or (y, x) == goal or dist[y, x] < 0:
                continue
            best: List[str] = []
            for action, (dy, dx) in ACTION_DELTAS.items():
                ny, nx = y + dy, x + dx
                if (
                    0 <= ny < H
                    and 0 <= nx < W
                    and maze[ny, nx] == 0
                    and dist[ny, nx] == dist[y, x] - 1
                ):
                    best.append(action)
            out[(y, x)] = best
    return out


def maze_solver(maze: np.ndarray, goal: Tuple[int, int]) -> Dict[Tuple[int, int], str]:
    """One optimal action per cell (first in ACTION_STRS order) — the
    functional equivalent of maze/env/maze_utils.py:91-116's BFS solver."""
    opts = optimal_actions(maze, goal)
    return {
        cell: next(a for a in ACTION_STRS if a in acts)
        for cell, acts in opts.items()
        if acts
    }
