"""Vectorized maze: batched grid navigation as tensor code on the device.

The port of `lmrl_gym_tpu/envs/maze/vector.py`. Action ids index (up,
down, left, right); the agent moves iff the target cell is open; reward 0
at the goal, -4 for an invalid action, -1 per step; past `max_steps` the
step times out (reward -1, done). INVALID_ACTION models un-parseable text
actions (stay, illegal penalty).

The grid is one shared [H, W] wall map; per-env state is (position, goal,
step count, done), so a batch of any size fits on the card.

Gathers reproduce the JAX package's index semantics explicitly: a JAX
gather wraps a negative index once and clamps the rest, where a CUDA
gather would assert (`jax_index`). A move off an unwalled grid therefore
reads the wall map where the JAX package reads it.

`reset` samples as `jax.random` does (a uniform goal index, then the
start cell as the argmax of Gumbel noise over the open cells that are not
the goal), from an explicit `torch.Generator` or from draws the caller
hands in (`MazeResetDraws`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lmrl_gym_torch.core.device import DeviceLike, resolve_device
from lmrl_gym_torch.core.random import categorical

# action ids match grids.ACTION_STRS order: up, down, left, right
DELTAS = np.asarray([(-1, 0), (1, 0), (0, -1), (0, 1)], dtype=np.int64)
INVALID_ACTION = 4  # out-of-vocabulary text action


def jax_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The index a JAX gather reads for `idx` on an axis of size n: a
    negative index wraps once (idx + n), then everything clamps to
    [0, n - 1]."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


class MazeVecState(NamedTuple):
    pos: torch.Tensor  # [B, 2] int64 (y, x)
    goal: torch.Tensor  # [B, 2] int64
    n_steps: torch.Tensor  # [B] int32
    done: torch.Tensor  # [B] bool
    reward: torch.Tensor  # [B] float32 — last step's reward
    illegal: torch.Tensor  # [B] bool — last step was an illegal/invalid action


class MazeResetDraws(NamedTuple):
    """One reset's draws: `goal_idx` [B] indices into valid_goals and
    `gumbel` [B, C] noise over the open cells."""

    goal_idx: torch.Tensor
    gumbel: torch.Tensor


class MazeVectorEnv:
    def __init__(
        self,
        maze: np.ndarray,
        valid_goals: np.ndarray,
        max_steps: Optional[int] = None,
        illegal_penalty: float = -4.0,
        step_penalty: float = -1.0,
        goal_reward: float = 0.0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.maze_np = np.asarray(maze, dtype=np.uint8)
        self.maze = torch.as_tensor(self.maze_np, device=self.device)
        self.valid_goals = torch.as_tensor(np.asarray(valid_goals, dtype=np.int64), device=self.device)
        self.open_cells = torch.as_tensor(np.argwhere(self.maze_np == 0).astype(np.int64), device=self.device)
        self.max_steps = max_steps
        self.illegal_penalty = illegal_penalty
        self.step_penalty = step_penalty
        self.goal_reward = goal_reward
        # deltas with an extra zero row for INVALID_ACTION
        self.deltas = torch.as_tensor(np.concatenate([DELTAS, np.zeros((1, 2), np.int64)]), device=self.device)

    def reset(self, batch: int, generator: Optional[torch.Generator] = None,
              draws: Optional[MazeResetDraws] = None) -> MazeVecState:
        """A uniform goal from valid_goals and a uniform start among the open
        cells other than the goal (reference env.py:186-202)."""
        n_goals, cells = self.valid_goals.shape[0], self.open_cells
        if draws is None:
            goal_idx = torch.randint(0, n_goals, (batch,), generator=generator, device=self.device)
            gumbel = None
        else:
            goal_idx, gumbel = draws.goal_idx.to(self.device).long(), draws.gumbel.to(self.device)
        goal = self.valid_goals[goal_idx]  # [B, 2]
        is_goal = (cells[None, :, :] == goal[:, None, :]).all(dim=-1)  # [B, C]
        logits = torch.where(is_goal, -torch.inf, 0.0)
        pos = cells[categorical(logits, generator, gumbel)]
        return MazeVecState(
            pos=pos,
            goal=goal,
            n_steps=torch.zeros((batch,), dtype=torch.int32, device=self.device),
            done=torch.zeros((batch,), dtype=torch.bool, device=self.device),
            reward=torch.zeros((batch,), dtype=torch.float32, device=self.device),
            illegal=torch.zeros((batch,), dtype=torch.bool, device=self.device),
        )

    def step(self, state: MazeVecState, action: torch.Tensor) -> MazeVecState:
        """action: [B] ∈ [0, 4]; 4 = invalid/unparseable. Out-of-range ids
        clamp to INVALID_ACTION (a negative id too)."""
        action = action.long().clamp(0, INVALID_ACTION)
        # max-steps timeout fires before the move (env.py:164-165)
        if self.max_steps is not None:
            timeout = state.n_steps >= self.max_steps
        else:
            timeout = torch.zeros_like(state.done)

        target = state.pos + self.deltas[action]  # [B, 2], may leave the grid
        H, W = self.maze.shape
        open_cell = self.maze[jax_index(target[:, 0], H), jax_index(target[:, 1], W)] == 0
        legal = (action < INVALID_ACTION) & open_cell
        new_pos = torch.where(legal[:, None], target, state.pos)

        at_goal = (new_pos == state.goal).all(dim=-1)
        invalid = action >= INVALID_ACTION
        reward = torch.where(
            at_goal,
            self.goal_reward,
            torch.where(invalid, self.illegal_penalty, self.step_penalty),
        )
        reward = torch.where(timeout, -1.0, reward).float()
        new_done = at_goal | timeout

        frozen = state.done
        return MazeVecState(
            pos=torch.where(frozen[:, None], state.pos, new_pos),
            goal=state.goal,
            n_steps=torch.where(frozen, state.n_steps, state.n_steps + 1),
            done=torch.where(frozen, state.done, new_done),
            reward=torch.where(frozen, 0.0, reward),
            illegal=~frozen & invalid,
        )

    def auto_reset(self, state: MazeVecState, generator: Optional[torch.Generator] = None,
                   draws: Optional[MazeResetDraws] = None) -> MazeVecState:
        """Done games restart from a fresh reset; the rest keep their state."""
        fresh = self.reset(state.done.shape[0], generator, draws)
        d = state.done

        def sel(a, b):
            return torch.where(d.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)

        return MazeVecState(*(sel(a, b) for a, b in zip(state, fresh)))

    def optimal_action_table(self, goal: Tuple[int, int]) -> torch.Tensor:
        """[H, W] table of BFS-optimal action ids (-1 = wall/goal); the
        device-side analogue of the reference's optimal-directions oracle
        (maze/env/mazes.py:20-48)."""
        from lmrl_gym_torch.envs.maze.grids import ACTION_STRS, maze_solver

        table = np.full(self.maze_np.shape, -1, dtype=np.int64)
        for (y, x), action in maze_solver(self.maze_np, goal).items():
            table[y, x] = ACTION_STRS.index(action)
        return torch.as_tensor(table, device=self.device)


# ---------------------------------------------------------------------------
# Token-frame adapter: MazeVectorEnv as a Markov token env for the fused
# actor (loops/actor.rollout_markov). The observation is a fixed-width
# rendering, "g Y Y X X p Y Y X X\n" (zero-padded two-digit coordinates
# spelled digit by digit; the host renderer's wall sentences are static
# text and left out). The action field holds one of grids.ACTION_STRS
# verbatim in a fixed ACT_LEN = 11 slot ("move right\n" is exactly 11
# bytes; shorter actions end at their '\n' and the parser ignores the tail).
# ---------------------------------------------------------------------------

_NL, _SP = 10, 32


def _action_templates() -> np.ndarray:
    from lmrl_gym_torch.envs.maze.grids import ACTION_STRS

    out = np.full((len(ACTION_STRS), MazeTokenVecEnv.ACT_LEN), _SP, np.int64)
    for i, s in enumerate(ACTION_STRS):
        b = s.encode()
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return out


class MazeTokenVecEnv:
    """Markov token-frame wrapper over MazeVectorEnv."""

    OBS_LEN = 20  # "g Y Y X X p Y Y X X" spelled (10 chars, 9 separators) + '\n'
    ACT_LEN = 11

    def __init__(self, inner: MazeVectorEnv):
        self.inner = inner
        self.device = inner.device
        templates = _action_templates()
        self.templates = torch.as_tensor(templates, device=self.device)  # [4, ACT_LEN]
        # per-template compare length: through its '\n'
        self.template_len = torch.as_tensor([int(np.argmax(row == _NL)) + 1 for row in templates],
                                            device=self.device)

    def reset(self, batch: int, generator: Optional[torch.Generator] = None,
              draws: Optional[MazeResetDraws] = None) -> MazeVecState:
        return self.inner.reset(batch, generator, draws)

    def obs_tokens(self, state: MazeVecState) -> torch.Tensor:
        """[B, OBS_LEN] int64 byte tokens."""
        B = state.pos.shape[0]

        def d(v, p):
            return ord("0") + (v // p) % 10

        cols = [
            torch.full((B,), ord("g"), dtype=torch.int64, device=self.device),
            d(state.goal[:, 0], 10), d(state.goal[:, 0], 1), d(state.goal[:, 1], 10), d(state.goal[:, 1], 1),
            torch.full((B,), ord("p"), dtype=torch.int64, device=self.device),
            d(state.pos[:, 0], 10), d(state.pos[:, 0], 1), d(state.pos[:, 1], 10), d(state.pos[:, 1], 1),
        ]
        out = torch.full((B, self.OBS_LEN), _SP, dtype=torch.int64, device=self.device)
        out[:, 0: 2 * len(cols): 2] = torch.stack(cols, dim=1).long()
        out[:, self.OBS_LEN - 1] = _NL
        return out

    def parse_action(self, act_tokens: torch.Tensor) -> torch.Tensor:
        """[B, ACT_LEN] frame → [B] action id (4 = INVALID)."""
        idx = torch.arange(self.ACT_LEN, device=self.device)[None, None, :]
        within = idx < self.template_len[None, :, None]
        eq = act_tokens.long()[:, None, :] == self.templates[None, :, :]
        match = (eq | ~within).all(dim=-1)  # [B, 4]
        first = torch.argmax(match.to(torch.int32), dim=1)  # the first matching template
        return torch.where(match.any(dim=1), first, INVALID_ACTION)

    def step(self, state: MazeVecState, act_tokens: torch.Tensor, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> MazeVecState:
        """Maze transitions are deterministic: `generator` and `noise` are
        taken for the token-env interface and unused."""
        return self.inner.step(state, self.parse_action(act_tokens))

    def render_action(self, action: torch.Tensor) -> torch.Tensor:
        """[B] action id → [B, ACT_LEN] frame (scripted/optimal policies)."""
        return self.templates[action.long().clamp(0, self.templates.shape[0] - 1)]

    def optimal_action(self, state: MazeVecState, table: torch.Tensor) -> torch.Tensor:
        """BFS-optimal action ids for the single-goal table (see
        MazeVectorEnv.optimal_action_table); a position off an unwalled
        grid reads the table as a JAX gather does."""
        H, W = table.shape
        return table[jax_index(state.pos[:, 0], H), jax_index(state.pos[:, 1], W)]
