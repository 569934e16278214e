"""The port's vectorized maze (`envs/maze/vector.py`) against the JAX
package's, on the same numpy-seeded actions and the JAX resets' own draws
(each reset key turned into the goal indices and Gumbel noise it gives).
Every state field, reward, token and action id must be identical
(tolerance 0). An unwalled grid makes moves leave the board, where both
packages read the wall map at the JAX gather's index (wrap once, then
clamp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.envs.maze import grids as jgrids
from lmrl_gym_tpu.envs.maze import vector as jvec
from lmrl_gym_torch.envs.maze import vector as tvec

B = 32


def _np(x):
    return torch.from_numpy(np.array(x))


def _draws(env_j, key, batch):
    """MazeVectorEnv.reset's key splits, as draws."""
    goal_key, pos_key = jax.random.split(key)
    goal_idx = jax.random.randint(goal_key, (batch,), 0, env_j.valid_goals.shape[0])
    gumbel = jax.random.gumbel(pos_key, (batch, env_j.open_cells.shape[0]), jnp.float32)
    return tvec.MazeResetDraws(_np(goal_idx), _np(gumbel))


def _assert_state_equal(t, j):
    for name in tvec.MazeVecState._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)


def _grids():
    open_grid = np.zeros((5, 6), np.uint8)  # no border wall: moves leave the board
    goals = np.asarray([(2, 3), (0, 0), (4, 5)])
    return {
        "double_t": (jgrids.double_t_maze(), np.asarray([jgrids.DOUBLE_T_GOAL])),
        "unwalled": (open_grid, goals),
    }


@pytest.fixture(scope="module", params=["double_t", "unwalled"])
def envs(request):
    maze, goals = _grids()[request.param]
    return (jvec.MazeVectorEnv(maze, goals, max_steps=12),
            tvec.MazeVectorEnv(maze, goals, max_steps=12, device="cpu"), request.param)


def test_reset_auto_reset_and_steps_match(envs):
    jenv, tenv, name = envs
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(7)
    key, rk = jax.random.split(key)
    js, ts = jenv.reset(rk, B), tenv.reset(B, draws=_draws(jenv, rk, B))
    _assert_state_equal(ts, js)
    left_board = False
    for t in range(16):
        # valid ids, INVALID_ACTION and out-of-range ids on both sides
        action = np.where(rng.random(B) < 0.6, rng.integers(0, 4, size=B), rng.integers(-3, 9, size=B))
        action = action.astype(np.int32)
        js = jenv.step(js, jnp.asarray(action))
        ts = tenv.step(ts, torch.from_numpy(action.astype(np.int64)))
        _assert_state_equal(ts, js)
        H, W = jenv.maze.shape
        pos = np.asarray(js.pos)
        left_board |= bool(((pos < 0) | (pos[:, :1] >= H) | (pos[:, 1:] >= W)).any())
        if t % 5 == 4:
            key, rk = jax.random.split(key)
            js = jenv.auto_reset(js, rk)
            ts = tenv.auto_reset(ts, draws=_draws(jenv, rk, B))
            _assert_state_equal(ts, js)
    assert bool(np.asarray(js.done).any())
    if name == "unwalled":
        assert left_board  # the case that needs the JAX gather's index semantics
    assert set(np.unique(np.asarray(js.reward))) <= {0.0, -1.0, -4.0}


def test_jax_index_semantics():
    idx = torch.tensor([-12, -6, -5, -1, 0, 4, 5, 6, 40])
    got = tvec.jax_index(idx, 5)
    want = jnp.arange(5)[jnp.asarray(idx.numpy())]  # a JAX gather on an axis of size 5
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_optimal_action_table_matches():
    maze = jgrids.double_t_maze()
    goal = jgrids.DOUBLE_T_GOAL
    j = jvec.MazeVectorEnv(maze, np.asarray([goal]))
    t = tvec.MazeVectorEnv(maze, np.asarray([goal]), device="cpu")
    np.testing.assert_array_equal(t.optimal_action_table(goal).numpy(), np.asarray(j.optimal_action_table(goal)))


def _frames(rng, n):
    """Action frames: every template, templates with junk tails and
    corrupted bytes, and random bytes."""
    templates = np.asarray(jvec._action_templates())
    out = templates[rng.integers(0, 4, size=n)].copy()
    tail = rng.random(n) < 0.3
    out[tail, -1] = rng.integers(0, 256, size=int(tail.sum()))  # past '\n' for the shorter actions
    bad = rng.random(n) < 0.3
    out[bad, rng.integers(0, 11, size=int(bad.sum()))] = rng.integers(0, 256, size=int(bad.sum()))
    junk = rng.random(n) < 0.1
    out[junk] = rng.integers(0, 256, size=(int(junk.sum()), 11))
    return out.astype(np.int32)


@pytest.mark.parametrize("grid", ["double_t", "unwalled"])
def test_token_adapter_matches(grid):
    maze, goals = _grids()[grid]
    jenv = jvec.MazeTokenVecEnv(jvec.MazeVectorEnv(maze, goals, max_steps=10))
    tenv = tvec.MazeTokenVecEnv(tvec.MazeVectorEnv(maze, goals, max_steps=10, device="cpu"))
    np.testing.assert_array_equal(tenv.templates.numpy(), np.asarray(jenv.templates))
    np.testing.assert_array_equal(tenv.template_len.numpy(), np.asarray(jenv.template_len))
    rng = np.random.default_rng(11)
    key = jax.random.PRNGKey(2)
    js, ts = jenv.reset(key, B), tenv.reset(B, draws=_draws(jenv.inner, key, B))
    table_j = jenv.inner.optimal_action_table(tuple(goals[0]))
    table_t = tenv.inner.optimal_action_table(tuple(goals[0]))
    for _ in range(12):
        np.testing.assert_array_equal(tenv.obs_tokens(ts).numpy(), np.asarray(jenv.obs_tokens(js)))
        np.testing.assert_array_equal(tenv.optimal_action(ts, table_t).numpy(),
                                      np.asarray(jenv.optimal_action(js, table_j)))
        frames = _frames(rng, B)
        np.testing.assert_array_equal(tenv.parse_action(torch.from_numpy(frames)).numpy(),
                                      np.asarray(jenv.parse_action(jnp.asarray(frames))))
        js = jenv.step(js, jnp.asarray(frames), jax.random.PRNGKey(0))
        ts = tenv.step(ts, torch.from_numpy(frames).long())
        _assert_state_equal(ts, js)
    ids = rng.integers(-2, 7, size=B).astype(np.int32)
    np.testing.assert_array_equal(tenv.render_action(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jenv.render_action(jnp.asarray(ids))))


def test_reset_draws_from_generator():
    """Without draws, reset samples from the generator: goals from
    valid_goals, starts on open cells other than the goal."""
    maze = jgrids.double_t_maze()
    env = tvec.MazeVectorEnv(maze, np.asarray([(8, 6), (1, 1)]), device="cpu")
    s = env.reset(256, torch.Generator().manual_seed(0))
    assert (maze[s.pos[:, 0].numpy(), s.pos[:, 1].numpy()] == 0).all()
    assert not (s.pos == s.goal).all(dim=1).any()
    assert {tuple(g) for g in s.goal.tolist()} == {(8, 6), (1, 1)}
