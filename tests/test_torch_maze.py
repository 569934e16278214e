"""The port's maze host env (`envs/maze/*`) and task builders
(`cli/tasks.py`) against the JAX package's copies: transcripts, chains and
per-cell accuracies must be identical for fixed seeds (tolerance 0)."""
import random

import numpy as np
import pytest

from lmrl_gym_tpu.cli import tasks as jtasks
from lmrl_gym_tpu.envs.maze import env as jenv, eval as jeval, grids as jgrids
from lmrl_gym_tpu.text.frames import Text as JText
from lmrl_gym_torch.cli import tasks as ttasks
from lmrl_gym_torch.envs.maze import env as tenv, eval as teval, grids as tgrids
from lmrl_gym_torch.text.frames import Text as TText


def _transcript(env, Text, seed, actions):
    out = []
    obs = env.reset(seed=seed)
    out.append([(t.text, t.is_action) for t in obs])
    history = obs
    for a in actions:
        history = history + (Text(a, True),)
        history, reward, done = env.step(history)
        out.append(([(t.text, t.is_action) for t in history], reward, done, tuple(env.position)))
        if done:
            break
    return out


def test_grids_match():
    np.testing.assert_array_equal(tgrids.double_t_maze(), jgrids.double_t_maze())
    np.testing.assert_array_equal(tgrids.maze2d_umaze(), jgrids.maze2d_umaze())
    for maze in (jgrids.double_t_maze(), jgrids.maze2d_umaze()):
        goal = tuple(np.argwhere(maze == 0)[-1])
        np.testing.assert_array_equal(tgrids.bfs_distances(maze, goal), jgrids.bfs_distances(maze, goal))
        assert tgrids.optimal_actions(maze, goal) == jgrids.optimal_actions(maze, goal)
        assert tgrids.maze_solver(maze, goal) == jgrids.maze_solver(maze, goal)


@pytest.mark.parametrize("last_k,describe", [(1, "describe_observation_give_position"), (40, "describe_observation"),
                                             (3, "describe_observation_only_walls")])
@pytest.mark.parametrize("seed", [0, 7])
def test_maze_env_transcripts_match(last_k, describe, seed):
    rng = random.Random(seed)
    actions = [rng.choice(jgrids.ACTION_STRS + ["jump\n"]) for _ in range(60)]
    kw = lambda m: dict(maze=m.double_t_maze(), valid_goals=np.asarray([(8, 6)]), max_steps=30,  # noqa: E731
                        last_k=last_k)
    j = jenv.MazeEnv(**kw(jgrids), describe_function=getattr(jenv, describe))
    t = tenv.MazeEnv(**kw(tgrids), describe_function=getattr(tenv, describe))
    assert _transcript(t, TText, seed, actions) == _transcript(j, JText, seed, actions)


def test_maze_builders_and_chains_match():
    j, t = jtasks.build_maze_env(), ttasks.build_maze_env()
    assert [x.text for x in t.reset(seed=3)] == [x.text for x in j.reset(seed=3)]
    for kw in (dict(), dict(p_optimal=0.35, wrong_bias=True)):
        jc, tc = jtasks.generate_maze_chains(5, seed=2, **kw), ttasks.generate_maze_chains(5, seed=2, **kw)
        assert len(jc) == len(tc) == 5
        for a, b in zip(jc, tc):
            ja = [(tuple((x.text, x.is_action) for x in tt.text_history), tt.reward, tt.done) for tt in a.to_list()]
            tb = [(tuple((x.text, x.is_action) for x in tt.text_history), tt.reward, tt.done) for tt in b.to_list()]
            assert ja == tb
    assert set(ttasks.TASKS) == {"maze"} and ttasks.TASKS["maze"].max_length == jtasks.TASKS["maze"].max_length


def test_per_cell_accuracy_matches():
    maze, goal = jgrids.double_t_maze(), (8, 6)
    rng = np.random.default_rng(0)
    picks = {}

    def policy(Text):
        def act(histories):
            out = []
            for h in histories:
                a = picks.setdefault(h[0].text, jgrids.ACTION_STRS[int(rng.integers(4))])
                out.append(h + (Text(a, True),))
            return out
        return act

    jacc, jcells = jeval.per_cell_optimal_move_accuracy(policy(JText), maze, goal, bsize=7)
    tacc, tcells = teval.per_cell_optimal_move_accuracy(policy(TText), maze, goal, bsize=7)
    assert tacc == jacc and tcells == jcells and 0.0 < tacc < 1.0
    assert teval.render_accuracy_grid(maze, goal, tcells) == jeval.render_accuracy_grid(maze, goal, jcells)
