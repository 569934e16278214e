"""The port's fused actors under a data-parallel mesh (`loops/actor.py`,
`mesh=`), tests/test_actor_sharded.py's claims: on 2 gloo ranks with envs
sharded over dp, a sampled rollout's results stay batch-sharded
(`DTensor`s over the batch ranks), and gathered whole they equal the
unsharded rollout's: tokens exactly, rewards within 1e-6. Wordle (16
games) and a Markov env (chess endgames, 16 games, 3 turns). The
unsharded run takes one intra-op thread, as the ranks do, so both sum
alike.
Then one round of the on-device online loop (`loops/online_device.py`)
with its games and its train steps sharded over dp=2.
"""
import numpy as np
import pytest
import torch

from lmrl_gym_torch.parallel.dryrun import online_ranks, rollout_ranks
from lmrl_gym_torch.parallel.launch import run_ranks


@pytest.fixture(autouse=True)
def one_thread():
    """The ranks' one intra-op thread here too, so both runs sum alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("env_kind", ["wordle", "chess"])
def test_rollout_shards_over_dp(env_kind):
    ref = rollout_ranks(env_kind, 16, None)
    got = run_ranks(rollout_ranks, 2, (env_kind, 16, (2, 1, 1)))[0]
    assert got["sharded"] and not ref["sharded"]
    assert got["tokens"].shape[0] == 16
    np.testing.assert_array_equal(got["tokens"].numpy(), ref["tokens"].numpy())
    np.testing.assert_allclose(got["reward"].numpy(), ref["reward"].numpy(), atol=1e-6, rtol=0)


def test_online_wordle_round_under_dp():
    """One round of `online_ilql_wordle` with its games and its ILQL steps
    sharded over dp=2: the rollout's metrics equal the unsharded round's
    and the mean train loss agrees within 1e-5."""
    ref = online_ranks(None)
    got = run_ranks(online_ranks, 2, ((2, 1, 1),))[0]
    assert len(got) == len(ref) == 1
    for k in ("mean_episode_reward", "win_rate", "mean_turns"):
        assert got[0][k] == ref[0][k], k
    np.testing.assert_allclose(got[0]["loss"], ref[0]["loss"], atol=1e-5, rtol=1e-5)
