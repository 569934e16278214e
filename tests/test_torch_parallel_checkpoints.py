"""Checkpoints under a mesh, on gloo ranks (`lmrl_gym_torch/loops/
checkpoints.py`, `core/checkpointing.py::stream_sharding_fn`).

- A sharded save (an ILQL state one step in, its base, head and target
  head sharded by their rules over (1,2,1) and (1,1,2)... gathered whole
  and written by rank 0) gives the unsharded save's bytes, optimizer state
  included.
- A JAX checkpoint (the JAX package's `dump_modules`) loads into a sharded
  port state through `stream_sharding_fn`: each rank keeps its block, and
  the blocks gathered whole are the JAX arrays, bit for bit.
"""
import os

import jax
import numpy as np
import pytest
import torch

from lmrl_gym_tpu.loops.checkpoints import dump_modules as jdump
from lmrl_gym_tpu.models.config import tiny_test_config as jtiny
from lmrl_gym_tpu.models.heads import MLPHead, MLPHeadConfig, init_head_params
from lmrl_gym_tpu.models.transformer import init_params
from lmrl_gym_torch.models.convert import head_params_from_jax, params_from_jax
from lmrl_gym_torch.parallel.dryrun import checkpoint_ranks, unsharded_checkpoint
from lmrl_gym_torch.parallel.launch import run_ranks


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.fixture(autouse=True)
def one_thread():
    """The ranks' one intra-op thread here too, so the steps sum alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 1, 2)], ids=["fsdp2", "dp2_mp2"])
def test_sharded_save_gives_unsharded_bytes(tmp_path, shape):
    unsharded_checkpoint(str(tmp_path / "whole"))
    run_ranks(checkpoint_ranks, int(np.prod(shape)), (shape, str(tmp_path / "sharded")))
    whole, sharded = _files(tmp_path / "whole"), _files(tmp_path / "sharded")
    assert set(whole) == {"base/train_state.msgpack", "q1_head/train_state.msgpack", "q1_target/params.msgpack"}
    assert set(sharded) == set(whole)
    for name in whole:
        assert sharded[name] == whole[name], name


def test_jax_checkpoint_streams_into_sharded_state(tmp_path):
    config = jtiny(num_heads=4, hidden_size=64)
    key = jax.random.PRNGKey(7)
    base = init_params(config, key)
    q_cfg = MLPHeadConfig(input_dim=64, hidden_dim=128, output_dim=config.padded_vocab_size)
    q1 = init_head_params(MLPHead(q_cfg), 64, jax.random.PRNGKey(8))
    jdump(str(tmp_path / "jax"), {"base": base, "q1_head": q1})
    out = run_ranks(checkpoint_ranks, 4, ((1, 2, 2), str(tmp_path / "port"), str(tmp_path / "jax")))[0]
    assert out["sharded"]
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    for got, want in ((out["base"], params_from_jax(np_tree(base), config)),
                      (out["q1_head"], head_params_from_jax(np_tree(q1)))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
