"""The command line and the LM oracle under a mesh, on gloo ranks.

- `cli.train --device cpu --mesh 1,2,1` on two ranks against `--mesh
  1,1,1` on one, both on the JAX CLI's draws (its ILQL run on Wordle,
  recorded as tests/test_torch_cli_train.py records it): the checkpoints
  agree as that file holds the port's to the JAX CLI's (2e-6 abs + 1e-4
  rel outside elements whose gradient was at noise level on some step,
  the masks from the unsharded run), and every config and key path is the
  same.
- `cli.evaluate --mesh 1,2,1` on two ranks reads the sharded run's
  checkpoint (each rank its blocks) and reports what the unsharded
  evaluate of that checkpoint reports.
- `envs/lm_oracle.py::train_oracle_lm` with its model sharded over (1,2,1)
  against the unsharded trainer: every logged loss within 1e-5, the
  trained parameters as above.
The unsharded runs take one intra-op thread, as the ranks do, so both
sum alike.
"""
import numpy as np
import pytest
import torch

from lmrl_gym_torch.cli import train as ttrain
from lmrl_gym_torch.parallel.dryrun import cli_main_ranks, oracle_ranks
from lmrl_gym_torch.parallel.launch import run_ranks
from test_torch_cli_train import COMMON, assert_same_checkpoint, jax_cli_run, noise_masks, port_cli_run, replay_of

ARGV = ["--algo", "ilql"] + COMMON + ["--task", "wordle", "--train-bsize", "8"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the spawned ranks run, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sharded_cli_matches_unsharded_and_evaluates(tmp_path, monkeypatch):
    jrec = jax_cli_run(ARGV + ["--save-dir", str(tmp_path / "jax")])
    config = ttrain.MODEL_SIZES["tiny"]()
    # the unsharded port run in this process records the gradients
    replay = replay_of(jrec, "ilql", config)
    modules = dict(replay.modules)
    prec, _, _ = port_cli_run(ARGV + ["--save-dir", str(tmp_path / "one")], replay, monkeypatch)
    masks = noise_masks(prec, modules, config)
    run_ranks(cli_main_ranks, 2, ("train", ARGV + ["--save-dir", str(tmp_path / "two"), "--device", "cpu",
                                                   "--mesh", "1,2,1"], replay_of(jrec, "ilql", config)))
    assert_same_checkpoint(str(tmp_path / "one" / "run" / "last"), str(tmp_path / "two" / "run" / "last"), masks)

    ckpt = str(tmp_path / "two" / "run" / "last")
    eval_argv = ["--task", "wordle", "--checkpoint", ckpt, "--device", "cpu", "--model-size", "tiny",
                 "--n-rollouts", "4"]
    one = cli_main_ranks("evaluate", eval_argv)
    two = run_ranks(cli_main_ranks, 2, ("evaluate", eval_argv + ["--mesh", "1,2,1"]))[0]
    assert two == one


def test_oracle_trainer_under_a_mesh():
    ref = oracle_ranks(None, 4, 1)
    got = run_ranks(oracle_ranks, 2, ((1, 2, 1), 4, 1))[0]
    assert len(got["logs"]) == len(ref["logs"]) == 1
    for a, b in zip(got["logs"], ref["logs"]):
        np.testing.assert_allclose(float(a.split("loss=")[1].split()[0]), float(b.split("loss=")[1].split()[0]),
                                   atol=1e-4, rtol=1e-5)
    for k, b in ref["params"].items():
        noise = np.zeros(b.shape, bool)
        for g in ref["grads"]:
            t = g[k].abs()
            noise |= ((t <= 1e-5 * t.max()) | (t <= 1e-7)).numpy() & bool(t.max() > 0)
        a, b = got["params"][k].numpy(), b.numpy()
        apart = np.abs(a - b) > 2e-6 + 1e-4 * np.abs(b)
        assert not (apart & ~noise).any(), f"{k}: max {np.abs(a - b).max()}"
