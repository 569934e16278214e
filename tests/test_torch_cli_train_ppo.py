"""The port's training CLI against the JAX package's for PPO, offline and
one online round, on the JAX CLI's own draws: the helpers, tolerances and
exemptions of tests/test_torch_cli_train.py.

The online case runs as tests/test_ppo_cli.py drives the JAX CLI (Wordle,
one round of two rollouts at batch 2, the adaptive KL controller and the
BC term); each sampled `LMServer` call of the JAX run is replayed by its
Gumbel noise, and every serving call's prompts and actions must be
identical.
"""
import pytest

from test_torch_cli_train import check_cli_parity, one_thread  # noqa: F401

ONLINE = ["--task", "wordle", "--train-bsize", "4", "--n-data", "2", "--rollouts-per-round", "2",
          "--rollout-bsize", "2", "--eval-max-new-tokens", "16", "--log-every", "4", "--online-rounds", "1",
          "--ppo-kl-target", "0.05", "--bc-loss-weight", "0.1"]


def test_offline_ppo_cli_matches_jax_cli(tmp_path, monkeypatch):
    check_cli_parity("ppo", ["--task", "maze", "--ppo-value-bias-init", "-0.5"], tmp_path, monkeypatch)


def test_online_ppo_round_matches_jax_cli(tmp_path, monkeypatch):
    jrec, prec = check_cli_parity("ppo", ONLINE, tmp_path, monkeypatch)
    sampled = [c for c in jrec["calls"] if not c["greedy"]]
    assert sampled and len(prec["calls"]) == len(jrec["calls"])
    for i, (jc, pc) in enumerate(zip(jrec["calls"], prec["calls"])):
        assert pc["prompts"] == jc["prompts"], i
        assert pc["outs"] == jc["outs"], i
