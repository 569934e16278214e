"""On-device online ILQL on Wordle: fused actor rollouts feeding ILQL
updates, rollouts and updates both on the card. The port of the Wordle half
of `lmrl_gym_tpu/loops/online_device.py`.

A round is one `rollout_wordle` of the shared-trunk β-perturbed policy
(base + β·min(q1,q2)) over the LIVE modules that the optimizer updates in
place, so each round's rollouts are on-policy for the current weights; its
device-resident tokens become an ILQL batch, sliced into minibatches by a
random permutation. The only host work is loop control and metric fetches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from lmrl_gym_torch.algos.ilql import ILQLBatch, ILQLConfig, ILQLTrainState, make_ilql_train_step
from lmrl_gym_torch.envs.wordle.vector import WordleVectorEnv
from lmrl_gym_torch.loops import actor as actor_mod
from lmrl_gym_torch.models.interface import LMCore


def wordle_rollout_to_ilql_batch(out: actor_mod.WordleRollout) -> ILQLBatch:
    """Rollout → ILQLBatch (single-window episodes: the 128-token Wordle
    episode fits one context, so no chain bootstrap). The rollout's tensors
    come out of inference mode, which autograd may not save (the trunk's
    embedding saves its indices), so the batch holds copies."""
    return ILQLBatch(
        input_ids=out.tokens.clone(),
        should_take_action=out.token_action_mask()[:, 1:].clone(),
        rewards=out.token_rewards()[:, 1:].clone(),
        dones=torch.ones(out.tokens.shape[:1], dtype=torch.bool, device=out.tokens.device),
        next_token_ids=None,
        next_dones=None,
    )


@dataclass
class OnlineDeviceConfig:
    n_rounds: int = 4
    rollout_batch: int = 256
    train_bsize: int = 64
    epochs_per_round: int = 1
    temperature: float = 1.0
    pad_token_id: int = 256


class RoundReplay(NamedTuple):
    """One round's draws, handed in to replay another sampler's: the
    rollout's noise and one permutation of the rollout batch per epoch."""

    noise: actor_mod.WordleNoise
    perms: List[torch.Tensor]


def online_ilql_wordle(
    core: LMCore,
    state: ILQLTrainState,
    env: WordleVectorEnv,
    ilql_config: ILQLConfig,
    config: OnlineDeviceConfig,
    generator: Optional[torch.Generator] = None,
    replay: Optional[List[RoundReplay]] = None,
) -> Tuple[ILQLTrainState, list]:
    """Round-based online ILQL, rollouts and updates both on `env`'s device
    → (final state, per-round metrics). `state` is trained in place.
    Sampling and permutations draw from `generator`, or round i replays
    `replay[i]`."""
    B = config.rollout_batch
    step_fn, carry0 = actor_mod.make_value_guided_step_fn(
        core, batch=B, two_trunks=False, twin_q=True, beta=ilql_config.beta
    )
    train_step = make_ilql_train_step(core, ilql_config, config.pad_token_id)

    history: list = []
    for rnd in range(config.n_rounds):
        # the live modules: the optimizer updates them in place, so every
        # round decodes with the current weights; carry0's caches are at
        # index 0, so each rollout starts them afresh
        policy = {"base": state.base.params, "q1": state.q1_head.params, "q2": state.q2_head.params}
        out = actor_mod.rollout_wordle(
            env, step_fn, policy, carry0, B, config.temperature, False,
            generator=generator, noise=None if replay is None else replay[rnd].noise,
        )
        batch = wordle_rollout_to_ilql_batch(out)

        losses = []
        n = B // config.train_bsize
        for epoch in range(config.epochs_per_round):
            if replay is None:
                perm = torch.randperm(B, generator=generator, device=env.device)
            else:
                perm = replay[rnd].perms[epoch].to(env.device)
            for i in range(n):
                idx = perm[i * config.train_bsize: (i + 1) * config.train_bsize]
                sub = ILQLBatch(
                    input_ids=batch.input_ids[idx],
                    should_take_action=batch.should_take_action[idx],
                    rewards=batch.rewards[idx],
                    dones=batch.dones[idx],
                    next_token_ids=None,
                    next_dones=None,
                )
                state, loss, _ = train_step(state, sub, generator)
                losses.append(loss)

        metrics: Dict[str, float] = {
            "round": rnd,
            "mean_episode_reward": float((out.turn_reward * out.turn_live).sum(dim=1).mean()),
            "win_rate": float(out.win.float().mean()),
            "mean_turns": float(out.n_turns.float().mean()),
            "loss": float(torch.stack(losses).mean()),
        }
        history.append(metrics)
    return state, history
