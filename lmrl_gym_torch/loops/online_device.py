"""On-device online ILQL: fused actor rollouts feeding ILQL updates,
rollouts and updates both on the card. The port of
`lmrl_gym_tpu/loops/online_device.py`: Wordle, and any Markov token env
(the maze, chess endgames).

A round is one `rollout_wordle` of the shared-trunk β-perturbed policy
(base + β·min(q1,q2)) over the LIVE modules that the optimizer updates in
place, so each round's rollouts are on-policy for the current weights; its
device-resident tokens become an ILQL batch, sliced into minibatches by a
random permutation. The only host work is loop control and metric fetches.

Under a distributed `mesh` the rollout's games shard over the batch ranks
(each rank plays its rows, the draws made over the whole batch), the
rollout is gathered whole on every rank, and the sharded ILQL step takes
each minibatch's rows rank by rank, as the JAX loop hands its mesh to the
step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from lmrl_gym_torch.algos.ilql import ILQLBatch, ILQLConfig, ILQLTrainState, make_ilql_train_step
from lmrl_gym_torch.envs.wordle.vector import WordleVectorEnv
from lmrl_gym_torch.loops import actor as actor_mod
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.parallel.mesh import Mesh, Spec, batch_rows, gather_tree, local_shard

_BATCH = ("dp", "fsdp")


def _sharded_noise(noise, mesh: Optional[Mesh], batch_dims):
    """This rank's rows of replayed rollout noise (the batch at dim
    `batch_dims[i]` of field i)."""
    if noise is None:
        return None
    return type(noise)(*(None if x is None else local_shard(x, mesh, Spec(*([None] * d), _BATCH))
                         for x, d in zip(noise, batch_dims)))


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
    mesh: Optional[Mesh] = None,
) -> Tuple[ILQLTrainState, list]:
    """Round-based online ILQL, rollouts and updates both on `env`'s device
    → (final state, per-round metrics). `state` is trained in place (sharded
    by `parallel/mesh.py::shard_train_state` under a distributed `mesh`).
    Sampling and permutations draw from `generator`, or round i replays
    `replay[i]`."""
    B = config.rollout_batch
    step_fn, carry0 = actor_mod.make_value_guided_step_fn(
        core, batch=batch_rows(mesh, B), two_trunks=False, twin_q=True, beta=ilql_config.beta
    )
    train_step = make_ilql_train_step(core, ilql_config, config.pad_token_id, mesh)

    history: list = []
    for rnd in range(config.n_rounds):
        # the live modules: the optimizer updates them in place, so every
        # round decodes with the current weights; carry0's caches are at
        # index 0, so each rollout starts them afresh
        policy = {"base": state.base.params, "q1": state.q1_head.params, "q2": state.q2_head.params}
        out = actor_mod.rollout_wordle(
            env, step_fn, policy, carry0, batch_rows(mesh, B), config.temperature, False,
            generator=generator, noise=_sharded_noise(None if replay is None else replay[rnd].noise, mesh, (2, 1)),
            mesh=mesh,
        )
        out = gather_tree(out)
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


# ---------------------------------------------------------------------------
# The Markov-env variant (chess endgames, the maze): per-turn (obs, act)
# windows with chain bootstrapping — next_token_ids is the NEXT turn's
# observation, the reference's chess ILQL chain convention (FEN windows
# linked by next-state tokens, algorithms/ilql/data.py:10-79).
# ---------------------------------------------------------------------------


def markov_rollout_to_ilql_batch(out: actor_mod.MarkovRollout) -> ILQLBatch:
    """[B, N]-turn rollout → [B·N] one-window-per-turn ILQLBatch; every
    tensor built outside inference mode, so autograd may save it."""
    B, N, obs_len = out.obs_tokens.shape
    W = obs_len + out.act_tokens.shape[-1]
    device = out.obs_tokens.device
    live = out.turn_live  # [B, N]
    sta = torch.zeros((B, N, W - 1), dtype=torch.bool, device=device)
    # token t+1 is an action ⇔ t ∈ [obs_len - 1, W - 2]; masked to live turns
    sta[:, :, obs_len - 1:] = live[:, :, None]
    rewards = torch.zeros((B, N, W - 1), dtype=torch.float32, device=device)
    rewards[:, :, W - 2] = out.turn_reward * live
    # the bootstrap chain: the next turn's obs (final_obs after the last
    # turn); done when the next turn was never played
    next_obs = torch.cat([out.obs_tokens[:, 1:], out.final_obs[:, None, :]], dim=1)
    next_live = torch.cat([live[:, 1:], torch.zeros((B, 1), dtype=torch.bool, device=device)], dim=1)
    dones = (~next_live).reshape(B * N)
    return ILQLBatch(
        input_ids=out.window_tokens().reshape(B * N, W).clone(),
        should_take_action=sta.reshape(B * N, W - 1),
        rewards=rewards.reshape(B * N, W - 1),
        dones=dones,
        next_token_ids=next_obs.reshape(B * N, obs_len).clone(),
        next_dones=dones.clone(),
    )


class MarkovRoundReplay(NamedTuple):
    """One Markov round's draws, handed in to replay another sampler's: the
    env reset's (chess: the [3, 8, B] squares; the maze: `MazeResetDraws`),
    the rollout's noise, and one permutation of the B·N windows per epoch."""

    reset: Any
    noise: actor_mod.MarkovNoise
    perms: List[torch.Tensor]


def online_ilql_markov(
    core: LMCore,
    state: ILQLTrainState,
    env,  # token env: ChessEndgameVectorEnv, MazeTokenVecEnv, ...
    n_turns: int,
    ilql_config: ILQLConfig,
    config: OnlineDeviceConfig,
    pi_beta: Optional[torch.nn.Module] = None,
    generator: Optional[torch.Generator] = None,
    replay: Optional[List[MarkovRoundReplay]] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[ILQLTrainState, list]:
    """Round-based online ILQL over a Markov token env, rollouts and updates
    on `env`'s device → (final state, per-round metrics); `state` is trained
    in place.

    `pi_beta`: an optional FROZEN behavior prior. With it, decoding is
    two-trunk π_β + β·min(q1,q2) with π_β fixed (the reference's
    value_rl_base structure, generation.py:36-121); without it the value
    base doubles as π_β. Each epoch's permutation is stable-sorted so the
    live windows come first, and a round takes at most as many minibatches
    as the live windows fill: an all-dead minibatch has zero loss, but
    AdamW would still step on stale momentum and weight decay and the
    polyak target would still mix. Draws come from `generator`, or round i
    replays `replay[i]`. Under a distributed `mesh`, as `online_ilql_wordle`
    (every rank resets the whole batch and plays its rows)."""
    B = config.rollout_batch
    step_fn, carry0 = actor_mod.make_value_guided_step_fn(
        core, batch=batch_rows(mesh, B), two_trunks=pi_beta is not None, twin_q=True, beta=ilql_config.beta,
        total_len=env.OBS_LEN + env.ACT_LEN,
    )
    train_step = make_ilql_train_step(core, ilql_config, config.pad_token_id, mesh)

    history: list = []
    for rnd in range(config.n_rounds):
        policy = {"base": state.base.params, "q1": state.q1_head.params, "q2": state.q2_head.params}
        if pi_beta is not None:
            policy["pi_beta"] = pi_beta
        rep = None if replay is None else replay[rnd]
        state0 = local_shard(env.reset(B, generator, None if rep is None else rep.reset), mesh, Spec(_BATCH))
        out, _ = actor_mod.rollout_markov(env, n_turns, step_fn, policy, carry0, state0, config.temperature, False,
                                          generator=generator, mesh=mesh,
                                          noise=_sharded_noise(None if rep is None else rep.noise, mesh, (2, 1)))
        out = gather_tree(out)
        batch = markov_rollout_to_ilql_batch(out)
        n_windows = batch.input_ids.shape[0]
        live_flat = out.turn_live.reshape(-1)

        losses = []
        # windows past the last full minibatch are dropped for the epoch
        bs = min(config.train_bsize, n_windows)
        n = max(1, n_windows // bs)
        n = max(1, min(n, -(-int(live_flat.sum()) // bs)))  # capped at the live prefix
        for epoch in range(config.epochs_per_round):
            if rep is None:
                perm = torch.randperm(n_windows, generator=generator, device=env.device)
            else:
                perm = rep.perms[epoch].to(env.device)
            perm = perm[torch.argsort((~live_flat[perm]).to(torch.int8), stable=True)]
            for i in range(n):
                idx = perm[i * bs: (i + 1) * bs]
                state, loss, _ = train_step(state, ILQLBatch(*(x[idx] for x in batch)), generator)
                losses.append(loss)

        live = out.turn_live
        metrics: Dict[str, float] = {
            "round": rnd,
            "mean_episode_reward": float((out.turn_reward * live).sum(dim=1).mean()),
            "mean_turns": float(live.sum(dim=1).float().mean()),
            "illegal_rate": float((out.turn_illegal & live).sum().float() / live.sum().clamp(min=1).float()),
            "loss": float(torch.stack(losses).mean()),
        }
        history.append(metrics)
    return state, history
