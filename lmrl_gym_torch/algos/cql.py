"""CQL: SARSA-style conservative Q-learning (ILQL without the V head). The
port of `lmrl_gym_tpu/algos/cql.py`: the Bellman target is r + γ·min over
the target Qs at the next action; the endpoint bootstraps from the max over
vocab of the target heads at the next window's last real token (zeroed when
done), or, with no next window, from the window's own final state.

The step updates the state in place. Forwards whose result carries no
gradient in the JAX package (the target base, the target heads, the
next-window bootstrap) run under `torch.no_grad()`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from lmrl_gym_torch.algos.ilql import ILQLBatch, _frozen_copy, _last_true, update_target
from lmrl_gym_torch.algos.losses import cql_loss
from lmrl_gym_torch.core.logs import detach_logs
from lmrl_gym_torch.core.optimizer import GradientTransformation, TrainState, value_and_grads
from lmrl_gym_torch.models.interface import LMCore, initialize_attn_mask_pos_ids
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.parallel.mesh import Mesh, gather_batch, sharded_step


@dataclass(frozen=True)
class CQLConfig:
    gamma: float = 0.99
    cql_weight: float = 0.01
    beta: float = 8.0
    polyak_alpha: float = 0.005
    hard_update_every: Optional[int] = None
    use_separate_target_base: bool = True

    def to_dict(self) -> dict:
        import dataclasses

        return dataclasses.asdict(self)


@dataclass
class CQLTrainState:
    base: TrainState
    target_base_params: Optional[Transformer]
    q1_head: TrainState
    q2_head: TrainState
    q1_target_params: nn.Module
    q2_target_params: nn.Module


def init_cql_state(
    base_params: Transformer,
    q1_params: nn.Module,
    q2_params: nn.Module,
    base_tx: GradientTransformation,
    head_tx: GradientTransformation,
    config: CQLConfig,
) -> CQLTrainState:
    """Online modules are trained in place; the targets start as copies."""
    return CQLTrainState(
        base=TrainState(base_params, base_tx),
        target_base_params=_frozen_copy(base_params) if config.use_separate_target_base else None,
        q1_head=TrainState(q1_params, head_tx),
        q2_head=TrainState(q2_params, head_tx),
        q1_target_params=_frozen_copy(q1_params),
        q2_target_params=_frozen_copy(q2_params),
    )


def cql_forward(
    core: LMCore,
    base_params: Transformer,
    target_base_params: Optional[Transformer],
    q1_params: nn.Module,
    q2_params: nn.Module,
    q1_target_params: nn.Module,
    q2_target_params: nn.Module,
    batch: ILQLBatch,
    config: CQLConfig,
    pad_token_id: int,
    train: bool,
    generator: Optional[torch.Generator] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, Any]:
    """Runs all forwards and computes the CQL loss → (loss, logs); the loss
    inputs are gathered over the batch ranks of a distributed `mesh`."""
    input_ids = batch.input_ids
    attention_mask, position_ids = initialize_attn_mask_pos_ids(input_ids, pad_token_id)

    _, hidden = core.forward(base_params, input_ids, attention_mask, position_ids, train=train, generator=generator)
    with torch.no_grad():
        if target_base_params is not None:
            _, target_hidden = core.forward(
                target_base_params, input_ids, attention_mask, position_ids, train=train, generator=generator
            )
        else:
            target_hidden = hidden.detach()

    def head(mod, h):
        return mod(h, deterministic=not train, generator=generator)

    q1_out = head(q1_params, hidden)  # [b, t, V]
    q2_out = head(q2_params, hidden)
    with torch.no_grad():
        tq1_out = head(q1_target_params, target_hidden)
        tq2_out = head(q2_target_params, target_hidden)

    nxt = input_ids[:, 1:, None].long()
    q1 = torch.gather(q1_out[:, :-1], 2, nxt).squeeze(2)
    q2 = torch.gather(q2_out[:, :-1], 2, nxt).squeeze(2)
    target_q1 = torch.gather(tq1_out[:, :-1], 2, nxt).squeeze(2)
    target_q2 = torch.gather(tq2_out[:, :-1], 2, nxt).squeeze(2)

    # ---- endpoint bootstrap (stopped: no gradient) ----
    rows = torch.arange(input_ids.shape[0], device=input_ids.device)
    with torch.no_grad():
        if batch.next_token_ids is not None:
            next_mask, next_pos = initialize_attn_mask_pos_ids(batch.next_token_ids, pad_token_id)
            base_for_target = target_base_params if target_base_params is not None else base_params
            _, next_hidden = core.forward(
                base_for_target, batch.next_token_ids, next_mask, next_pos, train=train, generator=generator
            )
            final_h = next_hidden[rows, _last_true(next_mask)][:, None, :]
            live = 1 - batch.next_dones.float()
            tq1_final = head(q1_target_params, final_h).amax(dim=-1).squeeze(1) * live
            tq2_final = head(q2_target_params, final_h).amax(dim=-1).squeeze(1) * live
        else:
            last_token_idx = _last_true(attention_mask)
            live = 1 - batch.dones.float()
            tq1_final = tq1_out.amax(dim=-1)[rows, last_token_idx] * live
            tq2_final = tq2_out.amax(dim=-1)[rows, last_token_idx] * live

    return cql_loss(
        *gather_batch(
            mesh,
            q1,
            q2,
            target_q1,
            target_q2,
            tq1_final,
            tq2_final,
            q1_out[:, :-1].float(),
            q2_out[:, :-1].float(),
            input_ids[:, 1:],
            attention_mask[:, 1:].float(),
            batch.should_take_action,
            batch.rewards,
        ),
        gamma=config.gamma,
        cql_weight=config.cql_weight,
    )


def make_cql_train_step(
    core: LMCore, config: CQLConfig, pad_token_id: int, mesh: Optional[Mesh] = None
) -> Callable[[CQLTrainState, ILQLBatch, Optional[torch.Generator]], Tuple[CQLTrainState, torch.Tensor, Any]]:
    """step(state, batch, generator=None) → (state, loss, logs); the state is
    updated in place. `generator` draws the dropout masks."""

    def step(state: CQLTrainState, batch: ILQLBatch, generator: Optional[torch.Generator] = None):
        loss, logs = cql_forward(
            core,
            state.base.params, state.target_base_params,
            state.q1_head.params, state.q2_head.params,
            state.q1_target_params, state.q2_target_params,
            batch, config, pad_token_id, train=True, generator=generator, mesh=mesh,
        )
        base_g, q1_g, q2_g = value_and_grads(loss, (state.base.params, state.q1_head.params, state.q2_head.params))
        state.base.apply_gradients(base_g)
        state.q1_head.apply_gradients(q1_g)
        state.q2_head.apply_gradients(q2_g)
        if state.target_base_params is not None:
            update_target(state.base, state.target_base_params, config)
        update_target(state.q1_head, state.q1_target_params, config)
        update_target(state.q2_head, state.q2_target_params, config)
        return state, loss.detach(), detach_logs(logs)

    return sharded_step(step, mesh)
