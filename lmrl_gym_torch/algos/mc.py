"""MC returns: reward-to-go Q regression with one Q head and the CQL term.
The port of `lmrl_gym_tpu/algos/mc.py`: Q(s,a) at the realized token,
gathered from the vocab-sized Q-head logits, regressed onto the chain-level
discounted reward-to-go. The step updates the state in place."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from lmrl_gym_torch.algos.losses import mc_loss
from lmrl_gym_torch.core.logs import detach_logs
from lmrl_gym_torch.core.optimizer import TrainState, value_and_grads
from lmrl_gym_torch.models.interface import LMCore, initialize_attn_mask_pos_ids
from lmrl_gym_torch.models.transformer import Transformer


@dataclass(frozen=True)
class MCConfig:
    gamma: float = 0.99
    cql_weight: float = 0.01
    beta: float = 8.0  # decode-time weight (policy layer)


class MCBatch(NamedTuple):
    input_ids: torch.Tensor  # [b, t]
    should_take_action: torch.Tensor  # [b, t-1]
    returns: torch.Tensor  # [b, t-1]


@dataclass
class MCTrainState:
    base: TrainState
    q_head: TrainState


def mc_loss_from_params(
    core: LMCore,
    base_params: Transformer,
    q_params: nn.Module,
    batch: MCBatch,
    config: MCConfig,
    pad_token_id: int,
    train: bool,
    generator: Optional[torch.Generator] = None,
):
    """One trunk forward and the Q head → (loss, logs)."""
    attention_mask, position_ids = initialize_attn_mask_pos_ids(batch.input_ids, pad_token_id)
    _, hidden = core.forward(base_params, batch.input_ids, attention_mask, position_ids, train=train,
                             generator=generator)
    q_out = q_params(hidden, deterministic=not train, generator=generator)  # [b, t, V]
    q = torch.gather(q_out[:, :-1], 2, batch.input_ids[:, 1:, None].long()).squeeze(2)
    return mc_loss(
        q=q,
        q_logits=q_out[:, :-1].float(),
        token_ids=batch.input_ids[:, 1:],
        attention_mask=attention_mask[:, 1:].float(),
        should_take_action=batch.should_take_action,
        returns=batch.returns,
        cql_weight=config.cql_weight,
    )


def make_mc_train_step(
    core: LMCore, config: MCConfig, pad_token_id: int
) -> Callable[[MCTrainState, MCBatch, Optional[torch.Generator]], Tuple[MCTrainState, torch.Tensor, Any]]:
    """step(state, batch, generator=None) → (state, loss, logs)."""

    def step(state: MCTrainState, batch: MCBatch, generator: Optional[torch.Generator] = None):
        loss, logs = mc_loss_from_params(core, state.base.params, state.q_head.params, batch, config,
                                         pad_token_id, train=True, generator=generator)
        base_g, q_g = value_and_grads(loss, (state.base.params, state.q_head.params))
        state.base.apply_gradients(base_g)
        state.q_head.apply_gradients(q_g)
        return state, loss.detach(), detach_logs(logs)

    return step


def make_mc_eval_loss(core: LMCore, config: MCConfig, pad_token_id: int):
    def eval_loss(state: MCTrainState, batch: MCBatch):
        with torch.no_grad():
            return mc_loss_from_params(core, state.base.params, state.q_head.params, batch, config,
                                       pad_token_id, train=False)

    return eval_loss
