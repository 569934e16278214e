"""Behavior cloning: masked-LM fine-tuning. The port of
`lmrl_gym_tpu/algos/bc.py`: the loss counts action tokens fully and the
others with `non_action_weight`. The step updates the state in place."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from lmrl_gym_torch.algos.losses import masked_lm_loss
from lmrl_gym_torch.core.logs import detach_logs
from lmrl_gym_torch.core.optimizer import Params, TrainState, value_and_grads
from lmrl_gym_torch.models.interface import LMCore, initialize_attn_mask_pos_ids
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.parallel.mesh import Mesh, gather_batch, sharded_step


@dataclass(frozen=True)
class BCConfig:
    non_action_weight: float = 0.0


class BCBatch(NamedTuple):
    input_ids: torch.Tensor  # [b, t]
    training_mask: torch.Tensor  # [b, t] — 1 on tokens that count


@dataclass
class BCTrainState:
    model: TrainState


def bc_loss_from_params(
    core: LMCore,
    params: Transformer,
    batch: BCBatch,
    config: BCConfig,
    pad_token_id: int,
    train: bool,
    generator: Optional[torch.Generator] = None,
    mesh: Optional[Mesh] = None,
):
    attention_mask, position_ids = initialize_attn_mask_pos_ids(batch.input_ids, pad_token_id)
    logits, _ = core.forward(params, batch.input_ids, attention_mask, position_ids, train=train, generator=generator)
    return masked_lm_loss(
        *gather_batch(
            mesh,
            logits[:, :-1],
            batch.input_ids[:, 1:],
            attention_mask[:, 1:].float(),
            batch.training_mask[:, 1:].float(),
        ),
        non_train_weight=config.non_action_weight,
    )


def bc_loss_and_grads(
    core: LMCore, state: BCTrainState, batch: BCBatch, config: BCConfig, pad_token_id: int,
    generator: Optional[torch.Generator] = None, mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, Any, Params]:
    loss, logs = bc_loss_from_params(core, state.model.params, batch, config, pad_token_id, train=True,
                                     generator=generator, mesh=mesh)
    (grads,) = value_and_grads(loss, (state.model.params,))
    return loss.detach(), detach_logs(logs), grads


def make_bc_train_step(
    core: LMCore, config: BCConfig, pad_token_id: int, mesh: Optional[Mesh] = None
) -> Callable[[BCTrainState, BCBatch, Optional[torch.Generator]], Tuple[BCTrainState, torch.Tensor, Any]]:
    """step(state, batch, generator=None) → (state, loss, logs). Under a
    distributed `mesh` each rank takes its rows of the global batch (and,
    through `core`, its slice of the sequence under sp)."""

    def step(state: BCTrainState, batch: BCBatch, generator: Optional[torch.Generator] = None):
        loss, logs, grads = bc_loss_and_grads(core, state, batch, config, pad_token_id, generator, mesh)
        state.model.apply_gradients(grads)
        return state, loss, logs

    return sharded_step(step, mesh)


def make_bc_eval_loss(core: LMCore, config: BCConfig, pad_token_id: int):
    def eval_loss(state: BCTrainState, batch: BCBatch):
        return bc_loss_from_params(core, state.model.params, batch, config, pad_token_id, train=False)

    return eval_loss
