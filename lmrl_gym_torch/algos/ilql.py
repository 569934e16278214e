"""ILQL: per-token implicit Q-learning on a transformer trunk. The port of
`lmrl_gym_tpu/algos/ilql.py`.

- state: the base `TrainState` (+ an optional frozen target base), q1/q2/v
  head `TrainState`s, q1/q2 target heads — modules, as everywhere in the
  port;
- forward: base hidden → q1/q2 heads (vocab-sized logits; Q(s,a) =
  logits[realized next token]), v head (scalar), target heads on the
  (target-)base hidden; v_final bootstraps from the next chain window's
  last real token, zeroed when done;
- update: one backward over (base, q1, q2, v), four optimizer updates, and
  Polyak / periodic target updates gated on grad-accumulation boundaries.

The step updates the state in place and returns it. Forwards whose result
carries no gradient in the JAX package (the target base, the target heads,
the next-window bootstrap, and the base under `freeze_base`) run under
`torch.no_grad()`: the values are the same and autograd keeps none of their
activations. Parameters without a path to the loss get zero gradients, as
`jax.grad` gives them, so Adam's moments and weight decay still apply.
"""
from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from lmrl_gym_torch.algos.losses import ilql_loss
from lmrl_gym_torch.core.logs import detach_logs
from lmrl_gym_torch.core.optimizer import (
    GradientTransformation,
    Params,
    TrainState,
    incremental_update,
    mini_step_of,
    periodic_update,
    value_and_grads,
)
from lmrl_gym_torch.models.interface import LMCore, initialize_attn_mask_pos_ids
from lmrl_gym_torch.models.transformer import Transformer

@dataclass(frozen=True)
class ILQLConfig:
    gamma: float = 0.99
    tau: float = 0.7
    cql_weight: float = 0.01
    beta: float = 8.0  # decode-time advantage weight (policy layer)
    polyak_alpha: float = 0.005
    hard_update_every: Optional[int] = None
    use_separate_target_base: bool = True
    detach_q1: bool = False
    detach_q2: bool = False
    detach_v: bool = False
    # heads train on a stop-gradient view of the trunk features; the base
    # receives zero gradients (pair it with a zero/no-op base optimizer)
    freeze_base: bool = False

    def to_dict(self) -> dict:
        import dataclasses

        return dataclasses.asdict(self)


class ILQLBatch(NamedTuple):
    input_ids: torch.Tensor  # [b, t]
    should_take_action: torch.Tensor  # [b, t-1]
    rewards: torch.Tensor  # [b, t-1]
    dones: torch.Tensor  # [b]
    next_token_ids: Optional[torch.Tensor]  # [b, nt] or None
    next_dones: Optional[torch.Tensor]  # [b] or None


@dataclass
class ILQLTrainState:
    base: TrainState
    target_base_params: Optional[Transformer]
    q1_head: TrainState
    q2_head: TrainState
    v_head: TrainState
    q1_target_params: nn.Module
    q2_target_params: nn.Module


def _frozen_copy(module: nn.Module) -> nn.Module:
    return copy.deepcopy(module).requires_grad_(False)


def init_ilql_state(
    base_params: Transformer,
    q1_params: nn.Module,
    q2_params: nn.Module,
    v_params: nn.Module,
    base_tx: GradientTransformation,
    head_tx: GradientTransformation,
    config: ILQLConfig,
) -> ILQLTrainState:
    """Online modules are trained in place; the targets start as copies."""
    return ILQLTrainState(
        base=TrainState(base_params, base_tx),
        target_base_params=_frozen_copy(base_params) if config.use_separate_target_base else None,
        q1_head=TrainState(q1_params, head_tx),
        q2_head=TrainState(q2_params, head_tx),
        v_head=TrainState(v_params, head_tx),
        q1_target_params=_frozen_copy(q1_params),
        q2_target_params=_frozen_copy(q2_params),
    )


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of each row's last nonzero entry, as (L − 1) −
    argmax(flip(mask)) (L − 1 for an all-zero row)."""
    L = mask.shape[1]
    return (L - 1) - torch.argmax(torch.flip(mask, dims=(1,)).int(), dim=1)


def ilql_forward(
    core: LMCore,
    base_params: Transformer,
    target_base_params: Optional[Transformer],
    q1_params: nn.Module,
    q2_params: nn.Module,
    v_params: nn.Module,
    q1_target_params: nn.Module,
    q2_target_params: nn.Module,
    batch: ILQLBatch,
    config: ILQLConfig,
    pad_token_id: int,
    train: bool,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Any]:
    """Runs all forwards and computes the ILQL loss → (loss, logs)."""
    input_ids = batch.input_ids
    attention_mask, position_ids = initialize_attn_mask_pos_ids(input_ids, pad_token_id)

    with torch.no_grad() if config.freeze_base else contextlib.nullcontext():
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
    v_out = head(v_params, hidden)  # [b, t, 1]
    with torch.no_grad():
        tq1_out = head(q1_target_params, target_hidden)
        tq2_out = head(q2_target_params, target_hidden)

    if config.detach_q1:
        q1_out = q1_out.detach()
    if config.detach_q2:
        q2_out = q2_out.detach()
    if config.detach_v:
        v_out = v_out.detach()

    nxt = input_ids[:, 1:, None].long()
    q1 = torch.gather(q1_out[:, :-1], 2, nxt).squeeze(2)
    q2 = torch.gather(q2_out[:, :-1], 2, nxt).squeeze(2)
    target_q1 = torch.gather(tq1_out[:, :-1], 2, nxt).squeeze(2)
    target_q2 = torch.gather(tq2_out[:, :-1], 2, nxt).squeeze(2)
    v_full = v_out.squeeze(2)
    v = v_full[:, :-1]

    # ---- v_final bootstrap (stopped: no gradient) ----
    b = input_ids.shape[0]
    rows = torch.arange(b, device=input_ids.device)
    with torch.no_grad():
        if batch.next_token_ids is not None:
            next_mask, next_pos = initialize_attn_mask_pos_ids(batch.next_token_ids, pad_token_id)
            _, next_hidden = core.forward(
                base_params, batch.next_token_ids, next_mask, next_pos, train=train, generator=generator
            )
            final_h = next_hidden[rows, _last_true(next_mask)]
            v_final = head(v_params, final_h[:, None, :]).squeeze(2).squeeze(1)
            v_final = v_final * (1 - batch.next_dones.float())
        else:
            sta = batch.should_take_action
            last_action_idx = _last_true(sta) + 1
            last_token_idx = _last_true(attention_mask)
            dones_f = batch.dones.float()
            final_idx = ((1 - dones_f) * last_action_idx + dones_f * last_token_idx).long()
            v_final = v_full[rows, final_idx] * (1 - dones_f)

    return ilql_loss(
        q1,
        q2,
        v,
        v_final,
        target_q1,
        target_q2,
        q1_out[:, :-1].float(),
        q2_out[:, :-1].float(),
        input_ids[:, 1:],
        attention_mask[:, 1:].float(),
        batch.should_take_action,
        batch.rewards,
        gamma=config.gamma,
        tau=config.tau,
        cql_weight=config.cql_weight,
    )


def ilql_loss_and_grads(
    core: LMCore,
    state: ILQLTrainState,
    batch: ILQLBatch,
    config: ILQLConfig,
    pad_token_id: int,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Any, Tuple[Params, Params, Params, Params]]:
    """The training forward and its backward: (loss, logs, (base, q1, q2, v)
    gradients), the `jax.value_and_grad` of the JAX step."""
    loss, logs = ilql_forward(
        core,
        state.base.params, state.target_base_params,
        state.q1_head.params, state.q2_head.params, state.v_head.params,
        state.q1_target_params, state.q2_target_params,
        batch, config, pad_token_id, train=True, generator=generator,
    )
    grads = value_and_grads(
        loss, (state.base.params, state.q1_head.params, state.q2_head.params, state.v_head.params)
    )
    return loss.detach(), detach_logs(logs), grads


def update_target(train_state: TrainState, target: nn.Module, config) -> None:
    """Polyak on every real update (not on grad-accumulation mini steps),
    then the optional periodic hard update on the new step count; `config`
    carries `polyak_alpha` and `hard_update_every` (ILQL's or CQL's)."""
    mini = mini_step_of(train_state.opt_state)
    if mini is not None and mini != 0:
        return
    incremental_update(train_state.params, target, config.polyak_alpha)
    if config.hard_update_every is not None:
        periodic_update(train_state.params, target, train_state.step, config.hard_update_every)


def make_ilql_train_step(
    core: LMCore, config: ILQLConfig, pad_token_id: int
) -> Callable[[ILQLTrainState, ILQLBatch, Optional[torch.Generator]], Tuple[ILQLTrainState, torch.Tensor, Any]]:
    """step(state, batch, generator=None) → (state, loss, logs); the state is
    updated in place. `generator` draws the dropout masks."""

    def step(state: ILQLTrainState, batch: ILQLBatch, generator: Optional[torch.Generator] = None):
        loss, logs, (base_g, q1_g, q2_g, v_g) = ilql_loss_and_grads(core, state, batch, config, pad_token_id, generator)
        state.base.apply_gradients(base_g)
        state.q1_head.apply_gradients(q1_g)
        state.q2_head.apply_gradients(q2_g)
        state.v_head.apply_gradients(v_g)
        if state.target_base_params is not None:
            update_target(state.base, state.target_base_params, config)
        update_target(state.q1_head, state.q1_target_params, config)
        update_target(state.q2_head, state.q2_target_params, config)
        return state, loss, logs

    return step


def make_ilql_eval_loss(core: LMCore, config: ILQLConfig, pad_token_id: int):
    def eval_loss(state: ILQLTrainState, batch: ILQLBatch):
        with torch.no_grad():
            return ilql_forward(
                core,
                state.base.params, state.target_base_params,
                state.q1_head.params, state.q2_head.params, state.v_head.params,
                state.q1_target_params, state.q2_target_params,
                batch, config, pad_token_id, train=False,
            )

    return eval_loss
