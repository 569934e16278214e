"""PPO: clipped policy-gradient fine-tuning with a value head. The port of
`lmrl_gym_tpu/algos/ppo.py`:

- KL controllers (host floats);
- train step: a joint update of the policy and the value head, with an
  optional BC term on a separate masked-LM batch (a second trunk forward
  whose gradient is added to the first); the state is updated in place;
- the GAE data pipeline: each trajectory chain flattened into one token
  stream with chunk lengths, batched forwards for the π₀/π logprobs and the
  values, the per-token KL penalty r −= kl·(logπ − logπ₀), GAE over action
  positions only (next-state index = action mask with the first action
  cleared + a bootstrap endpoint), batch-global advantage whitening, and a
  re-scatter into per-window `PPOData`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from lmrl_gym_torch.algos.losses import (
    gae_advantages_and_returns,
    masked_lm_loss,
    ppo_loss,
    softmax_cross_entropy_with_integer_labels,
    whiten,
)
from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation, block_sequences
from lmrl_gym_torch.core.logs import detach_logs
from lmrl_gym_torch.core.optimizer import TrainState, value_and_grads
from lmrl_gym_torch.models.interface import LMCore, initialize_attn_mask_pos_ids
from lmrl_gym_torch.models.transformer import Transformer
from lmrl_gym_torch.text.frames import TokenTrajectoryChain


class AdaptiveKLController:
    """βₜ₊₁ = βₜ·(1 + clip(kl/target − 1, ±0.2)·n/horizon)."""

    def __init__(self, init_kl_coef: float, target: float, horizon: int):
        self.value = init_kl_coef
        self.target = target
        self.horizon = horizon

    def update(self, current: float, n_steps: int):
        proportional_error = float(np.clip(current / self.target - 1, -0.2, 0.2))
        self.value *= 1 + proportional_error * n_steps / self.horizon


class FixedKLController:
    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current: float, n_steps: int):
        pass


@dataclass(frozen=True)
class PPOConfig:
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    value_loss_coef: float = 1.0
    bc_loss_weight: float = 0.0
    use_advantage_whitening: bool = True

    def to_dict(self) -> dict:
        import dataclasses

        return dataclasses.asdict(self)


class PPOBatch(NamedTuple):
    input_ids: torch.Tensor  # [b, t]
    should_take_action: torch.Tensor  # [b, t-1]
    old_logprobs: torch.Tensor  # [b, t-1]
    old_values: torch.Tensor  # [b, t-1]
    old_advantages: torch.Tensor  # [b, t-1]
    old_returns: torch.Tensor  # [b, t-1]
    bc_input_ids: Optional[torch.Tensor] = None  # [b2, t2]
    bc_training_mask: Optional[torch.Tensor] = None  # [b2, t2]


@dataclass
class PPOTrainState:
    policy: TrainState
    value_head: TrainState


def token_logprobs_from_logits(logits: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
    """[b, t-1] logprob of each realized next token, in f32."""
    return -softmax_cross_entropy_with_integer_labels(logits[:, :-1].float(), input_ids[:, 1:])


def ppo_forward(
    core: LMCore,
    policy_params: Transformer,
    value_head_params: nn.Module,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    position_ids: torch.Tensor,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits [b,t,V], values [b,t])."""
    logits, hidden = core.forward(policy_params, input_ids, attention_mask, position_ids, train=train,
                                  generator=generator)
    values = value_head_params(hidden, deterministic=not train, generator=generator).squeeze(-1)
    return logits, values


def make_ppo_train_step(
    core: LMCore, config: PPOConfig, pad_token_id: int
) -> Callable[[PPOTrainState, PPOBatch, Optional[torch.Generator]], Tuple[PPOTrainState, torch.Tensor, Any]]:
    """step(state, batch, generator=None) → (state, loss, logs)."""

    def step(state: PPOTrainState, batch: PPOBatch, generator: Optional[torch.Generator] = None):
        policy, value_head = state.policy.params, state.value_head.params
        attention_mask, position_ids = initialize_attn_mask_pos_ids(batch.input_ids, pad_token_id)
        logits, values = ppo_forward(core, policy, value_head, batch.input_ids, attention_mask, position_ids,
                                     train=True, generator=generator)
        loss, logs = ppo_loss(
            attention_mask=attention_mask[:, 1:].float(),
            logprobs=token_logprobs_from_logits(logits, batch.input_ids),
            values=values[:, :-1],
            should_take_action=batch.should_take_action,
            old_logprobs=batch.old_logprobs,
            old_values=batch.old_values,
            old_advantages=batch.old_advantages,
            old_returns=batch.old_returns,
            cliprange_value=config.cliprange_value,
            cliprange=config.cliprange,
            value_loss_coef=config.value_loss_coef,
        )
        if batch.bc_input_ids is not None and config.bc_loss_weight != 0.0:
            bc_mask, bc_pos = initialize_attn_mask_pos_ids(batch.bc_input_ids, pad_token_id)
            bc_logits, _ = core.forward(policy, batch.bc_input_ids, bc_mask, bc_pos, train=True, generator=generator)
            bc_loss_val, _ = masked_lm_loss(
                bc_logits[:, :-1],
                batch.bc_input_ids[:, 1:],
                bc_mask[:, 1:].float(),
                batch.bc_training_mask[:, 1:].float(),
            )
            loss = loss + config.bc_loss_weight * bc_loss_val
            logs = dict(logs, bc_loss=bc_loss_val)
        policy_g, head_g = value_and_grads(loss, (policy, value_head))
        state.policy.apply_gradients(policy_g)
        state.value_head.apply_gradients(head_g)
        return state, loss.detach(), detach_logs(logs)

    return step


def _f32(x: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


# ---------------- data pipeline ----------------


class PPOData(NamedTuple):
    """One training window."""

    input_ids: np.ndarray  # [t]
    should_take_action: np.ndarray  # [t-1]
    old_logprobs: np.ndarray  # [t-1]
    old_values: np.ndarray  # [t-1]
    old_advantages: np.ndarray  # [t-1]
    old_returns: np.ndarray  # [t-1]


def block_ppo_data(
    data: List[PPOData],
    strategy: BlockingStrategy,
    pad_token_id: int,
) -> Dict[str, np.ndarray]:
    shifted = BlockingStrategy(strategy.padding, strategy.truncation, strategy.max_length - 1)
    return dict(
        input_ids=block_sequences([d.input_ids for d in data], pad_token_id, np.int32, strategy),
        should_take_action=block_sequences(
            [d.should_take_action for d in data], False, np.bool_, shifted
        ),
        old_logprobs=block_sequences([d.old_logprobs for d in data], 0.0, np.float32, shifted),
        old_values=block_sequences([d.old_values for d in data], 0.0, np.float32, shifted),
        old_advantages=block_sequences(
            [d.old_advantages for d in data], 0.0, np.float32, shifted
        ),
        old_returns=block_sequences([d.old_returns for d in data], 0.0, np.float32, shifted),
    )


def fold_trajectory_to_length(
    trajectory,
    tokenizer,
    max_length: int,
    gamma: float = 1.0,
):
    """Context-overflow folding: while the tokenized trajectory exceeds max_length, drop the trailing
    (state, action) pair and fold its discounted reward into the new last
    action. Returns a TextTrajectory that fits (or has one action left)."""
    from lmrl_gym_torch.text.frames import TextTrajectory

    history = list(trajectory.text_history)
    rewards = list(trajectory.reward)

    def total_tokens():
        return sum(len(tokenizer.encode(t.text)) for t in history)

    while total_tokens() > max_length:
        action_idxs = [i for i, t in enumerate(history) if t.is_action]
        if len(action_idxs) <= 1:
            break
        last_a, prev_a = action_idxs[-1], action_idxs[-2]
        folded = rewards[last_a]
        history = history[: prev_a + 1]
        rewards = rewards[: prev_a + 1]
        rewards[prev_a] = rewards[prev_a] + gamma * folded
    return TextTrajectory(tuple(history), tuple(rewards), trajectory.done)


class CombinedChain(NamedTuple):
    """Chain flattened to one token stream."""

    input_tokens: np.ndarray
    output_tokens: np.ndarray
    rewards: np.ndarray
    should_take_action: np.ndarray
    done: np.ndarray
    chunk_lens: List[int]

    @classmethod
    def from_chain(cls, chain: TokenTrajectoryChain, max_length: Optional[int] = None) -> "CombinedChain":
        tts = chain.to_list()
        assert len(tts) > 0
        if max_length is None:
            max_length = max(tt.tokens.shape[0] for tt in tts) + 1
        assert not any(tt.done for tt in tts[:-1]), "done only at chain end"
        for i, tt in enumerate(tts):
            no_trunc = (tt.tokens.shape[0] - 1) <= max_length
            ends_with_state = not np.any(tt.is_action[1:][max_length:])
            next_starts_with_action = i < len(tts) - 1 and tts[i + 1].is_action[0]
            assert not (ends_with_state and next_starts_with_action), "trajectory truncation error"
            assert no_trunc or ends_with_state, "trajectory truncation error"
        return cls(
            input_tokens=np.concatenate([tt.tokens[:-1][:max_length] for tt in tts]),
            output_tokens=np.concatenate([tt.tokens[1:][:max_length] for tt in tts]),
            rewards=np.concatenate([tt.reward[1:][:max_length] for tt in tts]),
            should_take_action=np.concatenate([tt.is_action[1:][:max_length] for tt in tts]),
            done=np.asarray(tts[-1].done),
            chunk_lens=[min(tt.tokens.shape[0] - 1, max_length) for tt in tts],
        )

    def unroll(self, arr: np.ndarray) -> List[np.ndarray]:
        assert arr.shape[0] == self.input_tokens.shape[0]
        return np.split(arr, np.cumsum(self.chunk_lens)[:-1], axis=0)


def action_state_next_state_idxs(should_take_action: np.ndarray):
    """Action/state idxs = action positions; next-state idxs = action mask with first action cleared + endpoint."""
    action_idxs = np.where(should_take_action)[0]
    is_next_state = should_take_action.copy()
    if is_next_state.any():
        is_next_state[np.argmax(is_next_state.astype(np.int32))] = False
    is_next_state = np.concatenate(
        (is_next_state, np.asarray([should_take_action.sum() > 0]))
    )
    next_state_idxs = np.where(is_next_state)[0]
    assert action_idxs.shape == next_state_idxs.shape
    return action_idxs, action_idxs, next_state_idxs


def unpad_array(arr: np.ndarray, mask: np.ndarray) -> np.ndarray:
    return arr[: int(mask.sum())]


ForwardFn = Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray, np.ndarray]]
# forward_fn(tokens [b,t]) -> (initial_logprobs [b,t-1], logprobs [b,t-1], values [b,t])


def make_ppo_forward_fn(
    core: LMCore,
    initial_policy_params: Transformer,
    policy_params: Transformer,
    value_head_params: nn.Module,
    pad_token_id: int,
) -> ForwardFn:
    """Two trunk forwards (the initial and the current policy) and the value
    head on the policy's device, returned as numpy."""
    device = next(policy_params.parameters()).device

    def forward_fn(tokens):
        with torch.no_grad():
            tokens = torch.as_tensor(np.asarray(tokens), device=device)
            attention_mask, position_ids = initialize_attn_mask_pos_ids(tokens, pad_token_id)
            init_logits, _ = core.forward(initial_policy_params, tokens, attention_mask, position_ids)
            logits, values = ppo_forward(core, policy_params, value_head_params, tokens, attention_mask, position_ids)
            out = (
                token_logprobs_from_logits(init_logits, tokens),
                token_logprobs_from_logits(logits, tokens),
                values.float(),
            )
        return tuple(x.cpu().numpy() for x in out)

    return forward_fn


def get_ppo_data_from_chains(
    forward_fn: ForwardFn,
    tokenizer,
    chains: List[TokenTrajectoryChain],
    bsize: int,
    max_length: Optional[int] = None,
    *,
    gamma: float,
    lam: float,
    kl_weight: float,
    use_advantage_whitening: bool = True,
) -> Tuple[List[PPOData], np.ndarray]:
    """The GAE pipeline. Returns (ppo_datas, per-action-token KL estimates
    for the controller). GAE and whitening run in float32 tensors on the
    CPU, as the JAX package runs them in float32 arrays."""
    n_chains = len(chains)
    combined = [
        CombinedChain.from_chain(c, max_length - 1 if max_length is not None else None)
        for c in chains
    ]
    all_windows: List[np.ndarray] = []
    for c in chains:
        all_windows.extend(tt.tokens for tt in c.to_list())
    tokens = block_sequences(
        all_windows,
        tokenizer.pad_token_id,
        np.int32,
        BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, max_length),
    )

    init_lps, lps, vals = [], [], []
    for i in range(0, len(tokens), bsize):
        a, b, v = forward_fn(tokens[i : i + bsize])
        init_lps.append(a)
        lps.append(b)
        vals.append(v)
    init_lps = np.concatenate(init_lps, axis=0)
    lps = np.concatenate(lps, axis=0)
    vals = np.concatenate(vals, axis=0)

    sections = np.cumsum([len(c.chunk_lens) for c in combined])[:-1]
    mask_by_chain = np.split(tokens != tokenizer.pad_token_id, sections, axis=0)
    init_by_chain = np.split(init_lps, sections, axis=0)
    lp_by_chain = np.split(lps, sections, axis=0)
    val_by_chain = np.split(vals, sections, axis=0)

    # per chain: concat unpadded per-window streams
    init_chain = [
        np.concatenate([unpad_array(x, m) for x, m in zip(item, mask[:, 1:])])
        for mask, item in zip(mask_by_chain, init_by_chain)
    ]
    lp_chain = [
        np.concatenate([unpad_array(x, m) for x, m in zip(item, mask[:, 1:])])
        for mask, item in zip(mask_by_chain, lp_by_chain)
    ]
    val_chain = [
        np.concatenate([unpad_array(x, m)[:-1] for x, m in zip(item, mask)])
        for mask, item in zip(mask_by_chain, val_by_chain)
    ]
    # bootstrap: last window's last real value, zeroed when done
    last_vals = [
        unpad_array(item[-1], mask[-1])[-1]
        for mask, item in zip(mask_by_chain, val_by_chain)
    ]
    val_chain = [
        np.concatenate((v, last_vals[i][None] * (1.0 - float(combined[i].done))))
        for i, v in enumerate(val_chain)
    ]

    # KL penalty on rewards at action positions
    log_ratio = [
        (lp - ilp) * c.should_take_action.astype(np.float32)
        for ilp, lp, c in zip(init_chain, lp_chain, combined)
    ]
    flat_sta = np.concatenate([c.should_take_action.reshape(-1) for c in combined])
    valid_idxs = np.argwhere(flat_sta)[:, 0]
    all_log_ratio = np.concatenate([lr.reshape(-1) for lr in log_ratio])[valid_idxs]
    all_kls = np.exp(all_log_ratio) - 1 - all_log_ratio
    combined = [
        c._replace(rewards=c.rewards - kl_weight * lr)
        for c, lr in zip(combined, log_ratio)
    ]

    # per-chain GAE over action positions
    all_adv, all_ret = [], []
    for i in range(n_chains):
        action_idxs, state_idxs, next_state_idxs = action_state_next_state_idxs(
            combined[i].should_take_action
        )
        adv, ret = gae_advantages_and_returns(
            _f32(val_chain[i][state_idxs])[None],
            _f32(val_chain[i][next_state_idxs])[None],
            _f32(combined[i].rewards[action_idxs])[None],
            gamma=gamma,
            lam=lam,
            use_whitening=False,
        )
        all_adv.append(adv[0].numpy())
        all_ret.append(ret[0].numpy())

    # batch-global whitening
    if use_advantage_whitening:
        flat = np.concatenate(all_adv)
        flat = whiten(_f32(flat), shift_mean=True).numpy()
        pos = 0
        for i in range(n_chains):
            ln = all_adv[i].shape[0]
            all_adv[i] = flat[pos : pos + ln]
            pos += ln

    # scatter back onto token positions and unroll into windows
    ppo_datas: List[PPOData] = []
    for i in range(n_chains):
        action_idxs, _, _ = action_state_next_state_idxs(combined[i].should_take_action)
        adv_tok = np.zeros((val_chain[i].shape[0] - 1,), np.float32)
        adv_tok[action_idxs] = all_adv[i]
        ret_tok = np.zeros((val_chain[i].shape[0] - 1,), np.float32)
        ret_tok[action_idxs] = all_ret[i]

        window_tokens = [
            tt.tokens[:max_length] for tt in chains[i].to_list()
        ]
        sta_w = combined[i].unroll(combined[i].should_take_action)
        lp_w = combined[i].unroll(lp_chain[i])
        val_w = combined[i].unroll(val_chain[i][:-1])
        adv_w = combined[i].unroll(adv_tok)
        ret_w = combined[i].unroll(ret_tok)
        for w in range(len(combined[i].chunk_lens)):
            ppo_datas.append(
                PPOData(
                    input_ids=window_tokens[w],
                    should_take_action=sta_w[w],
                    old_logprobs=lp_w[w],
                    old_values=val_w[w],
                    old_advantages=adv_w[w],
                    old_returns=ret_w[w],
                )
            )
    return ppo_datas, all_kls
