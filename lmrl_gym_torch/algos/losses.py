"""Loss functions of every algorithm: the port of
`lmrl_gym_tpu/algos/losses.py` (`select_at_mask`, `next_state_mask`,
`ilql_loss`, `cql_loss`, `mc_loss`, `ppo_loss`, `masked_lm_loss`, `whiten`,
`gae_advantages_and_returns`, `reward_to_go`).

Shift conventions as in the JAX package: values q/v are model outputs at
positions x[:-1]; token_ids / should_take_action / rewards are shifted
x[1:]; all arrays are [batch, time-1]. Every selection keeps a fixed shape:
no `torch.nonzero`, whose data-dependent size would make the host wait for
the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from lmrl_gym_torch.core.logs import get_tensor_stats

Scalar = Union[float, torch.Tensor]


def l2_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """optax.l2_loss: ½(x − y)²."""
    return 0.5 * (predictions - targets) ** 2


def softmax_cross_entropy_with_integer_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's: −log_softmax(logits)[label] over the last axis, in the
    logits' dtype."""
    return -torch.gather(F.log_softmax(logits, dim=-1), -1, labels[..., None].long())[..., 0]


def select_at_mask(values_flat: torch.Tensor, mask_flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather `values_flat` at True positions of `mask_flat`, in order,
    zero-padded to full length → (selected [N], sel_mask [N]): the JAX
    package's `argwhere(size=N, fill_value=N)` + fill-gather. A stable sort
    of the unselected flag puts the selected positions first, in order: a
    permutation, so no two elements meet in one slot (a scatter of the
    unselected ones into one spare slot costs a serial pass over them under
    CUDA's deterministic algorithms)."""
    N = mask_flat.shape[0]
    mask = mask_flat.bool()
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    sel = torch.arange(N, device=mask.device) < mask.sum()
    return torch.where(sel, values_flat[order], 0), sel.to(values_flat.dtype)


def next_state_mask(should_take_action: torch.Tensor) -> torch.Tensor:
    """[b, t] next-state indicator from a [b, t-1] action mask: the action
    mask with each row's first action cleared, plus an endpoint column
    (True iff the row has ≥ 1 action)."""
    sta = should_take_action.bool()
    b = sta.shape[0]
    first_action = torch.argmax(sta.int(), dim=1)
    cleared = sta.clone()
    cleared[torch.arange(b, device=sta.device), first_action] = False
    endpoint = sta.any(dim=1, keepdim=True)
    return torch.cat((cleared, endpoint), dim=1)


def ilql_loss(
    q1: torch.Tensor,
    q2: torch.Tensor,
    v: torch.Tensor,
    v_final: torch.Tensor,  # [batch]
    target_q1: torch.Tensor,
    target_q2: torch.Tensor,
    q1_logits: torch.Tensor,  # [b, t-1, vocab]
    q2_logits: torch.Tensor,
    token_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    should_take_action: torch.Tensor,
    rewards: torch.Tensor,
    *,
    gamma: Scalar,
    tau: Scalar,
    cql_weight: Scalar,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Per-token implicit Q-learning loss: Bellman L2 on both Q heads vs
    r + γ·V(next state), expectile-weighted V regression vs min(target Q),
    plus CQL cross-entropy on the Q logits."""
    mask = should_take_action.float() * attention_mask
    # an all-dead batch yields loss 0, not 0/0
    n = torch.clamp(mask.sum(), min=1.0)

    sta_flat = should_take_action.reshape(-1)
    q1_sel, sa_mask = select_at_mask(q1.reshape(-1), sta_flat)
    q2_sel, _ = select_at_mask(q2.reshape(-1), sta_flat)
    v_sel, _ = select_at_mask(v.reshape(-1), sta_flat)
    tq1_sel, _ = select_at_mask(target_q1.reshape(-1), sta_flat)
    tq2_sel, _ = select_at_mask(target_q2.reshape(-1), sta_flat)
    r_sel, _ = select_at_mask(rewards.reshape(-1), sta_flat)

    # V(next state): V at token positions plus a bootstrap column v_final
    vns_flat = torch.cat((v, v_final[:, None]), dim=1).reshape(-1)
    ns_flat = next_state_mask(should_take_action).reshape(-1)
    vns_sel, ns_mask = select_at_mask(vns_flat, ns_flat)
    vns_sel = vns_sel[: q1_sel.shape[0]]
    ns_mask = ns_mask[: q1_sel.shape[0]]

    target = (r_sel + gamma * vns_sel).detach()
    q1_loss = (l2_loss(q1_sel, target) * sa_mask).sum() / n
    q2_loss = (l2_loss(q2_sel, target) * sa_mask).sum() / n

    target_q_sel = torch.minimum(tq1_sel, tq2_sel)
    expectile_ind = (target_q_sel >= v_sel).float()
    expectile_w = expectile_ind * tau + (1 - expectile_ind) * (1 - tau)
    v_loss = (l2_loss(v_sel, target_q_sel.detach()) * expectile_w.detach() * sa_mask).sum() / n

    q1_cql = (mask * softmax_cross_entropy_with_integer_labels(q1_logits, token_ids)).sum() / n
    q2_cql = (mask * softmax_cross_entropy_with_integer_labels(q2_logits, token_ids)).sum() / n

    loss = q1_loss + q2_loss + v_loss + cql_weight * (q1_cql + q2_cql)

    logs = dict(
        losses=dict(
            total_loss=loss,
            q1_loss=q1_loss,
            q2_loss=q2_loss,
            v_loss=v_loss,
            q1_cql_loss=q1_cql,
            q2_cql_loss=q2_cql,
        ),
        q1=get_tensor_stats(q1_sel, mask=sa_mask, n=n),
        q2=get_tensor_stats(q2_sel, mask=sa_mask, n=n),
        v=get_tensor_stats(v_sel, mask=sa_mask, n=n),
        target_q=get_tensor_stats(target_q_sel, mask=sa_mask, n=n),
        vns=get_tensor_stats(vns_sel, mask=ns_mask, n=n),
        v_final=get_tensor_stats(v_final, mask=torch.ones_like(v_final), n=v_final.shape[0]),
        rewards=get_tensor_stats(rewards, mask=mask, n=n),
    )
    return loss, logs


def cql_loss(
    q1: torch.Tensor,
    q2: torch.Tensor,
    target_q1: torch.Tensor,
    target_q2: torch.Tensor,
    target_q1_final: torch.Tensor,  # [batch]
    target_q2_final: torch.Tensor,  # [batch]
    q1_logits: torch.Tensor,
    q2_logits: torch.Tensor,
    token_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    should_take_action: torch.Tensor,
    rewards: torch.Tensor,
    *,
    gamma: Scalar,
    cql_weight: Scalar,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """SARSA-style CQL: ILQL without the V head — the Bellman target is the
    min over the target Qs at the next action."""
    mask = should_take_action.float() * attention_mask
    n = torch.clamp(mask.sum(), min=1.0)

    sta_flat = should_take_action.reshape(-1)
    q1_sel, a_mask = select_at_mask(q1.reshape(-1), sta_flat)
    q2_sel, _ = select_at_mask(q2.reshape(-1), sta_flat)
    r_sel, _ = select_at_mask(rewards.reshape(-1), sta_flat)

    tq1_flat = torch.cat((target_q1, target_q1_final[:, None]), dim=1).reshape(-1)
    tq2_flat = torch.cat((target_q2, target_q2_final[:, None]), dim=1).reshape(-1)
    ns_flat = next_state_mask(should_take_action).reshape(-1)
    tq1ns_sel, ans_mask = select_at_mask(tq1_flat, ns_flat)
    tq2ns_sel, _ = select_at_mask(tq2_flat, ns_flat)
    tq1ns_sel = tq1ns_sel[: q1_sel.shape[0]]
    tq2ns_sel = tq2ns_sel[: q1_sel.shape[0]]
    ans_mask = ans_mask[: q1_sel.shape[0]]

    target_qns = torch.minimum(tq1ns_sel, tq2ns_sel)
    target = (r_sel + gamma * target_qns).detach()
    q1_loss = (l2_loss(q1_sel, target) * a_mask).sum() / n
    q2_loss = (l2_loss(q2_sel, target) * a_mask).sum() / n

    q1_cql = (mask * softmax_cross_entropy_with_integer_labels(q1_logits, token_ids)).sum() / n
    q2_cql = (mask * softmax_cross_entropy_with_integer_labels(q2_logits, token_ids)).sum() / n

    loss = q1_loss + q2_loss + cql_weight * (q1_cql + q2_cql)
    logs = dict(
        losses=dict(total_loss=loss, q1_loss=q1_loss, q2_loss=q2_loss, q1_cql_loss=q1_cql, q2_cql_loss=q2_cql),
        q1=get_tensor_stats(q1_sel, mask=a_mask, n=n),
        q2=get_tensor_stats(q2_sel, mask=a_mask, n=n),
        target_qns=get_tensor_stats(target_qns, mask=ans_mask, n=n),
        rewards=get_tensor_stats(rewards, mask=mask, n=n),
    )
    return loss, logs


def mc_loss(
    q: torch.Tensor,
    q_logits: torch.Tensor,
    token_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    should_take_action: torch.Tensor,
    returns: torch.Tensor,
    *,
    cql_weight: Scalar,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Reward-to-go Q regression plus the CQL cross-entropy."""
    mask = should_take_action.float() * attention_mask
    n = torch.clamp(mask.sum(), min=1.0)

    sta_flat = should_take_action.reshape(-1)
    q_sel, a_mask = select_at_mask(q.reshape(-1), sta_flat)
    ret_sel, _ = select_at_mask(returns.reshape(-1), sta_flat)

    q_loss = (l2_loss(q_sel, ret_sel.detach()) * a_mask).sum() / n
    q_cql = (mask * softmax_cross_entropy_with_integer_labels(q_logits, token_ids)).sum() / n

    loss = q_loss + cql_weight * q_cql
    logs = dict(
        losses=dict(total_loss=loss, q_loss=q_loss, q_cql_loss=q_cql),
        q=get_tensor_stats(q_sel, mask=a_mask, n=n),
        returns=get_tensor_stats(ret_sel, mask=a_mask, n=n),
    )
    return loss, logs


def ppo_loss(
    attention_mask: torch.Tensor,
    logprobs: torch.Tensor,
    values: torch.Tensor,
    should_take_action: torch.Tensor,
    old_logprobs: torch.Tensor,
    old_values: torch.Tensor,
    old_advantages: torch.Tensor,
    old_returns: torch.Tensor,
    *,
    cliprange_value: Scalar,
    cliprange: Scalar,
    value_loss_coef: Scalar,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Clipped PPO objective over action tokens (trlx-derived)."""
    mask = should_take_action.float() * attention_mask
    n = torch.clamp(mask.sum(), min=1.0)

    values_clipped = torch.clamp(values, old_values - cliprange_value, old_values + cliprange_value)
    vf_loss1 = (values - old_returns) ** 2
    vf_loss2 = (values_clipped - old_returns) ** 2
    vf_loss = 0.5 * torch.sum(torch.maximum(vf_loss1, vf_loss2) * mask) / n
    vf_clipfrac = torch.sum((vf_loss2 > vf_loss1).float() * mask) / n

    log_ratio = (logprobs - old_logprobs) * mask
    ratio = torch.exp(log_ratio)
    # k3 unbiased KL estimate (http://joschu.net/blog/kl-approx.html)
    approx_kl = torch.sum((ratio - 1) - log_ratio) / n

    pg_loss1 = -old_advantages * ratio
    pg_loss2 = -old_advantages * torch.clamp(ratio, 1.0 - cliprange, 1.0 + cliprange)
    pg_loss = torch.sum(torch.maximum(pg_loss1, pg_loss2) * mask) / n
    pg_clipfrac = torch.sum((pg_loss2 > pg_loss1).float() * mask) / n

    loss = pg_loss + value_loss_coef * vf_loss

    logs = dict(
        losses=dict(total_loss=loss, policy_loss=pg_loss, value_loss=vf_loss),
        values=dict(
            get_tensor_stats(values, mask, n),
            values_error=torch.sum(((values - old_returns) * mask) ** 2) / n,
            clipfrac=vf_clipfrac,
        ),
        old_values=get_tensor_stats(old_values, mask, n),
        returns=get_tensor_stats(old_returns, mask, n),
        policy=dict(approx_kl=approx_kl, clipfrac=pg_clipfrac),
        ratio=(ratio * mask).sum() / n,
        padding_percentage=n / mask.numel(),
    )
    return loss, logs


def masked_lm_loss(
    logits: torch.Tensor,  # [b, t, vocab] (positions x[:-1])
    target_ids: torch.Tensor,  # [b, t] (x[1:])
    attention_mask: torch.Tensor,  # [b, t]
    training_mask: torch.Tensor,  # [b, t] — 1 on tokens that contribute fully
    *,
    non_train_weight: Scalar = 0.0,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """LM cross-entropy with down-weighted non-training tokens (BC on
    action tokens only with non_train_weight=0)."""
    token_losses = softmax_cross_entropy_with_integer_labels(logits, target_ids) * attention_mask
    weights = training_mask + (1 - training_mask) * non_train_weight
    loss = (token_losses * weights).sum() / torch.clamp(attention_mask.sum(), min=1)
    return loss, {"loss": loss}


def whiten(xs: torch.Tensor, mask: Optional[torch.Tensor] = None, shift_mean: bool = True) -> torch.Tensor:
    """Normalize to unit variance; without a mask the variance has ddof 0,
    as `jnp.var`."""
    if mask is None:
        mean, var = xs.mean(), xs.var(unbiased=False)
    else:
        n = torch.clamp(mask.sum(), min=1)
        mean = (xs * mask).sum() / n
        var = (((xs - mean) ** 2) * mask).sum() / n
    out = (xs - mean) * torch.rsqrt(var + 1e-8)
    if not shift_mean:
        out = out + mean
    return out


def gae_advantages_and_returns(
    state_values: torch.Tensor,  # [b, n] per action position
    next_state_values: torch.Tensor,  # [b, n]
    action_rewards: torch.Tensor,  # [b, n]
    *,
    gamma: Scalar,
    lam: Scalar,
    use_whitening: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over action positions: the JAX package's reverse `lax.scan` as a
    reversed loop over the action axis, in the scan's order of sums."""
    delta = action_rewards + gamma * next_state_values - state_values
    advantages = torch.zeros_like(state_values)
    lastgaelam = torch.zeros_like(state_values[:, 0])
    for t in reversed(range(state_values.shape[1])):
        lastgaelam = delta[:, t] + gamma * lam * lastgaelam
        advantages[:, t] = lastgaelam
    returns = advantages + state_values
    if use_whitening:
        advantages = whiten(advantages)
    return advantages, returns


def reward_to_go(action_rewards: torch.Tensor, *, gamma: Scalar) -> torch.Tensor:
    """Discounted reward-to-go over action positions [b, n] → [b, n], a
    reversed loop over the action axis (the JAX package's reverse scan)."""
    rtg = torch.zeros_like(action_rewards)
    acc = torch.zeros_like(action_rewards[:, 0])
    for t in reversed(range(action_rewards.shape[1])):
        acc = action_rewards[:, t] + gamma * acc
        rtg[:, t] = acc
    return rtg
