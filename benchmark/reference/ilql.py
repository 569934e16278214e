"""Plain ILQL training steps: the loss as the ILQL paper and LMRL-Gym define
it per token, AdamW as optax applies it, and the Polyak target update, in
float32 with TF32 off.

A batch's rows are independent in the loss (a sum over action tokens over
their total count), so a step runs in blocks of rows, each block's part of
the loss differentiated on its own and the gradients summed: the same
gradient at a fraction of the activations.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.gpt import Quant, mlp_head, strict_f32, trunk_hidden

TRAINED = ("base", "q1", "q2", "v")


def leaf_parts(name: str, t: torch.Tensor):
    """The parameters as the architecture defines them: a fused q/k/v
    projection is three (the key's bias, for one, has no gradient under
    the softmax); every other leaf is itself."""
    if ".attn.qkv." in name:
        return [(f"{name}[{p}]", c) for p, c in zip("qkv", t.chunk(3, dim=0))]
    return [(name, t)]


def part_norms(name: str, t: torch.Tensor, scale: float = 1.0) -> Dict[str, float]:
    return {k: float(c.norm()) * scale for k, c in leaf_parts(name, t)}


def ilql_block_loss(params: Dict[str, Dict[str, torch.Tensor]], targets: Dict[str, Dict[str, torch.Tensor]],
                    cfg: dict, batch: Dict[str, torch.Tensor], hp: dict, quant: Quant = None) -> torch.Tensor:
    """The sum over this block's action tokens of the per-token ILQL loss
    (not yet divided by the batch's action count):

    - Q_i(s_t, a_t) regresses on r_t + γ·V(s_next), where s_next is the
      row's next action token, or for its last action the next window's
      last token (zero when that window ends the episode);
    - V(s_t) regresses on min(Q̄1, Q̄2)(s_t, a_t) of the target trunk and
      heads, weighted τ above and 1 − τ below (expectile);
    - CQL: the cross-entropy of each Q head's logits at the taken token,
      weighted `cql_weight`."""
    ids, sta, rew = batch["input_ids"], batch["should_take_action"].bool(), batch["rewards"]
    gamma, tau = hp["gamma"], hp["tau"]
    hidden = trunk_hidden(params["base"], cfg, ids, quant)
    with torch.no_grad():
        t_hidden = trunk_hidden(targets["base"], cfg, ids, quant)
        n_hidden = trunk_hidden(params["base"], cfg, batch["next_token_ids"], quant)
        v_final = mlp_head(params["v"], n_hidden[:, -1])[:, 0] * (1.0 - batch["next_dones"].float())
    nxt = ids[:, 1:, None]
    q_logits = [mlp_head(params[g], hidden)[:, :-1] for g in ("q1", "q2")]
    q1, q2 = (torch.gather(q, 2, nxt)[..., 0] for q in q_logits)
    v = mlp_head(params["v"], hidden)[:, :-1, 0]
    with torch.no_grad():
        tq = torch.minimum(*(torch.gather(mlp_head(targets[g], t_hidden)[:, :-1], 2, nxt)[..., 0]
                             for g in ("q1", "q2")))
    total = hidden.new_zeros(())
    for r in range(ids.shape[0]):
        acts = torch.nonzero(sta[r])[:, 0]
        if acts.numel() == 0:
            continue
        v_next = torch.cat((v[r, acts[1:]], v_final[r:r + 1])).detach()
        target = rew[r, acts] + gamma * v_next
        total = total + 0.5 * ((q1[r, acts] - target) ** 2).sum() + 0.5 * ((q2[r, acts] - target) ** 2).sum()
        w = torch.where(tq[r, acts] >= v[r, acts].detach(), tau, 1.0 - tau)
        total = total + (0.5 * (v[r, acts] - tq[r, acts]) ** 2 * w).sum()
        for ql in q_logits:
            ce = -F.log_softmax(ql[r, acts], dim=-1).gather(1, nxt[r, acts])[:, 0]
            total = total + hp["cql_weight"] * ce.sum()
    return total


def adamw_(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, step: int, lr: float, hp: dict):
    """optax's adamw in place: moments, bias-corrected ratio, decoupled
    weight decay, then the learning rate."""
    b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
    mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.mul_(b2).add_(g * g, alpha=1 - b2)
    u = (mu / (1 - b1 ** step)) / ((nu / (1 - b2 ** step)).sqrt() + eps) + wd * p
    p.sub_(lr * u)


def ilql_steps(initial: Callable[[str], Iterable[Tuple[str, torch.Tensor]]], cfg: dict,
               batches: List[Dict[str, torch.Tensor]], hp: dict, row_block: int, quant: Quant = None,
               judge: Optional[Dict[str, Dict[str, torch.Tensor]]] = None, keep_first_grads: bool = False) -> dict:
    """Runs len(batches) ILQL updates from the weights `initial(group)`
    yields (float32; the targets start as copies) and returns the readings
    the program is compared on: each step's loss, each leaf's gradient norm
    at step 1, and each leaf's change after the last step (the initial
    weights drawn again from `initial`). `judge` holds other computations'
    first gradients by source and leaf (on the host): the norm of each
    one's difference from this gradient is returned by source and leaf
    part. `keep_first_grads` returns this run's own, on the host."""
    strict_f32()
    params = {g: {n: t.float().clone().requires_grad_(True) for n, t in initial(g)} for g in TRAINED}
    targets = {g: {n: t.detach().clone() for n, t in params[g].items()} for g in ("base", "q1", "q2")}
    moments = {g: {n: (torch.zeros_like(t), torch.zeros_like(t)) for n, t in params[g].items()} for g in TRAINED}
    losses, grad_norms, firsts = [], {}, {}
    diffs: Dict[str, Dict[str, float]] = {src: {} for src in (judge or {})}
    for step, batch in enumerate(batches, start=1):
        n = torch.clamp(batch["should_take_action"].float().sum(), min=1.0)
        loss = 0.0
        B = batch["input_ids"].shape[0]
        for lo in range(0, B, row_block):
            block = {k: t[lo:lo + row_block] for k, t in batch.items()}
            part = ilql_block_loss(params, targets, cfg, block, hp, quant) / n
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            for g in TRAINED:
                lr = hp["lr_base"] if g == "base" else hp["lr_heads"]
                for name, p in params[g].items():
                    grad = p.grad if p.grad is not None else torch.zeros_like(p)
                    if step == 1:
                        key = f"{g}.{name}"
                        grad_norms.update(part_norms(key, grad))
                        for src, grads in (judge or {}).items():
                            diffs[src].update(part_norms(key, grads[key].to(grad.device) - grad))
                        if keep_first_grads:
                            firsts[key] = grad.cpu()
                    adamw_(p, grad, *moments[g][name], step, lr, hp)
                    p.grad = None
            for g in ("base", "q1", "q2"):
                for name, t in targets[g].items():
                    t.mul_(1 - hp["polyak_alpha"]).add_(params[g][name], alpha=hp["polyak_alpha"])
    del targets, moments
    change_norms = {}
    with torch.no_grad():
        for g in TRAINED:
            for name, t0 in initial(g):
                change_norms.update(part_norms(f"{g}.{name}", params[g][name] - t0.float()))
    out = {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms, "grad_diff_norms": diffs}
    if keep_first_grads:
        out["first_grads"] = firsts
    return out
