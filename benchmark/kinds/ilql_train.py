"""Traffic kind `ilql_train`: a closed loop of back-to-back ILQL updates on
batches drawn from the seed.

Set-up builds one training object, the port's `make_ilql_train_step` on
`init_ilql_state` with AdamW (a separate target trunk, twin Q heads, a V
head), from the benchmark's weights, and drives it through its first
`checked_steps` updates on distinct batches: those updates warm every shape
up and give the readings the plain reference is held to (each step's loss,
each leaf's first gradient as Adam's first moment holds it, each leaf's
change after the last). The window then runs the same object on.

Traffic parameters: `batch`, `seq`, `next_seq` (the next window), `pool`
(distinct batches, cycled), `action_every` (every k-th token is an action),
`zero_reward_share`, `next_done_share`, `checked_steps`, `row_block` (the
reference's rows per block), `trace_units`, and the hyperparameters
`ilql` (gamma, tau, cql_weight, polyak_alpha), `adamw` (b1, b2, eps,
weight_decay) and `lr_base` / `lr_heads`.
"""
from __future__ import annotations

import gc
import math
from statistics import median
from typing import Dict, List

import torch

from benchmark import flops
from benchmark.harness import timed_loop
from benchmark.program import build_modules, transformer_config
from benchmark.reference.gpt import fp8_quant
from benchmark.reference.ilql import TRAINED, ilql_steps, part_norms
from benchmark.weights import derived_seed, draw, group_seed, model_spec

GROUPS = TRAINED


def make_batches(cfg: dict, tr: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """`pool` distinct batches from the seed: ids uniform over the true
    vocab less the pad id (its last id), so no token is padding; an action
    on every `action_every`-th token, reward −1 on an action unless drawn
    zero; no episode ends inside the window; the next window ends the
    episode with probability `next_done_share`."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 11))
    B, T, nt = tr["batch"], tr["seq"], tr["next_seq"]
    V = cfg["vocab_size"] - 1
    sta = torch.zeros((B, T - 1), dtype=torch.bool, device=device)
    sta[:, tr["action_every"] - 1::tr["action_every"]] = True
    out = []
    for _ in range(tr["pool"]):
        zero = torch.rand((B, T - 1), generator=gen, device=device) < tr["zero_reward_share"]
        out.append({
            "input_ids": torch.randint(0, V, (B, T), generator=gen, device=device),
            "should_take_action": sta.clone(),
            "rewards": torch.where(sta & ~zero, -1.0, 0.0),
            "dones": torch.zeros((B,), dtype=torch.bool, device=device),
            "next_token_ids": torch.randint(0, V, (B, nt), generator=gen, device=device),
            "next_dones": torch.rand((B,), generator=gen, device=device) < tr["next_done_share"],
        })
    return out


def n_actions(tr: dict) -> int:
    return tr["batch"] * len(range(tr["action_every"] - 1, tr["seq"] - 1, tr["action_every"]))


def reference_hp(tr: dict) -> dict:
    return {**tr["ilql"], **tr["adamw"], "lr_base": tr["lr_base"], "lr_heads": tr["lr_heads"]}


class Session:
    def __init__(self, run):
        from lmrl_gym_torch.algos import ilql
        from lmrl_gym_torch.core.optimizer import adamw
        from lmrl_gym_torch.models.interface import LMCore

        self.run, cfg, tr, dev = run, run.cfg, run.traffic, run.device
        self.spec = model_spec(cfg, GROUPS)
        mods = build_modules(cfg, GROUPS, run.seed, dev, torch.float32)
        icfg = ilql.ILQLConfig(**tr["ilql"])
        self.state = ilql.init_ilql_state(
            mods["base"], mods["q1"], mods["q2"], mods["v"], adamw(tr["lr_base"], **tr["adamw"]),
            adamw(tr["lr_heads"], **tr["adamw"]), icfg)
        del mods
        self.step = ilql.make_ilql_train_step(LMCore(transformer_config(cfg), dev), icfg, cfg["vocab_size"] - 1)
        self.batches = [ilql.ILQLBatch(**b) for b in make_batches(cfg, tr, run.seed, dev)]
        self.checked = [b._asdict() for b in self.batches[: tr["checked_steps"]]]
        self.readings = self._checked_steps()

    def _modules(self):
        s = self.state
        return {"base": s.base, "q1": s.q1_head, "q2": s.q2_head, "v": s.v_head}

    def _checked_steps(self) -> dict:
        """The first updates, read as the reference will be: the loss after
        each, the first gradient from Adam's first moment after step 1
        (μ = (1 − b1)·g), each leaf's change after the last."""
        b1 = self.run.traffic["adamw"]["b1"]
        losses, grad_norms = [], {}
        self.first_grads = {}  # on the host: judged by the reference, leaf by leaf
        for k, batch in enumerate(self.checked):
            self.state, loss, _ = self.step(self.state, self.batches[k])
            losses.append(float(loss))
            if k == 0:
                for g, ts in self._modules().items():
                    mu = ts.opt_state[0].mu
                    for name in mu:
                        grad_norms.update(part_norms(f"{g}.{name}", mu[name], 1 / (1 - b1)))
                        self.first_grads[f"{g}.{name}"] = (mu[name] / (1 - b1)).cpu()
        change = {}
        with torch.no_grad():
            for g, ts in self._modules().items():
                params = dict(ts.params.named_parameters())
                for name, t0 in draw(self.spec[g], group_seed(self.run.seed, g), self.run.device, torch.float32):
                    change.update(part_norms(f"{g}.{name}", params[name] - t0))
        return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

    def window(self, seconds: float, tracer=None) -> dict:
        tr, cfg = self.run.traffic, self.run.cfg
        start = tr["checked_steps"]

        def update(n):
            self.state, loss, _ = self.step(self.state, self.batches[(start + n) % len(self.batches)])
            return loss

        losses, window_s, unit_s = timed_loop(self.run, seconds, tracer, update)
        finite = torch.isfinite(torch.stack(losses)).sum().item()
        return {
            "units": len(losses), "window_s": window_s, "unit_s": unit_s, "failed": len(losses) - int(finite),
            "tokens_per_unit": tr["batch"] * tr["seq"],
            "flops_per_unit": flops.ilql_update_flops(cfg, tr["batch"], tr["seq"], tr["next_seq"], n_actions(tr)),
            "bwd_least_s_per_unit": flops.ilql_bwd_least_seconds(cfg, tr["batch"], tr["seq"]),
        }

    def release(self) -> None:
        self.state = self.step = self.batches = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: bool = False, judge=None, keep_first_grads: bool = False) -> dict:
        """The plain reference's readings over the checked batches; with
        `control`, the same computed with the trunk's products in float8."""
        tr, seed, dev = self.run.traffic, self.run.seed, self.run.device

        def initial(g):
            return draw(self.spec[g], group_seed(seed, g), dev, torch.float32)

        return ilql_steps(initial, self.run.cfg, self.checked, reference_hp(tr), tr["row_block"],
                          fp8_quant if control else None, judge, keep_first_grads)

    def compare(self) -> dict:
        return compare(self.readings, self.reference(judge={"program": self.first_grads}))


def compare(prog: dict, ref: dict, source: str = "program") -> dict:
    """The numbers held to the cell's limits:

    - `loss_gap`: the relative gap of the first step's loss (the later
      steps' losses swing with the signs Adam's first update gives to the
      gradients that lie within rounding: see PERF.md);
    - `grad_norm_gap`: the largest gap of a leaf's first-gradient norm, over
      the larger of the reference's norm of that leaf and of the median
      leaf;
    - `update_norm_gap`: the same for each leaf's change after the checked
      steps, over the leaves whose reference gradient is at least a
      thousandth of the median leaf's (the others move by rounding and
      weight decay alone);
    - `grad_error`: the first gradient's relative error over every trained
      parameter, ‖`source`'s gradient − the reference's‖ / ‖the
      reference's‖. Norms and losses average rounding away, and the later
      steps swing with the signs Adam gives to gradients within rounding;
      this one reads the first gradient element by element (see PERF.md).

    `loss_gap` has no reading that separates the program from the control
    and is printed, not compared (see PERF.md)."""
    loss_gap = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    g_ref = ref["grad_norms"]
    g_med = median(g_ref.values())
    grad_gap = max(abs(prog["grad_norms"][k] - v) / max(v, g_med) for k, v in g_ref.items())
    kept = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    c_med = median(ref["change_norms"][k] for k in kept)
    upd_gap = max(abs(prog["change_norms"][k] - ref["change_norms"][k]) / max(ref["change_norms"][k], c_med)
                  for k in kept)
    diff = ref["grad_diff_norms"].get(source)
    grad_error = (math.sqrt(sum(v * v for v in diff.values()) / sum(g_ref[k] ** 2 for k in diff)) if diff
                  else float("inf"))
    out = {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "update_norm_gap": upd_gap, "grad_error": grad_error}
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}
