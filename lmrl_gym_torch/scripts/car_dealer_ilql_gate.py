"""Car-Dealer ILQL gate on the port: the port of
`scripts/car_dealer_ilql_gate.py`, with the same flags, defaults, stages
and JSON keys, plus `--device`. Reference recipe:
llm_rl_scripts/car_dealer/ilql/train_ilql.py (offline ILQL on seller-view
conversations against the GPT-2 buyer sim, car_dealer/env/buyer.py:12-83).

    python -m lmrl_gym_torch.scripts.car_dealer_ilql_gate              # on the card
    python -m lmrl_gym_torch.scripts.car_dealer_ilql_gate --device cpu # plain path

The fancy reward buy_price / ((budget + msrp) / 2) is continuous in the
negotiated price, so strategy, not luck, sets an episode's return:

  1. behavior = a RANDOM-PRICE seller: each offer turn quotes a uniformly
     random price from a 9-value menu, so identical contexts carry the full
     quality range; the scripted buyer's counteroffer min(budget, 0.9·p)
     reveals the budget in context;
  2. BC on all episodes (the baseline RL must beat);
  3. offline ILQL from the BC trunk (twin Q + V, cosine lr warmdown), and
     an MC-returns column (one Q regressed on reward-to-go);
  4. serving: SAMPLE-RERANK — K BC proposals per turn scored by the
     LENGTH-NORMALIZED mean advantage (ILQL) or mean Q (MC), argmax — and
     the β-guided two-trunk decode π_β + β·min(Q1,Q2); a controlled
     ranking probe of each scorer over the nine menu offers;
  5. eval on fixed seeds against the scripted buyer and a TRAINED LM buyer
     (decoder-only, d192, served through `LMServer`), with the LM buyer's
     fidelity on the (budget × price) grid.

The JAX gate's draws: the initial policy trunk, the (q1, q2, v) heads (the
MC head starts from q2's draw, as the JAX gate's shares its key), the LM
buyer's initial weights and the PRNG keys of its sampled decodes. A
`Replay` (`dialog_ilql_gate.Replay`) of those holds this gate to the JAX
gate. The gate runs in float32 (`tiny_test_config`), as the JAX gate does.
"""
from __future__ import annotations

import argparse
import copy
import json
import random
import re
import time

import numpy as np
import torch

from lmrl_gym_torch.scripts import dialog_ilql_gate
from lmrl_gym_torch.scripts.dialog_ilql_gate import Replay  # noqa: F401  (this gate's Replay)

PRICE_MENU = [15000, 25000, 35000, 45000, 55000, 65000, 75000, 85000, 95000]
WELCOME = "Welcome! We have excellent cars on the lot today.\n"


def offer_line(price: int) -> str:
    return f"I can offer this one for ${price:,}. It's a great deal.\n"


def make_random_price_seller(rng):
    """Behavior policy: a uniform menu price at every offer turn."""
    from lmrl_gym_torch.envs.base import TextPolicy
    from lmrl_gym_torch.text.frames import Text

    class RandomPriceSeller(TextPolicy):
        def act(self, th):
            n = sum(1 for t in th if t.is_action)
            if n == 0:
                return th + (Text(WELCOME, True),)
            return th + (Text(offer_line(rng.choice(PRICE_MENU)), True),)

    return RandomPriceSeller()


def collect_behavior(n_episodes, seed):
    """Random-price seller vs the scripted buyer → (trajectory, return)."""
    from lmrl_gym_torch.cli.tasks import build_car_dealer_env, transitions_to_chain
    from lmrl_gym_torch.envs.base import interact_environment

    env = build_car_dealer_env()
    rng = random.Random(seed)
    episodes = []
    for i in range(n_episodes):
        transitions = interact_environment(env, make_random_price_seller(rng), env_seed=seed * 104729 + i)[0]
        traj = transitions_to_chain(transitions).text_trajectory
        episodes.append((traj, sum(traj.reward)))
    return episodes


def buyer_fidelity_grid(lm_env_buyer_factory):
    """The LM buyer on the full (budget × menu price) grid: the exact
    buyer-view prompt the env serves (persona header, welcome, buyer ask,
    seller offer); its decision and counteroffer against the scripted
    buyer's on the same view."""
    from lmrl_gym_torch.envs.car_dealer.data import (
        DEFAULT_BRANDS,
        DEFAULT_BUDGETS,
        DEFAULT_FEATURES,
        DEFAULT_PERSONALITIES,
        DEFAULT_TYPES,
        Role,
        create_lines_from_text_history,
        create_trajectory_from_conversation,
        extract_output_from_str,
    )
    from lmrl_gym_torch.envs.car_dealer.env import ScriptedBuyerPolicy
    from lmrl_gym_torch.text.frames import Text

    rng = random.Random(0)
    agree, total = 0, 0
    for budget in DEFAULT_BUDGETS:
        for price in PRICE_MENU:
            info = {
                "personality": rng.choice(DEFAULT_PERSONALITIES),
                "preferred_brands": rng.choice(DEFAULT_BRANDS),
                "preferred_type": rng.choice(DEFAULT_TYPES),
                "preferred_features": rng.sample(DEFAULT_FEATURES, k=2),
                "budget": budget,
            }
            ask = f"I'm looking for {info['preferred_brands']} {info['preferred_type']}. What have you got?\n"
            seller_view = (Text("Start\n", False), Text(WELCOME, True), Text(ask, False),
                           Text(offer_line(price), True))
            conversation = {"buyer_info": info, "lines": create_lines_from_text_history(seller_view)}
            view = create_trajectory_from_conversation(conversation, Role.BUYER)
            want = ScriptedBuyerPolicy(info, patience=4).act(view.text_history)[-1].text
            got = lm_env_buyer_factory(info).act(view.text_history)[-1].text
            w_out, _ = extract_output_from_str(want)
            g_out, _ = extract_output_from_str(got)
            if w_out is not None or g_out is not None:
                ok = (w_out is not None and g_out is not None and w_out["car_bought"] == g_out["car_bought"]
                      and w_out.get("buy_price") == g_out.get("buy_price"))
            else:
                wm = re.findall(r"\$([0-9][0-9,]*)", want)
                gm = re.findall(r"\$([0-9][0-9,]*)", got)
                ok = bool(wm) and wm == gm
            agree += int(ok)
            total += 1
    return agree / total


def ranking_probe(score_fn, tokenizer, max_len, device=None):
    """A controlled Q-ranking probe: welcome → buyer ask → offer $95,000 →
    buyer counter min(B, $85,500) (which reveals every budget B below
    $85,500); the candidates are the nine menu offers. The best is the
    largest menu price ≤ the counter, except B = $10,000, where no price
    fits and the top reject reward picks $95,000. Returns (rank accuracy
    over budgets, per-budget score rows)."""
    from lmrl_gym_torch.algos.value_policy import tokenize_histories_for_scoring
    from lmrl_gym_torch.envs.car_dealer.data import DEFAULT_BUDGETS
    from lmrl_gym_torch.text.frames import Text

    best = {10000: 95000, 30000: 25000, 50000: 45000, 70000: 65000, 90000: 85000}
    rows, hits = [], 0
    for budget in DEFAULT_BUDGETS:
        counter = min(budget, int(95000 * 0.9))
        state = (Text("Start\n", False), Text(WELCOME, True),
                 Text("I'm looking for a Toyota SUV. What have you got?\n", False), Text(offer_line(95000), True),
                 Text(f"That's too much. I could do ${counter:,}.\n", False))
        cands = [state + (Text(offer_line(p), True),) for p in PRICE_MENU]
        ids, am = tokenize_histories_for_scoring(cands, tokenizer, max_len, device=device)
        scores = score_fn(ids, am).cpu().numpy()
        pick = PRICE_MENU[int(np.argmax(scores))]
        hits += int(pick == best[budget])
        rows.append({"budget": budget, "picked": pick, "best": best[budget],
                     "scores": {str(p): round(float(s), 4) for p, s in zip(PRICE_MENU, scores)}})
    return hits / len(DEFAULT_BUDGETS), rows


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--behavior-episodes", type=int, default=600)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--bc-epochs", type=int, default=40)
    p.add_argument("--ilql-epochs", type=int, default=80,
                   help="token-level Bellman backups propagate reward one action token per target refresh; a "
                   "~45-action-token episode at polyak 0.02 needs thousands of updates before turn-level Q ranks")
    p.add_argument("--mc-epochs", type=int, default=60,
                   help="MC-returns column (single Q regressed on reward-to-go — no propagation chain; "
                   "mc_returns/train_mc.py:38). 0 disables.")
    p.add_argument("--bsize", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ilql-lr", type=float, default=1e-3)
    p.add_argument("--beta", type=float, default=8.0)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--polyak", type=float, default=0.02)
    p.add_argument("--value-bias-init", type=float, default=0.65, help="behavior-mixture mean return (fancy reward)")
    p.add_argument("--freeze-base", action="store_true")
    p.add_argument("--lr-warmdown", action="store_true", default=True)
    p.add_argument("--no-lr-warmdown", dest="lr_warmdown", action="store_false")
    p.add_argument("--rerank-k", type=int, default=8)
    p.add_argument("--rerank-temp", type=float, default=1.0)
    p.add_argument("--max-len", type=int, default=448)
    p.add_argument("--bpe-vocab", type=int, default=1024)
    p.add_argument("--eval-rollouts", type=int, default=64)
    p.add_argument("--eval-bsize", type=int, default=16)
    p.add_argument("--buyer-episodes", type=int, default=400)
    p.add_argument("--buyer-epochs", type=int, default=12)
    p.add_argument("--buyer-hidden", type=int, default=192)
    p.add_argument("--skip-lm-buyer", action="store_true", help="scripted-buyer eval only (fast debug)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu (the plain path)")
    return p.parse_args(argv)


class Gate(dialog_ilql_gate.Gate):
    """The dialog ILQL gate's machinery on Car-Dealer: its own behavior
    data and tokenizer, 40 new tokens per turn, length-normalized scores,
    the MC column and the LM buyer."""

    MAX_NEW = 40
    SCORE_LENGTH_NORMALIZE = True

    def make_tokenizer(self):
        """BPE on the gate's own text: 150 behavior episodes' seller views
        and 60 buyer-view conversations (personas, counters, verdicts)."""
        from lmrl_gym_torch.envs.lm_oracle import collect_buyer_conversations
        from lmrl_gym_torch.text.bpe import train_bpe

        args = self.args
        self.episodes = collect_behavior(args.behavior_episodes, args.seed)
        corpus = [t.text for traj, _ in self.episodes[:150] for t in traj.text_history]
        corpus += [t.text for w in collect_buyer_conversations(60, seed=args.seed + 13,
                                                                seller_factory=make_random_price_seller)
                   for t in w.text_history]
        return train_bpe(corpus, vocab_size=args.bpe_vocab)

    def behavior(self):
        return self.episodes

    def train_mc(self, chains, bc_params):
        """--mc-epochs of MC returns from the BC trunk, its Q head a copy of
        q2's initial draw; batches ordered by default_rng(seed + 2)."""
        from lmrl_gym_torch.algos import data as algo_data
        from lmrl_gym_torch.algos.mc import MCBatch, MCConfig, MCTrainState, make_mc_train_step
        from lmrl_gym_torch.core import optimizer as opt

        args, pad = self.args, self.tokenizer.pad_token_id
        examples = [algo_data.MCExample.from_chain(c, args.gamma) for c in chains]
        dataset = algo_data.ArrayDataset(algo_data.block_mc_examples(examples, self.strategy, pad))
        n_batches = -(-len(chains) // args.bsize)
        _, q, _ = self.initial_heads()
        state = MCTrainState(base=opt.TrainState(copy.deepcopy(bc_params), self._base_tx()),
                             q_head=opt.TrainState(q, opt.adamw(self._head_lr(args.mc_epochs, n_batches))))
        step = make_mc_train_step(self.core, MCConfig(gamma=args.gamma), pad)
        rng = np.random.default_rng(args.seed + 2)
        for epoch in range(1, args.mc_epochs + 1):
            t0 = time.time()
            for b in dataset.batches(args.bsize, rng=rng, drop_last=False):
                t = self._tensors(b, input_ids=torch.long, should_take_action=torch.bool, returns=torch.float32)
                state, loss, _ = step(state, MCBatch(t["input_ids"], t["should_take_action"], t["returns"]))
            if epoch % 10 == 0 or epoch == args.mc_epochs:
                print(f"MC epoch {epoch}: loss {float(loss):.4f} ({time.time() - t0:.0f}s)", flush=True)
        return state

    def mc_score_fn(self, state):
        from lmrl_gym_torch.algos.value_policy import ValueRLParams, make_mc_score_fn

        bundle = ValueRLParams(pi_beta=None, base=state.base.params, q1_head=state.q_head.params, q2_head=None,
                               v_head=None)
        return make_mc_score_fn(self.core, bundle, self.tokenizer.pad_token_id, length_normalize=True)

    def oracle_train_config(self):
        """The LM buyer's recipe: --buyer-hidden, 512-token buyer views."""
        from lmrl_gym_torch.envs.lm_oracle import OracleTrainConfig

        args = self.args
        return OracleTrainConfig(n_episodes=args.buyer_episodes, epochs=args.buyer_epochs, max_length=512,
                                 hidden_size=args.buyer_hidden, seed=args.seed)

    def lm_buyer_env(self):
        """The LM buyer (decoder-only, BC on buyer views from the
        random-price seller) in the loop, and its grid fidelity."""
        from lmrl_gym_torch.envs.lm_oracle import build_lm_car_dealer_env, collect_buyer_conversations

        args = self.args
        windows = collect_buyer_conversations(args.buyer_episodes, seed=args.seed + 1,
                                              seller_factory=make_random_price_seller)
        core, params = self.train_oracle(windows)
        env = build_lm_car_dealer_env(core, self.tokenizer, params)
        fidelity = buyer_fidelity_grid(env.buyer_factory)
        self.log(f"LM buyer fidelity on the (budget x price) grid: {fidelity:.2f}")
        return env, fidelity


def run(g: Gate) -> dict:
    """Every stage in the JAX gate's order; returns its JSON result."""
    from lmrl_gym_torch.cli.tasks import build_car_dealer_env

    args = g.args
    episodes = g.behavior()
    rewards = np.asarray([r for _, r in episodes])
    g.log(f"behavior: {len(episodes)} episodes, reward mean {rewards.mean():.3f} min {rewards.min():.3f} "
          f"max {rewards.max():.3f}")
    all_trajs = [t for t, _ in episodes]
    bc_params, bc_loss = g.train_bc(all_trajs)
    g.log(f"BC loss {bc_loss:.3f}")
    chains = g.token_chains(all_trajs)
    state = g.train_ilql(chains, bc_params)
    mc_state = g.train_mc(chains, bc_params) if args.mc_epochs > 0 else None

    score_fn = g.ilql_score_fn(state)
    mc_score_fn = g.mc_score_fn(mc_state) if mc_state is not None else None
    ilql_probe_acc, ilql_probe_rows = ranking_probe(score_fn, g.tokenizer, args.max_len, g.device)
    print(f"ILQL ranking probe: {ilql_probe_acc:.2f} picks {[r['picked'] for r in ilql_probe_rows]} "
          f"best {[r['best'] for r in ilql_probe_rows]}", flush=True)
    mc_probe_acc, mc_probe_rows = None, None
    if mc_score_fn is not None:
        mc_probe_acc, mc_probe_rows = ranking_probe(mc_score_fn, g.tokenizer, args.max_len, g.device)
        print(f"MC ranking probe: {mc_probe_acc:.2f} picks {[r['picked'] for r in mc_probe_rows]}", flush=True)
    K = args.rerank_k

    envs = {"scripted": build_car_dealer_env()}
    buyer_fidelity = None
    if not args.skip_lm_buyer:
        envs["lm_buyer"], buyer_fidelity = g.lm_buyer_env()

    results = {}
    for env_name, env in envs.items():
        ev = lambda policy, name: g.eval_policy(policy, env, f"{name} [{env_name}]", ".3f")  # noqa: E731
        results[f"bc_greedy_{env_name}"] = ev(g.bc_policy(bc_params, True), "BC greedy")
        results[f"bc_sampled_{env_name}"] = ev(g.bc_policy(bc_params, False), "BC sampled")
        results[f"ilql_guided_{env_name}"] = ev(g.guided_policy(state, bc_params), "ILQL guided")
        results[f"ilql_rerank_{env_name}"] = ev(g.rerank_policy(bc_params, score_fn), f"ILQL sample-rerank K={K}")
        if mc_score_fn is not None:
            results[f"mc_rerank_{env_name}"] = ev(g.rerank_policy(bc_params, mc_score_fn), f"MC sample-rerank K={K}")

    return dict(
        behavior_reward_mean=float(rewards.mean()),
        buyer_fidelity=buyer_fidelity,
        gate_env="scripted",
        bc_reward=results["bc_greedy_scripted"],
        ilql_rerank_reward=results["ilql_rerank_scripted"],
        ilql_guided_reward=results["ilql_guided_scripted"],
        mc_rerank_reward=results.get("mc_rerank_scripted"),
        ilql_probe_acc=ilql_probe_acc,
        mc_probe_acc=mc_probe_acc,
        ilql_probe=ilql_probe_rows,
        mc_probe=mc_probe_rows,
        improvement=results["ilql_rerank_scripted"] - results["bc_greedy_scripted"],
        mc_improvement=(results["mc_rerank_scripted"] - results["bc_greedy_scripted"]
                        if mc_score_fn is not None else None),
        lm_improvement=(results["ilql_rerank_lm_buyer"] - results["bc_greedy_lm_buyer"]
                        if "lm_buyer" in envs else None),
        all_evals=results,
        model=f"d{args.hidden} L{args.layers} bpe vocab {g.tokenizer.vocab_size} policy; in-repo LM buyer "
        f"d{args.buyer_hidden} (ref uses a finetuned GPT-2 buyer checkpoint — zero egress); K={K} sample-rerank "
        f"serving with length-normalized mean-advantage scores",
    )


def main(argv=None):
    args = parse_args(argv)
    g = Gate(args)
    result = run(g)
    print(f"gate wall time: {time.time() - g.t_start:.1f} s on {g.device.type}", flush=True)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(args=vars(args), **result), f, indent=1)
    return result


if __name__ == "__main__":
    main()
