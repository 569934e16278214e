"""Wordle ILQL learning gate on the port: the port of
`scripts/wordle_ilql_gate.py`, with the same flags, defaults, stages and
JSON keys.

    python -m lmrl_gym_torch.scripts.wordle_ilql_gate              # on the card
    python -m lmrl_gym_torch.scripts.wordle_ilql_gate --device cpu # plain path

It trains in the streaming regime the vector env makes possible: every
gradient step trains on a fresh batch from the scripted behavior policy.

  1. behavior = the per-TURN quality mixture (`rollout_wordle_scripted`:
     a knowledge-consistent guess w.p. --prob-smart, else a random valid
     word); the pure-consistent ceiling (p_smart = 1) beside it.
  2. BC(all): streaming BC, a fresh --bsize-episode batch per step.
  3. %BC: the same updates, each batch the top --filter-frac episodes by
     return of a bsize/filter_frac-episode chunk (a stable descending
     sort, so ties fall as the JAX package's `argsort(...)[::-1]` puts
     them).
  4. offline ILQL from the BC trunk (twin Q + V, a separate target base,
     cosine learning rates, streaming batches from the same behavior
     policy), served as π_β + β·min(Q1,Q2) guided decoding with the decode
     masked to the vocab trie for every policy alike; live and target
     heads.
  5. the host OptimalPolicy's expected-information bound.

Gate: ILQL guided (sampled, fixed seeds) should beat %BC. The JAX package's
draws come from PRNG keys, the port's from `torch.Generator`s seeded with
the same integers, so the two runs share a recipe, not a random stream.
A `Replay` hands the gate another run's draws and initial weights, so a
test can hold it to the JAX gate on the JAX gate's own draws.
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    from lmrl_gym_torch.models.heads import MATMUL_PRECISIONS

    p = argparse.ArgumentParser()
    p.add_argument("--bc-steps", type=int, default=16000, help="streaming BC updates (fresh batch per step)")
    p.add_argument("--pbc-steps", type=int, default=16000)
    p.add_argument("--ilql-steps", type=int, default=10000)
    p.add_argument("--bsize", type=int, default=512)
    p.add_argument("--prob-smart", type=float, default=0.66)
    p.add_argument(
        "--prob-repeat", type=float, default=0.0,
        help="per-turn mass on REPEATING the previous valid guess (a concentrated bad action greedy imitation "
        "locks onto); 0 is the gate's configuration",
    )
    p.add_argument("--filter-frac", type=float, default=0.25)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=500)
    p.add_argument("--beta", type=float, default=32.0, help="decode-time advantage weight")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument(
        "--polyak", type=float, default=0.02,
        help="target-head step: token-level backups carry the terminal reward back one action token per refresh",
    )
    p.add_argument("--value-bias-init", type=float, default=-4.0, help="typical Wordle return scale")
    p.add_argument("--base-lr-scale", type=float, default=0.3,
                   help="ILQL trunk lr = lr * this (heads get full lr); both cosine-annealed to zero over --ilql-steps")
    p.add_argument("--eval-every", type=int, default=2500, help="guided-eval interval in ILQL steps")
    p.add_argument("--eval-batch", type=int, default=1024)
    p.add_argument("--eval-temp", type=float, default=1.0)
    p.add_argument("--optimal-episodes", type=int, default=64, help="0 skips the host OptimalPolicy bound")
    p.add_argument("--constrain-vocab", action="store_true", default=True,
                   help="mask every serving rollout's decode to the vocab trie, for BC, %%BC and ILQL alike "
                   "(a from-scratch byte LM emits almost no valid word unmasked)")
    p.add_argument("--no-constrain-vocab", dest="constrain_vocab", action="store_false")
    p.add_argument(
        "--head-matmul-precision", choices=MATMUL_PRECISIONS, default="float32",
        help="the Q/V heads' matmul precision (`MLPHeadConfig.matmul_precision`): bfloat16 rounds both operands "
        "of every head product, forward and backward, as XLA's default precision does to an f32 dot on a TPU",
    )
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu (the plain path)")
    p.add_argument("--out", type=str, default=None)
    return p.parse_args(argv)


class Replay(NamedTuple):
    """Another run's draws and initial weights: one `ScriptedNoise` per
    scripted rollout and one `WordleNoise` per eval rollout, in the order
    the gate makes them; the initial trunk (BC and %BC each train a copy)
    and the initial (q1, q2, v) heads."""

    scripted: Iterator
    evals: Iterator
    trunk: torch.nn.Module
    heads: Tuple[torch.nn.Module, torch.nn.Module, torch.nn.Module]


class Gate:
    """The gate's model, env and eval harness, built from its flags; one
    method per stage. Draws come from `torch.Generator`s seeded with the
    JAX gate's key integers, or from `replay`. `dtype` is the trunk's
    activation dtype (bf16, as the JAX gate runs)."""

    def __init__(self, args: argparse.Namespace, dtype: str = "bfloat16", replay: Optional[Replay] = None):
        from lmrl_gym_torch.core.device import resolve_device
        from lmrl_gym_torch.envs.wordle.vector import WordleVectorEnv, WordleVocab
        from lmrl_gym_torch.loops import actor
        from lmrl_gym_torch.models.config import TransformerConfig
        from lmrl_gym_torch.models.interface import LMCore
        from lmrl_gym_torch.text.tokenizer import ByteTokenizer

        self.args = args
        self.replay = replay
        self.device = resolve_device(args.device)
        self.t_start = time.time()
        self.tokenizer = ByteTokenizer()
        self.config = TransformerConfig(
            vocab_size=self.tokenizer.vocab_size, hidden_size=args.hidden,
            num_layers=args.layers, num_heads=args.heads,
            max_position_embeddings=actor.EPISODE_LEN, pad_vocab_to_multiple=64,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype=dtype,
        )
        self.core = LMCore(self.config, device=self.device)
        self.vocab = WordleVocab.from_file()
        self.venv = WordleVectorEnv(self.vocab, device=self.device)
        # %BC draws a bigger chunk and keeps the top filter-frac, so every
        # update still sees a full bsize batch (equal updates and tokens per update)
        self.pbc_gen = max(args.bsize, int(round(args.bsize / max(args.filter_frac, 1e-6))))
        self.lm_step_fn, self.lm_carry0 = actor.make_lm_step_fn(self.core, args.eval_batch)
        self.guided_step_fn, self.guided_carry0 = actor.make_value_guided_step_fn(
            self.core, args.eval_batch, two_trunks=True, twin_q=True, beta=args.beta
        )

    def log(self, msg: str) -> None:
        print(f"{msg} ({time.time() - self.t_start:.0f}s)", flush=True)

    def gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def scripted(self, batch: int, p_smart: float, p_repeat: float, generator):
        from lmrl_gym_torch.loops.actor import rollout_wordle_scripted

        noise = None if self.replay is None else next(self.replay.scripted)
        return rollout_wordle_scripted(self.venv, batch, p_smart, p_repeat, generator=generator, noise=noise)

    # ---- 1. behavior / ceiling statistics (on-device scripted rollouts)
    def scripted_stats(self, p_smart: float, seed0: int, p_repeat: float = 0.0, n_batches: int = 2):
        rets, wins = [], []
        for s in range(n_batches):
            ro = self.scripted(2048, p_smart, p_repeat, self.gen(seed0 + s))
            rets.append(float(episode_return(ro).mean()))
            wins.append(float(ro.win.float().mean()))
        return float(np.mean(rets)), float(np.mean(wins))

    # ---- 2-3. streaming BC (a fresh scripted-mixture batch every update)
    def train_bc_stream(self, steps: int, seed: int, filter_frac: Optional[float] = None):
        """BC (or %BC with `filter_frac`) from a fresh trunk (from `seed`, or
        a copy of the replayed one). Returns (params, last loss)."""
        from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, make_bc_train_step
        from lmrl_gym_torch.core.optimizer import OptimizerConfig, TrainState, make_optimizer, warmup_cosine_decay_schedule
        from lmrl_gym_torch.models.transformer import init_params

        args = self.args
        if self.replay is None:
            params = init_params(self.config, seed=seed, device=self.device)
        else:
            params = copy.deepcopy(self.replay.trunk)
        sched = warmup_cosine_decay_schedule(0.0, args.lr, min(args.warmup, max(1, steps // 4)), steps)
        state = BCTrainState(model=TrainState(params, make_optimizer(OptimizerConfig(lr=sched), params)))
        step = make_bc_train_step(self.core, BCConfig(), self.tokenizer.pad_token_id)
        data_gen = self.gen(seed * 131 + 7)
        n_gen = args.bsize if filter_frac is None else self.pbc_gen
        loss = torch.zeros(())
        for it in range(1, steps + 1):
            ro = self.scripted(n_gen, args.prob_smart, args.prob_repeat, data_gen)
            # copies out of inference mode: autograd saves the token ids
            toks, mask = ro.tokens.clone(), ro.token_action_mask().float()
            if filter_frac is not None:
                # top-frac episodes of this chunk, ties in descending index order
                keep = torch.argsort(episode_return(ro), stable=True).flip(0)[: args.bsize]
                toks, mask = toks[keep], mask[keep]
            state, loss, _ = step(state, BCBatch(toks, mask))
            if it % 4000 == 0:
                self.log(f"  bc step {it}/{steps}: loss {float(loss):.3f}")
        return state.model.params, float(loss)

    # ---- on-device eval harness (fused actor; fixed seeds)
    def _eval(self, name: str, greedy: bool, step_fn, params, carry0):
        from lmrl_gym_torch.loops.actor import rollout_wordle

        args = self.args
        noise = None if self.replay is None else next(self.replay.evals)
        out = rollout_wordle(
            self.venv, step_fn, params, carry0, args.eval_batch, args.eval_temp, greedy,
            constrain_vocab=args.constrain_vocab, generator=self.gen(args.seed * 31 + int(greedy)), noise=noise,
        )
        ret, win = float(episode_return(out).mean()), float(out.win.float().mean())
        self.log(f"{name}{' greedy' if greedy else ''}: return {ret:.3f} win {win:.3f} "
                 f"turns {float(out.n_turns.float().mean()):.2f}")
        return dict(ret=ret, win=win)

    def eval_lm(self, params, name: str, greedy: bool = False) -> dict:
        return self._eval(name, greedy, self.lm_step_fn, params, self.lm_carry0)

    def eval_guided(self, state, bc_params, name: str, greedy: bool = False, use_target: bool = False) -> dict:
        """Two-trunk π_β(BC) + β·min(Q1,Q2) fused actor."""
        params = {
            "pi_beta": bc_params,
            "base": state.base.params,
            "q1": state.q1_target_params if use_target else state.q1_head.params,
            "q2": state.q2_target_params if use_target else state.q2_head.params,
        }
        return self._eval(name, greedy, self.guided_step_fn, params, self.guided_carry0)

    # ---- 4. streaming offline ILQL from the BC trunk
    def init_ilql(self, bc_params):
        """The ILQL state on a copy of the BC trunk, with fresh heads (seeds
        2, 3, 4; second layers zero, bias --value-bias-init) or the replayed
        ones. Returns (state, ilql_config)."""
        from lmrl_gym_torch.algos.ilql import ILQLConfig, init_ilql_state
        from lmrl_gym_torch.core.optimizer import adamw, cosine_decay_schedule
        from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig

        args = self.args
        D = self.config.hidden_size
        kw = dict(input_dim=D, hidden_dim=2 * D, layer2_initializer_range=0.0,
                  layer2_bias_init=args.value_bias_init, matmul_precision=args.head_matmul_precision)
        q_cfg = MLPHeadConfig(output_dim=self.config.padded_vocab_size, **kw)
        v_cfg = MLPHeadConfig(output_dim=1, **kw)
        heads = self.replay.heads if self.replay is not None else (
            MLPHead(q_cfg, device=self.device, seed=2), MLPHead(q_cfg, device=self.device, seed=3),
            MLPHead(v_cfg, device=self.device, seed=4),
        )
        ilql_config = ILQLConfig(gamma=args.gamma, polyak_alpha=args.polyak, beta=args.beta,
                                 use_separate_target_base=True)
        head_lr = cosine_decay_schedule(args.lr, max(1, args.ilql_steps))
        base_lr = cosine_decay_schedule(args.lr * args.base_lr_scale, max(1, args.ilql_steps))
        state = init_ilql_state(copy.deepcopy(bc_params), *heads, adamw(base_lr), adamw(head_lr), ilql_config)
        return state, ilql_config

    def train_ilql_stream(self, state, ilql_config, bc_params):
        """--ilql-steps updates, a guided eval every --eval-every and at the
        end. Returns (state, curve)."""
        from lmrl_gym_torch.algos.ilql import make_ilql_train_step
        from lmrl_gym_torch.loops.online_device import wordle_rollout_to_ilql_batch

        args = self.args
        train_step = make_ilql_train_step(self.core, ilql_config, self.tokenizer.pad_token_id)
        data_gen = self.gen(args.seed * 977 + 13)
        curve = []
        for it in range(1, args.ilql_steps + 1):
            ro = self.scripted(args.bsize, args.prob_smart, args.prob_repeat, data_gen)
            state, loss, logs = train_step(state, wordle_rollout_to_ilql_batch(ro))
            if it % args.eval_every == 0 or it == args.ilql_steps:
                self.log(f"ilql step {it}: loss {float(loss):.3f} q~{float(logs['q1']['mean']):.2f} "
                         f"v~{float(logs['v']['mean']):.2f}")
                m = self.eval_guided(state, bc_params, f"ILQL(step {it})")
                curve.append(dict(step=it, **m))
        return state, curve

    # ---- 5. OptimalPolicy bound (host, exact expected-information argmax)
    def optimal_bound(self) -> Optional[float]:
        n = self.args.optimal_episodes
        if n <= 0:
            return None
        import random

        from lmrl_gym_torch.envs.wordle.data import generate_trajectories
        from lmrl_gym_torch.envs.wordle.policies import OptimalPolicy, StartWordPolicy

        pol = OptimalPolicy(self.vocab, start_word_policy=StartWordPolicy(rng=random.Random(0)), rng=random.Random(0))
        trajs = generate_trajectories(n, pol, self.vocab, seed=90_000, reformat=False)
        ret = float(np.mean([sum(t.reward) for t in trajs]))
        self.log(f"OptimalPolicy bound: {ret:.3f} over {n} episodes")
        return ret


def episode_return(ro) -> torch.Tensor:
    return (ro.turn_reward * ro.turn_live).sum(dim=1)


def run(g: Gate) -> dict:
    """Every stage in the JAX gate's order; returns its JSON result."""
    args = g.args

    behavior_ret, behavior_win = g.scripted_stats(args.prob_smart, 1000, p_repeat=args.prob_repeat)
    ceiling_ret, ceiling_win = g.scripted_stats(1.0, 2000)
    g.log(f"behavior (p_smart={args.prob_smart}, p_repeat={args.prob_repeat}): return {behavior_ret:.3f} "
          f"win {behavior_win:.3f} | pure-consistent ceiling: {ceiling_ret:.3f}/{ceiling_win:.3f}")

    g.log(f"BC(all): {args.bc_steps} streaming steps @ bsize {args.bsize}")
    bc_params, bc_loss = g.train_bc_stream(args.bc_steps, args.seed)
    g.log(f"BC loss {bc_loss:.3f}")
    g.log(f"%BC: {args.pbc_steps} steps, top {args.filter_frac:.0%} of {g.pbc_gen}-episode chunks")
    pbc_params, pbc_loss = g.train_bc_stream(args.pbc_steps, args.seed, filter_frac=args.filter_frac)
    g.log(f"%BC loss {pbc_loss:.3f}")

    bc_s = g.eval_lm(bc_params, "BC(all)")
    bc_g = g.eval_lm(bc_params, "BC(all)", greedy=True)
    pbc_s = g.eval_lm(pbc_params, "%BC")
    pbc_g = g.eval_lm(pbc_params, "%BC", greedy=True)

    state, ilql_config = g.init_ilql(bc_params)
    state, curve = g.train_ilql_stream(state, ilql_config, bc_params)
    ilql_t = g.eval_guided(state, bc_params, "ILQL guided (target heads)", use_target=True)
    ilql_g = g.eval_guided(state, bc_params, "ILQL guided", greedy=True)
    optimal_ret = g.optimal_bound()

    final = curve[-1] if curve else dict(ret=float("nan"), win=float("nan"))
    result = dict(
        behavior_return=behavior_ret, behavior_win=behavior_win,
        consistent_ceiling_return=ceiling_ret,
        consistent_ceiling_win=ceiling_win,
        bc_return=bc_s["ret"], bc_win=bc_s["win"],
        bc_return_greedy=bc_g["ret"],
        pbc_return=pbc_s["ret"], pbc_win=pbc_s["win"],
        pbc_return_greedy=pbc_g["ret"],
        ilql_return=final["ret"], ilql_win=final["win"],
        ilql_return_target_heads=ilql_t["ret"],
        ilql_win_target_heads=ilql_t["win"],
        ilql_return_greedy=ilql_g["ret"], ilql_win_greedy=ilql_g["win"],
        optimal_return=optimal_ret,
        curve=curve,
        constrain_vocab=args.constrain_vocab,
        model=f"d{args.hidden} L{args.layers} byte vocab {g.tokenizer.vocab_size}, beta={args.beta}, streaming "
        f"bsize {args.bsize}, eval B={args.eval_batch} fused rollouts on {g.device.type}, head matmul "
        f"{args.head_matmul_precision} (lmrl_gym_torch)",
    )
    return result


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
