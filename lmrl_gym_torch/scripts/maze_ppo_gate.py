"""PPO learning gate on the double-T maze, on the port: the port of
`scripts/maze_ppo_gate.py`, with the same flags, defaults, stages and JSON
keys, plus `--device`.

    python -m lmrl_gym_torch.scripts.maze_ppo_gate               # on the card
    python -m lmrl_gym_torch.scripts.maze_ppo_gate --device cpu  # plain path

  1. BC on mediocre behavior data (a uniform p_optimal mixture): the frozen
     π₀ (the KL anchor) and the baseline policy;
  2. the frozen BC policy's return over fixed eval seeds, sampled and
     greedy (`text_env_eval` through `LMServer`);
  3. PPO rounds: rollouts of the live policy, per-step Markov windows
     chained for cross-window GAE, the per-token KL penalty against π₀,
     clipped-update epochs. The first --value-warmup-rounds rounds train
     only the value head (each step's policy update is discarded): with a
     cold value head the whitened advantages are about −(remaining steps),
     a position signal that degrades the policy;
  4. the return again on the same seeds; PPO must beat frozen BC.

`Gate` holds one method per stage and is shared with the Text-Nav gate
(`text_nav_ppo_gate.py`), which overrides the data, the serving prompt
and the windows. Its draws are the initial trunk and value head and the
Gumbel noise of every sampled decode; a `Replay` of the JAX gate's holds
this gate to the JAX gate. Without one, the port draws from
`torch.Generator`s seeded with the JAX gate's integers.
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--n-chains", type=int, default=300)
    p.add_argument("--p-optimal", type=float, default=0.4)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--bc-epochs", type=int, default=4)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--epochs-per-round", type=int, default=2)
    p.add_argument("--rollouts-per-round", type=int, default=48)
    p.add_argument("--eval-rollouts", type=int, default=48)
    p.add_argument("--bsize", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ppo-lr", type=float, default=3e-4)
    p.add_argument("--kl-weight", type=float, default=0.01)
    p.add_argument("--kl-target", type=float, default=None)
    p.add_argument("--value-warmup-rounds", type=int, default=2,
                   help="rounds that train only the value head (the policy restored after each step)")
    p.add_argument("--seed", type=int, default=9)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu (the plain path)")
    return p.parse_args(argv)


class Replay(NamedTuple):
    """Another run's draws: the initial trunk (BC starts from it), the
    initial value head, and the Gumbel noise [max_new_tokens, B, V] of
    each sampled `LMServer` call in order (greedy calls draw none)."""

    trunk: torch.nn.Module
    value_head: torch.nn.Module
    gumbels: Iterator[torch.Tensor]


class Gate:
    """The gate's data, model and harness, built from its flags; one method
    per stage. `dtype` is the trunk's activation dtype (bf16, as the JAX
    gate runs)."""

    MAX_LEN, MAX_NEW = 160, 12

    def __init__(self, args: argparse.Namespace, dtype: str = "bfloat16", replay: Optional[Replay] = None):
        from lmrl_gym_torch.algos.value_policy import LMServer
        from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation
        from lmrl_gym_torch.core.device import resolve_device
        from lmrl_gym_torch.models.config import TransformerConfig
        from lmrl_gym_torch.models.generation import SamplingConfig
        from lmrl_gym_torch.models.interface import LMCore

        self.args = args
        self.replay = replay
        self.device = resolve_device(args.device)
        self.t_start = time.time()
        self.tokenizer, eos_id = self.make_tokenizer()
        self.config = TransformerConfig(
            vocab_size=self.tokenizer.vocab_size, hidden_size=args.hidden, num_layers=args.layers,
            num_heads=args.heads, max_position_embeddings=self.max_positions(), pad_vocab_to_multiple=64,
            embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0, dtype=dtype,
        )
        self.core = LMCore(self.config, device=self.device)
        self.strategy = BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, self.MAX_LEN)
        self.server = LMServer(self.core, self.tokenizer)
        pad = self.tokenizer.pad_token_id
        self.greedy_sampling = SamplingConfig(max_new_tokens=self.MAX_NEW, greedy=True, eos_token_id=eos_id,
                                              pad_token_id=pad)
        self.rollout_sampling = SamplingConfig(max_new_tokens=self.MAX_NEW, greedy=False, temperature=1.0,
                                               eos_token_id=eos_id, pad_token_id=pad)
        # one numpy stream orders BC's batches and then every round's
        self.rng = np.random.default_rng(0)

    # ---- the parts the Text-Nav gate overrides
    def make_tokenizer(self):
        from lmrl_gym_torch.text.tokenizer import ByteTokenizer

        return ByteTokenizer(), 10

    def max_positions(self) -> int:
        return 256

    def eval_env(self):
        from lmrl_gym_torch.cli.tasks import build_maze_env

        if not hasattr(self, "_env"):
            self._env = build_maze_env()
        return self._env

    def prompt(self, history) -> str:
        from lmrl_gym_torch.text.frames import text_history_to_str

        return text_history_to_str(history)

    def round_chain(self, rollout):
        """One rollout → its per-step Markov windows, chained."""
        from lmrl_gym_torch.text.frames import TextTrajectory, TextTrajectoryChain, TokenTrajectoryChain

        chain = None
        for tr in reversed(rollout):
            chain = TextTrajectoryChain(TextTrajectory((tr.pre_action_history[-1], tr.post_action_history[-1]),
                                                       (0.0, tr.reward), tr.done), chain)
        return TokenTrajectoryChain.from_text_trajectory_chain(chain, self.tokenizer)

    def bc_token_chains(self):
        from lmrl_gym_torch.cli.tasks import generate_maze_chains
        from lmrl_gym_torch.text.frames import TokenTrajectoryChain

        args = self.args
        self.log(f"data: {args.n_chains} chains, p_optimal={args.p_optimal} uniform mixture")
        chains = generate_maze_chains(args.n_chains, seed=args.seed, p_optimal=args.p_optimal)
        return [TokenTrajectoryChain.from_text_trajectory_chain(c, self.tokenizer) for c in chains]

    def trace_entry(self, rnd: int, mean_kl: float, kl_coef: float, reward: float) -> dict:
        return dict(round=rnd, mean_kl=mean_kl, kl_coef=kl_coef, rollout_reward=reward)

    def result_extra(self) -> dict:
        return {}

    # ---- shared machinery
    def kl_controller(self):
        """Adaptive towards --kl-target where the gate has that flag and it
        is set, else fixed at --kl-weight."""
        from lmrl_gym_torch.algos.ppo import AdaptiveKLController, FixedKLController

        args = self.args
        if getattr(args, "kl_target", None) is not None:
            return AdaptiveKLController(args.kl_weight, args.kl_target, 10000.0)
        return FixedKLController(args.kl_weight)

    def log(self, msg: str) -> None:
        print(f"{msg} ({time.time() - self.t_start:.0f}s)", flush=True)

    def initial_weights(self) -> Tuple[torch.nn.Module, torch.nn.Module]:
        """The trunk BC starts from and the value head: the replayed ones,
        else torch draws seeded 0 and 2 (the JAX gate's PRNGKey integers)."""
        if self.replay is not None:
            return self.replay.trunk, self.replay.value_head
        from lmrl_gym_torch.models.heads import LinearHead, LinearHeadConfig
        from lmrl_gym_torch.models.transformer import init_params

        value_head = LinearHead(LinearHeadConfig(self.config.hidden_size, 1, bias_init=0.0), device=self.device,
                                seed=2)
        return init_params(self.config, seed=0, device=self.device), value_head

    def generate(self, params, prompts: List[str], sampling, generator) -> List[str]:
        """`LMServer` over the prompts; a sampled call takes the replay's
        next noise when there is a replay."""
        gumbel = None
        if self.replay is not None and not sampling.greedy:
            gumbel = next(self.replay.gumbels).to(self.device)
        return self.server.generate_from_strs(params, prompts, self.MAX_LEN, sampling, generator, gumbel)

    def make_policy(self, params, sampling, seed: int):
        """The serving policy: `self.prompt(history)` → the LM's action."""
        from lmrl_gym_torch.envs.base import BatchedTextPolicy
        from lmrl_gym_torch.text.frames import Text

        gate = self
        generator = torch.Generator(device=self.device).manual_seed(seed)

        class Policy(BatchedTextPolicy):
            def act(self, text_history, done=None):
                if done is None:
                    done = [False] * len(text_history)
                live = [i for i, d in enumerate(done) if not d]
                results = [None] * len(text_history)
                if not live:
                    return results
                outs = gate.generate(params, [gate.prompt(text_history[i]) for i in live], sampling, generator)
                for i, out in zip(live, outs):
                    results[i] = text_history[i] + (Text(out, True),)
                return results

        return Policy()

    def eval_return(self, params, tag: str) -> Tuple[float, float]:
        """(sampled, greedy) mean return over the fixed eval seeds."""
        from lmrl_gym_torch.envs.base import text_env_eval

        out = {}
        n = self.args.eval_rollouts
        for name, sampling, seed in (("sampled", self.rollout_sampling, 1234), ("greedy", self.greedy_sampling, 0)):
            _, summary = text_env_eval(self.eval_env(), self.make_policy(params, sampling, seed), n_rollouts=n,
                                   seed_generator=iter(range(5000, 5000 + n)), bsize=16)
            out[name] = summary["reward"]["mean"]
            self.log(f"{tag}: {name} return {out[name]:.3f} (len {summary['length']['mean']:.1f})")
        return out["sampled"], out["greedy"]

    def _tensors(self, b: dict, **dtypes) -> dict:
        return {k: torch.from_numpy(np.asarray(b[k])).to(self.device, dt) for k, dt in dtypes.items()}

    # ---- stage 1: BC
    def train_bc(self, token_chains):
        """--bc-epochs over every chain window; returns (params, last loss)."""
        from lmrl_gym_torch.algos import data as algo_data
        from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, make_bc_train_step
        from lmrl_gym_torch.core.optimizer import OptimizerConfig, TrainState, make_optimizer

        args = self.args
        windows = [tt for c in token_chains for tt in c.to_list()]
        examples = [algo_data.BCExample.from_segments(tt.tokens, tt.is_action) for tt in windows]
        dataset = algo_data.ArrayDataset(
            algo_data.block_bc_examples(examples, self.strategy, self.tokenizer.pad_token_id))
        params = copy.deepcopy(self.initial_weights()[0])
        state = BCTrainState(TrainState(params, make_optimizer(OptimizerConfig(lr=args.lr), params)))
        step = make_bc_train_step(self.core, BCConfig(), self.tokenizer.pad_token_id)
        loss = torch.zeros(())
        for _ in range(args.bc_epochs):
            for b in dataset.batches(args.bsize, rng=self.rng, drop_last=False):
                t = self._tensors(b, input_ids=torch.long, training_mask=torch.float32)
                state, loss, _ = step(state, BCBatch(t["input_ids"], t["training_mask"]))
        return state.model.params, float(loss)

    # ---- stage 2: PPO
    def init_ppo(self, bc_params):
        """(PPO state on copies of the BC trunk and the initial value head,
        the frozen π₀, the train step)."""
        from lmrl_gym_torch.algos.ppo import PPOConfig, PPOTrainState, make_ppo_train_step
        from lmrl_gym_torch.core.optimizer import OptimizerConfig, TrainState, make_optimizer

        args = self.args
        policy = copy.deepcopy(bc_params)
        value_head = copy.deepcopy(self.initial_weights()[1])
        state = PPOTrainState(
            TrainState(policy, make_optimizer(OptimizerConfig(lr=args.ppo_lr), policy)),
            TrainState(value_head, make_optimizer(OptimizerConfig(lr=args.lr), value_head)),
        )
        step = make_ppo_train_step(self.core, PPOConfig(gamma=0.99, lam=0.95), self.tokenizer.pad_token_id)
        return state, copy.deepcopy(bc_params).requires_grad_(False), step

    def rollouts(self, params, rnd: int):
        """The round's rollouts of the live policy → (token chains, summary)."""
        from lmrl_gym_torch.envs.base import text_env_eval

        args = self.args
        start = args.seed * 7 + rnd * 1009
        interactions, summary = text_env_eval(
            self.eval_env(), self.make_policy(params, self.rollout_sampling, 100 + rnd),
            n_rollouts=args.rollouts_per_round, seed_generator=iter(range(start, start + args.rollouts_per_round)),
            bsize=16)
        return [self.round_chain(r) for r in interactions], summary

    def ppo_data(self, state, init_policy, chains, kl_weight: float):
        """GAE data of the round's chains → (blocked arrays, mean KL, windows)."""
        from lmrl_gym_torch.algos.ppo import block_ppo_data, get_ppo_data_from_chains, make_ppo_forward_fn
        from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation

        pad = self.tokenizer.pad_token_id
        forward_fn = make_ppo_forward_fn(self.core, init_policy, state.policy.params, state.value_head.params, pad)
        datas, kls = get_ppo_data_from_chains(forward_fn, self.tokenizer, chains, bsize=self.args.bsize,
                                              max_length=self.MAX_LEN, gamma=0.99, lam=0.95, kl_weight=kl_weight)
        mean_kl = float(np.mean(kls)) if len(kls) else 0.0
        blocked = block_ppo_data(datas, BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, self.MAX_LEN), pad)
        return blocked, mean_kl, len(datas)

    def ppo_epochs(self, state, step, blocked: dict, warmup: bool):
        """--epochs-per-round over the round's windows; a warm-up round
        keeps only the value head's updates. Returns (state, last loss)."""
        from lmrl_gym_torch.algos import data as algo_data
        from lmrl_gym_torch.algos.ppo import PPOBatch, PPOTrainState

        dataset = algo_data.ArrayDataset(blocked)
        loss = torch.zeros(())
        for _ in range(self.args.epochs_per_round):
            for b in dataset.batches(self.args.bsize, rng=self.rng, drop_last=False):
                t = self._tensors(b, input_ids=torch.long, should_take_action=torch.bool, old_logprobs=torch.float32,
                                  old_values=torch.float32, old_advantages=torch.float32, old_returns=torch.float32)
                saved_policy = copy.deepcopy(state.policy) if warmup else None
                state, loss, _ = step(state, PPOBatch(t["input_ids"], t["should_take_action"], t["old_logprobs"],
                                                      t["old_values"], t["old_advantages"], t["old_returns"]))
                if warmup:  # value-only round: the policy update is discarded
                    state = PPOTrainState(saved_policy, state.value_head)
        return state, float(loss)


def run(g: Gate) -> dict:
    """Every stage in the JAX gate's order; returns its JSON result."""
    args = g.args
    token_chains = g.bc_token_chains()
    t0 = time.time()
    bc_params, bc_loss = g.train_bc(token_chains)
    g.log(f"BC trained, loss {bc_loss:.3f} ({time.time() - t0:.0f}s of BC)")
    r0, g0 = g.eval_return(bc_params, "frozen BC")

    state, init_policy, step = g.init_ppo(bc_params)
    kl_controller = g.kl_controller()
    kl_trace = []
    for rnd in range(args.rounds):
        chains, summary = g.rollouts(state.policy.params, rnd)
        blocked, mean_kl, n_windows = g.ppo_data(state, init_policy, chains, kl_controller.value)
        kl_controller.update(mean_kl, n_windows)
        reward = summary["reward"]["mean"]
        kl_trace.append(g.trace_entry(rnd, mean_kl, kl_controller.value, reward))
        state, loss = g.ppo_epochs(state, step, blocked, warmup=rnd < args.value_warmup_rounds)
        g.log(f"round {rnd}: rollout_r={reward:7.3f} kl={mean_kl:.4f} coef={kl_controller.value:.5f} loss={loss:7.3f}")

    r1, g1 = g.eval_return(state.policy.params, "after PPO")
    return dict(bc_return=r0, ppo_return=r1, improvement=r1 - r0, bc_return_greedy=g0, ppo_return_greedy=g1,
                kl_trace=kl_trace, **g.result_extra())


def main(argv=None, gate_class=Gate, parse=parse_args):
    args = parse(argv)
    g = gate_class(args)
    result = run(g)
    print(f"gate wall time: {time.time() - g.t_start:.1f} s on {g.device.type}", flush=True)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(args=vars(args), **result), f, indent=1)
    return result


if __name__ == "__main__":
    main()
