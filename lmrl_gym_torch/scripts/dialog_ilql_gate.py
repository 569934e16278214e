"""Dialog-task ILQL gate on Twenty-Questions, with the trained LM oracle in
the loop, on the port: the port of `scripts/dialog_ilql_gate.py`, with the
same flags, defaults, stages and JSON keys, plus `--device`.

    python -m lmrl_gym_torch.scripts.dialog_ilql_gate              # on the card
    python -m lmrl_gym_torch.scripts.dialog_ilql_gate --device cpu # plain path

  1. behavior = an EPISODE-level quality mixture (half a strong
     category-elimination asker, p = 0.85, half a weak random guesser,
     p = 0.15) in the scripted-oracle env;
  2. BC on ALL episodes (the baseline the RL must beat);
  3. offline ILQL from the BC trunk (twin Q + V, value-bias-init at the
     typical return, cosine lr warmdown);
  4. serving: (a) β-guided two-trunk decode π_β + β·min(Q1,Q2) and (b)
     SAMPLE-RERANK — K BC samples per turn scored by
     Σ_action(min(Q1,Q2) − V), argmax;
  5. eval on fixed seeds in the scripted-oracle env and the LM-oracle env
     (the oracle trained in-repo and served batched), with the oracle's
     fidelity against the scripted labeler.

The JAX gate's draws: the initial policy trunk, the (q1, q2, v) heads and
the oracle, and the PRNG keys of its sampled decodes (BC sampled, the
reranker's K proposals). Its data, batch order and greedy decodes come
from the same Python and numpy RNG calls in both packages. A `Replay` of
those initial weights and of each sampled call's Gumbel noise holds this
gate to the JAX gate. The gate runs in float32 (`tiny_test_config`), as
the JAX gate does.

`Gate` here is the ILQL machinery the Car-Dealer gate
(`car_dealer_ilql_gate.py`) extends.
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lmrl_gym_torch.scripts import twenty_questions_gate as tqg


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--behavior-episodes", type=int, default=400)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--bc-epochs", type=int, default=60)
    p.add_argument("--ilql-epochs", type=int, default=10)
    p.add_argument("--bsize", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ilql-lr", type=float, default=1e-3)
    p.add_argument("--beta", type=float, default=8.0)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--polyak", type=float, default=0.005)
    p.add_argument("--value-bias-init", type=float, default=-17.0, help="typical episode return of the mixture")
    p.add_argument("--freeze-base", action="store_true")
    p.add_argument("--lr-warmdown", action="store_true", default=True)
    p.add_argument("--no-lr-warmdown", dest="lr_warmdown", action="store_false")
    p.add_argument("--rerank-k", type=int, default=8, help="BC proposals sampled per turn for the reranker")
    p.add_argument("--rerank-temp", type=float, default=1.0)
    p.add_argument("--max-len", type=int, default=768)
    p.add_argument("--bpe-vocab", type=int, default=2048)
    p.add_argument("--eval-rollouts", type=int, default=48)
    p.add_argument("--eval-bsize", type=int, default=16)
    p.add_argument("--oracle-episodes", type=int, default=200)
    p.add_argument("--oracle-epochs", type=int, default=10)
    p.add_argument("--skip-lm-oracle", action="store_true", help="scripted-env eval only (fast debug)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu (the plain path)")
    return p.parse_args(argv)


class Replay(NamedTuple):
    """Another run's draws: the initial policy trunk (BC trains a copy), the
    initial (q1, q2, v) heads, the LM oracle's (or buyer's) initial weights,
    and the Gumbel noise of every sampled decode, in call order."""

    trunk: torch.nn.Module
    heads: Tuple[torch.nn.Module, torch.nn.Module, torch.nn.Module]
    oracle: Optional[torch.nn.Module]
    gumbels: Iterator[torch.Tensor]


class Gate(tqg.OracleStage):
    """The gate's tokenizer, model, ILQL stage and serving policies, built
    from its flags; one method per stage. Draws come from torch Generators
    seeded with the JAX gate's key integers, or from `replay`."""

    MAX_NEW = 48  # new tokens per policy turn
    SCORE_LENGTH_NORMALIZE = False  # Σ advantage (the JAX gate's score fn)

    def __init__(self, args: argparse.Namespace, dtype: str = "float32", replay: Optional[Replay] = None):
        from lmrl_gym_torch.algos.value_policy import LMServer
        from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation
        from lmrl_gym_torch.core.device import resolve_device
        from lmrl_gym_torch.models.config import tiny_test_config
        from lmrl_gym_torch.models.generation import SamplingConfig
        from lmrl_gym_torch.models.interface import LMCore

        self.args = args
        self.replay = replay
        self.device = resolve_device(args.device)
        self.t_start = time.time()
        self.tokenizer = self.make_tokenizer()
        print(f"BPE tokenizer: vocab {self.tokenizer.vocab_size}", flush=True)
        self.config = tiny_test_config(
            vocab_size=self.tokenizer.vocab_size, hidden_size=args.hidden, num_layers=args.layers,
            num_heads=args.heads, max_position_embeddings=max(256, args.max_len), dtype=dtype,
        )
        self.core = LMCore(self.config, device=self.device)
        self.server = LMServer(self.core, self.tokenizer)
        self.strategy = BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, args.max_len)
        eos, pad = self.tokenizer.newline_token_id, self.tokenizer.pad_token_id
        self.sampling_greedy = SamplingConfig(max_new_tokens=self.MAX_NEW, greedy=True, eos_token_id=eos,
                                              pad_token_id=pad)
        self.sampling_sample = SamplingConfig(max_new_tokens=self.MAX_NEW, greedy=False,
                                              temperature=args.rerank_temp, eos_token_id=eos, pad_token_id=pad)

    def make_tokenizer(self):
        from lmrl_gym_torch.text.bpe import train_bpe_for_task

        return train_bpe_for_task("twenty_questions", vocab_size=self.args.bpe_vocab, n_episodes=200, seed=0)

    def log(self, msg: str) -> None:
        print(f"{msg} ({time.time() - self.t_start:.0f}s)", flush=True)

    def gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _tensors(self, b: dict, **dtypes) -> dict:
        """The batch's arrays on the device; an absent one (the next window
        of a chain without one) stays None."""
        return {k: None if b.get(k) is None else torch.from_numpy(np.asarray(b[k])).to(self.device, dt)
                for k, dt in dtypes.items()}

    # ---- 1. behavior
    def behavior(self):
        return tqg.collect_behavior(self.args.behavior_episodes, -1.0, self.args.seed)

    # ---- 2. BC
    def train_bc(self, trajectories):
        args = self.args
        initial = None if self.replay is None else self.replay.trunk
        train = tqg.build_policy_trainer(self.core, self.config, self.tokenizer, args.max_len, args.lr,
                                         args.bc_epochs, args.bsize, initial)
        return train(trajectories, args.seed)

    # ---- 3. offline ILQL from the BC trunk
    def token_chains(self, trajectories):
        from lmrl_gym_torch.text.frames import TextTrajectoryChain, TokenTrajectoryChain

        return [TokenTrajectoryChain.from_text_trajectory_chain(TextTrajectoryChain(t, None), self.tokenizer)
                for t in trajectories]

    def initial_heads(self):
        """Copies of the initial (q1, q2, v) heads: the replayed ones, else
        MLP heads (hidden 2·D, second layer zero, bias --value-bias-init)
        from seeds 2, 3 and 4."""
        from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig

        if self.replay is not None:
            return tuple(copy.deepcopy(h) for h in self.replay.heads)
        D = self.config.hidden_size
        kw = dict(input_dim=D, hidden_dim=2 * D, layer2_initializer_range=0.0,
                  layer2_bias_init=self.args.value_bias_init)
        q_cfg = MLPHeadConfig(output_dim=self.config.padded_vocab_size, **kw)
        return (MLPHead(q_cfg, device=self.device, seed=2), MLPHead(q_cfg, device=self.device, seed=3),
                MLPHead(MLPHeadConfig(output_dim=1, **kw), device=self.device, seed=4))

    def _base_tx(self):
        from lmrl_gym_torch.core import optimizer as opt

        return opt.set_to_zero() if self.args.freeze_base else opt.adamw(self.args.ilql_lr * 0.3)

    def _head_lr(self, epochs: int, n_batches: int):
        from lmrl_gym_torch.core import optimizer as opt

        args = self.args
        total = max(1, epochs * n_batches)
        return opt.cosine_decay_schedule(args.ilql_lr, total) if args.lr_warmdown else args.ilql_lr

    def train_ilql(self, chains, bc_params):
        """--ilql-epochs of ILQL on the episodes' windows; returns the state."""
        from lmrl_gym_torch.algos import data as algo_data
        from lmrl_gym_torch.algos.ilql import ILQLBatch, ILQLConfig, init_ilql_state, make_ilql_train_step
        from lmrl_gym_torch.core import optimizer as opt

        args, pad = self.args, self.tokenizer.pad_token_id
        examples = [algo_data.ILQLExample.from_chain(c) for c in chains]
        dataset = algo_data.ArrayDataset(algo_data.block_ilql_examples(examples, self.strategy, pad))
        config = ILQLConfig(gamma=args.gamma, polyak_alpha=args.polyak, beta=args.beta,
                            use_separate_target_base=not args.freeze_base, freeze_base=args.freeze_base)
        n_batches = -(-len(examples) // args.bsize)
        q1, q2, v = self.initial_heads()
        state = init_ilql_state(copy.deepcopy(bc_params), q1, q2, v, self._base_tx(),
                                opt.adamw(self._head_lr(args.ilql_epochs, n_batches)), config)
        step = make_ilql_train_step(self.core, config, pad)
        rng = np.random.default_rng(args.seed)
        for epoch in range(1, args.ilql_epochs + 1):
            t0 = time.time()
            for b in dataset.batches(args.bsize, rng=rng, drop_last=False):
                t = self._tensors(b, input_ids=torch.long, should_take_action=torch.bool, rewards=torch.float32,
                                  dones=torch.bool, next_token_ids=torch.long, next_dones=torch.bool)
                state, loss, logs = step(state, ILQLBatch(t["input_ids"], t["should_take_action"], t["rewards"],
                                                          t["dones"], t["next_token_ids"], t["next_dones"]))
            print(f"ILQL epoch {epoch}: loss {float(loss):.3f} q~{float(logs['q1']['mean']):.2f} "
                  f"v~{float(logs['v']['mean']):.2f} ({time.time() - t0:.0f}s)", flush=True)
        return state

    # ---- 4. serving
    def generate(self, params, prompts, sampling, generator):
        """`LMServer` over the prompts; a sampled call takes the replay's
        next noise when there is a replay."""
        gumbel = None
        if self.replay is not None and not sampling.greedy:
            gumbel = next(self.replay.gumbels).to(self.device)
        return self.server.generate_from_strs(params, prompts, self.args.max_len, sampling, generator, gumbel)

    def bc_policy(self, bc_params, greedy: bool = True):
        from lmrl_gym_torch.algos.value_policy import GenerationPolicy

        sampling = self.sampling_greedy if greedy else self.sampling_sample
        return GenerationPolicy(generate_batch=lambda prompts, gen: self.generate(bc_params, prompts, sampling, gen),
                                generator=self.gen(self.args.seed))

    def guided_policy(self, state, bc_params):
        from lmrl_gym_torch.algos.value_policy import GenerationPolicy, ValueGuidedServer, ValueRLParams

        guided = ValueGuidedServer(self.core, self.tokenizer, beta=self.args.beta, share_trunk=False)
        bundle = ValueRLParams(pi_beta=bc_params, base=state.base.params, q1_head=state.q1_head.params,
                               q2_head=state.q2_head.params, v_head=state.v_head.params)

        def generate_batch(prompts, generator):
            return guided.generate_from_strs(bundle, prompts, self.args.max_len, self.sampling_greedy, generator)

        return GenerationPolicy(generate_batch=generate_batch, generator=self.gen(self.args.seed))

    def ilql_score_fn(self, state):
        from lmrl_gym_torch.algos.value_policy import ValueRLParams, make_ilql_score_fn

        bundle = ValueRLParams(pi_beta=None, base=state.base.params, q1_head=state.q1_head.params,
                               q2_head=state.q2_head.params, v_head=state.v_head.params)
        return make_ilql_score_fn(self.core, bundle, self.tokenizer.pad_token_id,
                                  length_normalize=self.SCORE_LENGTH_NORMALIZE)

    def rerank_policy(self, bc_params, score_fn):
        """K BC samples per turn, the best by `score_fn` over its action
        tokens; the score batch is padded to eval_bsize·K rows (row 0
        repeated), the JAX gate's one score shape."""
        from lmrl_gym_torch.algos.value_policy import tokenize_histories_for_scoring
        from lmrl_gym_torch.core.blocking import strip_prompt_from_completion
        from lmrl_gym_torch.envs.base import BatchedTextPolicy
        from lmrl_gym_torch.text.frames import Text, text_history_to_str

        gate, args = self, self.args
        K, CH = args.rerank_k, args.eval_bsize * args.rerank_k

        class SampleRerankPolicy(BatchedTextPolicy):
            def __init__(self):
                self.generator = gate.gen(args.seed + 1)

            def act(self, histories, done=None):
                if done is None:
                    done = [False] * len(histories)
                live = [i for i, d in enumerate(done) if not d]
                results = [None] * len(histories)
                if not live:
                    return results
                prompts = [text_history_to_str(histories[i]) for i in live]
                tiled = [pr for pr in prompts for _ in range(K)]
                outs = gate.generate(bc_params, tiled, gate.sampling_sample, self.generator)
                cands = []
                for j, i in enumerate(live):
                    for k in range(K):
                        out = strip_prompt_from_completion(prompts[j], outs[j * K + k])
                        cands.append(histories[i] + (Text(out, True),))
                ids, am = tokenize_histories_for_scoring(cands, gate.tokenizer, args.max_len, device=gate.device)
                n = ids.shape[0]
                if n < CH:
                    ids = torch.cat([ids, ids[:1].expand(CH - n, -1)])
                    am = torch.cat([am, am[:1].expand(CH - n, -1)])
                scores = score_fn(ids, am).cpu().numpy()[:n]
                for j, i in enumerate(live):
                    results[i] = cands[j * K + int(np.argmax(scores[j * K:(j + 1) * K]))]
                return results

        return SampleRerankPolicy()

    def eval_policy(self, policy, env, name, fmt: str = ".2f") -> float:
        from lmrl_gym_torch.envs.base import text_env_eval

        args = self.args
        _, summary = text_env_eval(env, policy, n_rollouts=args.eval_rollouts,
                                   seed_generator=iter(range(10_000, 10_000 + args.eval_rollouts)),
                                   bsize=args.eval_bsize)
        r = summary["reward"]["mean"]
        self.log(f"{name}: reward {r:{fmt}} done {summary['done']['mean']:.2f} len {summary['length']['mean']:.1f}")
        return r

    # ---- 5. the LM oracle
    def oracle_train_config(self):
        from lmrl_gym_torch.envs.lm_oracle import OracleTrainConfig

        args = self.args
        return OracleTrainConfig(n_episodes=args.oracle_episodes, epochs=args.oracle_epochs, seed=args.seed)

    def lm_oracle_env(self):
        """The LM-oracle env (the decoder oracle trained on rollout plus
        balanced QA, served batched) and the oracle's fidelity."""
        from lmrl_gym_torch.envs.lm_oracle import (
            build_lm_twenty_questions_env,
            collect_twenty_questions_qa,
            collect_twenty_questions_qa_balanced,
        )

        args = self.args
        qa = collect_twenty_questions_qa(args.oracle_episodes, seed=args.seed)
        qa += collect_twenty_questions_qa_balanced(seed=args.seed) * 3
        core, params = self.train_oracle(qa)
        env = build_lm_twenty_questions_env(core, self.tokenizer, params, batched=True)
        fidelity, _, _ = tqg.oracle_fidelity(env.oracle)
        self.log(f"oracle fidelity vs scripted: {fidelity:.2f}")
        return env, fidelity


def run(g: Gate) -> dict:
    """Every stage in the JAX gate's order; returns its JSON result."""
    from lmrl_gym_torch.cli.tasks import build_twenty_questions_env

    args = g.args
    episodes = g.behavior()
    rewards = np.asarray([r for _, r in episodes])
    g.log(f"behavior: {len(episodes)} episodes, reward mean {rewards.mean():.2f} min {rewards.min():.0f} "
          f"max {rewards.max():.0f}")
    all_trajs = [t for t, _ in episodes]
    bc_params, bc_loss = g.train_bc(all_trajs)
    g.log(f"BC loss {bc_loss:.3f}")
    state = g.train_ilql(g.token_chains(all_trajs), bc_params)
    score_fn = g.ilql_score_fn(state)
    K = args.rerank_k

    envs = {"scripted": build_twenty_questions_env()}
    oracle_fidelity = None
    if not args.skip_lm_oracle:
        envs["lm_oracle"], oracle_fidelity = g.lm_oracle_env()

    results = {}
    for env_name, env in envs.items():
        results[f"bc_greedy_{env_name}"] = g.eval_policy(g.bc_policy(bc_params, True), env, f"BC greedy [{env_name}]")
        results[f"bc_sampled_{env_name}"] = g.eval_policy(g.bc_policy(bc_params, False), env,
                                                          f"BC sampled [{env_name}]")
        results[f"ilql_guided_{env_name}"] = g.eval_policy(g.guided_policy(state, bc_params), env,
                                                           f"ILQL guided [{env_name}]")
        results[f"ilql_rerank_{env_name}"] = g.eval_policy(g.rerank_policy(bc_params, score_fn), env,
                                                           f"ILQL sample-rerank K={K} [{env_name}]")

    gate_env = "lm_oracle" if "lm_oracle" in envs else "scripted"
    return dict(
        behavior_reward_mean=float(rewards.mean()),
        oracle_fidelity=oracle_fidelity,
        gate_env=gate_env,
        bc_reward=results[f"bc_greedy_{gate_env}"],
        ilql_rerank_reward=results[f"ilql_rerank_{gate_env}"],
        ilql_guided_reward=results[f"ilql_guided_{gate_env}"],
        improvement=results[f"ilql_rerank_{gate_env}"] - results[f"bc_greedy_{gate_env}"],
        all_evals=results,
        model=f"d{args.hidden} L{args.layers} bpe vocab {g.tokenizer.vocab_size} policy; in-repo LM oracle (ref uses "
        f"flan-t5-xl — zero egress); K={K} sample-rerank serving",
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
