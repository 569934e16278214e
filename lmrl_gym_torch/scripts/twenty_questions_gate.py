"""Twenty-Questions BC vs filtered-BC gate with the LM oracle in the loop,
on the port: the port of `scripts/twenty_questions_gate.py`, with the same
flags, defaults, stages and JSON keys, plus `--device`.

    python -m lmrl_gym_torch.scripts.twenty_questions_gate              # on the card
    python -m lmrl_gym_torch.scripts.twenty_questions_gate --device cpu # plain path

  1. train the LM oracle from the scripted teacher's QA distribution
     (`envs/lm_oracle.py` collect → train), served batched: one padded
     generate per env turn; its fidelity against the scripted labeler on
     100 probe questions;
  2. collect behavior episodes from a mixed-quality asker (--p-good of the
     mass on the category-elimination heuristic, the rest on random object
     guesses; p_good < 0: half the episodes strong, half weak);
  3. BC on ALL episodes vs FILTERED BC on the top --filter-frac by reward
     (the reference's %BC filter), at an equal gradient-update budget;
  4. both policies' mean reward in the LM-oracle env on fixed seeds.

The JAX gate's draws are its initial weights (the policy trunk, one draw
for BC and filtered BC alike, and the oracle's); every decode is greedy,
and the data come from the same Python and numpy RNG calls in both
packages. A `Replay` of the JAX gate's initial weights holds this gate to
it. The gate runs in float32 (`tiny_test_config`), as the JAX gate does.

`build_policy_trainer`, `collect_behavior` and `probe_questions` serve
the dialog ILQL and Car-Dealer gates as well.
"""
from __future__ import annotations

import argparse
import copy
import json
import random
import time
from typing import NamedTuple, Optional

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--oracle-episodes", type=int, default=200)
    p.add_argument("--oracle-epochs", type=int, default=10)
    p.add_argument("--oracle-hidden", type=int, default=256)
    p.add_argument("--oracle-layers", type=int, default=4)
    p.add_argument("--behavior-episodes", type=int, default=400)
    p.add_argument("--p-good", type=float, default=0.5)
    p.add_argument("--filter-frac", type=float, default=0.25)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--bc-epochs", type=int, default=60)
    p.add_argument("--bsize", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max-len", type=int, default=768)
    p.add_argument(
        "--tokenizer", choices=["byte", "bpe"], default="bpe",
        help="bpe (default): task-trained BPE - object names become 1-2 tokens, like the reference's GPT-2 BPE. "
        "byte-level measurably fails here: the policy memorizes the 17 category templates but garbles the 158 "
        "long-tail object names, so no episode can ever name the target",
    )
    p.add_argument("--bpe-vocab", type=int, default=2048)
    p.add_argument("--eval-rollouts", type=int, default=32)
    p.add_argument("--eval-bsize", type=int, default=16)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu (the plain path)")
    return p.parse_args(argv)


class Replay(NamedTuple):
    """Initial weights: the policy trunk (BC and filtered BC each train a
    copy) and the LM oracle's."""

    trunk: torch.nn.Module
    oracle: torch.nn.Module


def build_policy_trainer(core, config, tokenizer, max_len, lr, bc_epochs, bsize, initial=None):
    """Returns train(trajectories, seed, epochs_scale=1) -> (params, last
    loss): a fresh model each call, a copy of `initial` when given, else
    drawn from `seed`; batches ordered by np.random.default_rng(seed)."""
    from lmrl_gym_torch.algos import data as algo_data
    from lmrl_gym_torch.algos.bc import BCBatch, BCConfig, BCTrainState, make_bc_train_step
    from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation
    from lmrl_gym_torch.core.optimizer import OptimizerConfig, TrainState, make_optimizer
    from lmrl_gym_torch.models.transformer import init_params
    from lmrl_gym_torch.text.frames import TokenTrajectory

    strategy = BlockingStrategy(Padding.RIGHT, Truncation.RIGHT, max_len)
    step = make_bc_train_step(core, BCConfig(), tokenizer.pad_token_id)

    def train(trajectories, seed, epochs_scale=1):
        examples = []
        for traj in trajectories:
            tt = TokenTrajectory.from_text_trajectory(traj, tokenizer)
            examples.append(algo_data.BCExample.from_segments(tt.tokens, tt.is_action))
        dataset = algo_data.ArrayDataset(algo_data.block_bc_examples(examples, strategy, tokenizer.pad_token_id))
        if initial is None:
            params = init_params(config, seed=seed, device=core.device)
        else:
            params = copy.deepcopy(initial)
        state = BCTrainState(model=TrainState(params, make_optimizer(OptimizerConfig(lr=lr), params)))
        rng = np.random.default_rng(seed)
        loss = torch.zeros(())
        for _ in range(bc_epochs * epochs_scale):
            for b in dataset.batches(bsize, rng=rng, drop_last=False):
                batch = BCBatch(torch.from_numpy(np.asarray(b["input_ids"])).to(core.device, torch.long),
                                torch.from_numpy(np.asarray(b["training_mask"])).to(core.device, torch.float32))
                state, loss, _ = step(state, batch)
        return state.model.params, float(loss)

    return train


def collect_behavior(n_episodes, p_good, seed):
    """Mixed-quality asker in the scripted-oracle env → (trajectory,
    total_reward) pairs. Bad actions are random object guesses, which
    prolong the episode. p_good < 0: an EPISODE-level mixture, the even
    episodes from a strong asker (0.85), the odd from a weak one (0.15)."""
    from lmrl_gym_torch.cli.tasks import HeuristicAskerPolicy, build_twenty_questions_env, transitions_to_chain
    from lmrl_gym_torch.envs.base import TextPolicy, interact_environment
    from lmrl_gym_torch.envs.twenty_questions.data import DEFAULT_OBJECT_DICT
    from lmrl_gym_torch.text.frames import Text

    env = build_twenty_questions_env()
    rng = random.Random(seed)
    all_objects = [e.split(";")[0] for entries in DEFAULT_OBJECT_DICT.values() for e in entries]

    class NoisyAsker(TextPolicy):
        def __init__(self, p):
            self.p = p
            self.inner = HeuristicAskerPolicy(rng=rng)

        def act(self, history):
            if rng.random() < self.p:
                return self.inner.act(history)
            obj = rng.choice(all_objects).lower()
            article = "an" if obj[0] in "aeiou" else "a"
            return history + (Text(f"Is it {article} {obj}?\n", True),)

    episodes = []
    for i in range(n_episodes):
        p = (0.85 if i % 2 == 0 else 0.15) if p_good < 0 else p_good
        transitions = interact_environment(env, NoisyAsker(p), env_seed=seed * 104729 + i)[0]
        traj = transitions_to_chain(transitions).text_trajectory
        episodes.append((traj, sum(traj.reward)))
    return episodes


def probe_questions(n: int = 100, seed: int = 123):
    """The oracle-fidelity probe: n (word, 'Is it a(n) <object>?') pairs,
    half naming the word itself, half a random word."""
    from lmrl_gym_torch.envs.twenty_questions.data import get_default_word_list

    words = get_default_word_list()
    rng = random.Random(seed)
    pw, pq = [], []
    for _ in range(n):
        w = rng.choice(words)
        t = (w.words[0] if rng.random() < 0.5 else rng.choice(words).words[0]).lower()
        article = "an" if t[0] in "aeiou" else "a"
        pw.append(w)
        pq.append(f"Is it {article} {t}?")
    return pw, pq


def oracle_fidelity(oracle):
    """(agreement with the scripted oracle, the LM's yes-rate, the scripted
    yes-rate) on `probe_questions`: one batched oracle call."""
    from lmrl_gym_torch.envs.twenty_questions.oracle import ScriptedOracle

    pw, pq = probe_questions()
    lm_ans = oracle.generate_answers(pw, pq)
    sc_ans = ScriptedOracle().generate_answers(pw, pq)
    agree = sum(a == b for a, b in zip(lm_ans, sc_ans)) / len(pw)
    yes = sum(a == "Yes." for a in lm_ans) / len(pw)
    return agree, yes, sum(a == "Yes." for a in sc_ans) / len(pw)


class OracleStage:
    """The LM-oracle stage the dialog gates share: a gate gives
    `oracle_train_config()`, `tokenizer`, `device` and `replay`."""

    @property
    def oracle_config(self):
        """The LM oracle's (or buyer's) TransformerConfig."""
        from lmrl_gym_torch.envs.lm_oracle import _oracle_model_config

        return _oracle_model_config(self.oracle_train_config(), self.tokenizer.vocab_size)

    def train_oracle(self, windows):
        """The decoder oracle (or buyer) BC-trained on `windows` → (core,
        params), from the replayed initial weights when there are some."""
        from lmrl_gym_torch.envs.lm_oracle import train_oracle_lm

        initial = None if self.replay is None else copy.deepcopy(self.replay.oracle)
        core, _, params, _ = train_oracle_lm(windows, self.oracle_train_config(), tokenizer=self.tokenizer,
                                             device=self.device, params=initial)
        return core, params


class Gate(OracleStage):
    """The gate's tokenizer, model, oracle and eval harness, built from its
    flags; one method per stage. `dtype` is the activation dtype (float32:
    the JAX gate's `tiny_test_config`)."""

    def __init__(self, args: argparse.Namespace, dtype: str = "float32", replay: Optional[Replay] = None):
        from lmrl_gym_torch.core.device import resolve_device
        from lmrl_gym_torch.models.config import tiny_test_config
        from lmrl_gym_torch.models.interface import LMCore

        self.args = args
        self.replay = replay
        self.device = resolve_device(args.device)
        self.t_start = time.time()
        if args.tokenizer == "bpe":
            from lmrl_gym_torch.text.bpe import train_bpe_for_task

            self.tokenizer = train_bpe_for_task("twenty_questions", vocab_size=args.bpe_vocab, n_episodes=200,
                                                seed=0)
            self.eos_id = self.tokenizer.newline_token_id
            print(f"BPE tokenizer: vocab {self.tokenizer.vocab_size}", flush=True)
        else:
            from lmrl_gym_torch.text.tokenizer import ByteTokenizer

            self.tokenizer = ByteTokenizer()
            self.eos_id = 10
        self.config = tiny_test_config(
            vocab_size=self.tokenizer.vocab_size, hidden_size=args.hidden, num_layers=args.layers,
            num_heads=args.heads, max_position_embeddings=max(256, args.max_len), dtype=dtype,
        )
        self.core = LMCore(self.config, device=self.device)

    def log(self, msg: str) -> None:
        print(f"{msg} ({time.time() - self.t_start:.0f}s)", flush=True)

    # ---- stage 1: the LM oracle
    def oracle_windows(self):
        """Rollout QA under the asker's questions plus three copies of the
        balanced synthetic QA (rollout-only data collapses the oracle to
        the majority 'No.')."""
        from lmrl_gym_torch.envs.lm_oracle import collect_twenty_questions_qa, collect_twenty_questions_qa_balanced

        qa = collect_twenty_questions_qa(self.args.oracle_episodes, seed=self.args.seed)
        return qa + collect_twenty_questions_qa_balanced(seed=self.args.seed) * 3

    def oracle_train_config(self):
        from lmrl_gym_torch.envs.lm_oracle import OracleTrainConfig

        args = self.args
        return OracleTrainConfig(n_episodes=args.oracle_episodes, epochs=args.oracle_epochs,
                                 hidden_size=args.oracle_hidden, num_layers=args.oracle_layers, seed=args.seed)

    def lm_env(self, oracle_core, oracle_params):
        from lmrl_gym_torch.envs.lm_oracle import build_lm_twenty_questions_env

        return build_lm_twenty_questions_env(oracle_core, self.tokenizer, oracle_params, batched=True)

    # ---- stage 3: BC
    def trainer(self):
        args = self.args
        initial = None if self.replay is None else self.replay.trunk
        return build_policy_trainer(self.core, self.config, self.tokenizer, args.max_len, args.lr, args.bc_epochs,
                                    args.bsize, initial)

    # ---- stage 4: evals
    def eval_policy(self, env, params, name):
        """The policy's greedy decode (48 new tokens) in `env` on the fixed
        eval seeds → the reward / done / length summary."""
        from lmrl_gym_torch.algos.value_policy import GenerationPolicy, LMServer
        from lmrl_gym_torch.envs.base import text_env_eval
        from lmrl_gym_torch.models.generation import SamplingConfig

        args = self.args
        server = LMServer(self.core, self.tokenizer)
        sampling = SamplingConfig(max_new_tokens=48, greedy=True, eos_token_id=self.eos_id,
                                  pad_token_id=self.tokenizer.pad_token_id)

        def generate_batch(prompts, generator):
            return server.generate_from_strs(params, prompts, args.max_len, sampling, generator)

        policy = GenerationPolicy(generate_batch=generate_batch,
                                  generator=torch.Generator(device=self.device).manual_seed(args.seed))
        inter, summary = text_env_eval(env, policy, n_rollouts=args.eval_rollouts,
                                       seed_generator=iter(range(10_000, 10_000 + args.eval_rollouts)),
                                       bsize=args.eval_bsize)
        self.log(f"{name}: reward {summary['reward']['mean']:.2f} done {summary['done']['mean']:.2f} "
                 f"len {summary['length']['mean']:.1f}")
        print(f"--- {name} sample transcript (first rollout) ---")
        for t in inter[0][-1].post_transition_history[:17]:
            print(("A> " if t.is_action else "S> ") + repr(t.text[:90]))
        return summary


def run(g: Gate) -> dict:
    """Every stage in the JAX gate's order; returns its JSON result."""
    args = g.args
    print(f"oracle: {args.oracle_episodes} teacher episodes + balanced QA", flush=True)
    oracle_core, oracle_params = g.train_oracle(g.oracle_windows())
    lm_env = g.lm_env(oracle_core, oracle_params)
    agree, yes_rate, sc_yes = oracle_fidelity(lm_env.oracle)
    print(f"oracle fidelity: {agree:.2f} agreement vs scripted (LM yes-rate {yes_rate:.2f}, scripted "
          f"{sc_yes:.2f})", flush=True)

    episodes = collect_behavior(args.behavior_episodes, args.p_good, args.seed)
    rewards = np.asarray([r for _, r in episodes])
    g.log(f"behavior: {len(episodes)} episodes, reward mean {rewards.mean():.2f} min {rewards.min():.0f} "
          f"max {rewards.max():.0f}")

    train = g.trainer()
    all_trajs = [t for t, _ in episodes]
    cutoff = np.quantile(rewards, 1.0 - args.filter_frac)
    filtered = [t for t, r in episodes if r >= cutoff]
    print(f"filter: top {args.filter_frac:.0%} (reward >= {cutoff:.0f}) keeps {len(filtered)} episodes", flush=True)
    bc_params, bc_loss = train(all_trajs, args.seed)
    # equal gradient-update budget: the filtered set is ~4x smaller
    scale = max(1, round(len(all_trajs) / max(1, len(filtered))))
    fbc_params, fbc_loss = train(filtered, args.seed, epochs_scale=scale)
    g.log(f"BC loss {bc_loss:.3f} | filtered-BC loss {fbc_loss:.3f}")

    bc_summary = g.eval_policy(lm_env, bc_params, "BC(all)")
    fbc_summary = g.eval_policy(lm_env, fbc_params, "filtered-BC")
    return dict(
        behavior_reward_mean=float(rewards.mean()),
        oracle_fidelity=agree,
        oracle_yes_rate=yes_rate,
        bc_reward=bc_summary["reward"]["mean"],
        filtered_bc_reward=fbc_summary["reward"]["mean"],
        bc_summary=bc_summary,
        filtered_bc_summary=fbc_summary,
        model=f"d{args.hidden} L{args.layers} byte-vocab policy + d128 L4 LM oracle (in-repo trained; ref uses "
        f"flan-t5-xl)",
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
