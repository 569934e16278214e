"""Text-Nav PPO learning gate on the port: the port of
`scripts/text_nav_ppo_gate.py` (the partially observed 8-room house, PPO
with GAE on history-conditioned windows), with the same flags, defaults,
stages and JSON keys, plus `--device`.

    python -m lmrl_gym_torch.scripts.text_nav_ppo_gate               # on the card
    python -m lmrl_gym_torch.scripts.text_nav_ppo_gate --device cpu  # plain path

  1. BC on `PartialWalkthroughAgent` episodes (optimal inside the first
     --known-rooms rooms, random elsewhere), cut into history windows;
  2. the frozen BC policy's mean return (= win rate) over fixed seeds;
  3. PPO rounds as the maze gate's (`maze_ppo_gate.py`), on windows of
     [the last H turns as context, the observation, the action];
  4. the return again on the same seeds; PPO must beat frozen BC.

The serving prompt is byte for byte the training window's layout: the
last H (observation, action) turns and the current observation
(`Gate.prompt`); the windows (`Gate.transitions_to_markov_chain`) carry
the past turns as context only (is_action=False), so each action is
credited once, in its own window. MAX_LEN = 384 + 128·H tokens.
"""
from __future__ import annotations

import argparse
import random

from lmrl_gym_torch.scripts import maze_ppo_gate
from lmrl_gym_torch.scripts.maze_ppo_gate import Replay, run  # noqa: F401  (this gate's Replay and run)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--n-episodes", type=int, default=300)
    p.add_argument("--known-rooms", type=int, default=5)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--bc-epochs", type=int, default=4)
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--epochs-per-round", type=int, default=2)
    p.add_argument("--rollouts-per-round", type=int, default=48)
    p.add_argument("--eval-rollouts", type=int, default=64)
    p.add_argument("--bsize", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ppo-lr", type=float, default=3e-4)
    p.add_argument("--kl-weight", type=float, default=0.01)
    p.add_argument("--value-warmup-rounds", type=int, default=2)
    p.add_argument("--max-steps", type=int, default=30)
    p.add_argument("--history-turns", type=int, default=2,
                   help="each training window and serving prompt carries the previous H (obs, action) turns as "
                   "context ahead of the current obs; 0 = Markov")
    p.add_argument("--tokenizer", choices=["byte", "bpe"], default="bpe",
                   help="bpe (default): the task BPE, so multi-word commands are a few tokens")
    p.add_argument("--bpe-vocab", type=int, default=1536)
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card) or cpu (the plain path)")
    return p.parse_args(argv)


class Gate(maze_ppo_gate.Gate):
    """The maze gate's harness with the Text-Nav data, windows and prompt."""

    MAX_NEW = 36

    def __init__(self, args: argparse.Namespace, dtype: str = "bfloat16", replay=None):
        self.H = args.history_turns
        # the first window is the objective and the room, <= 330 bytes; H
        # extra (obs, act) turns of context
        self.MAX_LEN = 384 if self.H == 0 else 384 + 128 * self.H
        super().__init__(args, dtype, replay)

    def make_tokenizer(self):
        if self.args.tokenizer == "bpe":
            from lmrl_gym_torch.text.bpe import train_bpe_for_task

            tokenizer = train_bpe_for_task("text_nav", vocab_size=self.args.bpe_vocab, n_episodes=150, seed=0)
            print(f"BPE tokenizer: vocab {tokenizer.vocab_size}", flush=True)
            return tokenizer, tokenizer.newline_token_id
        from lmrl_gym_torch.text.tokenizer import ByteTokenizer

        return ByteTokenizer(), 10

    def max_positions(self) -> int:
        return self.MAX_LEN

    def eval_env(self):
        from lmrl_gym_torch.envs.text_nav.env import TextNavEnv

        return TextNavEnv(display_location=False, max_steps=self.args.max_steps)

    def prompt(self, history) -> str:
        """The last H (obs, action) turns and the current observation."""
        return "".join(t.text for t in history[-(2 * self.H + 1):])

    def transitions_to_markov_chain(self, rollout):
        """Per-step windows [history context (is_action=False), obs, act]."""
        from lmrl_gym_torch.text.frames import Text, TextTrajectory, TextTrajectoryChain, TokenTrajectoryChain

        chain = None
        for tr in reversed(rollout):
            obs, act = tr.pre_action_history[-1], tr.post_action_history[-1]
            if self.H > 0 and len(tr.pre_action_history) > 1:
                ctx = "".join(t.text for t in tr.pre_action_history[:-1][-2 * self.H:])
                texts, rewards = (Text(ctx, False), obs, act), (0.0, 0.0, tr.reward)
            else:
                texts, rewards = (obs, act), (0.0, tr.reward)
            chain = TextTrajectoryChain(TextTrajectory(texts, rewards, tr.done), chain)
        return TokenTrajectoryChain.from_text_trajectory_chain(chain, self.tokenizer)

    round_chain = transitions_to_markov_chain

    def bc_token_chains(self):
        """--n-episodes of `PartialWalkthroughAgent` in the partial env."""
        from lmrl_gym_torch.envs.base import InteractionTransition
        from lmrl_gym_torch.envs.text_nav.env import ROOMS, PartialWalkthroughAgent

        args = self.args
        self.log(f"data: {args.n_episodes} episodes, known_rooms={args.known_rooms}")
        rng_py = random.Random(args.seed)
        episodes, wins = [], 0
        for i in range(args.n_episodes):
            env = self.eval_env()
            agent = PartialWalkthroughAgent(env, known_rooms=ROOMS[: args.known_rooms], rng=rng_py)
            history = env.reset(seed=args.seed * 7919 + i)
            done, steps, total = False, [], 0.0
            while not done:
                acted = agent.act(history)
                pre = history
                history, reward, done = env.step(acted)
                total += reward
                steps.append(InteractionTransition(pre, acted, history, reward, done))
            wins += total > 0
            episodes.append(steps)
        self.log(f"behavior win rate: {wins / args.n_episodes:.3f}")
        return [self.transitions_to_markov_chain(r) for r in episodes]

    def trace_entry(self, rnd, mean_kl, kl_coef, reward) -> dict:
        return dict(round=rnd, mean_kl=mean_kl, rollout_reward=reward)

    def result_extra(self) -> dict:
        args = self.args
        return dict(model=f"d{args.hidden} L{args.layers} {args.tokenizer} vocab {self.tokenizer.vocab_size} "
                          f"(the reference names GPT-2-medium for this config)")


def main(argv=None):
    return maze_ppo_gate.main(argv, gate_class=Gate, parse=parse_args)


if __name__ == "__main__":
    main()
