"""Traffic kind `guided_rollout`: back-to-back value-guided Wordle rollouts,
`batch` games each, through the port's `rollout_wordle` with
`make_value_guided_step_fn` (policy and value trunks, twin Q heads, logits
π_β + β·min(Q1, Q2)).

Every `greedy_every`-th rollout decodes greedily on the game's draws that
the benchmark makes from the seed (handed in as the rollout's noise); the
others sample at `temperature` from a generator seeded from the seed. The
greedy ones are the served answers that are checked: after the window,
`check_games` games drawn from the seed among them are replayed by the
plain reference (its guided logits at every chosen letter, and the game's
answers from the same draws).

Traffic parameters: `batch`, `beta`, `two_trunks`, `twin_q`,
`constrain_vocab`, `temperature`, `greedy_every`, `check_games`,
`trace_units`, and `qkv_std`, the spread of the trunks' q/k/v weights
(`weights.trunk_spec`). At init the attention logits spread by about
n_embd·qkv_std²; where that is far under 1 (GPT-2-small at 0.02: 0.3) a
greedy decision hardly depends on the game and a rollout's guesses
collapse onto a few words, and where it is far over (GPT-J-6B at 0.06:
15) the softmax turns on rounding. The cell draws it to ~2.8.
"""
from __future__ import annotations

import gc
import random

import torch

from benchmark import flops
from benchmark.harness import timed_loop
from benchmark.program import WORDS_FILE, build_modules, transformer_config
from benchmark.reference.gpt import fp8_quant
from benchmark.reference.wordle import (
    HEADER, N_CHARS, N_TRIES, TURN, guided_logits, letter_positions, read_words, replay_answers, served_gaps)
from benchmark.weights import derived_seed, draw, group_seed, model_spec

GROUPS = ("base", "pi_beta", "q1", "q2")
EPISODE = HEADER + N_TRIES * TURN


def decode_cache_lens():
    """Keys each single-token step reads: ten steps a turn, the k-th of
    turn t writing slot HEADER + TURN·t + k and reading it and all before."""
    return [HEADER + TURN * t + k + 1 for t in range(N_TRIES) for k in range(2 * N_CHARS)]


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, as the game's target draw takes it."""
    u = torch.rand(shape, generator=gen, device=device).clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class Session:
    def __init__(self, run):
        from lmrl_gym_torch.envs.wordle.vector import WordleVectorEnv, WordleVocab
        from lmrl_gym_torch.loops import actor
        from lmrl_gym_torch.models.interface import LMCore

        self.run, cfg, tr, dev = run, run.cfg, run.traffic, run.device
        self.actor = actor
        self.words = read_words(WORDS_FILE)
        self.env = WordleVectorEnv(WordleVocab.from_words(self.words), device=dev)
        self.params = build_modules(cfg, GROUPS, run.seed, dev, torch.bfloat16, tr["qkv_std"])
        self.step_fn, self.carry0 = actor.make_value_guided_step_fn(
            LMCore(transformer_config(cfg), dev), tr["batch"], two_trunks=tr["two_trunks"], twin_q=tr["twin_q"],
            beta=float(tr["beta"]))
        self.sample_gen = torch.Generator(device=dev).manual_seed(derived_seed(run.seed, 21))
        self.env_gen = torch.Generator(device=dev).manual_seed(derived_seed(run.seed, 22))
        self.served = []  # (tokens [B, T] on the host, env noise [N_TRIES, B, n_words])
        # warm-up: one sampled and one greedy rollout, the window's shapes
        self._rollout(greedy=False)
        self._rollout(greedy=True, keep=False)
        self._sync()

    def _sync(self):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def _rollout(self, greedy: bool, keep: bool = True):
        tr, B = self.run.traffic, self.run.traffic["batch"]
        noise = None
        if greedy:
            env = gumbel((N_TRIES, B, len(self.words)), self.env_gen, self.run.device)
            # greedy decoding reads no decode noise: a placeholder per slot
            noise = self.actor.WordleNoise(decode=torch.zeros((N_TRIES, 2 * N_CHARS)), env=env)
        out = self.actor.rollout_wordle(
            self.env, self.step_fn, self.params, self.carry0, B, temperature=tr["temperature"], greedy=greedy,
            constrain_vocab=tr["constrain_vocab"], generator=None if greedy else self.sample_gen, noise=noise)
        if greedy and keep:
            self.served.append((out.tokens, noise.env))
        return out

    def window(self, seconds: float, tracer=None) -> dict:
        tr, cfg, B = self.run.traffic, self.run.cfg, self.run.traffic["batch"]
        every = tr["greedy_every"]
        rewards, window_s, unit_s = timed_loop(
            self.run, seconds, tracer, lambda n: self._rollout(greedy=n % every == every - 1).turn_reward.sum(),
            min_units=every)
        n = len(rewards)
        finite = torch.isfinite(torch.stack(rewards)).sum().item()
        return {
            "units": n, "window_s": window_s, "unit_s": unit_s, "failed": (n - int(finite)) * B,
            "attempted": n * B, "env_steps_per_unit": B * N_TRIES,
            "flops_per_unit": flops.rollout_flops(cfg, B, EPISODE, N_TRIES * N_CHARS),
            "decode_least_s_per_unit": flops.rollout_decode_least_seconds(cfg, B, decode_cache_lens()),
        }

    def release(self) -> None:
        """Frees the program; keeps the checked games' streams and draws."""
        rng = random.Random(derived_seed(self.run.seed, 23))
        B = self.run.traffic["batch"]
        picks = sorted(rng.sample(range(len(self.served) * B), self.run.traffic["check_games"]))
        self.checked = [(self.served[i // B][0][i % B].tolist(), self.served[i // B][1][:, i % B].float().cpu())
                        for i in picks]
        self.served = self.params = self.step_fn = self.carry0 = self.env = None
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference_params(self):
        cfg, seed, dev = self.run.cfg, self.run.seed, self.run.device
        spec = model_spec(cfg, GROUPS, self.run.traffic["qkv_std"])
        return {g: dict(draw(spec[g], group_seed(seed, g), dev, torch.bfloat16 if g in ("base", "pi_beta")
                             else torch.float32)) for g in GROUPS}

    def compare(self, control: bool = False) -> dict:
        """`logit_gap`: the widest gap by which a served letter's guided
        logit lies below the reference's best allowed one (with `control`:
        the letter a float8 trunk puts first instead); `mean_logit_gap`:
        the mean of those gaps over every checked letter; `env_mismatches`:
        feedback tokens that differ from the game replayed on its draws."""
        tr, cfg, dev = self.run.traffic, self.run.cfg, self.run.device
        params = self._reference_params()
        tokens = torch.tensor([t for t, _ in self.checked], device=dev)
        gaps, wrong = [], 0
        with torch.no_grad():
            ref = guided_logits(params, cfg, tokens[:, :-1], float(tr["beta"]))
            low = guided_logits(params, cfg, tokens[:, :-1], float(tr["beta"]), fp8_quant) if control else None
            for i, (toks, env_noise) in enumerate(self.checked):
                gaps += served_gaps(ref[i], toks, self.words, tr["constrain_vocab"],
                                    None if low is None else low[i])
                wrong += replay_answers(toks, env_noise, self.words)
        self.gaps = gaps
        return {"logit_gap": max(gaps), "mean_logit_gap": sum(gaps) / len(gaps), "env_mismatches": float(wrong)}
