"""Fused Wordle actor: LM decoding and vectorized env stepping on one
device, with no host round-trips inside an episode. The port of
`lmrl_gym_tpu/loops/actor.py` (its `lax.scan`s become Python loops over
the same static schedule).

Under the byte tokenizer the reformatted Wordle protocol is fixed-width:

    "Wordle:\\n"                      8 obs tokens (header)
    per turn t<6:
      "c o p s e\\n"                 10 action tokens (letters at 0,2,4,6,8)
      "b y g b b\\n"                 10 obs tokens (feedback letters)

so a full episode is exactly 128 tokens: one 8-token header prefill, then
per turn ten 1-token decode steps, one env step and one 10-token
observation append. Every trunk therefore runs 7 multi-token cached
forwards (the flash kernel) and 60 single-token steps (the decode kernel)
per episode. `rollout_wordle_scripted` writes the same stream from scripted
guesses, with no model: the behavior data of the Wordle ILQL gate.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lmrl_gym_torch.core.random import categorical
from lmrl_gym_torch.envs.wordle.vector import GREEN, N_CHARS, N_TRIES, YELLOW, WordleVectorEnv, initial_state
from lmrl_gym_torch.models.interface import LMCore
from lmrl_gym_torch.models.transformer import KVCache, mask_pad_logits

# Byte-tokenizer constants (token id == byte value)
_SP, _NL = 32, 10
_A = 97  # ord('a')
HEADER = tuple("Wordle:\n".encode())  # 8 tokens
TURN_LEN = 2 * (2 * N_CHARS)  # action 10 + obs 10
EPISODE_LEN = len(HEADER) + N_TRIES * TURN_LEN  # 128
_FEEDBACK_BYTES = (98, 121, 103)  # GRAY->'b', YELLOW->'y', GREEN->'g'


def episode_is_action_mask() -> np.ndarray:
    """Static [EPISODE_LEN] bool: which slots are action tokens."""
    m = np.zeros(EPISODE_LEN, bool)
    for t in range(N_TRIES):
        off = len(HEADER) + t * TURN_LEN
        m[off: off + 2 * N_CHARS] = True
    return m


def action_end_positions() -> np.ndarray:
    """[N_TRIES] token index of each turn's final action token (the '\\n'),
    where per-turn rewards sit for ILQL/MC data."""
    return np.asarray([len(HEADER) + t * TURN_LEN + 2 * N_CHARS - 1 for t in range(N_TRIES)])


class WordleRollout(NamedTuple):
    tokens: torch.Tensor  # [B, EPISODE_LEN] int64 — full episode token stream
    turn_reward: torch.Tensor  # [B, N_TRIES] float32 (0 for turns after done)
    turn_live: torch.Tensor  # [B, N_TRIES] bool — env was not done going in
    win: torch.Tensor  # [B] bool
    n_turns: torch.Tensor  # [B] int32

    def token_rewards(self) -> torch.Tensor:
        """[B, EPISODE_LEN]: turn rewards scattered onto action-final tokens."""
        out = torch.zeros((self.tokens.shape[0], EPISODE_LEN), dtype=torch.float32, device=self.tokens.device)
        out[:, torch.as_tensor(action_end_positions(), device=out.device)] = self.turn_reward * self.turn_live
        return out

    def token_action_mask(self) -> torch.Tensor:
        """[B, EPISODE_LEN] bool: action tokens of live turns (loss mask)."""
        is_action = torch.as_tensor(episode_is_action_mask(), device=self.tokens.device)
        live_by_slot = torch.zeros((self.turn_live.shape[0], EPISODE_LEN), dtype=torch.bool, device=self.tokens.device)
        for t in range(N_TRIES):
            off = len(HEADER) + t * TURN_LEN
            live_by_slot[:, off: off + TURN_LEN] = self.turn_live[:, t: t + 1]
        return live_by_slot & is_action[None, :]


class ScriptedNoise(NamedTuple):
    """Draws of one scripted rollout, handed in to replay another sampler's,
    per turn in the JAX package's order: `guess` [N_TRIES, B, V_words]
    Gumbel noise of the consistent guess, `rand_idx` [N_TRIES, B] the random
    word's index, `uniform` [N_TRIES, B] the mixture draw, `env`
    [N_TRIES, B, V_words] the feedback target's Gumbel noise."""

    guess: torch.Tensor
    rand_idx: torch.Tensor
    uniform: torch.Tensor
    env: torch.Tensor


class WordleNoise(NamedTuple):
    """Sampling noise for one rollout, handed in to replay another sampler's
    draws: `decode` [N_TRIES, 2*N_CHARS, B, V] Gumbel draws per action slot,
    `env` [N_TRIES, B, V_words] per turn's feedback-target draw."""

    decode: torch.Tensor
    env: torch.Tensor


# step_fn(params, tokens [B,T], carry) -> (logits [B,T,V] f32, carry).
# Positions are implicit (dense layout: cache.index + arange(T)); every
# cache slot is visible (no padding in the actor's stream).
StepFn = Callable[[Any, torch.Tensor, Any], Tuple[torch.Tensor, Any]]


def make_lm_step_fn(core: LMCore, batch: int, total_len: int = EPISODE_LEN) -> Tuple[StepFn, Any]:
    """Plain-LM policy trunk for the actor (BC/filtered-BC checkpoints);
    `params` is the policy's `Transformer`."""
    config = core.config

    def step_fn(params, tokens, cache):
        logits, _, cache = params(tokens, cache=cache)
        return mask_pad_logits(logits.float(), config.vocab_size), cache

    return step_fn, KVCache.init(config, batch, total_len, device=core.device)


def make_value_guided_step_fn(
    core: LMCore,
    batch: int,
    two_trunks: bool,
    twin_q: bool,
    beta: float = 8.0,
    total_len: int = EPISODE_LEN,
) -> Tuple[StepFn, Any]:
    """β-perturbed decoding trunk: logits = π_β + β·min(q1,q2) as an actor
    step_fn.

    `params` at call time is a dict of modules {pi_beta?, base, q1, q2?}
    (trunks and Q heads; the heads carry their own weights, so unlike the
    JAX signature no head definition is passed here). With
    two_trunks=False the value base doubles as π_β (one forward per step)."""
    config = core.config

    def step_fn(params, tokens, carry):
        base_cache, pi_cache = carry
        base_logits, hidden, base_cache = params["base"](tokens, cache=base_cache)
        q = params["q1"](hidden)
        if twin_q:
            q = torch.minimum(q, params["q2"](hidden))
        if two_trunks:
            pi_logits, _, pi_cache = params["pi_beta"](tokens, cache=pi_cache)
        else:
            pi_logits = base_logits
        logits = pi_logits.float() + beta * q.float()
        return mask_pad_logits(logits, config.vocab_size), (base_cache, pi_cache)

    base_cache = KVCache.init(config, batch, total_len, device=core.device)
    pi_cache = KVCache.init(config, batch, total_len, device=core.device) if two_trunks else base_cache
    return step_fn, (base_cache, pi_cache)


def _obs_tokens(feedback: torch.Tensor) -> torch.Tensor:
    """Feedback codes [B,5] → the observation "b y g b b\\n" as 10 tokens
    (the byte map as arithmetic on the device: no host-to-device copy)."""
    gray, yellow, green = _FEEDBACK_BYTES
    fb = torch.where(feedback == GREEN, green, torch.where(feedback == YELLOW, yellow, gray))
    obs = torch.full((feedback.shape[0], 2 * N_CHARS), _SP, dtype=torch.int64, device=feedback.device)
    obs[:, 0: 2 * N_CHARS: 2] = fb
    obs[:, 2 * N_CHARS - 1] = _NL
    return obs


def _episode_tokens(batch: int, device) -> torch.Tensor:
    tokens = torch.zeros((batch, EPISODE_LEN), dtype=torch.int64, device=device)
    tokens[:, : len(HEADER)] = torch.tensor(HEADER, dtype=torch.int64, device=device)
    return tokens


def _write_turn(tokens: torch.Tensor, t: int, act: torch.Tensor, obs: torch.Tensor) -> None:
    off = len(HEADER) + t * TURN_LEN
    tokens[:, off: off + 2 * N_CHARS] = act
    tokens[:, off + 2 * N_CHARS: off + TURN_LEN] = obs


def _rollout_result(tokens, turn_reward, turn_live) -> WordleRollout:
    turn_reward = torch.stack(turn_reward, dim=1)  # [B, N_TRIES]
    turn_live = torch.stack(turn_live, dim=1)
    win = ((turn_reward == 0.0) & turn_live).any(dim=-1)
    return WordleRollout(
        tokens=tokens,
        turn_reward=turn_reward,
        turn_live=turn_live,
        win=win,
        n_turns=turn_live.sum(dim=-1).to(torch.int32),
    )


@torch.inference_mode()
def rollout_wordle(
    env: WordleVectorEnv,
    step_fn: StepFn,
    params: Any,
    init_carry: Any,
    batch: int,
    temperature: float = 1.0,
    greedy: bool = False,
    constrain_vocab: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[WordleNoise] = None,
) -> WordleRollout:
    """6 turns of (10-token decode → env.step → 10-token feedback forward)
    for `batch` games, all on env's device.

    constrain_vocab masks each decode step to the wordle vocab trie:
    separator slots are forced, letter slots restricted to letters that
    extend some vocab word matching the sampled prefix. Sampling uses
    `generator`, or the replayed draws in `noise`."""
    B = batch
    device = env.device
    tokens = _episode_tokens(B, device)

    # prefill the header; last logits condition the first action token
    logits, carry = step_fn(params, tokens[:, : len(HEADER)], init_carry)
    last_logits = logits[:, -1, :]

    state = initial_state(B, device)
    if constrain_vocab:
        # [V,5] letter indices and [5,V,26] per-position one-hots for the
        # alive-word → allowed-letter contraction
        vchars = env.vocab_chars.long()
        vonehot = F.one_hot(vchars.T, 26).float()

    def sample(logits, t, slot):
        if greedy:
            return torch.argmax(logits, dim=-1)
        gumbel = noise.decode[t, slot] if noise is not None else None
        return categorical(logits / max(temperature, 1e-6), generator, gumbel)

    turn_reward, turn_live = [], []
    for t in range(N_TRIES):
        live = ~state.done

        # decode the 10 action tokens
        if constrain_vocab:
            alive = torch.ones((B, vchars.shape[0]), dtype=torch.bool, device=device)
        act = []
        for slot in range(2 * N_CHARS):
            if not constrain_vocab:
                tok = sample(last_logits, t, slot)
            elif slot % 2 == 0:
                j = slot // 2  # letter position
                # allowed letters: some alive vocab word has that letter at j
                allowed = (alive.float() @ vonehot[j]) > 0.0  # [B,26]
                lmask = torch.full_like(last_logits, -1e9)
                lmask[:, _A:_A + 26] = torch.where(allowed, 0.0, -1e9)
                tok = sample(last_logits + lmask, t, slot)
                alive = alive & (vchars[:, j][None, :] == (tok - _A)[:, None])
            else:
                sep = _NL if slot == 2 * N_CHARS - 1 else _SP
                tok = torch.full((B,), sep, dtype=torch.int64, device=device)
            new_logits, carry = step_fn(params, tok[:, None], carry)
            last_logits = new_logits[:, -1, :]
            act.append(tok)
        act = torch.stack(act, dim=1)  # [B,10]

        # parse "c o p s e\n": letters at even slots, separators between
        letters = act[:, 0: 2 * N_CHARS: 2]  # [B,5]
        is_letter = ((letters >= _A) & (letters < _A + 26)).all(dim=-1)
        seps_ok = (act[:, 1: 2 * N_CHARS - 1: 2] == _SP).all(dim=-1) & (act[:, 2 * N_CHARS - 1] == _NL)
        valid = is_letter & seps_ok
        guess = (letters - _A).clamp(0, 25)

        state, feedback = env.step(state, guess, valid, generator, noise.env[t] if noise is not None else None)

        obs = _obs_tokens(feedback)
        _write_turn(tokens, t, act, obs)

        # advance the cache over the observation; its last logits start the
        # next turn's action
        logits, carry = step_fn(params, obs, carry)
        last_logits = logits[:, -1, :]

        turn_reward.append(state.reward * live)
        turn_live.append(live)
    return _rollout_result(tokens, turn_reward, turn_live)


@torch.inference_mode()
def rollout_wordle_scripted(
    env: WordleVectorEnv,
    batch: int,
    p_smart: float = 1.0,
    p_repeat: float = 0.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[ScriptedNoise] = None,
) -> WordleRollout:
    """Device-side behavior generator, no model: each turn's guess is the
    env's random-CONSISTENT guess w.p. p_smart, a REPEAT of the previous
    valid guess w.p. p_repeat (else a random word when there is none yet),
    else a uniform random vocab word (valid but feedback-blind). A per-TURN
    quality mixture, so identical contexts carry both good and bad actions.
    The token stream is byte-identical to `rollout_wordle`'s, so the
    rollouts feed BC/ILQL training directly. Draws come from `generator`,
    or are replayed from `noise`."""
    if p_smart + p_repeat > 1.0:
        raise ValueError(f"p_smart + p_repeat must be at most 1, got {p_smart} + {p_repeat}")
    B, device = batch, env.device
    rows = torch.arange(B, device=device)
    vchars = env.vocab_chars.long()
    V = vchars.shape[0]
    tokens = _episode_tokens(B, device)
    state = initial_state(B, device)
    turn_reward, turn_live = [], []
    for t in range(N_TRIES):
        live = ~state.done
        g_smart = env.random_consistent_guess(state, generator, None if noise is None else noise.guess[t])
        idx = torch.randint(0, V, (B,), generator=generator, device=device) if noise is None else noise.rand_idx[t]
        g_rand = vchars[idx.long()]
        # previous valid guess (guess_hist holds -1 for none or invalid)
        last_slot = (state.n_guesses - 1).clamp(0, N_TRIES - 1).long()
        g_last = state.guess_hist[rows, last_slot].long()
        g_repeat = torch.where((g_last[:, 0] >= 0)[:, None], g_last, g_rand)
        u = torch.rand((B,), generator=generator, device=device) if noise is None else noise.uniform[t]
        smart = u < p_smart
        repeat = ~smart & (u < p_smart + p_repeat)
        guess = torch.where(smart[:, None], g_smart.long(), torch.where(repeat[:, None], g_repeat, g_rand))

        state, feedback = env.step(
            state, guess, torch.ones((B,), dtype=torch.bool, device=device), generator,
            None if noise is None else noise.env[t],
        )
        act = torch.full((B, 2 * N_CHARS), _SP, dtype=torch.int64, device=device)
        act[:, 0: 2 * N_CHARS: 2] = _A + guess
        act[:, 2 * N_CHARS - 1] = _NL
        _write_turn(tokens, t, act, _obs_tokens(feedback))
        turn_reward.append(state.reward * live)
        turn_live.append(live)
    return _rollout_result(tokens, turn_reward, turn_live)
