"""Autoregressive decoding over an explicit KV-cache carry: the port of
`lmrl_gym_tpu/models/generation.py` (`lax.scan` becomes a Python loop).

The loop is generic over a `logits_fn`, so the same loop serves plain LM
sampling and value-guided decoding (π_β + β·min(q1,q2)). Prompts are
LEFT-padded, so every row's last prompt token sits at slot T_prompt−1;
the cache is written at physical slots and pad slots stay masked out.

`generate_constrained` masks each step to a per-row legal proposal set (a
trie walk over the proposals' tokens).

Sampling draws `argmax(logits + g)` with Gumbel noise g, which is what
`jax.random.categorical` computes. The noise comes from an explicit
`torch.Generator`, or is handed in (`gumbel=`), so a test can give both
packages the same draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from lmrl_gym_torch.core.random import categorical


@dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    greedy: bool = False
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0


def sample_token(
    logits: torch.Tensor,  # [B, V] float32
    config: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,  # [B, V] noise; drawn from generator if None
) -> torch.Tensor:
    """[B] next tokens under greedy / temperature / top-k / top-p."""
    if config.greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(config.temperature, 1e-6)
    if config.top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -config.top_k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if config.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep smallest set with cumulative prob >= top_p (always keep top-1)
        cutoff_idx = (cum < config.top_p).sum(dim=-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return categorical(logits, generator, gumbel)


# logits_fn(tokens [B,T], attention_mask [B,T_kv], carry) -> (logits [B,T,V], carry)
LogitsFn = Callable[[torch.Tensor, torch.Tensor, Any], Tuple[torch.Tensor, Any]]


class _LegalSet:
    """The per-row legal proposal sets of `generate_constrained`: a trie
    walk over the proposals' tokens. `mask` gives step t's logits with the
    tokens no live proposal emits at -inf (rows whose set has emptied keep
    theirs); `advance` keeps the proposals that emitted the sampled token."""

    def __init__(self, candidates: torch.Tensor, candidate_mask: torch.Tensor, config: SamplingConfig):
        self.candidates = candidates.long()  # [B, P, L]
        self.L = candidates.shape[2]
        self.lens = (self.candidates != config.pad_token_id).sum(dim=2).clamp(max=min(config.max_new_tokens, self.L))
        self.alive = candidate_mask.bool()  # [B, P]

    def _step(self, t: int):
        return t < self.lens, self.candidates[:, :, min(t, self.L - 1)]  # in range, candidate tokens [B, P]

    def mask(self, t: int, logits: torch.Tensor) -> torch.Tensor:
        in_range, cand_t = self._step(t)
        can_emit = self.alive & in_range
        # allowed[b, v]: some live proposal emits v now; ids outside [0, V)
        # land in a spare column V that is dropped
        B, V = logits.shape
        col = torch.where((cand_t >= 0) & (cand_t < V), cand_t, V)
        allowed = torch.zeros((B, V + 1), dtype=torch.int32, device=logits.device)
        allowed = allowed.scatter_reduce(1, col, can_emit.to(torch.int32), reduce="amax")[:, :V] > 0
        has_constraint = can_emit.any(dim=1, keepdim=True)
        return torch.where(has_constraint & ~allowed, -torch.inf, logits)

    def advance(self, t: int, token: torch.Tensor) -> None:
        in_range, cand_t = self._step(t)
        self.alive = self.alive & in_range & (cand_t == token[:, None])


def _decode(
    logits_fn: LogitsFn,
    init_carry: Any,
    prompt_ids: torch.Tensor,
    prompt_mask: torch.Tensor,
    config: SamplingConfig,
    generator: Optional[torch.Generator],
    gumbel: Optional[torch.Tensor],
    legal: Optional[_LegalSet] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode loop of `generate` and `generate_constrained`."""
    B, T_prompt = prompt_ids.shape
    T_total = T_prompt + config.max_new_tokens
    device = prompt_ids.device

    # [B, T_total] attention mask, prompt part at the left
    mask = torch.zeros((B, T_total), dtype=torch.int32, device=device)
    mask[:, :T_prompt] = prompt_mask

    logits, carry = logits_fn(prompt_ids, mask, init_carry)
    logits = logits[:, -1, :].float()
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    tokens, token_mask = [], []
    for t in range(config.max_new_tokens):
        if legal is not None:
            logits = legal.mask(t, logits)
        token = sample_token(logits, config, generator, None if gumbel is None else gumbel[t])
        if legal is not None:
            legal.advance(t, token)
        if config.eos_token_id is not None:
            token = torch.where(done, config.pad_token_id, token)
            done = done | (token == config.eos_token_id)
        emit_mask = torch.where(done & (token == config.pad_token_id), 0, 1).to(torch.int32)
        # post-eos pads enter the cache but stay masked out of attention
        mask[:, T_prompt + t] = emit_mask
        new_logits, carry = logits_fn(token[:, None], mask, carry)
        logits = new_logits[:, -1, :].float()
        tokens.append(token)
        token_mask.append(emit_mask)
    return torch.stack(tokens, dim=1), torch.stack(token_mask, dim=1)


@torch.inference_mode()
def generate(
    logits_fn: LogitsFn,
    init_carry: Any,
    prompt_ids: torch.Tensor,  # [B, T_prompt] LEFT-padded
    prompt_mask: torch.Tensor,  # [B, T_prompt] 1 = real
    config: SamplingConfig,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,  # [max_new_tokens, B, V] replayed noise
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_new_tokens], token_mask [B, max_new_tokens]).

    After eos, rows emit pad_token_id and token_mask turns 0. `init_carry`
    must hold KV cache(s) sized ≥ T_prompt + max_new_tokens; logits_fn is
    called once for prefill ([B,T_prompt]) then per step ([B,1])."""
    return _decode(logits_fn, init_carry, prompt_ids, prompt_mask, config, generator, gumbel)


@torch.inference_mode()
def generate_constrained(
    logits_fn: LogitsFn,
    init_carry: Any,
    prompt_ids: torch.Tensor,  # [B, T_prompt] LEFT-padded
    prompt_mask: torch.Tensor,
    config: SamplingConfig,
    candidates: torch.Tensor,  # [B, P, L] proposal token sequences, pad-padded
    candidate_mask: torch.Tensor,  # [B, P] bool — valid proposals per row
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,  # [max_new_tokens, B, V] replayed noise
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`generate`, with decoding masked to a per-row legal proposal set.

    At step t a row may only emit tokens that continue one of its still-
    matching proposals: the policy keeps choosing, but only among legal
    continuations. Proposals should end with the protocol terminator (e.g.
    '\\n' == eos_token_id) so a completed proposal ends the row; pad slots
    in `candidates` never match (pad_token_id is not a protocol token), and
    ids outside [0, V) are dropped. Rows whose proposal set empties fall
    back to the unmasked logits."""
    legal = _LegalSet(candidates, candidate_mask, config)
    return _decode(logits_fn, init_carry, prompt_ids, prompt_mask, config, generator, gumbel, legal)
