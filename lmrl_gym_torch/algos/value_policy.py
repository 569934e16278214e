"""Serving path: value-guided, plain-LM and encoder-decoder decoding, the
text policy over them, and word-level reranking. The port of
`lmrl_gym_tpu/algos/value_policy.py` (`ValueGuidedServer`, `LMServer`,
`Seq2SeqServer`, `GenerationPolicy`, the score functions,
`ReRankerPolicy` and `tokenize_histories_for_scoring`).

`ValueGuidedServer.generate` decodes with logits = π_β + β·min(q1,q2)
(the reference's value_rl_base/gpt2/generation.py:36-121): both trunks run
inside one decode loop (models/generation.py) with a (π_β cache, value
cache) carry. `share_trunk=True` runs ONE trunk and applies the Q heads to
its hidden states. `generate_legal` masks the same decode to a per-row
legal proposal set (`models/generation.py::generate_constrained`).
`GenerationPolicy` turns any `generate_batch(prompts, generator)` into a
`BatchedTextPolicy` for the host text envs (`envs/base.py`).

In the port, parameters live in modules: `ValueRLParams` carries the trunk
`Transformer`s and the head modules themselves, so the server needs no
separate head definitions. The JAX package's batch bucketing
(`_bucket_batch`) and score-program memo (`_memoized_score_jit`) only
bounded jit recompiles and have no counterpart in eager PyTorch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from lmrl_gym_torch.core.blocking import (
    BlockingStrategy,
    Padding,
    Truncation,
    block_sequences,
    strip_prompt_from_completion,
)
from lmrl_gym_torch.core.device import DeviceLike, resolve_device
from lmrl_gym_torch.envs.base import BatchedTextPolicy
from lmrl_gym_torch.models.generation import SamplingConfig, generate, generate_constrained
from lmrl_gym_torch.models.interface import LMCore, cached_positions, initialize_attn_mask_pos_ids, pad_mask_to
from lmrl_gym_torch.models.transformer import KVCache, mask_pad_logits
from lmrl_gym_torch.text.frames import Text, TextHistory, TokenHistory, text_history_to_str


def _encode_prompts(
    tok, prompts: Sequence[str], max_input_length: int, device, padding: Padding = Padding.LEFT
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompts → padded ids (truncated from the left) and their mask:
    LEFT-padded for the decoder-only servers, RIGHT-padded for an encoder's
    input (`Seq2SeqServer`), where real tokens must start at position 0."""
    ids = block_sequences(
        [tok.encode(p) for p in prompts],
        tok.pad_token_id,
        np.int64,
        BlockingStrategy(padding, Truncation.LEFT, max_input_length),
    )
    ids = torch.from_numpy(ids).to(device)
    return ids, (ids != tok.pad_token_id).to(torch.int32)


def _decode(tok, tokens: torch.Tensor, token_mask: torch.Tensor) -> List[str]:
    return [
        tok.decode([int(t) for t, m in zip(row, mrow) if m])
        for row, mrow in zip(tokens.tolist(), token_mask.tolist())
    ]


class ValueRLParams(NamedTuple):
    """Parameter bundle: trunks are `Transformer`s, heads are head modules."""

    pi_beta: Optional[Any]  # frozen BC prior (None → pure β·Q decoding)
    base: Any  # value trunk
    q1_head: Any
    q2_head: Optional[Any]
    v_head: Optional[Any]


class ValueGuidedServer:
    """Decode-time policy for ILQL/CQL/MC-class checkpoints."""

    def __init__(self, core: LMCore, tokenizer, beta: float = 8.0, share_trunk: bool = False):
        self.core = core
        self.tokenizer = tokenizer
        self.beta = beta
        self.share_trunk = share_trunk

    def _make_guided_logits_fn(self, params: ValueRLParams, total_len: int, batch: int):
        config = self.core.config
        device = self.core.device
        run_pi_beta = params.pi_beta is not None and not self.share_trunk

        def logits_fn(tokens, attn_mask, carry):
            pi_cache, base_cache, next_pos = carry
            attn_mask = pad_mask_to(attn_mask, base_cache.max_len)
            position_ids, next_pos = cached_positions(attn_mask, tokens.shape[1], next_pos)

            base_logits, hidden, base_cache = params.base(
                tokens, attention_mask=attn_mask, position_ids=position_ids, cache=base_cache
            )
            q = params.q1_head(hidden)
            if params.q2_head is not None:
                q = torch.minimum(q, params.q2_head(hidden))

            if run_pi_beta:
                pi_logits, _, pi_cache = params.pi_beta(
                    tokens, attention_mask=attn_mask, position_ids=position_ids, cache=pi_cache
                )
                logits = pi_logits.float() + self.beta * q.float()
            elif self.share_trunk:
                # shared trunk: base logits ARE π_β's (same params)
                logits = base_logits.float() + self.beta * q.float()
            else:
                logits = self.beta * q.float()

            logits = mask_pad_logits(logits, config.vocab_size)
            return logits, (pi_cache, base_cache, next_pos)

        base_cache = KVCache.init(config, batch, total_len, device=device)
        pi_cache = KVCache.init(config, batch, total_len, device=device) if run_pi_beta else base_cache
        return logits_fn, (pi_cache, base_cache, torch.zeros((batch,), dtype=torch.int64, device=device))

    def generate(
        self,
        params: ValueRLParams,
        prompt_ids: torch.Tensor,  # [B, T] LEFT-padded
        prompt_mask: torch.Tensor,
        sampling: SamplingConfig,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,  # [max_new_tokens, B, V] replayed noise
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T = prompt_ids.shape
        logits_fn, carry = self._make_guided_logits_fn(params, T + sampling.max_new_tokens, B)
        return generate(logits_fn, carry, prompt_ids, prompt_mask, sampling, generator, gumbel)

    def generate_from_strs(
        self,
        params: ValueRLParams,
        prompts: Sequence[str],
        max_input_length: int,
        sampling: SamplingConfig,
        generator: Optional[torch.Generator] = None,
    ) -> List[str]:
        ids, mask = _encode_prompts(self.tokenizer, prompts, max_input_length, self.core.device)
        tokens, token_mask = self.generate(params, ids, mask, sampling, generator)
        return _decode(self.tokenizer, tokens, token_mask)

    def generate_legal(
        self,
        params: ValueRLParams,
        prompt_ids: torch.Tensor,
        prompt_mask: torch.Tensor,
        sampling: SamplingConfig,
        candidates: torch.Tensor,  # [B, P, L]
        candidate_mask: torch.Tensor,  # [B, P]
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,  # [max_new_tokens, B, V] replayed noise
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Guided decode constrained to a per-row legal proposal set."""
        B, T = prompt_ids.shape
        logits_fn, carry = self._make_guided_logits_fn(params, T + sampling.max_new_tokens, B)
        return generate_constrained(
            logits_fn, carry, prompt_ids, prompt_mask, sampling, candidates, candidate_mask, generator, gumbel
        )

    def generate_from_strs_legal(
        self,
        params: ValueRLParams,
        prompts: Sequence[str],
        proposals: Sequence[Sequence[str]],  # legal action strings per prompt
        max_input_length: int,
        sampling: SamplingConfig,
        generator: Optional[torch.Generator] = None,
        max_proposals: Optional[int] = None,
        max_proposal_len: Optional[int] = None,
    ) -> List[str]:
        """generate_from_strs with decoding masked to each prompt's legal
        action set. Proposal strings should end with the protocol
        terminator (e.g. '\\n') so a completed action emits eos;
        max_proposals / max_proposal_len cap the padded (P, L) shape."""
        tok = self.tokenizer
        ids, mask = _encode_prompts(tok, prompts, max_input_length, self.core.device)
        tokenized = [[tok.encode(a) for a in props] for props in proposals]
        P = max_proposals or max(1, max(len(p) for p in tokenized))
        L = max_proposal_len or max(1, max((len(a) for p in tokenized for a in p), default=1))
        cands = np.full((len(prompts), P, L), tok.pad_token_id, np.int64)
        cmask = np.zeros((len(prompts), P), bool)
        for i, props in enumerate(tokenized):
            for j, a in enumerate(props[:P]):
                a = a[:L]
                cands[i, j, : len(a)] = a
                cmask[i, j] = True
        device = self.core.device
        tokens, token_mask = self.generate_legal(
            params, ids, mask, sampling, torch.from_numpy(cands).to(device), torch.from_numpy(cmask).to(device),
            generator,
        )
        return _decode(tok, tokens, token_mask)


class LMServer:
    """Plain-LM serving (BC policies, oracle LMs); `params` is the policy's
    `Transformer`."""

    def __init__(self, core: LMCore, tokenizer):
        self.core = core
        self.tokenizer = tokenizer

    def generate(
        self,
        params,
        prompt_ids: torch.Tensor,
        prompt_mask: torch.Tensor,
        sampling: SamplingConfig,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        B, T = prompt_ids.shape
        logits_fn, carry = self.core.make_lm_logits_fn(params, T + sampling.max_new_tokens, B)
        return generate(logits_fn, carry, prompt_ids, prompt_mask, sampling, generator, gumbel)

    def generate_from_strs(
        self,
        params,
        prompts: Sequence[str],
        max_input_length: int,
        sampling: SamplingConfig,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,  # [max_new_tokens, B, V] replayed noise
    ) -> List[str]:
        ids, mask = _encode_prompts(self.tokenizer, prompts, max_input_length, self.core.device)
        tokens, token_mask = self.generate(params, ids, mask, sampling, generator, gumbel)
        return _decode(self.tokenizer, tokens, token_mask)


class Seq2SeqServer:
    """Encoder-decoder (T5) serving — the reference's T5Inference oracle
    role (twenty_questions/env/oracle.py:8-9). The same generate_from_strs
    surface as LMServer, so LMOracle / LMGuessCityOracle take either; the
    prompt goes to the encoder (right-padded, so the relative-position
    buckets ignore pad slots) and decoding starts from
    decoder_start_token_id. `params` is the `EncoderDecoder`."""

    def __init__(self, core, tokenizer):
        self.core = core  # models.encdec.EncDecCore
        self.tokenizer = tokenizer

    def generate(
        self,
        params,
        enc_ids: torch.Tensor,  # [B, T_enc] RIGHT-padded
        enc_mask: torch.Tensor,
        sampling: SamplingConfig,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        B = enc_ids.shape[0]
        logits_fn, carry = self.core.make_seq2seq_logits_fn(params, enc_ids, enc_mask, 1 + sampling.max_new_tokens)
        start = torch.full((B, 1), self.core.config.decoder_start_token_id, dtype=torch.int64, device=enc_ids.device)
        return generate(logits_fn, carry, start, torch.ones_like(start, dtype=torch.int32), sampling, generator, gumbel)

    def generate_from_strs(
        self,
        params,
        prompts: Sequence[str],
        max_input_length: int,
        sampling: SamplingConfig,
        generator: Optional[torch.Generator] = None,
        gumbel: Optional[torch.Tensor] = None,  # [max_new_tokens, B, V] replayed noise
    ) -> List[str]:
        ids, mask = _encode_prompts(self.tokenizer, prompts, max_input_length, self.core.device, Padding.RIGHT)
        tokens, token_mask = self.generate(params, ids, mask, sampling, generator, gumbel)
        return _decode(self.tokenizer, tokens, token_mask)


@dataclass
class GenerationPolicy(BatchedTextPolicy):
    """histories → generate → append Text(output, True). `generate_batch(
    prompts, generator) -> outputs` abstracts over LM, value-guided and
    legal-set serving; done slots return None."""

    generate_batch: Callable[[List[str], Optional[torch.Generator]], List[str]]
    generator: Optional[torch.Generator] = None
    in_str_process: Optional[Callable[[str], str]] = None
    out_str_process: Optional[Callable[[str], str]] = None

    def act(
        self,
        text_history: List[Optional[TextHistory]],
        done: Optional[List[bool]] = None,
    ) -> List[Optional[TextHistory]]:
        if done is None:
            done = [False] * len(text_history)
        live_idx = [i for i, d in enumerate(done) if not d]
        if not live_idx:
            return [None] * len(text_history)
        proc_in = self.in_str_process or (lambda s: s)
        proc_out = self.out_str_process or (lambda s: s)
        prompts = [proc_in(text_history_to_str(text_history[i])) for i in live_idx]
        outputs = self.generate_batch(prompts, self.generator)
        results: List[Optional[TextHistory]] = [None] * len(text_history)
        for i, raw_out, prompt in zip(live_idx, outputs, prompts):
            out = proc_out(strip_prompt_from_completion(prompt, raw_out))
            results[i] = text_history[i] + (Text(out, True),)
        return results


# ---------------- rerankers ----------------


def score_action_tokens(
    values: torch.Tensor,  # [b, t-1] per-token scores at positions x[:-1]
    should_take_action: torch.Tensor,  # [b, t-1]
    attention_mask: torch.Tensor,  # [b, t-1]
) -> torch.Tensor:
    """Σ over action tokens → [b]."""
    mask = should_take_action.float() * attention_mask
    return (values * mask).sum(dim=1)


def _gather_next(out: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    return torch.gather(out[:, :-1], 2, nxt).squeeze(2)


def _action_count(action_mask: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    return torch.clamp((action_mask[:, 1:].float() * attention_mask[:, 1:].float()).sum(dim=1), min=1.0)


def make_ilql_score_fn(
    core: LMCore,
    params: ValueRLParams,
    pad_token_id: int,
    value_weight: float = 1.0,
    logit_weight: Optional[float] = None,
    length_normalize: bool = False,
):
    """score = Σ_action value_weight·(min(Q1,Q2)−V) + logit_weight·logπ_β.

    length_normalize divides by the action-token count (mean advantage),
    the length-independent analogue of the raw Σ. One trunk forward, and a
    second on π_β when `logit_weight` is set and `params.pi_beta` is."""

    def score(input_ids: torch.Tensor, action_mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            attention_mask, position_ids = initialize_attn_mask_pos_ids(input_ids, pad_token_id)
            _, hidden = core.forward(params.base, input_ids, attention_mask, position_ids)
            nxt = input_ids[:, 1:, None].long()
            q = _gather_next(params.q1_head(hidden), nxt)
            if params.q2_head is not None:
                q = torch.minimum(q, _gather_next(params.q2_head(hidden), nxt))
            v = params.v_head(hidden)[:, :-1].squeeze(2)
            total = value_weight * (q - v)
            if logit_weight is not None and params.pi_beta is not None:
                logits, _ = core.forward(params.pi_beta, input_ids, attention_mask, position_ids)
                logprobs = torch.log_softmax(mask_pad_logits(logits[:, :-1].float(), core.config.vocab_size), dim=-1)
                total = total + logit_weight * torch.gather(logprobs, 2, nxt).squeeze(2)
            out = score_action_tokens(total, action_mask[:, 1:], attention_mask[:, 1:].float())
            if length_normalize:
                out = out / _action_count(action_mask, attention_mask)
            return out

    return score


def make_mc_score_fn(core: LMCore, params: ValueRLParams, pad_token_id: int, length_normalize: bool = False):
    """score = Σ_action Q; with a twin-Q bundle (`q2_head` set, the CQL
    case) Σ min(Q1,Q2). length_normalize divides by the action-token count
    (mean Q): with Q < 0 the raw Σ favors proposals of fewer tokens."""

    def score(input_ids: torch.Tensor, action_mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            attention_mask, position_ids = initialize_attn_mask_pos_ids(input_ids, pad_token_id)
            _, hidden = core.forward(params.base, input_ids, attention_mask, position_ids)
            nxt = input_ids[:, 1:, None].long()
            q = _gather_next(params.q1_head(hidden), nxt)
            if params.q2_head is not None:
                q = torch.minimum(q, _gather_next(params.q2_head(hidden), nxt))
            total = score_action_tokens(q, action_mask[:, 1:], attention_mask[:, 1:].float())
            if length_normalize:
                total = total / _action_count(action_mask, attention_mask)
            return total

    return score


def make_logprob_score_fn(core: LMCore, params, pad_token_id: int):
    """score = Σ_action logπ (the BC/PPO reranker); `params` is the
    policy's `Transformer`."""

    def score(input_ids: torch.Tensor, action_mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            attention_mask, position_ids = initialize_attn_mask_pos_ids(input_ids, pad_token_id)
            logits, _ = core.forward(params, input_ids, attention_mask, position_ids)
            logprobs = torch.log_softmax(mask_pad_logits(logits[:, :-1].float(), core.config.vocab_size), dim=-1)
            logpi = torch.gather(logprobs, 2, input_ids[:, 1:, None].long()).squeeze(2)
            return score_action_tokens(logpi, action_mask[:, 1:], attention_mask[:, 1:].float())

    return score


@dataclass
class ReRankerPolicy(BatchedTextPolicy):
    """Score a fixed proposal set per history and pick the argmax (or sample
    at `temperature`). `proposal_fn(history) -> [history+action]`;
    `score_batch(histories) -> scores`."""

    proposal_fn: Callable[[TextHistory], List[TextHistory]]
    score_batch: Callable[[List[TextHistory]], np.ndarray]
    sample: bool = False
    temperature: float = 1.0
    rng: Optional[np.random.Generator] = None

    def act(self, text_history, done=None):
        if done is None:
            done = [False] * len(text_history)
        results: List[Optional[TextHistory]] = [None] * len(text_history)
        live = [i for i, d in enumerate(done) if not d]
        if not live:
            return results
        all_proposals: List[TextHistory] = []
        spans = []
        for i in live:
            props = self.proposal_fn(text_history[i])
            spans.append((len(all_proposals), len(all_proposals) + len(props)))
            all_proposals.extend(props)
        scores = np.asarray(self.score_batch(all_proposals))
        for i, (s, e) in zip(live, spans):
            sub = scores[s:e]
            if self.sample:
                rng = self.rng or np.random.default_rng()
                z = sub / self.temperature
                p = np.exp(z - z.max())
                p /= p.sum()
                choice = rng.choice(len(sub), p=p)
            else:
                choice = int(np.argmax(sub))
            results[i] = all_proposals[s + choice]
        return results


def tokenize_histories_for_scoring(
    histories: List[TextHistory], tokenizer, max_length: int, device: DeviceLike = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (input_ids [b,t], action_mask [b,t]) on `device` (the card unless
    the caller asks for the CPU); padded RIGHT, truncated LEFT."""
    token_histories = [TokenHistory.from_text_history(h, tokenizer) for h in histories]
    strategy = BlockingStrategy(Padding.RIGHT, Truncation.LEFT, max_length)
    ids = block_sequences([th.tokens for th in token_histories], tokenizer.pad_token_id, np.int64, strategy)
    am = block_sequences([th.is_action for th in token_histories], False, np.bool_, strategy)
    device = resolve_device(device)
    return torch.from_numpy(ids).to(device), torch.from_numpy(am).to(device)
