"""Serving path: value-guided decoding. The port of
`lmrl_gym_tpu/algos/value_policy.py::ValueGuidedServer`.

`ValueGuidedServer.generate` decodes with logits = π_β + β·min(q1,q2)
(the reference's value_rl_base/gpt2/generation.py:36-121): both trunks run
inside one decode loop (models/generation.py) with a (π_β cache, value
cache) carry. `share_trunk=True` runs ONE trunk and applies the Q heads to
its hidden states.

In the port, parameters live in modules: `ValueRLParams` carries the trunk
`Transformer`s and the head modules themselves, so the server needs no
separate head definitions. The JAX package's batch bucketing
(`_bucket_batch`) only bounded jit recompiles and has no counterpart in
eager PyTorch.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from lmrl_gym_torch.core.blocking import BlockingStrategy, Padding, Truncation, block_sequences
from lmrl_gym_torch.models.generation import SamplingConfig, generate
from lmrl_gym_torch.models.interface import LMCore, pad_mask_to, cached_positions
from lmrl_gym_torch.models.transformer import KVCache, mask_pad_logits


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
        tok = self.tokenizer
        ids = block_sequences(
            [tok.encode(p) for p in prompts],
            tok.pad_token_id,
            np.int64,
            BlockingStrategy(Padding.LEFT, Truncation.LEFT, max_input_length),
        )
        ids = torch.from_numpy(ids).to(self.core.device)
        mask = (ids != tok.pad_token_id).to(torch.int32)
        tokens, token_mask = self.generate(params, ids, mask, sampling, generator)
        return [
            tok.decode([int(t) for t, m in zip(row, mrow) if m])
            for row, mrow in zip(tokens.tolist(), token_mask.tolist())
        ]
