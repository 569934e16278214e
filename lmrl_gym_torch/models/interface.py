"""Model-facing glue: attention-mask/position conventions, LM forward and
the plain-LM decode hookup for models/generation.py. The port of
`lmrl_gym_tpu/models/interface.py`.

Attention mask = 1 where token != pad_id; position ids = cumsum(mask) − 1
clipped at 0, so left padding yields logical positions starting at 0.

In the port a model's parameters live in its `Transformer` module, so the
`params` argument of these functions is that module.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from lmrl_gym_torch.core.device import DeviceLike, resolve_device
from lmrl_gym_torch.models.config import TransformerConfig
from lmrl_gym_torch.models.transformer import KVCache, Transformer, mask_pad_logits


def initialize_attn_mask_pos_ids(
    input_ids: torch.Tensor,
    pad_token_id: Optional[int],
    attention_mask: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if attention_mask is None:
        if pad_token_id is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.int32)
        else:
            attention_mask = (input_ids != pad_token_id).to(torch.int32)
    if position_ids is None:
        position_ids = (torch.cumsum(attention_mask, dim=1) - 1).clamp(min=0)
    return attention_mask, position_ids


def pad_mask_to(attn_mask: torch.Tensor, length: int) -> torch.Tensor:
    if attn_mask.shape[1] < length:
        attn_mask = torch.nn.functional.pad(attn_mask, (0, length - attn_mask.shape[1]))
    return attn_mask


def cached_positions(attn_mask: torch.Tensor, T: int, next_pos: torch.Tensor):
    """Logical positions for a cached forward of T tokens and the next
    position after it: a prefill (T > 1) takes them from the mask prefix, a
    1-token step from the carried next_pos."""
    if T > 1:
        prefix = attn_mask[:, :T]
        return (torch.cumsum(prefix, dim=1) - 1).clamp(min=0), prefix.sum(dim=1)
    return next_pos[:, None], next_pos + 1


class LMCore:
    """The (config, device) a model runs with; parameters are a
    `Transformer` module passed to each call."""

    def __init__(self, config: TransformerConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)

    def forward(
        self,
        params: Transformer,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        pad_token_id: Optional[int] = None,
        train: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (logits [B,T,V_padded], final hidden [B,T,D])."""
        if train:
            raise NotImplementedError("training forwards (dropout, gradients) arrive with the training slice")
        attention_mask, position_ids = initialize_attn_mask_pos_ids(
            input_ids, pad_token_id, attention_mask, position_ids
        )
        with torch.no_grad():
            logits, hidden, _ = params(
                input_ids, attention_mask=attention_mask, position_ids=position_ids
            )
        return logits, hidden

    def make_lm_logits_fn(self, params: Transformer, total_len: int, batch: int):
        """(logits_fn, init_carry) for models.generation.generate.

        Carry = (KVCache, next_position [B]). Positions are logical
        (cumsum of mask), so left-padded prompts decode correctly."""
        cache = KVCache.init(self.config, batch, total_len, device=self.device)

        def logits_fn(tokens: torch.Tensor, attn_mask: torch.Tensor, carry):
            cache, next_pos = carry
            # the cache may be longer than prompt + new tokens: pad slots stay masked
            attn_mask = pad_mask_to(attn_mask, cache.max_len)
            position_ids, next_pos = cached_positions(attn_mask, tokens.shape[1], next_pos)
            logits, _, cache = params(
                tokens, attention_mask=attn_mask, position_ids=position_ids, cache=cache
            )
            logits = mask_pad_logits(logits, self.config.vocab_size)
            return logits, (cache, next_pos)

        init_carry = (cache, torch.zeros((batch,), dtype=torch.int64, device=self.device))
        return logits_fn, init_carry
