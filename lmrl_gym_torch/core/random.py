"""Categorical sampling as `jax.random.categorical` computes it: the argmax
of logits plus standard Gumbel noise. The noise comes from an explicit
`torch.Generator`, or the caller hands it in, so a test can give the port
and the JAX package the same draws."""
from __future__ import annotations

from typing import Optional

import torch


def gumbel_like(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard Gumbel noise of logits' shape (f32), as jax.random.gumbel
    draws it: −log(−log(U)), U uniform on [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_(min=tiny)))


def categorical(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample over the last axis: argmax(gumbel + logits)."""
    if gumbel is None:
        gumbel = gumbel_like(logits, generator)
    return torch.argmax(gumbel + logits, dim=-1)
