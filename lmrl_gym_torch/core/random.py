"""Categorical sampling as `jax.random.categorical` computes it: the argmax
of logits plus standard Gumbel noise. The noise comes from an explicit
`torch.Generator`, or the caller hands it in, so a test can give the port
and the JAX package the same draws.

Under `sharded_draws` (a sharded step or rollout, `parallel/mesh.py`) every
draw of `draw_uniform` is made over the global array and this rank's block
is kept, so the ranks together draw what the unsharded program draws."""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple

import torch

# per leading dim: (start of this rank's block, global size), or None
_SHARDS: contextvars.ContextVar[Tuple[Optional[Tuple[int, int]], ...]] = contextvars.ContextVar(
    "draw_shards", default=())


@contextlib.contextmanager
def sharded_draws(shards: Sequence[Optional[Tuple[int, int]]]):
    """Draw over the global array inside: `shards[d]` = (start, global size)
    of this rank's block along dim d, None where dim d is whole; an inner
    context's entries replace an outer one's where they are given."""
    outer = list(_SHARDS.get())
    inner = outer + [None] * (len(shards) - len(outer))
    for d, s in enumerate(shards):
        if s is not None:
            inner[d] = s
    token = _SHARDS.set(tuple(inner))
    try:
        yield
    finally:
        _SHARDS.reset(token)


def draw_uniform(shape: Sequence[int], generator: Optional[torch.Generator], device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """U[0, 1) of `shape`; under `sharded_draws`, this rank's block of the
    global draw."""
    shards = [s for s in _SHARDS.get()[: len(shape)]]
    shape = list(shape)
    full = [s[1] if s is not None else n for s, n in zip(shards + [None] * len(shape), shape)]
    u = torch.rand(full, generator=generator, device=device, dtype=dtype)
    for d, s in enumerate(shards):
        if s is not None:
            u = u.narrow(d, s[0], shape[d])
    return u


def gumbel_like(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard Gumbel noise of logits' shape (f32), as jax.random.gumbel
    draws it: −log(−log(U)), U uniform on [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = draw_uniform(logits.shape, generator, logits.device)
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
