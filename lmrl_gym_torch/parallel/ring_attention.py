"""Ring attention: causal attention with the sequence sharded over the 'sp'
mesh axis. The port of `lmrl_gym_tpu/parallel/ring_attention.py`.

Each rank holds a contiguous [T/n] slice of Q, K and V. The K/V blocks
(with their padding bias) go round the ring of sp ranks, one hop per step,
and every rank folds each visiting block into an online-softmax
accumulator, so the full [T, T] score matrix exists nowhere. Blocks above
the causal diagonal are masked, not skipped, as in the JAX package.

The block update is plain PyTorch (the JAX package's is an XLA einsum), so
it runs on the CPU test ranks and on the card alike. A hop is a
`torch.autograd.Function` over point-to-point sends: its forward passes the
blocks to the next rank, and its backward sends their cotangents the other
way round the ring, as JAX differentiates `ppermute`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from lmrl_gym_torch.parallel.mesh import Mesh

_NEG_BIG = -0.7 * torch.finfo(torch.float32).max


def _block_update(
    q: torch.Tensor,  # [B,H,Tq,D] local queries (f32, pre-scaled)
    k: torch.Tensor,  # [B,H,Tk,D] visiting keys
    v: torch.Tensor,  # [B,H,Tk,D] visiting values
    bias: torch.Tensor,  # [B,Tk] additive bias travelling with k/v
    q_off: int,  # absolute position of q[..., 0, :]
    k_off: int,  # absolute position of k[..., 0, :]
    causal: bool,
    carry: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
):
    acc, m_prev, l_prev = carry
    Tq, Tk = q.shape[2], k.shape[2]
    s = torch.matmul(q, k.float().transpose(-1, -2))
    s = s + bias.float()[:, None, None, :]
    if causal:
        q_pos = q_off + torch.arange(Tq, device=q.device)
        k_pos = k_off + torch.arange(Tk, device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, torch.full((), _NEG_BIG, device=q.device))
    m_cur = s.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_prev * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p, v.float())
    return acc, m_new, l_new


class _Hop(torch.autograd.Function):
    """Send tensors to rank `nxt` and receive the same shapes from `prv`;
    the backward sends the cotangents to `prv` and receives from `nxt`."""

    @staticmethod
    def forward(ctx, nxt: int, prv: int, group, *xs):
        ctx.nxt, ctx.prv, ctx.group = nxt, prv, group
        return _exchange(xs, nxt, prv, group)

    @staticmethod
    def backward(ctx, *gs):
        need = [i for i, g in enumerate(gs) if ctx.needs_input_grad[3 + i]]
        back = dict(zip(need, _exchange([gs[i] for i in need], ctx.prv, ctx.nxt, ctx.group)))
        return (None, None, None) + tuple(back.get(i) for i in range(len(gs)))


def _exchange(xs, to: int, frm: int, group) -> Tuple[torch.Tensor, ...]:
    xs = tuple(x.contiguous() for x in xs)
    out = tuple(torch.empty_like(x) for x in xs)
    ops = [dist.P2POp(dist.isend, x, to, group) for x in xs] + [dist.P2POp(dist.irecv, o, frm, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _ring_attention_local(q, k, v, bias, *, group, idx: int, n: int, causal: bool, sm_scale: float):
    """One rank's part: q/k/v [B,H,T_local,D], bias [B,T_local]."""
    B, H, Tl, D = q.shape
    qf = q.float() * sm_scale
    acc = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tl), _NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    carry = (acc, m, l)
    if n > 1:
        ranks = dist.get_process_group_ranks(group)
        nxt, prv = ranks[(idx + 1) % n], ranks[(idx - 1) % n]
    k_cur, v_cur, b_cur = k, v, bias
    for s in range(n):
        src = (idx - s) % n  # which original shard this k/v block is
        carry = _block_update(qf, k_cur, v_cur, b_cur, idx * Tl, src * Tl, causal, carry)
        if s != n - 1:
            k_cur, v_cur, b_cur = _Hop.apply(nxt, prv, group, k_cur, v_cur, b_cur)
    acc, m, l = carry
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def make_ring_attention(
    mesh: Mesh,
    sp_axis: str = "sp",
    causal: bool = True,
    sm_scale: Optional[float] = None,
):
    """f(q, k, v, bias=None) over this rank's blocks: q/k/v [B,H,T/n,Dh], the
    rank's contiguous slice of the sequence (rank i of the sp axis holds
    positions [i·T/n, (i+1)·T/n)); bias [B,T/n] additive (−big = masked).
    Batch and heads are whatever the rank holds. Returns the rank's
    [B,H,T/n,Dh] block of the output."""
    n = mesh.axis_size(sp_axis)
    group, idx, _ = mesh.group(sp_axis) if n > 1 else (None, 0, 1)

    def call(q, k, v, bias=None):
        scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
        if bias is None:
            bias = torch.zeros((q.shape[0], q.shape[2]), dtype=torch.float32, device=q.device)
        return _ring_attention_local(q, k, v, bias, group=group, idx=idx, n=n, causal=causal, sm_scale=float(scale))

    return call
