"""Causal flash-attention forward: CUDA kernel `csrc/flash_fwd.cu` and its
plain PyTorch version.

Replaces the Pallas kernel `lmrl_gym_tpu/ops/flash_attention.py::
_flash_kernel` (K1) behind `_flash_forward`. The function: O =
softmax(scale·QKᵀ + bias, causal with queries right-aligned at offset =
S − Tq)·V, fp32 online softmax, plus the per-row logsumexp that the
backward kernels (K2, K3; training slice) will need.

On an H100 this kernel is bound by device-memory bytes at the serving
path's shapes (Tq ≤ 10 queries over ≤ 128 cached keys, Dh = 64: about 10
FLOP per byte read), and by FLOPs only for long no-cache forwards. The
first design streams K/V tiles through shared memory in fp32 on the CUDA
cores; see the kernel source for what it leaves on the table.

Unlike the JAX package (which used the kernel only for T ≥ 1024 on a TPU),
the port runs it for every attention with more than one query on CUDA:
no-cache forwards (offset 0), cached prefills and appends over the filled
cache prefix (offset = index). No gradient yet: the kernel refuses inputs
that require one.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lmrl_gym_torch.ops import _build

# Large-negative instead of -inf (as in the JAX package): keeps exp() clean
# when an entire row is masked.
_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


def _plain_attention(q, k, v, bias, causal: bool, sm_scale: float):
    """Plain version, the same math as the JAX package's `_xla_attention`:
    q [B,H,Tq,Dh], k/v [B,H,S,Dh], bias [B,S] additive → (out in q's dtype,
    lse [B,H,Tq] f32)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        scores = scores + bias[:, None, None, :].float()
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        # queries sit at the END of the kv sequence (decode layout)
        q_pos = torch.arange(Tq, device=q.device) + (Tk - Tq)
        causal_mask = q_pos[:, None] >= torch.arange(Tk, device=q.device)[None, :]
        scores = torch.where(causal_mask[None, None], scores, _NEG_BIG)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return out.to(q.dtype), lse


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("flash_fwd")
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 13 + [ctypes.c_int, ctypes.c_float, ctypes.c_int]
            + [ctypes.c_void_p]
        )
        _lib = lib
    return _lib


def _check_cuda_inputs(q, k, v, bias):
    B, H, Tq, Dh = q.shape
    S = k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes float32 or bfloat16 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, H, S, Dh) or v.shape != k.shape:
        raise ValueError(f"flash_fwd: q {tuple(q.shape)} does not match k {tuple(k.shape)} / v {tuple(v.shape)}")
    if Dh % 8 != 0 or Dh > 256:
        raise ValueError(f"flash_fwd: head dim {Dh} must be a multiple of 8 and at most 256")
    if Tq > S:
        raise ValueError(f"flash_fwd: {Tq} queries over {S} keys (queries are right-aligned)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_fwd: {name} is not on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_fwd: {name} needs a contiguous last dim")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.shape != (B, S) or bias.stride(1) != 1 or bias.device != q.device:
            raise ValueError(f"flash_fwd: bias must be float32 [B, S] = [{B}, {S}] on {q.device} with a contiguous last dim")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_fwd has no backward yet; call it under torch.no_grad()")


def flash_fwd(
    q: torch.Tensor,  # [B, H, Tq, Dh]
    k: torch.Tensor,  # [B, H, S, Dh]
    v: torch.Tensor,  # [B, H, S, Dh]
    bias: Optional[torch.Tensor] = None,  # [B, S] additive f32, _NEG_BIG = masked
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (out [B,H,Tq,Dh] in q's dtype, lse [B,H,Tq] f32).

    CPU tensors take the plain version. CUDA tensors launch the kernel:
    q/k/v may be strided views (batch/head/row strides, contiguous last
    dim); `out` is a [B,H,Tq,Dh] view of a [B,Tq,H,Dh] buffer, so merging
    the heads back is free."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return _plain_attention(q, k, v, bias, causal, sm_scale)
    _check_cuda_inputs(q, k, v, bias)
    lib = _load()
    B, H, Tq, Dh = q.shape
    S = k.shape[2]
    out = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    rc = lib.flash_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(), lse.data_ptr(),
        B, H, Tq, S, Dh,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        bias.stride(0) if bias is not None else 0,
        S - Tq, float(sm_scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd: kernel launch failed with CUDA error {rc}")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention; output [B, H, Tq, Dh] in q.dtype. Queries are
    right-aligned against the kv sequence when Tq < S (decode layout)."""
    return flash_fwd(q, k, v, bias, causal, sm_scale)[0]
