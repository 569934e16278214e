"""Causal flash attention: the forward kernel (K1) and the two backward
kernels (K2, K3), each in two variants — `csrc/flash_fwd_tc.cu` and
`csrc/flash_bwd_tc.cu` on the tensor cores for bf16 with Dh a multiple of
16 up to 128, `csrc/flash_fwd.cu` and `csrc/flash_bwd.cu` on the fp32 CUDA
cores for the rest; `_variant` chooses for both directions — their plain
PyTorch versions, and the `torch.autograd.Function` that joins them.

Replaces the Pallas kernels of `lmrl_gym_tpu/ops/flash_attention.py`:
`_flash_kernel` (K1, behind `_flash_forward`), `_flash_bwd_dq_kernel` (K2)
and `_flash_bwd_dkv_kernel` (K3, both behind `_flash_backward`), and the
`_flash_mha` custom_vjp that joins them. The function: O =
softmax(scale·QKᵀ + bias, causal with queries right-aligned at offset =
S − Tq)·V, fp32 online softmax, plus the per-row logsumexp that the backward
kernels use to rebuild P = exp(s − lse); dQ, dK, dV by the recompute
formulas, Δ = rowsum(dO ⊙ O) computed here (outside the kernels, as the JAX
package does), the bias (a padding mask) without a gradient.

On an H100 the forward is bound by device-memory bytes at the serving
path's shapes (Tq ≤ 10 queries over ≤ 128 cached keys, Dh = 64: about 10
FLOP per byte read) and by latency at the training shapes (T = 160: a
block runs 1–3 short key tiles), and so are the backward kernels (T = 160,
Dh = 64: about 50 FLOP per byte). The "tc" kernels run bf16 mma.sync with
f32 sums behind a 16-byte cp.async ring; the forward's block shape follows
Tq (64 query rows per block, or one (b, h) per warp for Tq ≤ 16). The
"simt" kernels stream tiles through shared memory in fp32. See the kernel
sources for what each leaves on the table.

Unlike the JAX package (which used the kernels only for T ≥ 1024 on a TPU),
the port runs them for every attention with more than one query on CUDA:
no-cache forwards (offset 0), cached prefills and appends over the filled
cache prefix (offset = index), and, when q, k or v requires a gradient, the
backward of every trained forward.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from lmrl_gym_torch.ops import _build

# Large-negative instead of -inf (as in the JAX package): keeps exp() clean
# when an entire row is masked.
_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _plain_scores(q, k, bias, causal: bool, sm_scale: float):
    """s = scale·QKᵀ + bias [B,H,Tq,S] f32, _NEG_BIG where a key lies past
    its query (queries sit at the END of the kv sequence: decode layout)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        scores = scores + bias[:, None, None, :].float()
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        q_pos = torch.arange(Tq, device=q.device) + (Tk - Tq)
        causal_mask = q_pos[:, None] >= torch.arange(Tk, device=q.device)[None, :]
        scores = torch.where(causal_mask[None, None], scores, _NEG_BIG)
    return scores


def _plain_attention(q, k, v, bias, causal: bool, sm_scale: float):
    """Plain version, the same math as the JAX package's `_xla_attention`:
    q [B,H,Tq,Dh], k/v [B,H,S,Dh], bias [B,S] additive → (out in q's dtype,
    lse [B,H,Tq] f32)."""
    scores = _plain_scores(q, k, bias, causal, sm_scale)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return out.to(q.dtype), lse


def _plain_dscores(q, k, v, bias, lse, delta, dout, causal: bool, sm_scale: float):
    """(P = exp(s − lse), dS = P ⊙ (dO·Vᵀ − Δ)), both [B,H,Tq,S] f32."""
    p = torch.exp(_plain_scores(q, k, bias, causal, sm_scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta[..., None])


def _plain_bwd_dq(q, k, v, bias, lse, delta, dout, causal: bool, sm_scale: float):
    """Plain version of K2: dQ = scale·dS·K, in q's dtype."""
    _, ds = _plain_dscores(q, k, v, bias, lse, delta, dout, causal, sm_scale)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * sm_scale).to(q.dtype)


def _plain_bwd_dkv(q, k, v, bias, lse, delta, dout, causal: bool, sm_scale: float):
    """Plain version of K3: dK = scale·dSᵀ·Q and dV = Pᵀ·dO, in k's/v's dtype."""
    p, ds = _plain_dscores(q, k, v, bias, lse, delta, dout, causal, sm_scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, dout):
    """Δ = rowsum(dO ⊙ O) [B,H,Tq] f32 (the JAX package computes it in XLA,
    outside its kernels). Only dO is cast: f32 × bf16 promotes O exactly
    inside the product, so the products are those of two f32 casts, with one
    f32 copy fewer."""
    return (dout.float() * out).sum(-1)


def _plain_flash_backward(q, k, v, bias, out, lse, dout, causal: bool, sm_scale: float):
    """Plain backward, the recompute math of the JAX package's
    `_flash_backward` → (dq, dk, dv); the bias gets no gradient."""
    delta = _delta(out, dout)
    dq = _plain_bwd_dq(q, k, v, bias, lse, delta, dout, causal, sm_scale)
    dk, dv = _plain_bwd_dkv(q, k, v, bias, lse, delta, dout, causal, sm_scale)
    return dq, dk, dv


_SUFFIX = {"simt": "", "tc": "_tc"}  # of the source csrc/<source><suffix>.cu and of its C function
_SOURCE = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd", "flash_bwd_dkv": "flash_bwd"}
# argument types after the "simt" variant's leading dtype code: pointers,
# (B, H, Tq, S, Dh), the (b, h, t) strides of each strided tensor, then
# bias_sb, offset, scale, causal and the stream
_ARGTYPES = {
    "flash_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12,
    "flash_bwd_dq": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 15,
    "flash_bwd_dkv": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 18,
}
_TAIL = [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_fns: Dict[Tuple[str, str], Callable[..., int]] = {}


def _kernel(name: str, variant: str):
    """The C entry point of kernel `name` in `variant`: "simt" →
    `csrc/flash_fwd.cu` or `csrc/flash_bwd.cu` (fp32 CUDA cores, f32 or
    bf16 by a dtype code), "tc" → `csrc/flash_fwd_tc.cu` or
    `csrc/flash_bwd_tc.cu` (tensor cores, bf16 only). Built on first use."""
    fn = _fns.get((name, variant))
    if fn is None:
        suffix = _SUFFIX[variant]
        fn = getattr(_build.load(_SOURCE[name] + suffix), name + suffix)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] if variant == "simt" else []) + _ARGTYPES[name] + _TAIL
        _fns[(name, variant)] = fn
    return fn


def _variant(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels (K1 forward; K2, K3 backward) take inputs of this dtype
    and head dim: "tc" (`csrc/flash_{fwd,bwd}_tc.cu`, tensor cores) for
    bf16 with a head dim that is a multiple of 16 up to 128; "simt"
    (`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`, fp32 CUDA cores) for the
    rest: f32, whose products would otherwise go through TF32 (off by the
    port's rule, `core/device.py`), and Dh = 256."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 and head_dim <= 128:
        return "tc"
    return "simt"


def _check_tc_alignment(**tensors):
    """The tensor-core kernels copy rows in 16-byte pieces: each input must
    start on 16 bytes, with batch, head and row strides in multiples of 8
    elements (views into a fused qkv projection are, for Dh % 8 == 0, and so
    are prefixes of a contiguous KV cache)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"flash attention (tensor cores): {name} must start on 16 bytes with strides in multiples of 8 "
                f"elements, got offset {t.data_ptr() % 16} and strides {tuple(t.stride())}"
            )


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _launch(wrapper, name: str, pointers, strided: Dict[str, torch.Tensor], q, k, bias, causal: bool,
            sm_scale: float) -> None:
    """Launch kernel `name` of the variant `_variant` picks for q, and count
    it on `wrapper`. `pointers` are the C function's tensor arguments (None
    for a missing bias), `strided` the tensors whose (b, h, t) strides
    follow (B, H, Tq, S, Dh), in order. A refused launch raises; nothing
    falls back to the other variant."""
    B, H, Tq, Dh = q.shape
    S = k.shape[2]
    variant = _variant(q.dtype, Dh)
    if variant == "tc":
        _check_tc_alignment(**strided)
    head = (_DTYPE_CODE[q.dtype],) if variant == "simt" else ()
    rc = _kernel(name, variant)(
        *head, *(t.data_ptr() if t is not None else None for t in pointers), B, H, Tq, S, Dh,
        *(s for t in strided.values() for s in _strides(t)),
        bias.stride(0) if bias is not None else 0, S - Tq, float(sm_scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} ({variant}): kernel launch failed with CUDA error {rc}")
    wrapper.launches += 1
    if variant == "tc":
        wrapper.tc_launches += 1


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
    the heads back is free. No autograd here: `flash_attention` carries the
    gradient."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return _plain_attention(q, k, v, bias, causal, sm_scale)
    _check_cuda_inputs(q, k, v, bias)
    B, H, Tq, Dh = q.shape
    out = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    _launch(flash_fwd, "flash_fwd", (q, k, v, bias, out, lse), dict(q=q, k=k, v=v, out=out), q, k, bias, causal,
            sm_scale)
    return out, lse


flash_fwd.launches = 0  # every launch
flash_fwd.tc_launches = 0  # of those, the tensor-core variant's


def _grad_like(t: torch.Tensor) -> torch.Tensor:
    """An empty [B,H,T,Dh] view of a [B,T,H,Dh] buffer: autograd merges the
    heads of such a gradient back into the fused qkv projection's gradient
    without a copy."""
    B, H, T, Dh = t.shape
    return torch.empty((B, T, H, Dh), dtype=t.dtype, device=t.device).permute(0, 2, 1, 3)


def _check_cuda_grad_inputs(q, k, v, bias, dout, lse, delta):
    _check_cuda_inputs(q, k, v, bias)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device or dout.stride(3) != 1:
        raise ValueError(f"flash backward: dout must be {q.dtype} {tuple(q.shape)} on {q.device} with a contiguous last dim")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != q.shape[:3] or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash backward: {name} must be contiguous float32 {tuple(q.shape[:3])} on {q.device}")


def flash_bwd_dq(q, k, v, bias, lse, delta, dout, causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """K2: dQ [B,H,Tq,Dh] in q's dtype from the forward's lse and Δ =
    rowsum(dO ⊙ O). CPU tensors take the plain version; CUDA tensors
    launch the kernel of the variant `_variant` picks (strided inputs
    as `flash_fwd` takes them)."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return _plain_bwd_dq(q, k, v, bias, lse, delta, dout, causal, sm_scale)
    _check_cuda_grad_inputs(q, k, v, bias, dout, lse, delta)
    dq = _grad_like(q)
    _launch(flash_bwd_dq, "flash_bwd_dq", (q, k, v, dout, bias, lse, delta, dq),
            dict(q=q, k=k, v=v, dout=dout, dq=dq), q, k, bias, causal, sm_scale)
    return dq


flash_bwd_dq.launches = 0  # every launch
flash_bwd_dq.tc_launches = 0  # of those, the tensor-core variant's


def flash_bwd_dkv(
    q, k, v, bias, lse, delta, dout, causal: bool = True, sm_scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dK, dV) [B,H,S,Dh] in k's and v's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel of the variant
    `_variant` picks."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return _plain_bwd_dkv(q, k, v, bias, lse, delta, dout, causal, sm_scale)
    _check_cuda_grad_inputs(q, k, v, bias, dout, lse, delta)
    dk, dv = _grad_like(k), _grad_like(v)
    _launch(flash_bwd_dkv, "flash_bwd_dkv", (q, k, v, dout, bias, lse, delta, dk, dv),
            dict(q=q, k=k, v=v, dout=dout, dk=dk, dv=dv), q, k, bias, causal, sm_scale)
    return dk, dv


flash_bwd_dkv.launches = 0  # every launch
flash_bwd_dkv.tc_launches = 0  # of those, the tensor-core variant's


class _FlashAttnFunction(torch.autograd.Function):
    """K1 forward, K2 + K3 backward: the port of the `_flash_mha`
    custom_vjp. CPU tensors take the plain versions of all three."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool, sm_scale: float):
        out, lse = flash_fwd(q, k, v, bias, causal, sm_scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        delta = _delta(out, dout)
        dq = flash_bwd_dq(q, k, v, bias, lse, delta, dout, ctx.causal, ctx.sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, bias, lse, delta, dout, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention; output [B, H, Tq, Dh] in q.dtype. Queries are
    right-aligned against the kv sequence when Tq < S (decode layout).
    With grad mode on and q, k or v requiring a gradient, the call goes
    through `_FlashAttnFunction` (K1 forward, K2 + K3 backward)."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttnFunction.apply(q, k, v, bias, causal, sm_scale)
    return flash_fwd(q, k, v, bias, causal, sm_scale)[0]
