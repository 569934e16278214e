"""Single-token KV-cache decode attention: CUDA kernel `csrc/decode_attn.cu`
(with a split route for Dh ≤ 128 at small B·H, and a route of its own for
Dh > 128 at small B·H, as GPT-J's served turns give it: 8 lanes per key
row, each holding 32 dims) and its plain PyTorch version.

Replaces the Pallas kernel `lmrl_gym_tpu/ops/decode_attention.py::
_decode1_kernel` (K4) behind `_decode_attention_dispatch`. The function:
one query per (batch row, head) against a static [B,H,T_max,Dh] cache; key
slot j is visible iff j ≤ `index` and the additive bias allows it; fp32
online softmax.

On an H100 the kernel is bound by device-memory bandwidth: it reads K and
V of the filled prefix (slots 0..index) once, about 2 FLOP per byte, and
never touches the slots past `index`, so its traffic scales with the fill
and not with T_max. `index` is a host int (the actor's schedule is
static), so no device sync is needed to bound the read. At small B·H (a
served batch of 1–16) one block per (b, h) leaves the card short of bytes
in flight: below two blocks per SM, `_decode_splits` cuts the keys into
splits of at least 64, about four blocks per SM in all, and the kernel's
split route merges their partial softmaxes in the same launch (the last
block of each (b, h) to finish merges in split order, so the bits repeat),
with a scratch buffer from `torch.empty` and a per-(device, stream) buffer
of counters that the kernel leaves at 0.

The JAX model had retired its kernel (a v5e measurement); the port runs
this kernel on every q_len = 1 cached step on CUDA, with no flag.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from lmrl_gym_torch.ops import _build

_NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None

# The split route (csrc/decode_attn.cu, Dh ≤ 128): taken below
# _SPLIT_BELOW_BLOCKS_PER_SM blocks per SM, aiming at _SPLIT_BLOCKS_PER_SM
# blocks per SM in all, each split at least _SPLIT_MIN_KEYS keys.
_SPLIT_BELOW_BLOCKS_PER_SM = 2
_SPLIT_BLOCKS_PER_SM = 4
_SPLIT_MIN_KEYS = 64
_SPLIT_MAX = 64  # the kernel's kMaxSplits
_SPLIT_MAX_HEAD_DIM = 128
_n_sms: Dict[int, int] = {}
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _decode_splits(B: int, H: int, Dh: int, n_keys: int, n_sms: int) -> int:
    """How many splits the kernel cuts keys 0..n_keys − 1 into: 1 (one block
    per (b, h)) at and above B·H = 2 blocks per SM and for Dh > 128; below
    it, about 4 blocks per SM in all, each split at least 64 keys (the
    kernel gives split s the keys [s·n_keys // splits, (s + 1)·n_keys //
    splits))."""
    bh = B * H
    if Dh > _SPLIT_MAX_HEAD_DIM or bh >= _SPLIT_BELOW_BLOCKS_PER_SM * n_sms:
        return 1
    want = -(-_SPLIT_BLOCKS_PER_SM * n_sms // bh)
    return max(1, min(want, n_keys // _SPLIT_MIN_KEYS, _SPLIT_MAX))


def _device_sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _n_sms:
        _n_sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _n_sms[index]


def _split_counters(device: torch.device, stream: int) -> torch.Tensor:
    """The split route's int counter per (b, h), one buffer per device and
    stream, zeroed once: the merging block of each (b, h) sets its counter
    back to 0, so the next launch on the stream finds them all at 0."""
    key = (device.index, stream)
    if key not in _counters:
        _counters[key] = torch.zeros(_SPLIT_BELOW_BLOCKS_PER_SM * _device_sms(device), dtype=torch.int32,
                                     device=device)
    return _counters[key]


def _plain_decode_attention(q, k, v, index: int, bias, sm_scale: float):
    """Plain version, the same math as the JAX package's
    `_xla_decode_attention`: query t sits at absolute position index + t and
    sees cache slots k_pos ≤ index + t."""
    S = k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        scores = scores + bias[:, None, None, :].float()
    k_pos = torch.arange(S, device=q.device)[None, None, None, :]
    q_pos = index + torch.arange(q.shape[2], device=q.device)[None, None, :, None]
    scores = torch.where(k_pos <= q_pos, scores, _NEG_BIG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v).to(v.dtype)


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attn")
        lib.decode_attn.restype = ctypes.c_int
        lib.decode_attn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p]
        )
        _lib = lib
    return _lib


def _check_cuda_inputs(q, k, v, index, bias):
    B, H, Tq, Dh = q.shape
    S = k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attn takes float32 or bfloat16 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if Tq != 1:
        raise ValueError(f"decode_attn takes one query per row, got {Tq}")
    if k.shape != (B, H, S, Dh) or v.shape != k.shape:
        raise ValueError(f"decode_attn: q {tuple(q.shape)} does not match cache {tuple(k.shape)} / {tuple(v.shape)}")
    if Dh % 8 != 0 or Dh > 256:
        raise ValueError(f"decode_attn: head dim {Dh} must be a multiple of 8 and at most 256")
    if not 0 <= index < S:
        raise ValueError(f"decode_attn: index {index} outside the cache of {S} slots")
    # each lane reads 8 consecutive elements of a cache row with 16-byte loads
    align = 16 // k.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if isinstance(t, DTensor):  # the kernel reads raw pointers: a rank's plain local block only
            raise TypeError(f"decode_attn: {name} is a DTensor; pass the local tensor")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"decode_attn: {name} is not on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"decode_attn: {name} needs a contiguous last dim")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s % align for s in t.stride()[:3]):
            raise ValueError(f"decode_attn: cache {name} rows must be 16-byte aligned")
    # the Dh > 128 route reads q with the same 16-byte loads
    if Dh > 128 and (q.data_ptr() % 16 or any(s % align for s, n in zip(q.stride()[:2], q.shape[:2]) if n > 1)):
        raise ValueError(f"decode_attn: at head dim {Dh} q's rows must be 16-byte aligned")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.shape != (B, S) or bias.stride(1) != 1 or bias.device != q.device:
            raise ValueError(f"decode_attn: bias must be float32 [B, S] = [{B}, {S}] on {q.device} with a contiguous last dim")


def decode_attention(
    q: torch.Tensor,  # [B, H, Tq, Dh]; the kernel takes Tq == 1
    k: torch.Tensor,  # [B, H, S, Dh] full cache (slots past the fill unread)
    v: torch.Tensor,  # [B, H, S, Dh]
    index: int,  # absolute position of q[:, :, 0]
    bias: Optional[torch.Tensor] = None,  # [B, S] additive f32 (padding mask)
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """→ [B, H, Tq, Dh] in v's dtype. CPU tensors take the plain version
    (any Tq); CUDA tensors launch the kernel (Tq == 1) or raise."""
    index = int(index)
    if not q.is_cuda:
        return _plain_decode_attention(q, k, v, index, bias, sm_scale)
    _check_cuda_inputs(q, k, v, index, bias)
    lib = _load()
    B, H, _, Dh = q.shape
    n_keys = index + 1
    splits = _decode_splits(B, H, Dh, n_keys, _device_sms(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty((B, H, 1, Dh), dtype=q.dtype, device=q.device)
    part = count = None
    if splits > 1:
        part = torch.empty(B * H * splits * (Dh + 2), dtype=torch.float32, device=q.device)
        count = _split_counters(q.device, stream)
    rc = lib.decode_attn(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        part.data_ptr() if part is not None else None, count.data_ptr() if count is not None else None,
        B, H, Dh, n_keys, splits,
        q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        bias.stride(0) if bias is not None else 0,
        float(sm_scale),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attn: kernel launch failed with CUDA error {rc}")
    decode_attention.launches += 1
    if splits > 1:
        decode_attention.split_launches += 1
    return out


decode_attention.launches = 0  # every launch
decode_attention.split_launches = 0  # of those, the split route's
