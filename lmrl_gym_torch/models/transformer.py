"""Decoder-only transformer (GPT-2 / GPT-J / LLaMA families) in PyTorch.

The port of `lmrl_gym_tpu/models/transformer.py`. One module covers every
config branch: learned or rotary positions (both rotary conventions),
serial or parallel (GPT-J) MLP, layernorm or rmsnorm, plain or gated
(SwiGLU) MLP, tied or untied output head. Module and parameter names follow
the flax tree (`wte`, `h.<i>.attn.qkv`, `ln_f`, ...) so
`models/convert.py` maps one onto the other.

Dense layers are `nn.Linear` (weights [out, in], the flax kernels
transposed). Parameters are stored in whatever dtype the caller picks and
cast to the config's activation dtype where used, as flax's
`Dense(dtype=...)` does; that cast is free when the storage dtype already
matches (the serving path keeps bf16 weights).

Attention dispatch, by shape, on CUDA and CPU alike (CPU tensors take
each kernel's plain PyTorch version):

- no cache → `flash_attention`, offset 0;
- cache and T > 1 (prefill, observation append) → write K/V at
  [index, index+T), then `flash_attention` over the filled prefix
  [0, index+T) with bias = mask[:, :index+T] and the queries right-aligned
  at offset = index;
- cache and T == 1 → write, then `decode_attention`, which reads slots
  0..index only.

The JAX package's cached einsum path attends over the whole T_max buffer;
the slots past the fill contribute exact zeros there, so both compute the
same function on every row that has a visible key.

Training (`deterministic=False`) applies embedding and residual dropout
with masks drawn from a `torch.Generator` the caller passes, as the flax
module does with its dropout rng; with grad mode on, the no-cache
attention goes through `flash_attention`'s autograd function (K1 forward,
K2 + K3 backward). Attention-probability dropout (`attn_pdrop > 0` in
training) takes the JAX package's einsum path instead, as the JAX module
does (it leaves flash and the ring there, never running this dropout in a
kernel): `attention_with_dropout`, plain PyTorch, with plain autograd for
its backward, so such a step launches no K1, K2 or K3.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lmrl_gym_torch.core.device import DeviceLike, resolve_device, torch_dtype
from lmrl_gym_torch.models.config import TransformerConfig
from lmrl_gym_torch.ops.decode_attention import decode_attention
from lmrl_gym_torch.ops.flash_attention import _NEG_BIG as _MASK_BIAS
from lmrl_gym_torch.ops.flash_attention import flash_attention


@dataclass(frozen=True, eq=False)  # tensor fields: identity, not elementwise ==
class KVCache:
    """Per-model decode cache. k/v: L-tuples of [B, H, T_max, Dh] buffers
    (one per layer); index: next slot, a host int.

    A forward writes the new tokens' K/V into the buffers in place and
    returns a KVCache over the same buffers with index + T. Slots at or past
    a cache's index are never read, so a cache object at index 0 (an actor's
    initial carry) can be reused for a fresh episode."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    index: int = 0

    @classmethod
    def init(
        cls,
        config: TransformerConfig,
        batch: int,
        max_len: int,
        dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ) -> "KVCache":
        dtype = dtype or torch_dtype(config.dtype)
        device = resolve_device(device)
        shape = (batch, config.num_heads, max_len, config.head_dim)
        return cls(
            k=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(config.num_layers)),
            v=tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(config.num_layers)),
            index=0,
        )

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    def advanced(self, n: int) -> "KVCache":
        return KVCache(self.k, self.v, self.index + n)


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None, keep: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """flax `nn.Dropout(rate, deterministic=False)`: keep each element with
    probability 1 − rate (uniform draw < 1 − rate) and scale it by
    1/(1 − rate). `keep` replays another run's mask in place of a draw
    from `generator`."""
    if keep is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep.to(x.device), x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def attention_with_dropout(
    q: torch.Tensor,  # [B, H, T, Dh]
    k: torch.Tensor,  # [B, H, T, Dh]
    v: torch.Tensor,
    bias: Optional[torch.Tensor],  # [B, T] additive: 0 visible, _MASK_BIAS masked; None = all visible
    sm_scale: float,
    dtype: torch.dtype,
    drop: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """The JAX package's einsum attention with dropout on the probabilities
    (`lmrl_gym_tpu/models/transformer.py:236-243`): scores q·kᵀ with f32
    products and sums (`preferred_element_type=f32`: q and k upcast, which
    is exact, and multiplied in f32), times 1/√Dh; causal and padding
    masked entries set to f32's finfo.min; softmax in f32, cast to `dtype`;
    `drop`; then P·V in `dtype`."""
    T, S = q.shape[2], k.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    visible = torch.ones((T, S), dtype=torch.bool, device=q.device).tril()[None, None]
    if bias is not None:
        visible = visible & (bias == 0)[:, None, None, :]
    scores = scores.masked_fill(~visible, torch.finfo(torch.float32).min)
    probs = drop(torch.softmax(scores, dim=-1).to(dtype))
    return torch.matmul(probs, v.to(dtype))


def take_fill(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """flax `Embed`'s lookup (`jnp.take`, default "fill" mode): rows of the
    non-negative ids past the table's end are NaN, where a CUDA gather
    would assert. A decode that runs past max_position_embeddings (a long
    prompt plus its new tokens) thus goes NaN, as in the JAX package."""
    n = table.shape[0]
    return F.embedding(ids.clamp(max=n - 1), table).masked_fill((ids >= n)[..., None], float("nan"))


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax `Dense(dtype=dtype)`: inputs and params cast to `dtype`."""
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rotate_every_two(x):
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary(
    x: torch.Tensor,
    position_ids: torch.Tensor,
    rotary_dim: int,
    base: float = 10000.0,
    interleaved: bool = False,
) -> torch.Tensor:
    """x: [B, H, T, Dh]; rotary on the first rotary_dim dims.

    interleaved=True is the GPT-J convention (rotate adjacent pairs);
    False is the NeoX/LLaMA half-split."""
    inv_freq = 1.0 / (
        base ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=x.device) / rotary_dim)
    )
    angles = position_ids[:, :, None].float() * inv_freq[None, None, :]  # [B,T,rd/2]
    sin = torch.sin(angles)[:, None, :, :]  # [B,1,T,rd/2]
    cos = torch.cos(angles)[:, None, :, :]
    if interleaved:
        sin = sin.repeat_interleave(2, dim=-1).to(x.dtype)
        cos = cos.repeat_interleave(2, dim=-1).to(x.dtype)
        rot = _rotate_every_two
    else:
        sin = torch.cat([sin, sin], dim=-1).to(x.dtype)
        cos = torch.cat([cos, cos], dim=-1).to(x.dtype)
        rot = _rotate_half
    x_rot, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
    x_rot = x_rot * cos + rot(x_rot) * sin
    return torch.cat([x_rot, x_pass], dim=-1)


class Attention(nn.Module):
    def __init__(self, config: TransformerConfig, device=None, dtype=None):
        super().__init__()
        D = config.hidden_size
        self.config = config
        self.qkv = nn.Linear(D, 3 * D, bias=config.attn_bias, device=device, dtype=dtype)
        self.out = nn.Linear(D, D, bias=config.attn_bias, device=device, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D]
        bias: Optional[torch.Tensor],  # [B, T_kv] additive f32, None = all visible
        position_ids: torch.Tensor,  # [B, T]
        layer_cache: Optional[Tuple[torch.Tensor, torch.Tensor, int]],  # (k, v, index)
        drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,  # residual dropout
        attn_drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,  # probability dropout (training)
    ) -> torch.Tensor:
        cfg = self.config
        B, T, D = x.shape
        H, Dh = cfg.num_heads, cfg.head_dim
        dtype = torch_dtype(cfg.dtype)

        qkv = dense(self.qkv, x, dtype)

        def heads(t):  # [B,T,D] slice → [B,H,T,Dh] view, no copy
            return t.view(B, T, H, Dh).transpose(1, 2)

        q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
        if cfg.position_embedding == "rotary":
            rd = cfg.rotary_dim or Dh
            q = apply_rotary(q, position_ids, rd, cfg.rotary_base, cfg.rotary_interleaved)
            k = apply_rotary(k, position_ids, rd, cfg.rotary_base, cfg.rotary_interleaved)

        sm_scale = 1.0 / math.sqrt(Dh)
        if layer_cache is None and attn_drop is not None:
            out = attention_with_dropout(q, k, v, bias, sm_scale, dtype, attn_drop)
        elif layer_cache is None:
            out = flash_attention(q, k, v, bias, causal=True, sm_scale=sm_scale)
        else:
            ck, cv, index = layer_cache  # [B,H,T_max,Dh], written in place
            ck[:, :, index:index + T].copy_(k)
            cv[:, :, index:index + T].copy_(v)
            if T == 1:
                out = decode_attention(q, ck, cv, index, bias, sm_scale)
            else:
                S = index + T
                out = flash_attention(
                    q, ck[:, :, :S], cv[:, :, :S],
                    bias[:, :S] if bias is not None else None,
                    causal=True, sm_scale=sm_scale,
                )
        out = dense(self.out, out.transpose(1, 2).reshape(B, T, D), dtype)
        return drop(out) if drop is not None else out


class MLP(nn.Module):
    def __init__(self, config: TransformerConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        D, M = config.hidden_size, config.mlp_dim
        self.fc = nn.Linear(D, M, bias=config.mlp_bias, device=device, dtype=dtype)
        if config.gated_mlp:
            # SwiGLU: act(fc(x)) gates a linear up-projection (LLaMA MLP;
            # HF names: fc=gate_proj, gate=up_proj, proj=down_proj)
            self.gate = nn.Linear(D, M, bias=config.mlp_bias, device=device, dtype=dtype)
        self.proj = nn.Linear(M, D, bias=config.mlp_bias, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, drop: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
        cfg = self.config
        dtype = torch_dtype(cfg.dtype)
        h = dense(self.fc, x, dtype)
        if cfg.activation == "gelu_new":
            h = F.gelu(h, approximate="tanh")
        elif cfg.activation == "gelu":
            h = F.gelu(h)
        elif cfg.activation == "relu":
            h = F.relu(h)
        elif cfg.activation == "silu":
            h = F.silu(h)
        else:
            raise ValueError(cfg.activation)
        if cfg.gated_mlp:
            h = h * dense(self.gate, x, dtype)
        h = dense(self.proj, h, dtype)
        return drop(h) if drop is not None else h


class LayerNorm(nn.Module):
    """flax `LayerNorm(dtype=...)`: statistics in f32, output in `dtype`."""

    def __init__(self, dim: int, eps: float, out_dtype: torch.dtype, device=None, dtype=None):
        super().__init__()
        self.eps, self.out_dtype = eps, out_dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.out_dtype)


class RMSNorm(nn.Module):
    """flax `RMSNorm(dtype=...)`: x·rsqrt(mean(x²)+eps)·scale in f32."""

    def __init__(self, dim: int, eps: float, out_dtype: torch.dtype, device=None, dtype=None):
        super().__init__()
        self.eps, self.out_dtype = eps, out_dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        y = F.rms_norm(x.float(), x.shape[-1:], self.weight.float(), self.eps)
        return y.to(self.out_dtype)


def _norm(cfg: TransformerConfig, device=None, dtype=None) -> nn.Module:
    if cfg.norm == "rmsnorm":
        cls = RMSNorm
    elif cfg.norm == "layernorm":
        cls = LayerNorm
    else:
        raise ValueError(cfg.norm)
    return cls(cfg.hidden_size, cfg.layer_norm_epsilon, torch_dtype(cfg.dtype), device=device, dtype=dtype)


class Block(nn.Module):
    def __init__(self, config: TransformerConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.ln_1 = _norm(config, device, dtype)
        self.attn = Attention(config, device, dtype)
        if not config.parallel_ffn:
            self.ln_2 = _norm(config, device, dtype)
        self.mlp = MLP(config, device, dtype)

    def forward(self, x, bias, position_ids, layer_cache, drop=None, attn_drop=None):
        h = self.ln_1(x)
        attn_out = self.attn(h, bias, position_ids, layer_cache, drop, attn_drop)
        if self.config.parallel_ffn:
            # GPT-J: mlp reads the same normed input; one residual add
            return x + attn_out + self.mlp(h, drop)
        x = x + attn_out
        return x + self.mlp(self.ln_2(x), drop)


class Transformer(nn.Module):
    """forward → (logits [B,T,V_padded], hidden [B,T,D], new KVCache|None).

    Built on `device` (default `cuda`; raises without one) with parameters
    in `dtype`, initialized as the flax module is (normal(initializer_range)
    weights and embeddings, zero biases, unit norm scales) from `seed`."""

    def __init__(
        self,
        config: TransformerConfig,
        device: DeviceLike = None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        D, V = config.hidden_size, config.padded_vocab_size
        self.wte = nn.Embedding(V, D, device=device, dtype=dtype)
        if config.position_embedding == "learned":
            self.wpe = nn.Embedding(config.max_position_embeddings, D, device=device, dtype=dtype)
        elif config.position_embedding != "rotary":
            raise ValueError(config.position_embedding)
        self.h = nn.ModuleList(Block(config, device, dtype) for _ in range(config.num_layers))
        self.ln_f = _norm(config, device, dtype)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(D, V, bias=config.lm_head_bias, device=device, dtype=dtype)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        std = self.config.initializer_range
        for module in self.modules():  # norms start at scale 1, bias 0
            if isinstance(module, (nn.Linear, nn.Embedding)):
                nn.init.normal_(module.weight, 0.0, std, generator=generator)
                if getattr(module, "bias", None) is not None:
                    nn.init.zeros_(module.bias)

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, T]
        attention_mask: Optional[torch.Tensor] = None,  # [B, T], or [B, T_kv] with a cache
        position_ids: Optional[torch.Tensor] = None,  # [B, T]
        cache: Optional[KVCache] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,  # dropout masks when training
        attn_keep: Optional[Sequence[torch.Tensor]] = None,  # replayed attention keep masks, one per layer
    ):
        """`attn_keep` replays the attention-probability keep masks (bool
        [B, H, T, T] per layer, True = kept) in place of draws from
        `generator`; it applies only where that dropout runs (training
        with `attn_pdrop > 0`, no cache)."""
        cfg = self.config
        attn_dropout = not deterministic and cfg.attn_pdrop > 0
        train_drop = not deterministic and max(cfg.embd_pdrop, cfg.resid_pdrop) > 0
        if (train_drop or (attn_dropout and attn_keep is None)) and generator is None:
            raise ValueError("dropout in training (deterministic=False) draws its masks from `generator`; pass one")
        B, T = input_ids.shape
        dtype = torch_dtype(cfg.dtype)
        start = cache.index if cache is not None else 0
        if position_ids is None:
            position_ids = torch.arange(start, start + T, device=input_ids.device).expand(B, T)
        # additive padding bias over the kv slots; None = every slot visible
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask.bool(), 0.0, _MASK_BIAS).float()

        x = F.embedding(input_ids, self.wte.weight).to(dtype)
        if cfg.position_embedding == "learned":
            x = x + take_fill(self.wpe.weight, position_ids).to(dtype)
        drop = None
        if train_drop:
            if cfg.embd_pdrop > 0:
                x = dropout(x, cfg.embd_pdrop, generator)
            if cfg.resid_pdrop > 0:
                drop = functools.partial(dropout, rate=cfg.resid_pdrop, generator=generator)

        for i, block in enumerate(self.h):
            layer_cache = (cache.k[i], cache.v[i], start) if cache is not None else None
            attn_drop = None
            if attn_dropout and cache is None:
                attn_drop = functools.partial(dropout, rate=cfg.attn_pdrop, generator=generator,
                                              keep=None if attn_keep is None else attn_keep[i])
            x = block(x, bias, position_ids, layer_cache, drop, attn_drop)
        x = self.ln_f(x)

        if cfg.tie_word_embeddings:
            # flax Embed.attend promotes both sides to the module dtype: on a
            # bf16 config the tied logit product runs in bf16
            logits = F.linear(x.to(dtype), self.wte.weight.to(dtype))
        else:
            logits = dense(self.lm_head, x, torch.float32)
        new_cache = cache.advanced(T) if cache is not None else None
        return logits, x, new_cache


def init_params(
    config: TransformerConfig,
    seed: int = 0,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> Transformer:
    """A freshly initialized Transformer (the port's parameters live in the
    module)."""
    return Transformer(config, device=device, dtype=dtype, seed=seed)


def mask_pad_logits(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """finfo.min above the true vocab (generation must not sample pad ids)."""
    V = logits.shape[-1]
    if V == vocab_size:
        return logits
    mask = torch.arange(V, device=logits.device) < vocab_size
    return torch.where(mask, logits, torch.finfo(logits.dtype).min)
