"""Plain float32 GPT-2 / GPT-J trunk and MLP heads, written from the
published architectures (HF `GPT2Model`, `GPTJModel`) with no kernel, cache
or batching trick: every product in float32 with TF32 off, attention as an
explicit causal softmax.

Parameters are a {name: tensor} dict under `benchmark/weights.py`'s names,
in any float dtype: each is upcast to float32 where it is used, so bf16
serving weights are read at their bf16 values. `quant`, when given, rounds
both operands of every product of the trunk's layers (the control's lower
precision); the heads and the output projection stay float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _linear(x: torch.Tensor, p: Params, name: str, quant: Quant = None) -> torch.Tensor:
    w = p[name + ".weight"].float()
    b = p.get(name + ".bias")
    if quant is not None:
        x, w = quant(x), quant(w)
    y = x @ w.t()
    return y if b is None else y + b.float()


def _layer_norm(x: torch.Tensor, p: Params, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"].float(), p[name + ".bias"].float(), eps)


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x.pow(3))))


def _rotary(x: torch.Tensor, rotary_dim: int) -> torch.Tensor:
    """GPT-J's rotary embedding on the first `rotary_dim` dims of each head
    ([B, H, T, Dh], positions 0..T-1): adjacent pairs rotate together."""
    T = x.shape[2]
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=x.device) / rotary_dim))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv_freq[None, :]
    sin = torch.repeat_interleave(torch.sin(ang), 2, dim=-1)
    cos = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    pairs = torch.stack((-rot[..., 1::2], rot[..., ::2]), dim=-1).flatten(-2)
    return torch.cat((rot * cos + pairs * sin, rest), dim=-1)


def _attention(x: torch.Tensor, p: Params, pre: str, cfg: dict, quant: Quant) -> torch.Tensor:
    B, T, D = x.shape
    H = cfg["n_head"]
    Dh = D // H
    q, k, v = _linear(x, p, pre + "attn.qkv", quant).split(D, dim=-1)
    q, k, v = (t.reshape(B, T, H, Dh).transpose(1, 2) for t in (q, k, v))
    if cfg["model_type"] == "gptj":
        q, k = _rotary(q, cfg["rotary_dim"]), _rotary(k, cfg["rotary_dim"])
    if quant is not None:
        q, k = quant(q), quant(k)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(Dh)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    if quant is not None:
        probs, v = quant(probs), quant(v)
    out = (probs @ v).transpose(1, 2).reshape(B, T, D)
    return _linear(out, p, pre + "attn.out", quant)


def _mlp(x: torch.Tensor, p: Params, pre: str, quant: Quant) -> torch.Tensor:
    return _linear(_gelu_new(_linear(x, p, pre + "mlp.fc", quant)), p, pre + "mlp.proj", quant)


def trunk_hidden(p: Params, cfg: dict, tokens: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """Final hidden states [B, T, D] (after ln_f) of a full causal forward
    over `tokens` [B, T] at positions 0..T-1."""
    eps = cfg["layer_norm_epsilon"]
    x = p["wte.weight"].float()[tokens]
    if cfg["model_type"] == "gpt2":
        x = x + p["wpe.weight"].float()[: tokens.shape[1]][None]
    for i in range(cfg["n_layer"]):
        pre = f"h.{i}."
        h = _layer_norm(x, p, pre + "ln_1", eps)
        if cfg["model_type"] == "gptj":
            x = x + _attention(h, p, pre, cfg, quant) + _mlp(h, p, pre, quant)
        else:
            x = x + _attention(h, p, pre, cfg, quant)
            x = x + _mlp(_layer_norm(x, p, pre + "ln_2", eps), p, pre, quant)
    return _layer_norm(x, p, "ln_f", eps)


def lm_logits(p: Params, cfg: dict, hidden: torch.Tensor) -> torch.Tensor:
    """The output projection over the padded vocab: the tied embedding
    (GPT-2) or lm_head with its bias (GPT-J)."""
    if cfg["tie_word_embeddings"]:
        return hidden @ p["wte.weight"].float().t()
    return _linear(hidden, p, "lm_head")


def mlp_head(p: Params, x: torch.Tensor) -> torch.Tensor:
    """dense1 → gelu (tanh form) → dense2, float32."""
    return _linear(_gelu_new(_linear(x, p, "dense1")), p, "dense2")


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """Rounds to float8 e4m3 with one scale per tensor (its largest
    magnitude onto e4m3's 448), the gradient passed straight through: the
    control's precision, one step below bfloat16."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()
