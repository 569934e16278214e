"""The system under test, built from a configuration file: the port's
(`lmrl_gym_torch`) trunk and heads with the benchmark's weights copied in
by name. The only module of the benchmark, with the kinds, that imports the
program.
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch

from benchmark.weights import STD, Leaf, draw, group_seed, head_shape, model_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the game's word list, a raw file both sides read
WORDS_FILE = os.path.join(ROOT, "lmrl_gym_torch", "envs", "wordle", "vocab", "wordle_official_400.txt")


def transformer_config(cfg: dict):
    """The port's `TransformerConfig` for a configuration file: GPT-2 or
    GPT-J as published, bf16 activations."""
    from lmrl_gym_torch.models.config import TransformerConfig

    gptj = cfg["model_type"] == "gptj"
    return TransformerConfig(
        vocab_size=cfg["vocab_size"], max_position_embeddings=cfg["n_positions"], hidden_size=cfg["n_embd"],
        num_layers=cfg["n_layer"], num_heads=cfg["n_head"], intermediate_size=cfg["n_inner"],
        activation=cfg["activation_function"], position_embedding="rotary" if gptj else "learned",
        rotary_dim=cfg.get("rotary_dim"), rotary_interleaved=gptj, parallel_ffn=gptj, attn_bias=not gptj,
        layer_norm_epsilon=cfg["layer_norm_epsilon"], tie_word_embeddings=cfg["tie_word_embeddings"],
        embd_pdrop=cfg["embd_pdrop"], resid_pdrop=cfg["resid_pdrop"], attn_pdrop=cfg["attn_pdrop"],
        initializer_range=cfg["initializer_range"], pad_vocab_to_multiple=cfg["assumed"]["pad_vocab_to_multiple"],
        dtype="bfloat16",
    )


def load_into(module: torch.nn.Module, leaves: List[Leaf], seed: int, device, dtype: torch.dtype) -> None:
    """Copies the drawn leaves into `module`'s parameters of the same name;
    every parameter must be drawn, with its shape."""
    params = dict(module.named_parameters())
    if sorted(params) != sorted(name for name, *_ in leaves):
        raise ValueError(f"parameters {sorted(set(params) ^ {n for n, *_ in leaves})} differ from the drawn leaves")
    with torch.no_grad():
        for name, value in draw(leaves, seed, device, dtype):
            params[name].copy_(value)


def build_modules(cfg: dict, groups, seed: int, device, trunk_dtype: torch.dtype,
                  qkv_std: float = STD) -> Dict[str, torch.nn.Module]:
    """{group: module}: trunks ("base", "pi_beta") in `trunk_dtype`, MLP
    heads ("q1", "q2", "v") in float32, each holding the weights
    `weights.draw` gives its group."""
    from lmrl_gym_torch.models.heads import MLPHead, MLPHeadConfig
    from lmrl_gym_torch.models.transformer import init_params

    spec = model_spec(cfg, tuple(groups), qkv_std)
    out = {}
    for g in groups:
        if g in ("base", "pi_beta"):
            module = init_params(transformer_config(cfg), seed=0, device=device, dtype=trunk_dtype)
            dtype = trunk_dtype
        else:
            module = MLPHead(MLPHeadConfig(*head_shape(cfg, g)), device=device)
            dtype = torch.float32
        load_into(module, spec[g], group_seed(seed, g), device, dtype)
        out[g] = module
    return out


def route_counts() -> dict:
    """The attention kernels' launch counters: which routes a run took."""
    from lmrl_gym_torch.models.transformer import attention_einsum
    from lmrl_gym_torch.ops.decode_attention import decode_attention
    from lmrl_gym_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd

    return {
        "flash_fwd.launches": flash_fwd.launches, "flash_fwd.tc_launches": flash_fwd.tc_launches,
        "flash_bwd_dq.tc_launches": flash_bwd_dq.tc_launches, "flash_bwd_dkv.tc_launches": flash_bwd_dkv.tc_launches,
        "decode_attention.launches": decode_attention.launches,
        "decode_attention.split_launches": decode_attention.split_launches,
        "attention_einsum.calls": attention_einsum.calls,
    }
